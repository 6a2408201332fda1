"""The port's mini-CLEVR path against the JAX package's, on the CPU.

- ``probnmn_tpu_torch.data.mini_clevr.generate_split`` equals the JAX one
  exactly (features, programs, questions, answers, image indices) for seeds
  0, 1 and 2;
- the in-memory splits of ``make_mini_clevr`` equal the arrays JAX
  ``write_mini_clevr`` writes to H5, and the port's datasets built from them
  (``phase_dataset``) give the items of the JAX datasets reading those files,
  supervision subsets included;
- each phase's config from the port's runner equals the JAX script's
  ``phase_config`` with ``--hparam ALPHA 500.0`` applied last, and the
  runners share their settings, bars and flags;
- the port's ``write_mini_clevr`` writes the same files as the JAX one;
- the runner at ``--geometry tiny --grid 8 --device cpu`` in two
  invocations split by ``--phases``: the second re-evaluating the finished
  phases without training them, resuming module_training's second leg at
  the half-way iteration with the checkpoint's baseline and optimizer
  state, and reporting all four phases, each reading the earlier phases'
  best checkpoints;
- ``python -m probnmn_tpu_torch.evaluate --device cpu`` on the fixture
  config, from checkpoints the port's train CLI wrote.
"""
import copy
import json
import os
import sys

import h5py
import numpy as np
import pytest
import torch

from probnmn_tpu.data import datasets as jax_datasets
from probnmn_tpu.data import mini_clevr as jax_mc
from probnmn_tpu_torch import evaluate, mini_clevr_run, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data import mini_clevr as mc
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models import program_generator
from probnmn_tpu_torch.training import _trainer
from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer
from probnmn_tpu_torch.utils.checkpointing import load_objects, save_objects
from probnmn_tpu_torch.utils.observability import RecordingWriter

from tests.clevr_fixtures import build_fixture_data, make_fixture_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = mini_clevr_run.PHASE_ORDER
H5_KEYS = {"train": ("programs", "questions", "answers", "image_indices"),
           "val": ("programs", "questions", "answers", "image_indices"),
           "test": ("questions", "image_indices")}
SMALL = dict(n_train_images=20, n_val_images=8, n_test_images=4, questions_per_image=2,
             seed=0, height=6, width=6)


def _jax_runner():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import run_mini_clevr

    return run_mini_clevr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_split_equals_jax(seed):
    got = mc.generate_split(seed, 50, 2)
    want = jax_mc.generate_split(seed, 50, 2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[1:4] == want[1:4]
    np.testing.assert_array_equal(got[4], want[4])
    assert len(got[1]) == 100


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    r"""The JAX package's files and the port's in-memory splits, same arguments."""
    root = str(tmp_path_factory.mktemp("mini_clevr_h5"))
    jax_mc.write_mini_clevr(root, **SMALL)
    vocab, splits = mc.make_mini_clevr(**SMALL)
    return root, vocab, splits


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_in_memory_splits_equal_write_mini_clevr(written, split):
    root, _, splits = written
    got = splits[split]
    assert got.split == split
    with h5py.File(os.path.join(root, f"{split}_tokens.h5"), "r") as f:
        assert f.attrs["split"] == split
        assert sorted(f.keys()) == sorted(H5_KEYS[split])
        for key in H5_KEYS[split]:
            np.testing.assert_array_equal(getattr(got, key), f[key][:])
            assert getattr(got, key).dtype == f[key].dtype
    with h5py.File(os.path.join(root, f"{split}_features.h5"), "r") as f:
        np.testing.assert_array_equal(got.features, f["features"][:])
    if split == "test":
        assert got.programs is None and got.answers is None


@pytest.fixture(scope="module")
def written_by_port(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_clevr_h5_port"))
    mc.write_mini_clevr(root, **SMALL)
    return root


@pytest.mark.parametrize("kind", ["tokens", "features"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_write_mini_clevr_equals_jax_files(written, written_by_port, split, kind):
    root = written[0]
    name = f"{split}_{kind}.h5"
    with h5py.File(os.path.join(written_by_port, name), "r") as got, \
            h5py.File(os.path.join(root, name), "r") as want:
        assert dict(got.attrs) == dict(want.attrs)
        assert sorted(got.keys()) == sorted(want.keys())
        for key in want.keys():
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key][:], want[key][:], err_msg=key)
    if kind == "tokens":
        for vocab_file in sorted(os.listdir(os.path.join(root, "vocab"))):
            with open(os.path.join(root, "vocab", vocab_file)) as a, \
                    open(os.path.join(written_by_port, "vocab", vocab_file)) as b:
                assert a.read() == b.read(), vocab_file


def test_vocabulary_equals_write_mini_clevr(written, tmp_path):
    root, vocab, _ = written
    vocab.save_to_files(str(tmp_path))
    for name in sorted(os.listdir(os.path.join(root, "vocab"))):
        with open(os.path.join(root, "vocab", name)) as a, open(tmp_path / name) as b:
            assert a.read() == b.read(), name


def _jax_dataset(root, split, phase):
    tokens = os.path.join(root, f"{split}_tokens.h5")
    features = os.path.join(root, f"{split}_features.h5")
    if phase == "program_prior":
        return jax_datasets.ProgramPriorDataset(tokens)
    if phase == "question_coding":
        return jax_datasets.QuestionCodingDataset(tokens, num_supervision=12,
                                                  supervision_question_max_length=40)
    if phase == "module_training":
        return jax_datasets.ModuleTrainingDataset(tokens, features)
    return jax_datasets.JointTrainingDataset(tokens, features, num_supervision=12,
                                             supervision_question_max_length=40)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("phase", PHASES)
def test_phase_datasets_equal_jax_datasets(written, phase, split):
    root, _, splits = written
    np.random.seed(3)
    want = _jax_dataset(root, split, phase)
    np.random.seed(3)
    got = mc.phase_dataset(splits[split], phase, num_supervision=12,
                           supervision_question_max_length=40)
    assert len(got) == len(want) == (40 if split == "train" else 16)
    indices = np.arange(len(got))[::-1].copy()
    a, b = got.get_batch(indices), want.get_batch(indices)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=key)
    if phase in ("question_coding", "joint_training"):
        supervision = got.get_supervision_list()
        np.testing.assert_array_equal(supervision, want.get_supervision_list())
        assert supervision.sum() == (12 if split == "train" else len(got))


def _parse_both(tmp_path, extra=()):
    common = ["--root", str(tmp_path / "data"), "--runs", str(tmp_path / "runs"),
              "--hparam", "ALPHA", "500.0"] + list(extra)
    return (mini_clevr_run.parser.parse_args(common),
            _jax_runner().parser.parse_args(common))


DATA_PATHS = [f"{split}_{kind}" for split in ("TRAIN", "VAL", "TEST")
              for kind in ("TOKENS", "FEATURES")]


@pytest.mark.parametrize("extra", [(), ("--geometry", "tiny", "--grid", "8", "--max-batch", "16",
                                        "--nmn-channels", "24")])
@pytest.mark.parametrize("phase", PHASES)
def test_phase_config_equals_jax_runner(tmp_path, phase, extra):
    port_args, jax_args = _parse_both(tmp_path, extra)
    got = mini_clevr_run.phase_config(port_args, phase, 123).to_dict()
    want = _jax_runner().phase_config(jax_args, phase, 123).to_dict()
    for key in DATA_PATHS:  # the port's splits stay in memory
        del want["DATA"][key], got["DATA"][key]
    assert got == want
    assert got["ALPHA"] == 500.0 and got["OPTIM"]["NUM_ITERATIONS"] == 123


def test_runner_settings_equal_jax_runner(tmp_path):
    jax_runner = _jax_runner()
    assert mini_clevr_run.PHASE_HPARAMS == jax_runner.PHASE_HPARAMS
    assert mini_clevr_run.THRESHOLDS == jax_runner.THRESHOLDS
    assert mini_clevr_run.PHASE_ORDER == jax_runner.PHASE_ORDER
    port_args, jax_args = _parse_both(tmp_path)
    shared = ("train_images", "val_images", "questions_per_image", "supervision", "seed",
              "iters", "checkpoint_every", "num_val_batches", "phases", "assert_thresholds",
              "resume_split_phase", "geometry", "grid", "hparam", "max_batch", "nmn_channels")
    for key in shared:
        assert getattr(port_args, key) == getattr(jax_args, key), key
    assert port_args.device == "cuda"
    for metrics, ok in (({"nmn": {"answer_accuracy": 0.8}}, True),
                        ({"nmn": {"answer_accuracy": 0.75}}, False)):
        assert mini_clevr_run.check_threshold("joint_training", metrics) == \
            jax_runner.check_threshold("joint_training", metrics)
        assert mini_clevr_run.check_threshold("joint_training", metrics)[2] == ok


LOCKSTEP_STEPS = 30
LOCKSTEP_TOL = 1e-4


def test_question_coding_learns_in_lockstep_with_the_jax_trainer(tmp_path, monkeypatch):
    r"""OBJECTIVE ours on mini-CLEVR at the runner's question_coding config
    (tiny widths, two encoder layers): the port's trainer and the JAX
    package's, from the same parameters and prior, on the same batches, with
    both generators sampling from the same Philox Gumbel noise each step
    (the JAX trainer's jitted step reads it through a host callback), stay
    together step after step: every log and the REINFORCE baseline."""
    import jax
    import jax.numpy as jnp

    from probnmn_tpu.data.vocabulary import Vocabulary as JaxVocabulary
    from probnmn_tpu.models.program_prior import init_program_prior_params
    from probnmn_tpu.ops.pallas.seq2seq_decode import sampling_forward_with_noise_xla
    from probnmn_tpu.training import question_coding_trainer as jax_qc
    from probnmn_tpu.training.program_prior_trainer import make_prior_spec
    from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
    from probnmn_tpu_torch import interop
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        philox_gumbel, sampling_forward_with_noise,
    )
    from probnmn_tpu_torch.training._trainer import copy_into

    root, runs = str(tmp_path / "data"), str(tmp_path / "runs")
    jax_mc.write_mini_clevr(root, n_train_images=300, n_val_images=8, n_test_images=4, seed=0,
                            height=8, width=8)
    argv = ["--root", root, "--runs", runs, "--geometry", "tiny", "--grid", "8",
            "--max-batch", "32", "--supervision", "100", "--hparam", "ALPHA", "500.0"]
    argv += [x for m in ("PROGRAM_GENERATOR", "QUESTION_RECONSTRUCTOR")
             for x in ("--hparam", f"{m}.NUM_LAYERS", "2")]
    jax_config = _jax_runner().phase_config(_jax_runner().parser.parse_args(argv),
                                            "question_coding", LOCKSTEP_STEPS)
    prior = init_program_prior_params(jax.random.PRNGKey(11), make_prior_spec(
        jax_config, JaxVocabulary.from_files(os.path.join(root, "vocab"))))
    os.makedirs(os.path.join(runs, "program_prior"))
    jax_save_objects(jax_config.CHECKPOINTS.PROGRAM_PRIOR, {"program_prior": prior})
    port_prior = str(tmp_path / "prior_port.ckpt")
    save_objects(port_prior, {"program_prior": interop.program_prior_from_jax(
        jax.tree_util.tree_map(np.asarray, prior))})
    path = str(tmp_path / "qc.yml")
    jax_config.dump(path)
    config = Config(path, ["CHECKPOINTS.PROGRAM_PRIOR", port_prior])
    assert mini_clevr_run.phase_config(mini_clevr_run.parser.parse_args(argv), "question_coding",
                                       LOCKSTEP_STEPS).to_dict()["ALPHA"] == config.ALPHA

    draws = {"port": 0, "jax": 0, "rows": 0}

    def noise(side, rows, spec):
        draws[side] += 1
        return philox_gumbel(1000 + draws[side], spec.max_decoding_steps, rows,
                             spec.target_vocab_size)

    sampling = jax_qc.seq2seq_forward

    def jax_sampling(params, spec, source, target=None, *args, **kwargs):
        if target is not None:
            return sampling(params, spec, source, target, *args, **kwargs)
        shape = (spec.max_decoding_steps, source.shape[0], spec.target_vocab_size)

        def host_noise():  # the unsupervised rows are the window's last ones
            full = np.zeros(shape, np.float32)
            full[:, shape[1] - draws["rows"]:] = noise("jax", draws["rows"], spec)
            return full

        gumbel = jax.pure_callback(host_noise, jax.ShapeDtypeStruct(shape, jnp.float32))
        return sampling_forward_with_noise_xla(params, spec, source, gumbel)

    monkeypatch.setattr(jax_qc, "seq2seq_forward", jax_sampling)
    np.random.seed(config.RANDOM_SEED)
    jax_trainer = jax_qc.QuestionCodingTrainer(jax_config, str(tmp_path / "jax"))
    np.random.seed(config.RANDOM_SEED)
    port = QuestionCodingTrainer(config, str(tmp_path / "port"), device="cpu",
                                 writer=RecordingWriter())
    for name in ("program_generator", "question_reconstructor"):
        copy_into(port.params[name], interop.program_generator_from_jax(
            jax.tree_util.tree_map(np.asarray, jax_trainer.params[name])))

    def port_sampling(questions, dropout_masks=None):
        draws["rows"] = len(questions)
        gumbel = torch.from_numpy(noise("port", len(questions), port.pg_spec))
        with torch.no_grad():
            return sampling_forward_with_noise(port.params["program_generator"], port.pg_spec,
                                               questions, gumbel)["predictions"]

    port.sample_programs = port_sampling
    worst = 0.0
    for iteration in range(LOCKSTEP_STEPS):
        got = port.step(iteration)
        want = jax.tree_util.tree_map(float, jax_trainer._do_iteration(next(jax_trainer._batches)))
        assert draws["port"] == draws["jax"] == iteration + 1
        assert sorted(got) == sorted(want) == ["elbo", "loss"]
        for group, values in want.items():
            for key, value in values.items():
                worst = max(worst, abs(got[group][key] - value))
                assert abs(got[group][key] - value) <= LOCKSTEP_TOL, (iteration, group, key)
        assert abs(float(port.baseline) - float(jax_trainer._baseline)) <= LOCKSTEP_TOL
    assert float(port.baseline) != 0.0 and worst < LOCKSTEP_TOL


def test_lockstep_tool_at_tiny_width(tmp_path):
    r"""``tools/qc_lockstep_width.py`` (the lockstep above at any width, as a
    tool) on data and a random prior it makes itself: three steps, the
    trainers together (every log within LOCKSTEP_TOL, no sampled program
    different), and JAX's sampler restored when it returns."""
    from probnmn_tpu.training import question_coding_trainer as jax_qc

    sys.path.insert(0, REPO)
    from tools import qc_lockstep_width

    sampler = jax_qc.seq2seq_forward
    out = tmp_path / "lockstep.json"
    history = qc_lockstep_width.main([
        "--root", str(tmp_path / "data"), "--runs", str(tmp_path / "runs"), "--steps", "3",
        "--out", str(out), "--", "--geometry", "tiny", "--grid", "8", "--max-batch", "16",
        "--train-images", "60", "--val-images", "8", "--supervision", "30"])
    assert jax_qc.seq2seq_forward is sampler
    assert [row["iteration"] for row in history] == [0, 1, 2]
    assert json.load(open(out)) == history
    for row in history:
        assert row["log_diff"] <= LOCKSTEP_TOL and row["baseline_diff"] <= LOCKSTEP_TOL
        assert row["z_rows"] > 0 and row["z_rows_differ"] == 0
        assert max(row["params"].values()) < 1e-4


def test_runner_in_two_invocations(tmp_path, monkeypatch):
    r"""The JAX script's way of running the chain in pieces: the first
    invocation trains program_prior and question_coding, the second trains
    the NMN phases over more training images, re-evaluating the finished
    phases' best checkpoints into its report without training them again,
    and splitting module_training in two legs."""
    common = ["--geometry", "tiny", "--grid", "8", "--device", "cpu", "--val-images", "16",
              "--supervision", "20", "--iters", "4", "6", "4", "4", "--checkpoint-every", "2",
              "--num-val-batches", "1", "--max-batch", "8", "--hparam", "ALPHA", "500.0",
              "--root", str(tmp_path / "data"), "--runs", str(tmp_path / "runs"),
              "--report", str(tmp_path / "report.md"),
              "--report-json", str(tmp_path / "report.json")]
    runs = tmp_path / "runs"
    frozen, resumed = [], []
    real_load_objects = _trainer.load_objects
    real_load_checkpoint = _trainer._Trainer.load_checkpoint

    def record_frozen(path, templates):
        frozen.append((os.path.relpath(path, runs), sorted(templates)))
        return real_load_objects(path, templates)

    def record_resume(self, path, iteration=None):
        real_load_checkpoint(self, path, iteration)
        resumed.append(dict(path=path, iteration=self.iteration, baseline=self.baseline.clone(),
                            optimizer=copy.deepcopy(self._optimizer.state_dict()),
                            lr=self.learning_rate))

    monkeypatch.setattr(_trainer, "load_objects", record_frozen)
    monkeypatch.setattr(_trainer._Trainer, "load_checkpoint", record_resume)
    first = mini_clevr_run.main(mini_clevr_run.parser.parse_args(
        common + ["--train-images", "40", "--phases", "program_prior", "question_coding"]))
    assert list(first["phases"]) == PHASES[:2]
    assert all(e["trained"] for e in first["phases"].values())
    saved = {p: torch.load(runs / p / "checkpoint_best.ckpt", weights_only=True)
             for p in PHASES[:2]}

    frozen.clear(), resumed.clear()
    argv = common + ["--train-images", "60", "--phases", "module_training", "joint_training",
                     "--resume-split-phase", "module_training"]
    report = mini_clevr_run.main(mini_clevr_run.parser.parse_args(argv))
    assert report["command"].endswith(
        "--phases module_training joint_training --resume-split-phase module_training "
        "--hparam ALPHA 500.0")
    assert report["data"]["train_examples"] == 120

    # The finished phases: not trained again, their best checkpoints untouched
    # and evaluated on the same val split as before.
    for phase in PHASES[:2]:
        entry = report["phases"][phase]
        assert not entry["trained"] and entry["steps"] is None and entry["legs"] is None
        assert entry["metrics"] == first["phases"][phase]["metrics"]
        assert entry["best_iteration"] == saved[phase]["iteration"]
        again = torch.load(runs / phase / "checkpoint_best.ckpt", weights_only=True)
        assert again["iteration"] == saved[phase]["iteration"]
    assert set(report["val_trajectories"]) == set(mini_clevr_run.NMN_PHASES)

    # module_training in two legs, the second from the half-way checkpoint
    # with the checkpoint's baseline, learning rate and optimizer state.
    mt = runs / "module_training"
    mt_entry = report["phases"]["module_training"]
    assert [(leg["start"], leg["end"]) for leg in mt_entry["legs"]] == [(0, 2), (2, 4)]
    assert mt_entry["legs"][1]["resumed_from"] == str(mt / "checkpoint_1.ckpt")
    assert mt_entry["steps"] == 4
    half = torch.load(mt / "checkpoint_1.ckpt", weights_only=True)
    leg = resumed[2]
    assert leg["path"] == str(mt / "checkpoint_1.ckpt") and leg["iteration"] == 1
    assert float(leg["baseline"]) == float(half["reinforce_baseline"])
    assert leg["lr"] == half["scheduler"]["lr"]
    assert leg["optimizer"]["param_groups"] == half["optimizer"]["param_groups"]
    for key, state in half["optimizer"]["state"].items():
        for name, value in state.items():
            torch.testing.assert_close(leg["optimizer"]["state"][key][name], value,
                                       rtol=0, atol=0)
    # Every best checkpoint evaluated by a fresh trainer, in phase order.
    assert [os.path.relpath(p["path"], runs) for p in resumed] == [
        "program_prior/checkpoint_best.ckpt", "question_coding/checkpoint_best.ckpt",
        "module_training/checkpoint_1.ckpt", "module_training/checkpoint_best.ckpt",
        "joint_training/checkpoint_best.ckpt"]

    # Each phase read the earlier phases' best checkpoints.
    best = {p: os.path.join(p, "checkpoint_best.ckpt") for p in PHASES}
    assert (best["program_prior"], ["program_prior"]) in frozen
    assert (best["question_coding"], ["program_generator"]) in frozen
    assert (best["question_coding"], ["question_reconstructor"]) in frozen
    assert (best["module_training"], ["nmn"]) in frozen
    assert {path for path, _ in frozen} == {best[p] for p in PHASES[:3]}

    assert list(report["phases"]) == PHASES
    for phase, entry in report["phases"].items():
        assert np.isfinite(entry["value"]) and entry["metrics"]
        if entry["trained"]:
            assert entry["nonfinite_steps"] == 0
            model, metric, _, _ = mini_clevr_run.THRESHOLDS[phase]
            trajectory = report["val_trajectories"][phase][f"val/metrics/{model}/{metric}"]
            assert [it for it, _ in trajectory] == list(range(1, entry["iterations"], 2))
    for phase in mini_clevr_run.NMN_PHASES:
        assert set(report["phases"][phase]["metrics"]["nmn_free_greedy"]) == {
            "answer_accuracy", "average_invalid"}
    assert json.loads((tmp_path / "report.json").read_text()) == json.loads(json.dumps(report))
    table = (tmp_path / "report.md").read_text()
    assert all(f"| {phase} |" in table for phase in PHASES)


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    args = mini_clevr_run.parser.parse_args(["--runs", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mini_clevr_run.main(args)
    assert evaluate.parser.parse_args(
        ["--phase", "program_prior", "--config-yml", "x", "--checkpoint-path", "y"]
    ).device == "cuda"


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clevr_eval"))
    build_fixture_data(root)
    return root


@pytest.mark.parametrize("phase,streaming", [("program_prior", False),
                                             ("module_training", False),
                                             ("module_training", True)])
def test_evaluate_cli_on_the_cpu(fixture_root, tmp_path, phase, streaming):
    path = str(tmp_path / f"{phase}.yml")
    make_fixture_config(fixture_root, phase, [
        "CHECKPOINTS.QUESTION_CODING", str(tmp_path / "qc.ckpt")]).dump(path)
    config = Config(path)
    if phase == "module_training":  # its frozen generator, written by the port
        spec = program_generator.make_spec(Vocabulary.from_files(config.DATA.VOCABULARY),
                                           config)
        save_objects(config.CHECKPOINTS.QUESTION_CODING, {
            "program_generator": program_generator.init_params(torch.Generator().manual_seed(1),
                                                               spec)})
    out = str(tmp_path / "run")
    train.main(train.parser.parse_args([
        "--phase", phase, "--config-yml", path, "--config-override", "OPTIM.NUM_ITERATIONS", "2",
        "--device", "cpu", "--serialization-dir", out, "--checkpoint-every", "2",
        "--num-val-batches", "1"]))
    checkpoint = os.path.join(out, "checkpoint_best.ckpt")
    before = sorted(os.listdir(out))

    argv = ["--phase", phase, "--config-yml", path, "--checkpoint-path", checkpoint,
            "--device", "cpu"] + (["--streaming-features"] if streaming else [])
    got = evaluate.main(evaluate.parser.parse_args(argv))
    assert sorted(os.listdir(out)) == before  # evaluating writes nothing

    np.random.seed(config.RANDOM_SEED)
    trainer, evaluator = train.build(phase, config, str(tmp_path / "direct"), "cpu",
                                     writer=RecordingWriter())
    trainer.load_checkpoint(checkpoint)
    assert trainer.iteration == 1
    want = evaluator.evaluate()
    assert got == want
    model = "program_prior" if phase == "program_prior" else "nmn"
    assert np.isfinite(list(got[model].values())).all()
    partial = evaluate.main(evaluate.parser.parse_args(argv + ["--num-val-batches", "1"]))
    assert set(partial) == set(got)

    with pytest.raises(ValueError, match="expected config PHASE"):
        other = "question_coding" if phase == "program_prior" else "program_prior"
        evaluate.main(evaluate.parser.parse_args(
            ["--phase", other, "--config-yml", path, "--checkpoint-path", checkpoint,
             "--device", "cpu"]))
    assert load_objects(checkpoint, {model: None})[1] == 1
