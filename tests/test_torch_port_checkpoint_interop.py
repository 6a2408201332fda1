"""The port reads the JAX package's msgpack ``.ckpt`` and the reference's
``.pth``, told apart by content, on the CPU.

- ``utils/msgpack_format.py`` against flax (``msgpack_serialize`` /
  ``msgpack_restore``): each reads what the other wrote, bit for bit, and the
  port writes flax's bytes; chunked arrays with ``MAX_CHUNK_SIZE`` made small;
  a file of no known format raises a ``ValueError`` that names it.
- A checkpoint written by each of the JAX package's four phase trainers
  (its ``CheckpointManager``, on tests/clevr_fixtures.py, Adam's moments,
  the scheduler and the baseline set to values of their own): the port's
  trainers read their frozen models from these files, and ``load_frozen`` and
  ``load_checkpoint`` give the params of ``interop.*_from_jax`` at tolerance 0,
  Adam's ``step`` / ``exp_avg`` / ``exp_avg_sq``, the learning rate, the
  scheduler, the baseline and the iteration of the JAX trainer.
- Resume: the JAX program_prior trainer (weight decay on, which moves Adam
  in optax's chain) takes 3 steps and saves; the JAX trainer and the port
  each resume from that file and take 2 steps on the same batches, within
  tests/test_torch_port_training.py's tolerances. With
  ``OPTIM.ADAM_MU_DTYPE bfloat16`` the same both ways: the port resumes a
  JAX file with its bfloat16 ``mu`` bit for bit, and the JAX trainer
  resumes the port's ``save_checkpoint_jax`` file into the port's state.
- A reference ``.pth`` from tests/ref_checkpoints.py, zip and legacy: every
  model equals, at tolerance 0, the JAX package's ``torch_interop`` port of
  the same file through ``interop``.
- The suffix decides nothing; the train CLI starts from any of the formats.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.models import program_generator as jprogram_generator
from probnmn_tpu.models import question_reconstructor as jquestion_reconstructor
from probnmn_tpu.training.joint_training_trainer import JointTrainingTrainer as JaxJT
from probnmn_tpu.training.module_training_trainer import ModuleTrainingTrainer as JaxMT
from probnmn_tpu.training.optim import set_learning_rate
from probnmn_tpu.training.program_prior_trainer import ProgramPriorTrainer as JaxPP
from probnmn_tpu.training.program_prior_trainer import make_prior_spec as jax_make_prior_spec
from probnmn_tpu.training.question_coding_trainer import QuestionCodingTrainer as JaxQC
from probnmn_tpu.utils import torch_interop as jax_torch_interop
from probnmn_tpu_torch import interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models.program_prior import ProgramPriorSpec
from probnmn_tpu_torch.training._trainer import load_frozen, load_models, tree_leaves
from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer
from probnmn_tpu_torch.training.module_training_trainer import ModuleTrainingTrainer
from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer
from probnmn_tpu_torch.utils import msgpack_format
from probnmn_tpu_torch.utils.checkpointing import (
    MSGPACK,
    TORCH,
    TORCH_LEGACY,
    checkpoint_format,
    read_checkpoint,
    save_objects,
    save_objects_jax,
)
from probnmn_tpu_torch.utils.observability import RecordingWriter

from tests import ref_checkpoints
from tests.clevr_fixtures import build_fixture_data, make_fixture_config

PHASES = ["program_prior", "question_coding", "module_training", "joint_training"]
JAX_TRAINERS = {"program_prior": JaxPP, "question_coding": JaxQC, "module_training": JaxMT,
                "joint_training": JaxJT}
PORT_TRAINERS = {"program_prior": ProgramPriorTrainer, "question_coding": QuestionCodingTrainer,
                 "module_training": ModuleTrainingTrainer,
                 "joint_training": JointTrainingTrainer}
# The checkpoint each phase's JAX trainer writes is the next phases' frozen input.
FEEDS = {"program_prior": "PROGRAM_PRIOR", "question_coding": "QUESTION_CODING",
         "module_training": "MODULE_TRAINING"}
CPU = torch.device("cpu")
LOSS_ATOL, PARAM_ATOL, GRAD_FLOOR = 1e-5, 2e-5, 1e-5  # tests/test_torch_port_training.py


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda t: t.detach().numpy().copy() if isinstance(t, torch.Tensor) else np.array(t), tree)


def _paths(tree, prefix=""):
    r"""(key path, tensor) of a nested dict/list in insertion order, the
    order ``tree_leaves`` (and so the port's optimizer) takes."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [pair for k, v in items for pair in _paths(v, f"{prefix}/{k}")]


def _assert_trees_equal(got, want):
    got, want = dict(_paths(got)), dict(_paths(want))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def _port_specs(config, names):
    from probnmn_tpu_torch.models import nmn, program_generator, question_reconstructor
    from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec

    vocab = Vocabulary.from_files(config.DATA.VOCABULARY)
    make = {"program_prior": lambda: make_prior_spec(config, vocab),
            "program_generator": lambda: program_generator.make_spec(vocab, config),
            "question_reconstructor": lambda: question_reconstructor.make_spec(vocab, config),
            "nmn": lambda: nmn.make_spec(vocab, config)}
    return {name: make[name]() for name in names}, vocab


def _port_trainer(phase, config_path, directory, overrides=()):
    np.random.seed(0)  # the supervision subset, as the CLI seeds it
    return PORT_TRAINERS[phase](Config(config_path, list(overrides)), directory, device="cpu",
                                writer=RecordingWriter())


# ------------------------------------------------------------------ the codec --------
def _bf16(shape, seed):
    return np.asarray(jnp.asarray(np.random.RandomState(seed).randn(*shape), jnp.bfloat16))


CODEC_CASES = {
    "float32": {"w": np.random.RandomState(0).randn(3, 5).astype(np.float32)},
    "int32": {"i": np.arange(-4, 7, dtype=np.int32).reshape(11, 1), "count": np.int32(7)},
    "bfloat16": {"mu": _bf16((4, 6), 1), "scalar": _bf16((), 2)},
    "0-d": {"lr": np.array(0.004, np.float32), "n": np.float32(2.5), "i": 3, "f": -1.25,
            "none": None, "flag": True, "s": "program_prior"},
    "nested lists": {"encoder": [{"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)},
                                 [np.float32(1.0), -70000, 2 ** 40, "x" * 40]],
                     "empty": {}},
}


def _assert_same(got, want):
    r"""Equal values, dtypes and bits; the port's reader gives bfloat16 as a
    torch tensor, numpy (ml_dtypes) bfloat16 elsewhere."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)) or isinstance(got, torch.Tensor):
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.bfloat16
            got = got.view(torch.int16).numpy()
            want = np.asarray(want).view(np.int16)
        else:
            want = np.asarray(want)
            if want.dtype.name == "bfloat16":
                want, got = want.view(np.int16), np.asarray(got).view(np.int16)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_codec_reads_flax_and_flax_reads_the_codec(case):
    tree = CODEC_CASES[case]
    flax_bytes = serialization.msgpack_serialize(tree)
    assert msgpack_format.packb(tree) == flax_bytes
    _assert_same(msgpack_format.unpackb(flax_bytes), tree)
    # The port's tensors (bfloat16 among them) written by the port, read by flax.
    as_torch = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)
        if getattr(x, "dtype", None) is not None and x.dtype.name == "bfloat16" else x, tree)
    _assert_same(serialization.msgpack_restore(msgpack_format.packb(as_torch)), tree)


def test_codec_chunks_large_arrays_as_flax(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_format, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(3)
    tree = {"big": rs.randn(7, 9).astype(np.float32), "small": np.arange(4, dtype=np.int32),
            "inner": {"bf": _bf16((5, 21), 4), "b": rs.randn(40).astype(np.float32)}}
    flax_bytes = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in flax_bytes
    assert msgpack_format.packb(tree) == flax_bytes
    _assert_same(msgpack_format.unpackb(flax_bytes), tree)
    _assert_same(serialization.msgpack_restore(msgpack_format.packb(tree)), tree)


def test_garbage_raises_a_named_error(tmp_path):
    garbage = tmp_path / "model.ckpt"
    garbage.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="model.ckpt is not a checkpoint"):
        checkpoint_format(str(garbage))
    bad_type = tmp_path / "bad.ckpt"
    bad_type.write_bytes(b"\x82\xa9iteration\x03\xa5model\xc1")
    assert checkpoint_format(str(bad_type)) == MSGPACK
    with pytest.raises(ValueError, match="type byte 0xc1 at byte 18"):
        read_checkpoint(str(bad_type))
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_format.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="truncated at byte"):
        msgpack_format.unpackb(serialization.msgpack_serialize({"w": np.ones(9, np.float32)})[:-3])
    with pytest.raises(ValueError, match="not a checkpoint"):
        load_frozen(str(garbage), "program_prior", {}, CPU, ProgramPriorSpec(vocab_size=16), None)


# ------------------------------------------------------------------ JAX trainers -----
def _set_state(trainer, rs):
    r"""Adam's moments, count and learning rate, the scheduler and the
    baseline set to values of their own, so that each must be carried."""
    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.float32:
            return jnp.asarray(np.asarray(rs.rand(*x.shape), np.float32) + np.float32(0.1))
        return jnp.asarray(np.full(x.shape, 5, x.dtype))

    trainer._opt_state = set_learning_rate(jax.tree_util.tree_map(fill, trainer._opt_state),
                                           0.004)
    trainer._lr_scheduler.load_state_dict({"lr": 0.004, "best": 0.25, "num_bad": 2})
    trainer._baseline = np.float32(0.375)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    r"""The JAX package's four phase trainers on the fixture data, each
    writing checkpoint_7.ckpt through its CheckpointManager, which the next
    phases read as their frozen models."""
    root = str(tmp_path_factory.mktemp("interop"))
    build_fixture_data(root)
    rs = np.random.RandomState(0)
    out = {"root": root}
    for phase in PHASES:
        jax_config = make_fixture_config(root, phase)
        config_path = os.path.join(root, f"{phase}.yml")
        jax_config.dump(config_path)
        np.random.seed(0)
        trainer = JAX_TRAINERS[phase](jax_config, os.path.join(root, f"jax_{phase}"))
        _set_state(trainer, rs)
        trainer._checkpoint_manager.step(7, trainer._checkpointables())
        ckpt = os.path.join(root, f"jax_{phase}", "checkpoint_7.ckpt")
        if phase in FEEDS:
            shutil.copy(ckpt, getattr(jax_config.CHECKPOINTS, FEEDS[phase]))
        out[phase] = {"trainer": trainer, "config_path": config_path, "ckpt": ckpt}
    return out


@pytest.mark.parametrize("phase", PHASES)
def test_jax_trainer_checkpoint_loads(chain, tmp_path, phase):
    jax_trainer, ckpt = chain[phase]["trainer"], chain[phase]["ckpt"]
    assert checkpoint_format(ckpt) == MSGPACK
    # The port's trainer reads its frozen models from the JAX trainers' files.
    port = _port_trainer(phase, chain[phase]["config_path"], str(tmp_path))
    specs = port.model_specs()
    assert sorted(specs) == sorted(jax_trainer.model_specs())
    want = {name: interop.model_from_jax(name, _to_numpy(jax_trainer.params[name]), spec)
            for name, spec in specs.items()}
    vocab = Vocabulary.from_files(Config(chain[phase]["config_path"]).DATA.VOCABULARY)
    for name, spec in specs.items():
        template = jax.tree_util.tree_map(torch.zeros_like, want[name])
        _assert_trees_equal(load_frozen(ckpt, name, template, CPU, spec, vocab), want[name])
    assert port.iteration == -1
    port.load_checkpoint(ckpt)
    _assert_trees_equal({n: port.params[n] for n in specs}, want)
    assert port.iteration == 7
    assert float(port.baseline) == float(jax_trainer._baseline) == 0.375
    assert port._lr_scheduler.state_dict() == jax_trainer._lr_scheduler.state_dict()
    assert port.learning_rate == pytest.approx(jax_trainer.learning_rate) == pytest.approx(0.004)
    # Adam: the optax state's moments, per parameter in the port's order.
    adam = [s for s in jax_trainer._opt_state.inner_state if hasattr(s, "mu")][0]
    moments = {key: {n: interop.model_from_jax(n, _to_numpy(getattr(adam, key)[n]), spec)
                     for n, spec in specs.items()} for key in ("mu", "nu")}
    state = port._optimizer.state_dict()["state"]
    params = [path for path, _ in _paths({n: port.params[n] for n in port.params})]
    assert sorted(state) == list(range(len(params))) == list(range(len(tree_leaves(port.params))))
    mu, nu = dict(_paths(moments["mu"])), dict(_paths(moments["nu"]))
    for index, path in enumerate(params):
        assert float(state[index]["step"]) == int(adam.count) == 5
        assert torch.equal(state[index]["exp_avg"], mu[path]), path
        assert torch.equal(state[index]["exp_avg_sq"], nu[path]), path
    # The group's lr is optax's injected hyperparameter.
    payload, _ = read_checkpoint(ckpt)
    groups = interop.adam_state_from_optax(payload["optimizer"], port.params, specs,
                                           port._optimizer.state_dict())["param_groups"]
    assert groups[0]["lr"] == float(np.float32(0.004))


def test_bfloat16_adam_moment_is_refused_by_name(chain, tmp_path):
    r"""Once refused, now read and written both ways: the JAX trainer with
    ``OPTIM.ADAM_MU_DTYPE bfloat16`` takes 3 steps and saves; the port
    resumes from that file with every Adam moment as JAX stored it (``mu``
    in bfloat16, bit for bit), takes 2 steps beside the JAX trainer resumed
    from the same file (losses within 1e-5), and writes the JAX format
    (``save_checkpoint_jax``), which the JAX trainer resumes into the port's
    state exactly: params, ``mu`` (bfloat16) and ``nu``, the count, the
    learning rate, the scheduler, the baseline and the iteration."""
    root = chain["root"]
    overrides = ["OPTIM.ADAM_MU_DTYPE", "bfloat16"]
    jax_config = make_fixture_config(root, "program_prior", overrides)
    np.random.seed(0)
    first = JaxPP(jax_config, str(tmp_path / "jax"))
    for iteration in range(3):
        first._do_iteration(next(first._batches))
        first._iteration = iteration
    first._checkpoint_manager.step(2, first._checkpointables())
    ckpt = str(tmp_path / "jax" / "checkpoint_2.ckpt")

    port = _port_trainer("program_prior", chain["program_prior"]["config_path"],
                         str(tmp_path / "port"), overrides)
    port.load_checkpoint(ckpt)
    assert port.iteration == 2
    spec = port.model_specs()["program_prior"]

    def moments(trainer):
        adam = [s for s in trainer._opt_state.inner_state if hasattr(s, "mu")][0]
        return adam, {key: dict(_paths(interop.model_from_jax(
            "program_prior", _to_numpy(getattr(adam, key)["program_prior"]), spec)))
            for key in ("mu", "nu")}

    adam, want = moments(first)
    assert all(m.dtype == jnp.bfloat16 for m in jax.tree_util.tree_leaves(adam.mu))
    state = port._optimizer.state_dict()["state"]
    for index, (path, _) in enumerate(_paths(port.params["program_prior"])):
        assert float(state[index]["step"]) == int(adam.count) == 3
        assert state[index]["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(state[index]["exp_avg"].float(), want["mu"][path]), path
        assert torch.equal(state[index]["exp_avg_sq"], want["nu"][path]), path

    np.random.seed(0)
    jax_resumed = JaxPP(jax_config, str(tmp_path / "jax_resumed"))
    jax_resumed.load_checkpoint(ckpt)
    jax_losses, port_losses = [], []
    for iteration in (3, 4):
        jax_losses.append(float(jax_resumed._do_iteration(next(jax_resumed._batches))["loss"]))
        port_losses.append(port.step(iteration)["loss"])
    np.testing.assert_allclose(port_losses, jax_losses, atol=LOSS_ATOL, rtol=0)

    out = str(tmp_path / "port_as_jax.ckpt")
    port.save_checkpoint_jax(out)
    assert checkpoint_format(out) == MSGPACK
    np.random.seed(0)
    from_port = JaxPP(jax_config, str(tmp_path / "from_port"))
    from_port.load_checkpoint(out)
    assert from_port.iteration == 4
    _assert_trees_equal(
        interop.model_from_jax("program_prior", _to_numpy(from_port.params["program_prior"]), spec),
        jax.tree_util.tree_map(lambda t: t.detach(), port.params["program_prior"]))
    adam, got = moments(from_port)
    assert all(m.dtype == jnp.bfloat16 for m in jax.tree_util.tree_leaves(adam.mu))
    assert int(adam.count) == int(from_port._opt_state.count) == 5
    state = port._optimizer.state_dict()["state"]
    for index, (path, _) in enumerate(_paths(port.params["program_prior"])):
        assert torch.equal(got["mu"][path], state[index]["exp_avg"].float()), path
        assert torch.equal(got["nu"][path], state[index]["exp_avg_sq"]), path
    assert from_port.learning_rate == pytest.approx(port.learning_rate)
    assert from_port._lr_scheduler.state_dict() == port._lr_scheduler.state_dict()
    assert float(from_port._baseline) == float(port.baseline)
    # And the JAX trainer steps on from it.
    assert np.isfinite(float(from_port._do_iteration(next(from_port._batches))["loss"]))


def test_resume_from_a_jax_checkpoint_matches_the_jax_trainer(chain, tmp_path):
    root = chain["root"]
    overrides = ["OPTIM.WEIGHT_DECAY", 0.01]
    jax_config = make_fixture_config(root, "program_prior", overrides)
    np.random.seed(0)
    first = JaxPP(jax_config, str(tmp_path / "first"))
    for iteration in range(3):
        first._do_iteration(next(first._batches))
        first._iteration = iteration
    first._checkpoint_manager.step(2, first._checkpointables())
    ckpt = str(tmp_path / "first" / "checkpoint_2.ckpt")

    np.random.seed(0)
    jax_resumed = JaxPP(jax_config, str(tmp_path / "jax"))
    jax_resumed.load_checkpoint(ckpt)
    port = _port_trainer("program_prior", chain["program_prior"]["config_path"],
                         str(tmp_path / "port"), overrides)
    port.load_checkpoint(ckpt)
    assert port.iteration == jax_resumed.iteration == 2
    jax_losses, port_losses, grads = [], [], []
    for iteration in (3, 4):
        jax_losses.append(float(jax_resumed._do_iteration(next(jax_resumed._batches))["loss"]))
        port_losses.append(port.step(iteration)["loss"])
        grads.append(dict(_paths({k: v.grad for k, v in port.params["program_prior"].items()
                                  if isinstance(v, torch.Tensor)})))
    np.testing.assert_allclose(port_losses, jax_losses, atol=LOSS_ATOL, rtol=0)
    want = interop.program_prior_from_jax(_to_numpy(jax_resumed.params["program_prior"]))
    got = dict(_paths(port.params["program_prior"]))
    compared = 0
    for key, w in _paths(want):
        g = got[key].detach()
        if key in grads[0]:
            smooth = torch.stack([step[key].abs() for step in grads]).min(0).values > GRAD_FLOOR
            torch.testing.assert_close(g[smooth], w[smooth], atol=PARAM_ATOL, rtol=0)
            compared += int(smooth.sum())
        # Elsewhere the difference is bounded by the steps' size: 2 * lr a step.
        torch.testing.assert_close(g, w, atol=2 * 0.01 * 2, rtol=0)
    assert compared > 0


# ------------------------------------------------------------------ reference .pth ---
@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_reference_pth_loads_as_the_jax_package_ports_it(chain, tmp_path, legacy):
    root = chain["root"]
    jax_config = make_fixture_config(root, "joint_training")
    jvocab = JVocabulary.from_files(jax_config.DATA.VOCABULARY)
    jspecs = {"program_generator": jprogram_generator.make_spec(jvocab, jax_config),
              "question_reconstructor": jquestion_reconstructor.make_spec(jvocab, jax_config),
              "nmn": jnmn.make_spec(jvocab, jax_config),
              "program_prior": jax_make_prior_spec(jax_config, jvocab)}
    pg, qr, prior = (jspecs[n] for n in ("program_generator", "question_reconstructor",
                                         "program_prior"))
    payload = {
        "program_generator": ref_checkpoints.make_seq2seq_state(
            pg.source_vocab_size, pg.target_vocab_size, pg.input_size, pg.hidden_size,
            pg.num_layers, 1),
        "question_reconstructor": ref_checkpoints.make_seq2seq_state(
            qr.source_vocab_size, qr.target_vocab_size, qr.input_size, qr.hidden_size,
            qr.num_layers, 2),
        "nmn": ref_checkpoints.make_nmn_state(jvocab, jspecs["nmn"], 3),
        "program_prior": ref_checkpoints.make_prior_state(
            prior.vocab_size, prior.input_size, prior.hidden_size, prior.num_layers, 4),
        "optimizer": {}, "iteration": 11,
    }
    path = str(tmp_path / "model.pth")
    torch.save(payload, path, _use_new_zipfile_serialization=not legacy)
    assert checkpoint_format(path) == (TORCH_LEGACY if legacy else TORCH)

    config = Config(chain["joint_training"]["config_path"])
    specs, vocab = _port_specs(config, list(jspecs))
    ported = jax_torch_interop.load_reference_checkpoint(path, jspecs, jvocab)
    want = {name: interop.model_from_jax(name, _to_numpy(ported[name]), specs[name])
            for name in jspecs}
    got = load_models(path, specs, vocab)
    for name in jspecs:
        _assert_trees_equal(got[name], want[name])
    # A trainer reads the weights alone: a fresh optimizer, iteration -1.
    port = _port_trainer("program_prior", chain["program_prior"]["config_path"],
                         str(tmp_path / "port"))
    port.load_checkpoint(path)
    _assert_trees_equal(port.params["program_prior"], want["program_prior"])
    assert port.iteration == -1 and port._optimizer.state_dict()["state"] == {}


def test_the_suffix_decides_nothing(chain, tmp_path):
    config = Config(chain["program_prior"]["config_path"])
    specs, vocab = _port_specs(config, ["program_prior"])
    jax_params = chain["program_prior"]["trainer"].params["program_prior"]
    want = interop.program_prior_from_jax(_to_numpy(jax_params))
    jax_as_pth = str(tmp_path / "x.pth")
    shutil.copy(chain["program_prior"]["ckpt"], jax_as_pth)
    port_as_bin = str(tmp_path / "x.bin")
    save_objects(port_as_bin, {"program_prior": want}, 3)
    jax_as_pth_written_by_port = str(tmp_path / "y.pth")
    save_objects_jax(jax_as_pth_written_by_port,
                     {"program_prior": interop.program_prior_to_jax(want)}, 3)
    for path, fmt in ((jax_as_pth, MSGPACK), (port_as_bin, TORCH),
                      (jax_as_pth_written_by_port, MSGPACK)):
        assert checkpoint_format(path) == fmt
        template = jax.tree_util.tree_map(torch.zeros_like, want)
        got = load_frozen(path, "program_prior", template, CPU, specs["program_prior"], vocab)
        _assert_trees_equal(got, want)
    # What the port writes in the JAX format, the JAX package restores.
    from probnmn_tpu.utils.checkpointing import load_objects as jax_load_objects

    restored, iteration, _ = jax_load_objects(jax_as_pth_written_by_port,
                                              {"program_prior": jax_params})
    assert iteration == 3
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fmt", ["port", "jax", "reference"])
def test_train_cli_starts_from_any_format(chain, tmp_path, monkeypatch, fmt):
    config_path = chain["program_prior"]["config_path"]
    jax_ckpt = chain["program_prior"]["ckpt"]
    want = interop.program_prior_from_jax(
        _to_numpy(chain["program_prior"]["trainer"].params["program_prior"]))
    start, first_iteration = jax_ckpt, 8
    if fmt == "port":
        start = str(tmp_path / "port.ckpt")
        save_objects(start, {"program_prior": want}, 7)
    elif fmt == "reference":
        spec = _port_specs(Config(config_path), ["program_prior"])[0]["program_prior"]
        start = str(tmp_path / "ref.pth")
        ref_checkpoints.save_reference_pth(start, {"program_prior": ref_checkpoints.make_prior_state(
            spec.vocab_size, spec.input_size, spec.hidden_size, spec.num_layers, 5)}, 7)
        first_iteration = 0
    out = str(tmp_path / "run")
    args = train.parser.parse_args([
        "--phase", "program_prior", "--config-yml", config_path,
        "--config-override", "OPTIM.NUM_ITERATIONS", "9",
        "--device", "cpu", "--serialization-dir", out, "--start-from-checkpoint", start,
        "--checkpoint-every", "100",
    ])
    writer = RecordingWriter()
    original = train.build
    monkeypatch.setattr(train, "build", lambda *a, **kw: original(*a, **kw, writer=writer))
    train.main(args)
    steps = [step for tag, _, step in writer.scalars if tag == "train/loss"]
    assert steps == list(range(first_iteration, 9))
