"""Serving from a checkpoint: the port's beam decoding, ``InferenceEngine.from_checkpoint``
and inference CLI against the JAX package's, in float32 on the CPU.

- ``models/seq2seq.py::beam_search_forward`` against JAX's at beam 1 and 4:
  the same tokens (every hypothesis), scores and loss within 1e-5; beam 1
  gives the greedy tokens.
- ``InferenceEngine.from_checkpoint`` from a joint checkpoint in each of the
  three formats (the JAX package's ``.ckpt``, the port's, the reference's
  ``.pth``) against JAX's ``InferenceEngine.from_checkpoint``, greedy: the
  generator's and the NMN's params at tolerance 0 and the same answers. The
  generator is scripted (it emits one valid program whatever the question),
  so the NMN's answers are not all @@UNKNOWN@@.
- The port's inference CLI against ``scripts/inference.py`` (run as a
  subprocess: the port's tests import the JAX package, its CLI does not) on
  the same checkpoint, greedy, at a batch size of 6 that does not divide the
  16 test rows: the same predictions JSON, one entry for every row.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.models import program_generator as jprogram_generator
from probnmn_tpu.models import question_reconstructor as jquestion_reconstructor
from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu.serving import InferenceEngine as JaxInferenceEngine
from probnmn_tpu.utils import torch_interop as jax_torch_interop
from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
from probnmn_tpu_torch import inference, interop
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import JointTrainingDataset
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models import nmn, seq2seq
from probnmn_tpu_torch.serving import InferenceEngine
from probnmn_tpu_torch.utils.checkpointing import save_objects

from tests import ref_checkpoints
from tests.clevr_fixtures import build_fixture_data, make_fixture_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = dict(source_vocab_size=30, target_vocab_size=20, input_size=16, hidden_size=24,
             num_layers=2, max_decoding_steps=10)
# The scripted generator needs the program vocabulary (16) within D and H.
OVERRIDES = ["PROGRAM_GENERATOR.INPUT_SIZE", 16, "PROGRAM_GENERATOR.HIDDEN_SIZE", 16]
PROGRAM = ["count", "same_size", "filter_color[red]", "scene"]


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda t: t.detach().numpy().copy() if isinstance(t, torch.Tensor) else np.array(t), tree)


def _paths(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [pair for k, v in items for pair in _paths(v, f"{prefix}/{k}")]


def _assert_trees_equal(got, want):
    got, want = dict(_paths(got)), dict(_paths(want))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert torch.equal(got[key].cpu(), value), key


@pytest.mark.parametrize("beam_size", [1, 4])
def test_beam_search_matches_jax(beam_size):
    jspec, spec = jseq2seq.Seq2SeqSpec(**SIZES), seq2seq.Seq2SeqSpec(**SIZES)
    jparams = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(3), jspec)
    params = interop.program_generator_from_jax(_to_numpy(jparams))
    rs = np.random.RandomState(0)
    source = rs.randint(4, SIZES["source_vocab_size"], (12, 9))
    source *= np.arange(9)[None, :] < rs.randint(1, 10, (12, 1))
    source[0] = rs.randint(4, SIZES["source_vocab_size"], 9)  # full length
    source[1] = 0                                             # all padding
    want = jseq2seq.beam_search_forward(jparams, jspec, jnp.asarray(source, jnp.int32), beam_size)
    got = seq2seq.beam_search_forward(params, spec, torch.from_numpy(source), beam_size)
    assert got["beam_predictions"].shape == (12, beam_size, SIZES["max_decoding_steps"])
    np.testing.assert_array_equal(got["beam_predictions"].numpy(),
                                  np.asarray(want["beam_predictions"]))
    np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
    np.testing.assert_allclose(got["beam_scores"].numpy(), np.asarray(want["beam_scores"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=1e-5, rtol=0)
    scores = got["beam_scores"].numpy()
    assert np.isfinite(scores).all() and (np.diff(scores, axis=1) <= 0).all()
    if beam_size == 1:
        greedy = seq2seq.seq2seq_forward(params, spec, torch.from_numpy(source), seq2seq.GREEDY)
        assert torch.equal(got["predictions"], greedy["predictions"])


def _scripted(params, spec, vocab, program):
    r"""JAX-layout generator params whose decoder emits ``program`` and then
    @end@ whatever the question (the input and output gates held open, the
    forget gate shut, the projection mapping the previous token to the next;
    ``chip_smoke.scripted_generator``)."""
    H, D, V = spec.hidden_size, spec.input_size, spec.target_vocab_size
    tokens = ([spec.start_index] + [vocab.get_token_index(t, "programs") for t in program]
              + [spec.end_index])
    w_ih = np.zeros((4 * H, H + D), np.float32)
    w_ih[2 * H + np.arange(V), H + np.arange(V)] = 3.0
    bias = np.zeros(4 * H, np.float32)
    bias[:H], bias[H:2 * H], bias[3 * H:] = 20.0, -20.0, 20.0
    proj = np.zeros((V, H), np.float32)
    for prev, nxt in zip(tokens, tokens[1:] + [spec.end_index]):
        proj[nxt, prev] = 30.0
    return dict(_to_numpy(params), target_embedding=np.eye(V, D, dtype=np.float32),
                decoder_cell={"w_ih": w_ih, "w_hh": np.zeros((4 * H, H), np.float32),
                              "b_ih": bias, "b_hh": np.zeros(4 * H, np.float32)},
                output_projection={"w": proj, "b": np.zeros(V, np.float32)})


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    r"""Fixture data; one joint checkpoint in the JAX package's format, the
    port's and the reference's, from the same scripted generator."""
    root = str(tmp_path_factory.mktemp("serving_port"))
    build_fixture_data(root)
    jax_config = make_fixture_config(root, "joint_training", OVERRIDES)
    config_path = os.path.join(root, "joint_training.yml")
    jax_config.dump(config_path)
    jvocab = JVocabulary.from_files(jax_config.DATA.VOCABULARY)
    pg_spec = jprogram_generator.make_spec(jvocab, jax_config)
    qr_spec = jquestion_reconstructor.make_spec(jvocab, jax_config)
    nmn_spec = jnmn.make_spec(jvocab, jax_config)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    pg = _scripted(jprogram_generator.init_params(keys[0], pg_spec), pg_spec, jvocab, PROGRAM)
    qr = _to_numpy(jquestion_reconstructor.init_params(keys[1], qr_spec))
    nmn_params = _to_numpy(jnmn.init_nmn_params(keys[2], nmn_spec))
    paths = {fmt: os.path.join(root, f"joint_{fmt}.{suffix}")
             for fmt, suffix in (("jax", "ckpt"), ("port", "ckpt"), ("reference", "pth"))}
    jax_save_objects(paths["jax"], {"program_generator": pg, "question_reconstructor": qr,
                                    "nmn": nmn_params}, 9)
    port_nmn_spec = nmn.make_spec(Vocabulary.from_files(jax_config.DATA.VOCABULARY),
                                  Config(config_path))
    save_objects(paths["port"], {
        "program_generator": interop.program_generator_from_jax(pg),
        "question_reconstructor": interop.question_reconstructor_from_jax(qr),
        "nmn": interop.nmn_from_jax(nmn_params, port_nmn_spec)}, 9)
    # The reference's keys; its generator carries the scripted decoder.
    reference_pg = ref_checkpoints.make_seq2seq_state(
        pg_spec.source_vocab_size, pg_spec.target_vocab_size, pg_spec.input_size,
        pg_spec.hidden_size, pg_spec.num_layers, 1)
    for key, value in (("_target_embedder.weight", pg["target_embedding"]),
                       ("_decoder_cell.weight_ih", pg["decoder_cell"]["w_ih"]),
                       ("_decoder_cell.weight_hh", pg["decoder_cell"]["w_hh"]),
                       ("_decoder_cell.bias_ih", pg["decoder_cell"]["b_ih"]),
                       ("_decoder_cell.bias_hh", pg["decoder_cell"]["b_hh"]),
                       ("_output_projection_layer.weight", pg["output_projection"]["w"]),
                       ("_output_projection_layer.bias", pg["output_projection"]["b"])):
        reference_pg[key] = torch.from_numpy(value)
    ref_checkpoints.save_reference_pth(paths["reference"], {
        "program_generator": reference_pg,
        "nmn": ref_checkpoints.make_nmn_state(jvocab, nmn_spec, 2)})
    return dict(root=root, jax_config=jax_config, config_path=config_path, paths=paths,
                pg=pg, nmn=nmn_params, jvocab=jvocab, pg_spec=pg_spec, nmn_spec=nmn_spec)


@pytest.mark.parametrize("fmt", ["jax", "port", "reference"])
def test_from_checkpoint_matches_jax(served, fmt):
    config = Config(served["config_path"])
    engine = InferenceEngine.from_checkpoint(config, served["paths"][fmt], decoding="greedy",
                                             device="cpu")
    assert engine.compute_dtype == torch.float32
    jax_path = served["paths"]["reference" if fmt == "reference" else "jax"]
    jax_engine = JaxInferenceEngine.from_checkpoint(served["jax_config"], jax_path,
                                                    decoding="greedy")
    if fmt == "reference":
        ported = jax_torch_interop.load_reference_checkpoint(
            jax_path, {"program_generator": served["pg_spec"], "nmn": served["nmn_spec"]},
            served["jvocab"])
        pg, nmn_params = _to_numpy(ported["program_generator"]), _to_numpy(ported["nmn"])
    else:
        pg, nmn_params = served["pg"], served["nmn"]
    _assert_trees_equal(engine._replicas[0].pg_params, interop.program_generator_from_jax(pg))

    dataset = JointTrainingDataset(config.DATA.TEST_TOKENS, config.DATA.TEST_FEATURES)
    batch = dataset.get_batch(np.arange(len(dataset)))
    got = engine.predict(batch["question"], batch["image"])
    want = jax_engine.predict(batch["question"], batch["image"])
    assert len(got) == len(dataset) == 16
    assert got == want
    assert "@@UNKNOWN@@" not in got
    # The NMN the engine runs holds the file's weights: the same answers as an
    # engine over the params in memory.
    memory = InferenceEngine(engine.vocabulary, engine._pg_spec, engine._nmn_spec,
                             interop.program_generator_from_jax(pg),
                             interop.nmn_from_jax(nmn_params, engine._nmn_spec),
                             batch_size=config.OPTIM.BATCH_SIZE, decoding="greedy",
                             device="cpu")
    assert memory.predict(batch["question"], batch["image"]) == got


def test_inference_cli_matches_the_jax_cli(served, tmp_path):
    jax_ckpt = str(tmp_path / "jax_cli.ckpt")
    port_ckpt = str(tmp_path / "port_cli.ckpt")
    for path in (jax_ckpt, port_ckpt):
        shutil.copy(served["paths"]["jax"], path)
    common = ["--config-yml", served["config_path"], "--config-override", "OPTIM.BATCH_SIZE", "6",
              "--decoding-strategy", "greedy"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "inference.py"), *common,
         "--checkpoint-path", jax_ckpt],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    output = inference.main(inference.parser.parse_args(
        [*common, "--checkpoint-path", port_ckpt, "--device", "cpu"]))
    assert output == str(tmp_path / "port_cli_predictions.json")
    with open(output) as f:
        got = json.load(f)
    with open(str(tmp_path / "jax_cli_predictions.json")) as f:
        want = json.load(f)
    assert got == want
    assert sorted(p["question_index"] for p in got) == list(range(16))
    # The JAX CLI's flags, once refused: --gpu-ids ignored, --cpu-workers
    # accepted, one device; and two, each batch of 6 split over two shards
    # with the JAX CLI's answers.
    for cards in ("1", "2"):
        os.remove(output)
        assert inference.main(inference.parser.parse_args(
            [*common, "--checkpoint-path", port_ckpt, "--device", "cpu", "--gpu-ids", "0",
             "--cpu-workers", "2", "--num-devices", cards])) == output
        with open(output) as f:
            assert json.load(f) == want
