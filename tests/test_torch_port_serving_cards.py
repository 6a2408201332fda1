"""The port's InferenceEngine over several cards (``num_devices``: one replica
a card, each padded batch split into equal contiguous shards), on the CPU,
where the shards run one after another, against the JAX engine's data mesh
(conftest gives JAX 8 CPU devices) and against the port on one card:

- the bucket ladder equals the JAX engine's for each (batch, count);
- greedy answers at 2 cards equal the JAX engine's at ``num_devices=2`` and
  the port's at 1; beam answers equal the port's at 1;
- sampling answers at 2 and 4 cards equal the port's at 1 for the same seed
  and the JAX composition sampling_forward_with_noise_xla -> nmn_forward fed
  the Philox noise of the whole padded batch: shard k draws rows
  ``[k B / n, (k + 1) B / n)`` of the batch's stream (K1's ``row_base``);
- ``philox_gumbel`` and K1's plain version with a row base give the matching
  rows of the full batch's;
- the dispatcher at 2 cards answers as one card's ``predict``, a shard that fails fails
  its batch's futures, and ``--num-devices 2`` runs through the inference
  CLI and the serve CLI's ``ServingContext`` on ``--device cpu``.

The generator's decoder is scripted toward one valid program with a margin
that the question (through the encoder's final state) and the Gumbel noise
can overturn, so that every shard holds valid and invalid programs; rows 3,
7, 11 and 15 are all padding, one in each shard at 4 cards. The NMN's
classifier is rescaled so that its answers follow the image."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.data.pipeline import image_to_nhwc as jax_image_to_nhwc
from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.models import program_generator as jpg
from probnmn_tpu.ops.pallas.seq2seq_decode import sampling_forward_with_noise_xla
from probnmn_tpu.serving import InferenceEngine as JaxInferenceEngine
from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
from probnmn_tpu_torch import inference, interop, serve
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models import nmn, program_generator
from probnmn_tpu_torch.models.seq2seq import GREEDY, seq2seq_forward
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward, philox_gumbel
from probnmn_tpu_torch.serving import InferenceEngine

from chip_smoke import image_sensitive_classifier
from tests.clevr_fixtures import (ANSWERS, PROGRAM_TOKENS, QUESTION_WORDS, build_fixture_data,
                                  make_fixture_config)
from tests.test_torch_port_inference import OVERRIDES

TOKENS = {"questions": QUESTION_WORDS, "programs": PROGRAM_TOKENS, "answers": ANSWERS}
PG_SIZES = dict(input_size=16, hidden_size=16)
NMN_SIZES = dict(feature_channels=12, height=6, width=6, module_channels=8,
                 class_projection_channels=16, classifier_linear_size=10)
BATCH = 16
PROGRAM = ["count", "filter_color[red]", "scene"]
UNKNOWN = "@@UNKNOWN@@"
TIMEOUT = 60


def _scripted(params, spec, vocab, margin=6.0, question_weight=5.5):
    r"""Port-layout generator params whose decoder leans toward
    :data:`PROGRAM` then @end@ (``chip_smoke.scripted_generator`` with a
    logit margin of ~0.76 ``margin`` instead of ~23), with the random
    recurrent weights scaled by ``question_weight`` so that the encoder's
    final state, the question's, can turn the first steps aside."""
    H, D, V = spec.hidden_size, spec.input_size, spec.target_vocab_size
    tokens = ([spec.start_index] + [vocab.get_token_index(t, "programs") for t in PROGRAM]
              + [spec.end_index])
    w_ih = torch.zeros(4 * H, H + D)
    w_ih[2 * H + torch.arange(V), H + torch.arange(V)] = 3.0
    bias = torch.zeros(4 * H)
    bias[:H], bias[H:2 * H], bias[3 * H:] = 20.0, -20.0, 20.0
    proj = torch.zeros(V, H)
    for prev, nxt in zip(tokens, tokens[1:] + [spec.end_index]):
        proj[nxt, prev] = margin
    return dict(params, target_embedding=torch.eye(V, D),
                decoder_cell={"w_ih": w_ih,
                              "w_hh": question_weight * params["decoder_cell"]["w_hh"],
                              "b_ih": bias, "b_hh": torch.zeros(4 * H)},
                output_projection={"w": proj, "b": torch.zeros(V)})


@pytest.fixture(scope="module")
def setup():
    jvocab = JVocabulary(TOKENS, non_padded_namespaces=["answers"])
    vocab = Vocabulary(TOKENS, non_padded_namespaces=["answers"])
    jpg_spec = dataclasses.replace(jpg.make_spec(jvocab), **PG_SIZES)
    pg_spec = dataclasses.replace(program_generator.make_spec(vocab), **PG_SIZES)
    jnmn_spec, nmn_spec = jnmn.make_spec(jvocab), nmn.make_spec(vocab)
    for k, v in NMN_SIZES.items():
        setattr(jnmn_spec, k, v)
        setattr(nmn_spec, k, v)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    pg_params = _scripted(interop.program_generator_from_jax(to_np(jpg.init_params(k1, jpg_spec))),
                          pg_spec, vocab)
    jpg_params = jax.tree_util.tree_map(jnp.asarray, interop.program_generator_to_jax(pg_params))
    rs = np.random.RandomState(0)
    questions = rs.randint(4, len(QUESTION_WORDS), (BATCH, 12)).astype(np.int64)
    questions[3::4] = 0  # all padding, one row in each shard at 4 cards
    images = rs.randn(BATCH, 12, 6, 6).astype(np.float32)
    # A classifier whose answers follow the image, so that a shard given
    # another shard's rows answers otherwise.
    programs = seq2seq_forward(pg_params, pg_spec, torch.from_numpy(questions),
                               GREEDY)["predictions"]
    nmn_params = image_sensitive_classifier(
        torch, interop.nmn_from_jax(to_np(jnmn.init_nmn_params(k2, jnmn_spec)), nmn_spec),
        nmn_spec, programs, images, "cpu")
    jnmn_params = jax.tree_util.tree_map(jnp.asarray, interop.nmn_to_jax(nmn_params))
    return dict(jvocab=jvocab, vocab=vocab, jpg_spec=jpg_spec, pg_spec=pg_spec,
                jnmn_spec=jnmn_spec, nmn_spec=nmn_spec, jpg_params=jpg_params,
                jnmn_params=jnmn_params, pg_params=pg_params, nmn_params=nmn_params,
                questions=questions, images=images)


def _engine(s, num_devices=None, decoding="sampling", batch_size=BATCH, **kwargs):
    return InferenceEngine(s["vocab"], s["pg_spec"], s["nmn_spec"], s["pg_params"],
                           s["nmn_params"], batch_size=batch_size, decoding=decoding,
                           device="cpu", num_devices=num_devices, **kwargs)


def _jax_engine(s, num_devices, batch_size=BATCH, decoding="greedy"):
    return JaxInferenceEngine(s["jvocab"], s["jpg_spec"], s["jnmn_spec"], s["jpg_params"],
                              s["jnmn_params"], batch_size=batch_size, num_devices=num_devices,
                              decoding=decoding)


def _every_shard_mixed(answers, shards):
    r"""Each shard's rows hold a valid program's answer and an invalid one's."""
    rows = len(answers) // shards
    for k in range(shards):
        part = answers[k * rows:(k + 1) * rows]
        assert UNKNOWN in part and any(a != UNKNOWN for a in part), (k, part)


@pytest.mark.parametrize("batch_size, cards", [(8, 8), (16, 2), (256, 2), (256, 4), (12, 3)])
def test_bucket_ladder_matches_the_jax_mesh(setup, batch_size, cards):
    s = setup
    jax_engine = _jax_engine(s, cards, batch_size)
    engine = _engine(s, cards, "greedy", batch_size)
    assert engine.num_devices == jax_engine._mesh.shape["data"] == cards
    assert engine._buckets == jax_engine._buckets
    assert all(b % cards == 0 for b in engine._buckets) and engine._buckets[-1] == batch_size
    for n in range(1, batch_size + 1):
        assert engine.bucket_for(n) == jax_engine.bucket_for(n), n


def test_card_count_follows_the_jax_policy(setup):
    s = setup
    assert _engine(s).num_devices == 1
    assert _engine(s, 1).num_devices == 1
    assert _engine(s, 3).num_devices == 2      # the largest count <= 3 that divides 16
    assert _engine(s, 8, batch_size=12).num_devices == 6
    assert _engine(s, 2, share_card=True).num_devices == 2
    with pytest.raises(ValueError, match="every card"):
        _engine(s, 0)                          # on the CPU, 0 has no meaning


def test_shards_over_cards_must_start_at_card_0(setup, monkeypatch):
    r"""Shard k lives on ``cuda:k``: an engine over two cards asked for on
    ``cuda:1`` raises instead of using cards 0 and 1 (checked before any
    replica is made, so on the CPU with the card count patched)."""
    from probnmn_tpu_torch import serving

    s = setup
    monkeypatch.setattr(serving, "resolve_device", torch.device)
    monkeypatch.setattr(serving, "available_devices", lambda device_type, n: 2)
    with pytest.raises(ValueError, match="start at cuda:0"):
        InferenceEngine(s["vocab"], s["pg_spec"], s["nmn_spec"], s["pg_params"],
                        s["nmn_params"], batch_size=BATCH, device="cuda:1", num_devices=2)


def test_greedy_over_two_cards_matches_jax_mesh_and_one_card(setup):
    s = setup
    q, im = s["questions"], s["images"]
    want = _jax_engine(s, 2).predict(q, im)
    _every_shard_mixed(want, 2)
    assert sum(a != b for a, b in zip(want[:BATCH // 2], want[BATCH // 2:])) >= BATCH // 4
    one, two = _engine(s, 1, "greedy"), _engine(s, 2, "greedy")
    assert two.num_devices == 2
    assert one.predict(q, im) == want
    assert two.predict(q, im) == want
    # A short batch (the second shard all padding) and a chunked one.
    assert two.predict(q[:5], im[:5]) == want[:5]
    many_q, many_im = np.concatenate([q, q[:6]]), np.concatenate([im, im[:6]])
    assert two.predict(many_q, many_im) == want + want[:6]


def test_beam_over_two_cards_matches_one_card(setup):
    s = setup
    q, im = s["questions"], s["images"]
    want = _engine(s, 1, "beam", beam_size=3).predict(q, im)
    assert _engine(s, 2, "beam", beam_size=3).predict(q, im) == want


def _jax_sampling_answers(s, seed):
    r"""The JAX composition over the whole batch on the batch's Philox
    noise: what each shard's rows must give (computed once a seed)."""
    key = ("jax_sampling", seed)
    if key not in s:
        noise = philox_gumbel(seed, s["pg_spec"].max_decoding_steps, BATCH,
                              s["pg_spec"].target_vocab_size)
        z = sampling_forward_with_noise_xla(s["jpg_params"], s["jpg_spec"],
                                            jnp.asarray(s["questions"]),
                                            jnp.asarray(noise))["predictions"]
        out = jnmn.nmn_forward(s["jnmn_params"], s["jnmn_spec"],
                               jax_image_to_nhwc(jnp.asarray(s["images"])), z)
        s[key] = [s["jvocab"].get_token_from_index(int(a), "answers")
                  for a in np.asarray(out["predictions"])]
    return s[key]


@pytest.mark.parametrize("cards", [2, 4])
def test_sampling_answers_do_not_depend_on_the_card_count(setup, cards):
    s = setup
    q, im = s["questions"], s["images"]
    want = _jax_sampling_answers(s, 31)
    _every_shard_mixed(want, cards)
    engine, one = _engine(s, cards), _engine(s, 1)
    assert engine.num_devices == cards
    assert engine.predict(q, im, seed=31) == want
    assert one.predict(q, im, seed=31) == want
    # A short batch: the later shards all padding.
    assert engine.predict(q[:7], im[:7], seed=31) == one.predict(q[:7], im[:7], seed=31)
    # The engine's own seed stream: the same per-batch seeds at any count.
    assert engine.predict(q, im) == one.predict(q, im)


@pytest.mark.parametrize("row_base, rows", [(0, 16), (4, 4), (8, 8), (12, 4)])
def test_row_base_draws_the_rows_of_the_full_stream(setup, row_base, rows):
    s = setup
    spec = s["pg_spec"]
    T, V = spec.max_decoding_steps, spec.target_vocab_size
    full = philox_gumbel(2 ** 40 + 3, T, BATCH, V)
    part = philox_gumbel(2 ** 40 + 3, T, rows, V, row_base)
    np.testing.assert_array_equal(part, full[:, row_base:row_base + rows])
    q = torch.from_numpy(s["questions"])
    whole = fused_sampling_forward(s["pg_params"], spec, q, seed=2 ** 40 + 3,
                                   compute_dtype=torch.float32)
    shard = fused_sampling_forward(s["pg_params"], spec, q[row_base:row_base + rows],
                                   seed=2 ** 40 + 3, row_base=row_base,
                                   compute_dtype=torch.float32)
    for key in ("predictions", "logprobs"):
        assert torch.equal(shard[key], whole[key][row_base:row_base + rows]), key


@pytest.mark.parametrize("depth", [1, 2])
def test_dispatcher_over_two_cards_matches_predict(setup, depth):
    s = setup
    q, im = s["questions"], s["images"]
    engine = _engine(s, 2, "greedy")
    assert engine._buckets == [4, 16]
    want = _engine(s, 1, "greedy").predict(q, im)
    assert engine.predict(q, im) == want
    engine.start(max_batch_delay=0.05, pipeline_depth=depth)
    try:
        futures = [engine.submit(q[i], im[i]) for i in range(3)]
        futures += engine.submit_many(q[3:10], im[3:10])
        futures += engine.submit_many(q[10:], im[10:])
        got = [f.result(timeout=TIMEOUT) for f in futures]
    finally:
        engine.stop()
    assert got == want
    stats = engine.stats()
    assert stats["requests"] == 2 * BATCH and stats["queue_depth"] == 0
    assert 1 <= stats["max_in_flight"] <= depth


def test_a_failing_shard_fails_its_batch(setup, monkeypatch):
    s = setup
    q, im = s["questions"], s["images"]
    engine = _engine(s, 2, "greedy")
    pipeline = engine._pipeline
    shards = []

    def second_shard_fails(questions, images, seed, shard=0, row_base=0):
        shards.append((shard, row_base, len(questions)))
        if shard == 1:
            raise RuntimeError("shard 1 failed")
        return pipeline(questions, images, seed, shard, row_base)

    monkeypatch.setattr(engine, "_pipeline", second_shard_fails)
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        engine.predict(q, im)
    assert shards == [(0, 0, 8), (1, 8, 8)]
    engine.start(max_batch_delay=0.05)
    try:
        for fut in engine.submit_many(q[:3], im[:3]):
            with pytest.raises(RuntimeError, match="shard 1 failed"):
                fut.result(timeout=TIMEOUT)
    finally:
        engine.stop()
    assert engine.stats()["requests"] == 0 and engine.stats()["queue_depth"] == 0


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    r"""Fixture data, its config (batch 8) and a JAX-format joint checkpoint
    whose generator is scripted as :func:`setup`'s, its recurrent weights
    scaled by 2 (valid and invalid programs on these questions)."""
    root = str(tmp_path_factory.mktemp("serving_cards"))
    build_fixture_data(root)
    config = make_fixture_config(root, "joint_training", OVERRIDES)
    config_path = os.path.join(root, "joint_training.yml")
    config.dump(config_path)
    jvocab = JVocabulary.from_files(config.DATA.VOCABULARY)
    pg_spec = jpg.make_spec(jvocab, config)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    pg = _scripted(interop.program_generator_from_jax(to_np(jpg.init_params(k1, pg_spec))),
                   pg_spec, jvocab, question_weight=2.0)
    ckpt = os.path.join(root, "joint.ckpt")
    jax_save_objects(ckpt, {"program_generator": interop.program_generator_to_jax(pg),
                            "nmn": to_np(jnmn.init_nmn_params(k2, jnmn.make_spec(jvocab, config)))})
    return dict(root=root, config_path=config_path, ckpt=ckpt)


@pytest.mark.parametrize("decoding", ["sampling", "greedy"])
def test_inference_cli_over_two_cards(cli, decoding):
    argv = ["--config-yml", cli["config_path"], "--checkpoint-path", cli["ckpt"],
            "--device", "cpu", "--decoding-strategy", decoding]
    predictions = {}
    for cards in ("1", "2"):
        output = inference.main(inference.parser.parse_args(argv + ["--num-devices", cards]))
        with open(output) as f:
            predictions[cards] = json.load(f)
        os.remove(output)
    assert predictions["2"] == predictions["1"]
    assert sorted(p["question_index"] for p in predictions["2"]) == list(range(16))
    answers = [p["answer"] for p in predictions["2"]]
    assert UNKNOWN in answers and any(a != UNKNOWN for a in answers)


def test_serve_context_over_two_cards(cli):
    argv = ["--config-yml", cli["config_path"], "--checkpoint", cli["ckpt"], "--batch-size", "8",
            "--decoding", "greedy", "--max-question-length", "12", "--device", "cpu",
            "--features-h5", os.path.join(cli["root"], "missing.h5")]
    ctx = serve.ServingContext(serve.parser.parse_args(argv + ["--num-devices", "2"]))
    try:
        assert ctx.engine.num_devices == 2 and ctx.engine._buckets == [2, 8]
        rs = np.random.RandomState(5)
        tokens = rs.randint(4, ctx.engine.vocabulary.get_vocab_size("questions"), (5, 12))
        feats = rs.randn(5, 12, 6, 6).astype(np.float32)
        questions, images = ctx.parse({"question_tokens": tokens.tolist(),
                                       "features": feats.tolist()})
        got = ctx.answer(questions, images)["answers"]
    finally:
        ctx.engine.stop()
    one = serve.ServingContext(serve.parser.parse_args(argv))
    try:
        assert one.engine.num_devices == 1
        assert got == one.answer(questions, images)["answers"]
    finally:
        one.engine.stop()
