"""The port's InferenceEngine on the CPU against the JAX package's engine and
pipeline, on the same params (carried across by interop) and inputs:
greedy answers identical to the JAX engine's, the sampling pipeline identical
to the JAX composition sampling_forward_with_noise_xla -> nmn_forward when
both get the engine's Philox noise, and padding of a short batch."""
import dataclasses

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
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models import nmn, program_generator
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import philox_gumbel
from probnmn_tpu_torch.serving import InferenceEngine

from tests.clevr_fixtures import ANSWERS, PROGRAM_TOKENS, QUESTION_WORDS

TOKENS = {"questions": QUESTION_WORDS, "programs": PROGRAM_TOKENS, "answers": ANSWERS}
PG_SIZES = dict(input_size=16, hidden_size=16)
NMN_SIZES = dict(feature_channels=12, height=6, width=6, module_channels=8,
                 class_projection_channels=16, classifier_linear_size=10)
BATCH = 8


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
    jpg_params = jpg.init_params(k1, jpg_spec)
    jnmn_params = jnmn.init_nmn_params(k2, jnmn_spec)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    pg_params = interop.program_generator_from_jax(to_np(jpg_params))
    nmn_params = interop.nmn_from_jax(to_np(jnmn_params), nmn_spec)
    rs = np.random.RandomState(0)
    questions = rs.randint(4, len(QUESTION_WORDS), (BATCH, 12)).astype(np.int64)
    questions[1, 5:] = 0  # a padded question
    images = rs.randn(BATCH, 12, 6, 6).astype(np.float32)  # NCHW like the H5 layout
    return dict(jvocab=jvocab, vocab=vocab, jpg_spec=jpg_spec, pg_spec=pg_spec,
                jnmn_spec=jnmn_spec, nmn_spec=nmn_spec, jpg_params=jpg_params,
                jnmn_params=jnmn_params, pg_params=pg_params, nmn_params=nmn_params,
                questions=questions, images=images)


def _engine(s, decoding):
    return InferenceEngine(s["vocab"], s["pg_spec"], s["nmn_spec"], s["pg_params"],
                           s["nmn_params"], batch_size=BATCH, decoding=decoding,
                           device="cpu")


def test_greedy_engine_matches_jax_engine(setup):
    s = setup
    jax_engine = JaxInferenceEngine(
        s["jvocab"], s["jpg_spec"], s["jnmn_spec"], s["jpg_params"], s["jnmn_params"],
        batch_size=BATCH, num_devices=1, decoding="greedy",
    )
    engine = _engine(s, "greedy")
    assert engine.compute_dtype == torch.float32
    want = jax_engine.predict(s["questions"], s["images"])
    assert engine.predict(s["questions"], s["images"]) == want
    assert engine.predict(s["questions"][:3], s["images"][:3]) == want[:3]


def _jax_sampling_answers(s, seed, n):
    noise = philox_gumbel(seed, s["pg_spec"].max_decoding_steps, n,
                          s["pg_spec"].target_vocab_size)
    z = sampling_forward_with_noise_xla(
        s["jpg_params"], s["jpg_spec"], jnp.asarray(s["questions"][:n]), jnp.asarray(noise)
    )["predictions"]
    out = jnmn.nmn_forward(s["jnmn_params"], s["jnmn_spec"],
                           jax_image_to_nhwc(jnp.asarray(s["images"][:n])), z)
    return [s["jvocab"].get_token_from_index(int(a), "answers")
            for a in np.asarray(out["predictions"])]


def test_sampling_pipeline_matches_jax_composition(setup):
    s = setup
    engine = _engine(s, "sampling")
    got = engine.predict(s["questions"], s["images"], seed=31)
    assert got == _jax_sampling_answers(s, 31, BATCH)


def test_short_batch_is_padded_and_unpadded(setup):
    s = setup
    engine = _engine(s, "sampling")
    few = engine.predict(s["questions"][:3], s["images"][:3], seed=5)
    assert len(few) == 3
    assert few == _jax_sampling_answers(s, 5, 3)
    full = engine.predict(s["questions"], s["images"], seed=5)
    assert few == full[:3]  # pad rows do not perturb the first n answers


def test_predict_rejects_malformed_requests(setup):
    s = setup
    engine = _engine(s, "greedy")
    q, im = s["questions"], s["images"]
    bad_token = q.copy()
    bad_token[0, 0] = s["pg_spec"].source_vocab_size
    for questions, images in (
        (bad_token, im),                     # a token past the embedding table
        (q.astype(np.float32), im),          # tokens that are not integers
        (q, im[:, :, :4]),                   # a feature map of the wrong size
        (q[:4], im),                         # fewer questions than images
    ):
        with pytest.raises(ValueError):
            engine.predict(questions, images)


def test_chunks_buckets_and_engine_seed_stream(setup):
    s = setup
    engine = _engine(s, "sampling")
    assert engine.bucket_for(1) == 2 and engine.bucket_for(3) == 8
    many_q = np.concatenate([s["questions"]] * 2 + [s["questions"][:2]])
    many_i = np.concatenate([s["images"]] * 2 + [s["images"][:2]])
    answers = engine.predict(many_q, many_i, seed=3)
    assert len(answers) == 18
    assert set(answers) <= set(ANSWERS)
    assert answers == engine.predict(many_q, many_i, seed=3)  # a seed fixes the draw
    # Two engines with one rng_seed draw the same per-batch seeds.
    other = _engine(s, "sampling")
    assert engine.predict(s["questions"], s["images"]) == other.predict(
        s["questions"], s["images"])
    engine.warmup(question_length=12)
