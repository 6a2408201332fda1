"""The port's ProgramGenerator decode against the JAX package's, in float32 on
the CPU: sampling fed the same numpy Gumbel noise must pick the same tokens
as the JAX replica and as the Pallas sampling kernel in interpret mode
(logprobs and loss within 2e-4, the tolerance of test_seq2seq_pallas.py);
greedy must match the JAX scan path."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu.ops.pallas.seq2seq_decode import (
    _round_up,
    fused_sampling_forward as jax_fused_sampling_forward,
    sampling_forward_with_noise_xla,
)
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.models import seq2seq
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
    fused_sampling_forward,
    philox_gumbel,
    sampling_forward_with_noise,
)

ATOL = 2e-4
SIZES = dict(source_vocab_size=30, target_vocab_size=20, input_size=16, hidden_size=16,
             max_decoding_steps=26)
JSPEC = jseq2seq.Seq2SeqSpec(**SIZES)
SPEC = seq2seq.Seq2SeqSpec(**SIZES)


def _params(seed):
    jp = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(seed), JSPEC)
    return jp, interop.program_generator_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _source(batch=8, length=12, seed=0):
    rs = np.random.RandomState(seed)
    src = rs.randint(4, SIZES["source_vocab_size"], (batch, length))
    lens = rs.randint(1, length, (batch,))
    src = src * (np.arange(length)[None, :] < lens[:, None])
    src[0] = rs.randint(4, SIZES["source_vocab_size"], (length,))  # no padding at all
    src[1] = 0                                                    # all padding
    return src.astype(np.int32)


def _noise(batch, seed, width=None):
    rs = np.random.RandomState(seed)
    width = width or _round_up(SIZES["target_vocab_size"], 128)
    return rs.gumbel(size=(SIZES["max_decoding_steps"], batch, width)).astype(np.float32)


def _port_sample(tp, src, noise):
    return sampling_forward_with_noise(tp, SPEC, torch.from_numpy(src), torch.from_numpy(noise))


@pytest.mark.parametrize("seed", [0, 1])
def test_sampling_with_shared_noise_matches_jax_replica(seed):
    jp, tp = _params(seed)
    src = _source(seed=seed)
    noise = _noise(src.shape[0], 100 + seed)
    got = _port_sample(tp, src, noise)
    want = sampling_forward_with_noise_xla(jp, JSPEC, jnp.asarray(src), jnp.asarray(noise))
    np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
    np.testing.assert_allclose(got["logprobs"].numpy(), np.asarray(want["logprobs"]), atol=ATOL)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=ATOL)


def test_sampling_with_shared_noise_matches_pallas_kernel_interpret():
    jp, tp = _params(2)
    src = _source(seed=2)
    noise = _noise(src.shape[0], 7)
    want = jax_fused_sampling_forward(
        jp, JSPEC, jnp.asarray(src), jax.random.PRNGKey(0),
        compute_dtype=jnp.float32, batch_block=8, noise=jnp.asarray(noise), interpret=True,
    )
    got = _port_sample(tp, src, noise)
    np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
    np.testing.assert_allclose(got["logprobs"].numpy(), np.asarray(want["logprobs"]), atol=ATOL)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=ATOL)


def test_step0_end_row_is_zeroed_and_all_pad_row_decodes():
    jp, tp = _params(3)
    src = _source(seed=3)
    noise = _noise(src.shape[0], 9)
    noise[0, 2, :] = -1e9
    noise[0, 2, SPEC.end_index] = 1e9  # row 2 samples @end@ first
    got = _port_sample(tp, src, noise)
    want = sampling_forward_with_noise_xla(jp, JSPEC, jnp.asarray(src), jnp.asarray(noise))
    np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
    assert (got["predictions"][2] == 0).all()
    assert float(got["loss"][2]) == 0.0
    assert (got["predictions"][1] != 0).any()  # the all-pad question still decodes
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=ATOL)


def test_greedy_matches_jax_scan_path():
    jp, tp = _params(4)
    src = _source(seed=4)
    want = jseq2seq.seq2seq_forward(jp, JSPEC, jnp.asarray(src), None, jseq2seq.GREEDY)
    got = seq2seq.seq2seq_forward(tp, SPEC, torch.from_numpy(src).long(), seq2seq.GREEDY)
    np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=ATOL)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)


def test_philox_stream_serves_the_cpu_path_and_blocks_special_tokens():
    jp, tp = _params(5)
    src = _source(seed=5)
    out = fused_sampling_forward(tp, SPEC, torch.from_numpy(src), seed=1234,
                                 compute_dtype=torch.float32)
    again = fused_sampling_forward(tp, SPEC, torch.from_numpy(src), seed=1234,
                                   compute_dtype=torch.float32)
    np.testing.assert_array_equal(out["predictions"].numpy(), again["predictions"].numpy())
    noise = philox_gumbel(1234, SPEC.max_decoding_steps, src.shape[0], SPEC.target_vocab_size)
    want = sampling_forward_with_noise_xla(jp, JSPEC, jnp.asarray(src), jnp.asarray(noise))
    np.testing.assert_array_equal(out["predictions"].numpy(), np.asarray(want["predictions"]))
    preds = out["predictions"].numpy()
    assert not np.isin(preds, [SPEC.unk_index, SPEC.start_index]).any()
    other = fused_sampling_forward(tp, SPEC, torch.from_numpy(src), seed=1235,
                                   compute_dtype=torch.float32)
    assert (other["predictions"].numpy() != preds).any()


def test_philox_gumbel_is_row_stable_and_gumbel_distributed():
    big = philox_gumbel(99, 4, 64, 50)
    small = philox_gumbel(99, 4, 8, 50)
    np.testing.assert_array_equal(big[:, :8], small)  # draws do not depend on the batch
    assert big.dtype == np.float32 and np.isfinite(big).all()
    # Gumbel(0, 1): mean = Euler-Mascheroni 0.5772, variance = pi^2 / 6.
    assert abs(big.mean() - 0.5772) < 0.05
    assert abs(big.var() - np.pi ** 2 / 6) < 0.15


def test_bfloat16_operands_stay_close_to_float32():
    jp, tp = _params(6)
    src = _source(seed=6)
    noise = torch.from_numpy(_noise(src.shape[0], 11))
    f32 = sampling_forward_with_noise(tp, SPEC, torch.from_numpy(src), noise)
    bf16 = sampling_forward_with_noise(tp, SPEC, torch.from_numpy(src), noise,
                                       compute_dtype=torch.bfloat16)
    agree = float((f32["predictions"] == bf16["predictions"]).float().mean())
    assert agree > 0.95, agree
