"""K1's encoder on the CPU. The card holds its encoder sweep to the port's
plain encoder (``models/seq2seq.py::_encode``, which ``sampling_encode`` runs
on a CPU tensor); here that plain encoder is held, in float32, to the JAX
package's ``models/seq2seq.py::_encode`` within 1e-5, at the sweep's edge
shapes: one row, an all-pad row, a one-token source (@end@ at t = 1), rows
of full length, H = 128 and 512, one and three layers, an odd input size.
In bfloat16 its outputs are bfloat16 values and its final hidden state, the
decoder's initial state, is float32 and not rounded."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.models import seq2seq
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import sampling_encode

TOL = 1e-5
VOCAB = 30

# name: (batch, raw length, input size, hidden size, layers, rows)
# rows: "mixed" (random lengths, row 0 full, row 1 all padding, row 2 one
# token), "full" (every row full length), "one_token", "all_pad".
CASES = {
    "one_row": (1, 9, 16, 32, 2, "full"),
    "one_all_pad_row": (1, 9, 16, 32, 2, "all_pad"),
    "one_token_rows": (3, 7, 16, 32, 2, "one_token"),
    "full_length_rows": (4, 11, 16, 32, 2, "full"),
    "mixed_rows": (6, 12, 16, 32, 2, "mixed"),
    "hidden_128": (5, 10, 24, 128, 2, "mixed"),
    "hidden_512": (3, 6, 32, 512, 2, "mixed"),
    "one_layer": (5, 8, 16, 32, 1, "mixed"),
    "three_layers": (5, 8, 16, 32, 3, "mixed"),
    "odd_input_size": (5, 8, 13, 32, 2, "mixed"),
}


def _specs(input_size, hidden, layers):
    sizes = dict(source_vocab_size=VOCAB, target_vocab_size=20, input_size=input_size,
                 hidden_size=hidden, num_layers=layers, max_decoding_steps=4)
    return jseq2seq.Seq2SeqSpec(**sizes), seq2seq.Seq2SeqSpec(**sizes)


def _params(jspec, seed):
    jp = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(seed), jspec)
    return jp, interop.program_generator_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _source(batch, length, rows, seed):
    rs = np.random.RandomState(seed)
    src = rs.randint(4, VOCAB, (batch, length))
    if rows == "full":
        return src.astype(np.int32)
    if rows == "all_pad":
        return np.zeros_like(src, dtype=np.int32)
    if rows == "one_token":
        src[:, 1:] = 0
        return src.astype(np.int32)
    lens = rs.randint(1, length, (batch,))
    src = src * (np.arange(length)[None, :] < lens[:, None])
    src[0] = rs.randint(4, VOCAB, (length,))  # full length
    src[1] = 0                                # all padding
    src[2, 1:] = 0                            # one token
    return src.astype(np.int32)


def _case(name, seed):
    batch, length, input_size, hidden, layers, rows = CASES[name]
    jspec, spec = _specs(input_size, hidden, layers)
    jp, tp = _params(jspec, seed)
    return jp, tp, jspec, spec, _source(batch, length, rows, seed)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_encoder_matches_jax(name):
    jp, tp, jspec, spec, src = _case(name, seed=len(name))
    want_out, want_mask, want_h, _ = jseq2seq._encode(jp, jspec, jnp.asarray(src))
    got_out, got_mask, got_h, got_c = seq2seq._encode(tp, spec, torch.from_numpy(src).long())
    assert tuple(got_out.shape) == (src.shape[0], src.shape[1] + 1, spec.hidden_size)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=TOL)
    assert not got_c.any()
    # Pad steps give zero outputs; every row has a valid @end@ step.
    assert not got_out[~got_mask].any()
    assert bool(got_mask.any(dim=1).all())


@pytest.mark.parametrize("name", ["mixed_rows", "one_token_rows", "hidden_128", "odd_input_size"])
def test_bfloat16_outputs_are_rounded_and_the_final_state_is_not(name):
    _, tp, _, spec, src = _case(name, seed=3)
    out, mask, h, _ = seq2seq._encode(tp, spec, torch.from_numpy(src).long(), torch.bfloat16)
    assert out.dtype == torch.float32 and h.dtype == torch.float32
    assert torch.equal(out, out.to(torch.bfloat16).float())
    assert not torch.equal(h, h.to(torch.bfloat16).float())
    # The output at each row's last valid step (its @end@) is the final
    # state rounded to bfloat16.
    last = mask.sum(dim=1) - 1
    at_end = out[torch.arange(out.shape[0]), last]
    assert torch.equal(at_end, h.to(torch.bfloat16).float())
    # Within bfloat16 operand rounding of the float32 encoder.
    out32, _, h32, _ = seq2seq._encode(tp, spec, torch.from_numpy(src).long())
    assert float((h - h32).abs().max()) <= 2e-2
    assert float((out - out32).abs().max()) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampling_encode_on_the_cpu_is_the_plain_encoder(dtype):
    _, tp, _, spec, src = _case("mixed_rows", seed=5)
    tokens = torch.from_numpy(src).long()
    outputs, final = sampling_encode(tp, spec, tokens, compute_dtype=dtype)
    want_out, _, want_h, _ = seq2seq._encode(tp, spec, tokens, dtype)
    assert outputs.dtype == dtype and final.dtype == torch.float32
    assert torch.equal(outputs.float(), want_out)
    assert torch.equal(final, want_h)
    sampling_encode.launches = 0
    sampling_encode(tp, spec, tokens, compute_dtype=dtype)
    assert sampling_encode.launches == 0  # the plain version launches nothing
