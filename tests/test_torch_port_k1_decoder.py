"""K1's decoder on the CPU. On the card the decoder is one cluster launch
whose plan (``decoder_plan``), shared-memory layout and gate arithmetic are
fixed here without the card: the plan's Python twin at H = 128 / 256 / 512
in both dtypes; the order in which a CTA keeps its gate columns, through
which its products read W; the bf16 gates as the kernel splits them (a token
table of bias + embedding products, plus the context and h products).
And the plain decoder, which the card holds the kernel to, against the JAX
package's ``sampling_forward_with_noise_xla`` within 1e-5 in float32 at the
decoder's edge shapes: one row, an all-pad row, a first token forced to
@end@ by the noise, one-token sources, odd vocabulary and input sizes."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu.ops.pallas.seq2seq_decode import sampling_forward_with_noise_xla
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.models import seq2seq
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
    DECODER_MAX_ROWS, MAX_SMEM, decoder_columns, decoder_plan_twin, decoder_row_cap,
    decoder_smem, decoder_units, pack_weights, sampling_forward_with_noise,
)

TOL = 1e-5

# The H100's clusters at once, one CTA an SM (more than half its shared
# memory), by cluster size (cudaOccupancyMaxActiveClusters on the card).
H100_FIT = {8: 15, 16: 7}

# What the plan keeps in shared memory at B = 256, 45 source tokens, D = H,
# V = 44 (the shipped vocabulary): (W_hh, W_ih, encoder outputs,
# projection), rows a cluster and clusters.
RESIDENT = {
    (128, torch.bfloat16): ((1, 1, 1, 1), 18, 15),
    (256, torch.bfloat16): ((1, 1, 1, 1), 37, 7),
    (512, torch.bfloat16): ((0, 0, 0, 1), 37, 7),
    (128, torch.float32): ((1, 1, 1, 1), 18, 15),
    (256, torch.float32): ((1, 0, 0, 0), 37, 7),
    (512, torch.float32): ((0, 0, 0, 0), 24, 11),
}


def _twin(batch, hidden, dtype, raw_len=45, input_size=None, vocab=44):
    n = hidden // decoder_units(hidden)
    return decoder_plan_twin(batch, raw_len, input_size or hidden, hidden, vocab, dtype,
                             H100_FIT[n], H100_FIT[n])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hidden", [128, 256, 512])
def test_decoder_plan_twin(hidden, dtype):
    want_flags, want_rows, want_clusters = RESIDENT[hidden, dtype]
    plan = _twin(256, hidden, dtype)
    assert plan["cluster"] * plan["units"] == hidden and plan["cluster"] <= 16
    assert plan["units"] % 16 == 0
    flags = (plan["w_hh_resident"], plan["w_ih_resident"], plan["encoder_resident"],
             plan["projection_resident"])
    assert flags == want_flags, plan
    assert (plan["rows"], plan["clusters"]) == (want_rows, want_clusters), plan
    assert plan["smem"] <= MAX_SMEM and plan["rows"] <= plan["r_max"] <= DECODER_MAX_ROWS
    assert decoder_row_cap(hidden, dtype) <= 4 * plan["cluster"]
    assert plan["rows_per_cta"] <= 4
    for batch in (1, 37, 128, 255, 400, 2000):
        p = _twin(batch, hidden, dtype)
        assert p["smem"] <= MAX_SMEM
        assert p["rows"] * p["clusters"] >= batch > p["rows"] * (p["clusters"] - 1)
        assert p["rows"] <= p["r_max"] and p["rows_per_cta"] * p["cluster"] >= p["rows"]
        # the rows fit every cluster at once while shared memory allows it
        assert p["clusters"] <= p["fit"] or p["rows"] == p["r_max"]
        one_more = decoder_smem(dtype, p["r_max"] + 1, 45, hidden, hidden, 44,
                                *(bool(p[k]) for k in ("w_hh_resident", "w_ih_resident",
                                                       "encoder_resident", "projection_resident")))
        assert p["r_max"] == decoder_row_cap(hidden, dtype) or one_more["total"] > MAX_SMEM


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decoder_smem_parts_are_aligned_and_disjoint(dtype):
    flags = RESIDENT[256, dtype][0]
    lay = decoder_smem(dtype, 37, 45, 256, 256, 44, *map(bool, flags))
    offsets = [v for k, v in lay.items() if k != "total"]
    assert offsets == sorted(offsets) and all(o % 16 == 0 for o in offsets)
    assert lay["total"] == _twin(256, 256, dtype)["smem"]
    if dtype == torch.bfloat16:
        # Rows of the cell inputs and of h: 8 elements longer than H, 16-byte
        # aligned, 4 banks apart, so the eight rows an ldmatrix reads fall on
        # distinct banks; the resident W's [k][4U + 8] rows likewise.
        assert lay["hb"] - lay["xb"] == 2 * 37 * (256 + 8)
        for pitch in (256 + 8, 4 * 16 + 8, 4 * 32 + 8):
            assert (2 * pitch) % 16 == 0 and (2 * pitch // 4) % 32 == 4
        assert lay["w_ih"] - lay["w_hh"] == 2 * 256 * (4 * 16 + 8)
        assert lay["xb"] - lay["table"] == 4 * 44 * 4 * 16


@pytest.mark.parametrize("hidden", [128, 256, 512])
def test_decoder_columns_round_trip_and_read_w(hidden):
    r"""A CTA's gate columns (unit pair p, gate q, unit 2 p + e as column
    8 p + 2 q + e): over the cluster every column of W once, and x . W read
    through them, put back in place, is x @ W (float32 operands, float64
    sums, so that the order of the sums cannot show)."""
    U = decoder_units(hidden)
    n = hidden // U
    cols = np.concatenate([decoder_columns(hidden, rank) for rank in range(n)])
    assert sorted(cols.tolist()) == list(range(4 * hidden))
    rank = n - 1
    mine = decoder_columns(hidden, rank)
    for c, col in enumerate(mine):  # an 8-column n-tile is one unit pair's four gates
        p, q, e = c // 8, c // 2 % 4, c % 2
        assert col == q * hidden + rank * U + 2 * p + e
    rs = np.random.RandomState(hidden)
    x = torch.from_numpy(rs.randn(5, 2 * hidden).astype(np.float32)).double()
    w = torch.from_numpy(rs.randn(2 * hidden, 4 * hidden).astype(np.float32)).double()
    got = torch.empty(5, 4 * hidden, dtype=torch.float64)
    for r in range(n):
        index = torch.from_numpy(decoder_columns(hidden, r))
        got[:, index] = x @ w[:, index]
    torch.testing.assert_close(got, x @ w, rtol=0, atol=1e-9)


def test_bf16_gates_split_as_the_kernel_splits_them():
    r"""The kernel's bf16 gates: a (V, 4H) table bias + tgt_emb[v] . W_ih's
    embedding rows, looked up by the previous token, plus the context's and
    h's products. In float32 on operands rounded to bf16 that equals the cell
    input [context, embedding] . W_ih + h . W_hh + bias, up to the order of
    float32 sums."""
    spec = seq2seq.Seq2SeqSpec(source_vocab_size=30, target_vocab_size=45, input_size=37,
                               hidden_size=128, max_decoding_steps=4)
    params = seq2seq.init_seq2seq_params(torch.Generator().manual_seed(0), spec)
    packed = pack_weights(params, spec, torch.bfloat16, torch.device("cpu"))
    H, D = spec.hidden_size, spec.input_size
    w_ih, w_hh = packed["dec_wih"].float(), packed["dec_whh"].float()
    emb = packed["tgt_emb"].float()
    table = packed["dec_bias"] + emb @ w_ih[H:]
    rs = np.random.RandomState(1)
    tok = torch.from_numpy(rs.randint(0, spec.target_vocab_size, 6))
    ctx = torch.from_numpy(rs.randn(6, H).astype(np.float32)).bfloat16().float()
    h = torch.from_numpy(rs.randn(6, H).astype(np.float32)).bfloat16().float()
    got = table[tok] + ctx @ w_ih[:H] + h @ w_hh
    want = torch.cat([ctx, emb[tok]], 1) @ w_ih + h @ w_hh + packed["dec_bias"]
    assert D == w_ih.shape[0] - H
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


# name: (batch, raw length, input size, hidden, target vocabulary, rows)
CASES = {
    "one_row": (1, 9, 16, 32, 20, "mixed"),
    "one_all_pad_row": (1, 9, 16, 32, 20, "all_pad"),
    "one_token_sources": (4, 7, 16, 32, 20, "one_token"),
    "first_token_end": (5, 8, 16, 32, 20, "end_first"),
    "odd_vocab_and_input": (6, 10, 13, 32, 23, "mixed"),
    "hidden_128": (3, 6, 24, 128, 20, "mixed"),
}


def _case(name, seed):
    batch, length, input_size, hidden, vocab, rows = CASES[name]
    sizes = dict(source_vocab_size=30, target_vocab_size=vocab, input_size=input_size,
                 hidden_size=hidden, num_layers=2, max_decoding_steps=7)
    jspec, spec = jseq2seq.Seq2SeqSpec(**sizes), seq2seq.Seq2SeqSpec(**sizes)
    jp = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(seed), jspec)
    tp = interop.program_generator_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    rs = np.random.RandomState(seed)
    src = rs.randint(4, 30, (batch, length))
    if rows == "all_pad":
        src[:] = 0
    elif rows == "one_token":
        src[:, 1:] = 0
    else:
        src = src * (np.arange(length)[None, :] < rs.randint(1, length + 1, (batch, 1)))
    noise = rs.gumbel(size=(7, batch, vocab + 3)).astype(np.float32)
    if rows == "end_first":
        noise[0, 1] = -1e9
        noise[0, 1, spec.end_index] = 1e9  # row 1 samples @end@ first: zeroed
    return jp, tp, jspec, spec, src.astype(np.int32), noise


@pytest.mark.parametrize("name", list(CASES))
def test_plain_decoder_matches_jax(name):
    jp, tp, jspec, spec, src, noise = _case(name, seed=len(name))
    want = sampling_forward_with_noise_xla(jp, jspec, jnp.asarray(src), jnp.asarray(noise))
    got = sampling_forward_with_noise(tp, spec, torch.from_numpy(src).long(),
                                      torch.from_numpy(noise))
    np.testing.assert_array_equal(got["predictions"].numpy(), np.asarray(want["predictions"]))
    np.testing.assert_allclose(got["logprobs"].numpy(), np.asarray(want["logprobs"]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=0, atol=TOL)
    if name == "first_token_end":
        assert (got["predictions"][1] == 0).all() and float(got["loss"][1]) == 0.0
    # pad, unk and start are never drawn; a row ends at its first @end@
    preds = got["predictions"].numpy()
    assert not np.isin(preds, [spec.unk_index, spec.start_index]).any()
    for row in preds:
        if (row == 0).any():
            assert (row[np.argmax(row == 0):] == 0).all()
