"""The port's ops (probnmn_tpu_torch.ops) against the JAX package's, on the
same numpy inputs, in float32 on the CPU (atol 1e-5)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.ops import common as jcommon
from probnmn_tpu.ops import gconv as jgconv
from probnmn_tpu.ops import rnn as jrnn
from probnmn_tpu_torch.ops import common, gconv, rnn

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def test_add_boundary_matches_jax():
    rs = np.random.RandomState(0)
    tokens = rs.randint(4, 20, (6, 9))
    lens = np.array([0, 1, 4, 9, 3, 8])
    tokens = tokens * (np.arange(9)[None, :] < lens[:, None])
    want = np.asarray(jcommon.add_boundary(jnp.asarray(tokens), 0, 2, 3))
    got = common.add_boundary(_t(tokens), 0, 2, 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_trim_at_end_matches_jax_including_step0_end_row():
    rs = np.random.RandomState(1)
    preds = rs.randint(4, 12, (6, 10))
    preds[0, 0] = 3           # @end@ first: the whole row becomes zeros
    preds[1, 4] = 3           # kept through the first @end@
    preds[2, [2, 6]] = 3      # only the first @end@ counts
    preds[3, 9] = 3           # @end@ last
    want = np.asarray(jcommon.trim_at_end(jnp.asarray(preds), 3))
    got = common.trim_at_end(_t(preds), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all()
    np.testing.assert_array_equal(got[4], preds[4])  # no @end@: kept whole


def test_linear_and_padded_embed_match_jax():
    rs = np.random.RandomState(6)
    params = {"w": rs.randn(5, 4).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    x = rs.randn(3, 4).astype(np.float32)
    want = np.asarray(jcommon.linear({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    got = common.linear({k: _t(v) for k, v in params.items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    table = rs.randn(6, 3).astype(np.float32)
    tokens = np.array([[0, 2, 5], [1, 0, 0]])
    want = np.asarray(jcommon.embed(jnp.asarray(table), jnp.asarray(tokens), pad_index=0))
    got = common.embed(_t(table), _t(tokens), pad_index=0).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[1, 1:] == 0).all()


def test_masked_softmax_matches_jax():
    rs = np.random.RandomState(2)
    scores = rs.randn(5, 7).astype(np.float32)
    mask = rs.rand(5, 7) > 0.4
    mask[:, 0] = True
    want = np.asarray(jcommon.masked_softmax(jnp.asarray(scores), jnp.asarray(mask)))
    got = common.masked_softmax(_t(scores), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_length_normalized_logprob_loss_matches_jax():
    rs = np.random.RandomState(3)
    logprobs = -rs.rand(6, 8).astype(np.float32)
    preds = rs.randint(0, 5, (6, 8))
    preds[0] = 0  # all pad: loss 0 through the 1e-12 epsilon
    want = np.asarray(jcommon.length_normalized_logprob_loss(
        jnp.asarray(logprobs), jnp.asarray(preds), 0))
    got = common.length_normalized_logprob_loss(_t(logprobs), _t(preds), 0).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[0] == 0.0


def test_lstm_encode_matches_jax_with_all_pad_and_full_rows():
    rs = np.random.RandomState(4)
    batch, length, dim, hidden = 5, 7, 6, 8
    params = jrnn.init_lstm_params(jax.random.PRNGKey(0), dim, hidden, 2)
    x = rs.randn(batch, length, dim).astype(np.float32)
    lens = np.array([0, length, 3, 1, 5])  # an all-pad row and a full row
    mask = np.arange(length)[None, :] < lens[:, None]
    j_out, j_finals = jrnn.lstm_encode(params, jnp.asarray(x), jnp.asarray(mask))
    t_params = [{k: _t(v) for k, v in layer.items()} for layer in params]
    t_out, t_finals = rnn.lstm_encode(t_params, _t(x), _t(mask))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
    for (th, tc), (jh, jc) in zip(t_finals, j_finals):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    assert (t_out[0] == 0).all()  # all-pad row: zero outputs
    assert (t_finals[0][0][0] == 0).all()  # and a state that never moved


def test_lstm_cell_matches_jax():
    rs = np.random.RandomState(5)
    params = jrnn.init_lstm_cell_params(jax.random.PRNGKey(1), 6, 8)
    x, h, c = (rs.randn(4, n).astype(np.float32) for n in (6, 8, 8))
    jh, jc = jrnn.lstm_cell(params, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    th, tc = rnn.lstm_cell({k: _t(v) for k, v in params.items()}, _t(x), (_t(h), _t(c)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_conv3x3_matches_jax(dilation):
    rs = np.random.RandomState(10 + dilation)
    x = rs.randn(2, 14, 14, 5).astype(np.float32)
    w = (rs.randn(3, 3, 5, 6) * 0.2).astype(np.float32)  # HWIO, as the JAX package keeps it
    b = rs.randn(6).astype(np.float32)
    want = np.asarray(jgconv.conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation))
    got = gconv.conv3x3(_t(x), _t(w.transpose(3, 2, 0, 1).copy()), _t(b), dilation).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_gathered_conv3x3_matches_jax(dilation):
    rs = np.random.RandomState(20 + dilation)
    x = rs.randn(3, 14, 14, 4).astype(np.float32)
    bank = {"w": (rs.randn(5, 3, 3, 4, 4) * 0.2).astype(np.float32),
            "b": rs.randn(5, 4).astype(np.float32)}
    idx = np.array([4, 0, 2])
    want = np.asarray(jgconv.gathered_conv3x3(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in bank.items()}, jnp.asarray(idx), dilation))
    got = gconv.gathered_conv3x3(
        _t(x), {k: _t(v) for k, v in bank.items()}, _t(idx), dilation).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv1x1_and_max_pool_match_jax():
    rs = np.random.RandomState(30)
    x = rs.randn(2, 7, 7, 5).astype(np.float32)
    w = rs.randn(5, 3).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    want = np.asarray(jgconv.max_pool_2x2(jgconv.conv1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))))
    got = gconv.max_pool_2x2(gconv.conv1x1(_t(x), _t(w), _t(b))).numpy()
    assert got.shape == (2, 3, 3, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_as_operand_rounds_to_bfloat16_and_keeps_float32():
    x = torch.tensor([1.0 + 2 ** -10, 3.0], dtype=torch.float32)
    assert common.as_operand(x, torch.float32) is x
    np.testing.assert_array_equal(common.as_operand(x, torch.bfloat16).numpy(), [1.0, 3.0])
