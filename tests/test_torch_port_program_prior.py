"""The port's ProgramPrior LM against the JAX package's, in float32 on the CPU.

``fused_lm_loss`` (on CPU tensors: the plain versions of kernels K3f and K3b)
must give JAX ``program_prior_forward``'s loss and the loss of JAX
``fused_lm_loss`` run in interpret mode (as tests/test_seq2seq_train_pallas.py
runs it) within 1e-5, and every gradient leaf within 5e-6, that file's
``_grad_trees_match`` tolerance, under the plain mean and under a weighted
per-example cotangent. The free-running sampler keeps the reference's
log-softmax-over-the-projection quirk: fed the same Gumbel noise, its
logprobs match the JAX functions' on the tokens it drew."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.models import program_prior as jprior
from probnmn_tpu.ops import common as jcommon
from probnmn_tpu.ops import rnn as jrnn
from probnmn_tpu.ops.pallas.seq2seq_train import fused_lm_loss as jax_fused_lm_loss
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.models import program_prior
from probnmn_tpu_torch.ops import common, rnn
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    fused_lm_loss,
    lm_forward_cuda,
    lm_grads_plain,
    pack_lm_weights,
)

LOSS_ATOL = 1e-5
GRAD_ATOL = 5e-6
JSPEC = jprior.ProgramPriorSpec(vocab_size=50)
SPEC = program_prior.ProgramPriorSpec(vocab_size=50)


def _params(seed, jspec=JSPEC):
    jp = jprior.init_program_prior_params(jax.random.PRNGKey(seed), jspec)
    return jp, interop.program_prior_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _tokens(seed, batch=12, length=26, vocab=50):
    r"""The token maker of tests/test_seq2seq_train_pallas.py, plus an all-pad row."""
    rs = np.random.RandomState(seed)
    tok = rs.randint(4, vocab, (batch, length)).astype(np.int32)
    tok *= np.arange(length)[None, :] < rs.randint(2, length, (batch,))[:, None]
    tok[0] = rs.randint(4, vocab, (length,))  # full-length row
    tok[1] = 0                                # all padding: only the @end@ label
    return tok


def _port_grads(tp, spec, tok, weights=None):
    leaves = jax.tree_util.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = fused_lm_loss(tp, spec, torch.from_numpy(tok))
    (loss.mean() if weights is None else (torch.from_numpy(weights) * loss).sum()).backward()
    return jax.tree_util.tree_map(lambda t: t.grad.numpy(), tp)


def _assert_trees_close(got, want, atol):
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=f"gradient mismatch at {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_loss_and_grads_match_jax(seed):
    jp, tp = _params(seed)
    tok = _tokens(seed)
    want_kernel = np.asarray(jax_fused_lm_loss(jp, JSPEC, jnp.asarray(tok), jnp.float32, 4, True))
    want_xla = np.asarray(jprior.program_prior_forward(
        jp, JSPEC, jnp.asarray(tok), jax.random.PRNGKey(0))["loss"])
    got = fused_lm_loss(tp, SPEC, torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(got, want_xla, atol=LOSS_ATOL, rtol=0)
    assert np.isfinite(got[1]) and got[1] > 0  # the all-pad row still predicts @end@

    want = jax.grad(
        lambda p: jax_fused_lm_loss(p, JSPEC, jnp.asarray(tok), jnp.float32, 4, True).mean())(jp)
    _assert_trees_close(_port_grads(tp, SPEC, tok), want, GRAD_ATOL)


def test_lm_weighted_cotangent_matches_jax():
    jp, tp = _params(2)
    tok = _tokens(2)
    w = np.random.RandomState(9).rand(tok.shape[0]).astype(np.float32)
    want = jax.grad(lambda p: (jnp.asarray(w) * jax_fused_lm_loss(
        p, JSPEC, jnp.asarray(tok), jnp.float32, 4, True)).sum())(jp)
    plain = lm_grads_plain(tp, SPEC, torch.from_numpy(tok), torch.from_numpy(w))
    _assert_trees_close(jax.tree_util.tree_map(lambda t: t.numpy(), plain), want, GRAD_ATOL)
    _assert_trees_close(_port_grads(tp, SPEC, tok, weights=w), want, GRAD_ATOL)


def test_lm_unequal_widths_and_one_layer_match_jax():
    r"""The fixture config's shape: input 16 != hidden 12, one layer."""
    sizes = dict(vocab_size=16, input_size=16, hidden_size=12, num_layers=1)
    jspec, spec = jprior.ProgramPriorSpec(**sizes), program_prior.ProgramPriorSpec(**sizes)
    jp, tp = _params(3, jspec)
    tok = _tokens(3, batch=6, length=10, vocab=16)
    want = jprior.program_prior_forward(jp, jspec, jnp.asarray(tok), jax.random.PRNGKey(0))["loss"]
    np.testing.assert_allclose(fused_lm_loss(tp, spec, torch.from_numpy(tok)).numpy(),
                               np.asarray(want), atol=LOSS_ATOL, rtol=0)
    jgrad = jax.grad(lambda p: jprior.program_prior_forward(
        p, jspec, jnp.asarray(tok), jax.random.PRNGKey(0))["loss"].mean())(jp)
    _assert_trees_close(_port_grads(tp, spec, tok), jgrad, GRAD_ATOL)


def test_pack_lm_weights_layout():
    _, tp = _params(4)
    packed = pack_lm_weights(tp)
    H, D, L = SPEC.hidden_size, SPEC.input_size, SPEC.num_layers
    assert packed["w_ih"].shape == (4 * H * (D + (L - 1) * H),)
    assert torch.equal(packed["w_ih"][: 4 * H * D].view(4 * H, D), tp["encoder"][0]["w_ih"])
    assert torch.equal(packed["w_hh"][1], tp["encoder"][1]["w_hh"])
    assert torch.equal(packed["bias"][0], tp["encoder"][0]["b_ih"] + tp["encoder"][0]["b_hh"])


def test_cuda_wrapper_refuses_cpu_tensors_and_dropout():
    r"""The CUDA wrapper refuses CPU tensors. Dropout, once refused, now
    trains: with masks ``fused_lm_loss`` is JAX's ``train=True`` loss under
    the masks its key draws; without them (evaluation) it is the plain
    loss, whatever the spec's rate."""
    jp, tp = _params(5)
    tok = torch.from_numpy(_tokens(5))
    with pytest.raises(ValueError, match="CUDA"):
        lm_forward_cuda(pack_lm_weights(tp), SPEC, tok)
    jspec = jprior.ProgramPriorSpec(vocab_size=50, dropout=0.1)
    dropout_spec = program_prior.ProgramPriorSpec(vocab_size=50, dropout=0.1)
    rng = jax.random.PRNGKey(5)
    drop_rng = jax.random.fold_in(rng, 991)
    masks = torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(drop_rng, layer), 0.9, (tok.shape[0], tok.shape[1] + 2, 256)))
        for layer in range(dropout_spec.num_layers - 1)]))
    want = jprior.program_prior_forward(jp, jspec, jnp.asarray(tok.numpy()), rng, train=True)
    np.testing.assert_allclose(fused_lm_loss(tp, dropout_spec, tok, masks).numpy(),
                               np.asarray(want["loss"]), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(fused_lm_loss(tp, dropout_spec, tok).numpy(),
                               fused_lm_loss(tp, SPEC, tok).numpy(), atol=0, rtol=0)


def test_sequence_cross_entropy_and_blocked_sampling_match_jax():
    rs = np.random.RandomState(6)
    logits = rs.randn(4, 7, 11).astype(np.float32)
    targets = rs.randint(0, 11, (4, 7))
    weights = (rs.rand(4, 7) > 0.3).astype(np.float32)
    weights[2] = 0.0  # a row with no weight: 0 / 1e-13
    want = jcommon.sequence_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                          jnp.asarray(weights))
    got = common.sequence_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                        torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)

    noise = rs.gumbel(size=logits.shape).astype(np.float32)
    blocked = (2, 0, 1)
    drawn = common.sample_with_blocked_tokens(torch.from_numpy(logits), blocked,
                                              noise=torch.from_numpy(noise)).numpy()
    masked = logits.copy()
    masked[..., list(blocked)] = -np.inf
    np.testing.assert_array_equal(drawn, np.argmax(masked + noise, axis=-1))
    free = common.sample_with_blocked_tokens(torch.from_numpy(logits), blocked,
                                             gen=torch.Generator().manual_seed(0)).numpy()
    assert not np.isin(free, blocked).any()


def test_lstm_step_stacked_matches_jax():
    jp, tp = _params(7)
    rs = np.random.RandomState(7)
    x = rs.randn(5, SPEC.input_size).astype(np.float32)
    hs = rs.randn(SPEC.num_layers, 5, SPEC.hidden_size).astype(np.float32)
    cs = rs.randn(SPEC.num_layers, 5, SPEC.hidden_size).astype(np.float32)
    want = jrnn.lstm_step_stacked(jp["encoder"], jnp.asarray(x), jnp.asarray(hs), jnp.asarray(cs))
    got = rnn.lstm_step_stacked(tp["encoder"], torch.from_numpy(x), torch.from_numpy(hs),
                                torch.from_numpy(cs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def _jax_quirk_loss(jp, jspec, predictions):
    r"""The JAX functions' length-normalized quirk loss of given (trimmed)
    sample rows: the same per-step arithmetic as JAX ``program_prior_sample``,
    teacher-forced on the port's tokens."""
    n, steps = predictions.shape
    hs = jnp.zeros((jspec.num_layers, n, jspec.hidden_size))
    cs = jnp.zeros_like(hs)
    last = jnp.full((n,), jspec.start_index, jnp.int32)
    logprobs = []
    for t in range(steps):
        embedded = jcommon.embed(jp["embedding"], last, pad_index=jspec.pad_index)
        out, hs, cs = jrnn.lstm_step_stacked(jp["encoder"], embedded, hs, cs)
        _, projected = jprior._lm_logits(jp, out)
        tok = jnp.asarray(predictions[:, t])
        quirk = jax.nn.log_softmax(projected, axis=-1)
        logprobs.append(jnp.take_along_axis(quirk, tok[:, None], axis=-1)[:, 0])
        last = tok
    return np.asarray(jcommon.length_normalized_logprob_loss(
        jnp.stack(logprobs, axis=1), jnp.asarray(predictions), jspec.pad_index))


def test_sample_keeps_the_quirk_and_blocks_special_tokens():
    jp, tp = _params(8)
    num, length = 16, 28
    rs = np.random.RandomState(8)
    noise = rs.gumbel(size=(length - 1, num, SPEC.vocab_size)).astype(np.float32)
    # Bias toward @end@ so that some rows end early and some at step 0.
    noise[:, :, SPEC.end_index] += rs.choice([0.0, 3.0, 30.0], size=(num,))[None, :]
    out = program_prior.program_prior_sample(tp, SPEC, num_samples=num, max_sequence_length=length,
                                             noise=torch.from_numpy(noise))
    preds, loss = out["predictions"].numpy(), out["loss"].numpy()
    assert preds.shape == (num, length - 1)
    assert not np.isin(preds, [SPEC.start_index, SPEC.unk_index]).any()
    for row in preds:  # pad only as a suffix (after @end@ or for an end-at-step-0 row)
        nz = np.flatnonzero(row == 0)
        assert nz.size == 0 or (row[nz[0]:] == 0).all()
    assert (preds == 0).all(axis=1).any() and (preds[:, 0] != 0).any()
    assert np.all(np.diff(loss) >= 0)
    np.testing.assert_allclose(loss, _jax_quirk_loss(jp, JSPEC, preds), atol=1e-5, rtol=0)


def test_forward_predictions_are_masked_samples():
    _, tp = _params(9)
    tok = _tokens(9)
    out = program_prior.program_prior_forward(tp, SPEC, torch.from_numpy(tok),
                                              gen=torch.Generator().manual_seed(0))
    preds = out["predictions"].numpy()
    mask = common.add_boundary(torch.from_numpy(tok), 0, 2, 3).numpy()[:, 1:] != 0
    assert preds.shape == (tok.shape[0], tok.shape[1] + 1)
    assert (preds[~mask] == 0).all()
    assert not np.isin(preds[mask], [SPEC.start_index, SPEC.pad_index, SPEC.unk_index]).any()
    np.testing.assert_allclose(out["loss"].numpy(),
                               fused_lm_loss(tp, SPEC, torch.from_numpy(tok)).numpy(), atol=0, rtol=0)
