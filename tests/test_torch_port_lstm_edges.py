"""The plain versions that the card holds the LSTM layer sweeps against, at
the edge shapes the sweeps' launch plans must handle, against the JAX
package's, in float32 on the CPU.

On the card, K3f and K3b's replay and K4f's encoder run each layer's
recurrence as one cluster-resident launch (``csrc/lstm_sweep.cuh``), and
``tests/test_torch_port_cuda.py`` holds them to ``lm_loss_plain`` /
``lm_grads_plain`` and ``tf_loss_plain`` / ``tf_grads_plain``. Here those
plain versions meet JAX ``fused_lm_loss`` and ``fused_tf_loss`` run in
interpret mode (as tests/test_seq2seq_train_pallas.py runs them) at the
shapes where a sweep's plan is thinnest: one row, a source of one step
(@end@ after one token or none), rows padded to nothing, and hidden sizes
that are not a multiple of 32 (a cluster's last CTA then holds padding
units). Losses within 1e-5 and every gradient leaf, under a random positive
per-example cotangent, within 5e-6: the tolerances of
tests/test_torch_port_question_coding.py. JAX's fused kernels tie the input
size to the hidden size, so these specs do too."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.models import program_prior as jprior
from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu.ops.pallas.seq2seq_train import fused_lm_loss as jax_fused_lm_loss
from probnmn_tpu.ops.pallas.seq2seq_train import fused_tf_loss as jax_fused_tf_loss
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.models import program_prior, seq2seq
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    lm_grads_plain,
    lm_loss_plain,
    tf_grads_plain,
    tf_loss_plain,
)

LOSS_ATOL = 1e-5
GRAD_ATOL = 5e-6


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def _assert_trees_close(got, want, atol):
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=f"mismatch at {jax.tree_util.keystr(path)}")


def _tokens(rs, batch, length, vocab, pad_rows=0):
    r"""Right-padded rows (each with at least one token), a full-length first
    row, and the last ``pad_rows`` rows padded to nothing."""
    tok = rs.randint(4, vocab, (batch, length))
    tok *= np.arange(length)[None, :] < rs.randint(1, length + 1, (batch, 1))
    tok[0] = rs.randint(4, vocab, (length,))
    if pad_rows:
        tok[batch - pad_rows:] = 0
    return tok.astype(np.int32)


# (hidden = input size, layers, batch, token length, rows padded to nothing)
LM_CASES = {
    "one_row": (12, 2, 1, 7, 0),
    "one_token_and_empty_programs": (20, 2, 8, 1, 4),
    "every_row_empty": (12, 1, 4, 5, 4),
    "hidden_not_a_multiple_of_32": (40, 2, 6, 9, 1),
}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_plain_versions_match_jax_at_sweep_edges(case):
    hidden, layers, batch, length, pad_rows = LM_CASES[case]
    sizes = dict(vocab_size=30, input_size=hidden, hidden_size=hidden, num_layers=layers)
    jspec, spec = jprior.ProgramPriorSpec(**sizes), program_prior.ProgramPriorSpec(**sizes)
    jp = jprior.init_program_prior_params(jax.random.PRNGKey(len(case)), jspec)
    tp = interop.program_prior_from_jax(_to_numpy(jp))
    rs = np.random.RandomState(len(case))
    tok = _tokens(rs, batch, length, 30, pad_rows)
    w = rs.rand(batch).astype(np.float32) + 0.5

    want = np.asarray(jax_fused_lm_loss(jp, jspec, jnp.asarray(tok), jnp.float32, 4, True))
    got = lm_loss_plain(tp, spec, torch.from_numpy(tok).long()).numpy()
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    assert np.isfinite(got).all() and (got > 0).all()  # an empty program still predicts @end@

    jgrad = jax.grad(lambda p: (jnp.asarray(w) * jax_fused_lm_loss(
        p, jspec, jnp.asarray(tok), jnp.float32, 4, True)).sum())(jp)
    plain = lm_grads_plain(tp, spec, torch.from_numpy(tok).long(), torch.from_numpy(w))
    _assert_trees_close(_to_numpy(plain), jgrad, GRAD_ATOL)


# (hidden = input size, batch, source length, target length, rows padded to nothing)
TF_CASES = {
    "one_row": (12, 1, 7, 5, 0),
    "one_step_source": (20, 6, 1, 6, 2),
    "rows_padded_to_nothing": (12, 5, 6, 5, 3),
    "hidden_not_a_multiple_of_32": (40, 6, 8, 6, 1),
}


@pytest.mark.parametrize("reinforce_norm", [False, True], ids=["ce", "reinforce"])
@pytest.mark.parametrize("case", list(TF_CASES))
def test_tf_plain_versions_match_jax_at_sweep_edges(case, reinforce_norm):
    hidden, batch, ls, lt, pad_rows = TF_CASES[case]
    sizes = dict(source_vocab_size=30, target_vocab_size=20, input_size=hidden,
                 hidden_size=hidden, num_layers=2, max_decoding_steps=lt)
    jspec, spec = jseq2seq.Seq2SeqSpec(**sizes), seq2seq.Seq2SeqSpec(**sizes)
    jp = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(len(case) + 1), jspec)
    tp = interop.program_generator_from_jax(_to_numpy(jp))
    rs = np.random.RandomState(len(case) + 1)
    src = _tokens(rs, batch, ls, 30)
    tgt = _tokens(rs, batch, lt, 20)
    if reinforce_norm:  # a trimmed z: @end@ after the last token where it fits
        lens = (tgt != 0).sum(1)
        for b in np.flatnonzero(lens < lt):
            tgt[b, lens[b]] = spec.end_index
    if pad_rows:
        src[batch - pad_rows:] = 0
        tgt[batch - pad_rows:] = 0
    w = rs.rand(batch).astype(np.float32) + 0.5
    jsrc, jtgt = jnp.asarray(src), jnp.asarray(tgt)
    tsrc, ttgt = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()

    want = np.asarray(jax_fused_tf_loss(jp, jspec, jsrc, jtgt, reinforce_norm, jnp.float32, 4,
                                        True))
    got = tf_loss_plain(tp, spec, tsrc, ttgt, reinforce_norm).numpy()
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    assert np.isfinite(got).all()
    if reinforce_norm and pad_rows:
        assert (got[batch - pad_rows:] == 0.0).all()  # an empty z has no logprob to normalize

    jgrad = jax.grad(lambda p: (jnp.asarray(w) * jax_fused_tf_loss(
        p, jspec, jsrc, jtgt, reinforce_norm, jnp.float32, 4, True)).sum())(jp)
    plain = tf_grads_plain(tp, spec, tsrc, ttgt, torch.from_numpy(w), reinforce_norm)
    _assert_trees_close(_to_numpy(plain), jgrad, GRAD_ATOL)
