"""K4f hands K4b its residuals: the kernel route of ``fused_tf_loss``
(``fused_tf_kernels``) on CPU tensors, with its two launchers swapped for
the plain versions, as in ``test_fused_tf_loss_function_keeps_the_leaf_order``.

- K4f is asked to keep its residuals exactly when grad is enabled and a
  leaf requires grad, and not under ``torch.no_grad()``;
- autograd hands every leaf its own gradient (equal to the plain
  version's, bit for bit);
- a second backward through one forward (``retain_graph=True``) raises, as
  does ``tf_backward_cuda`` on residuals already consumed."""
import numpy as np
import pytest
import torch

from probnmn_tpu_torch.models.seq2seq import Seq2SeqSpec, init_seq2seq_params
from probnmn_tpu_torch.ops.kernels import seq2seq_train
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    TFResiduals,
    fused_tf_kernels,
    pack_tf_weights,
    tf_backward_cuda,
    tf_grads_plain,
    tf_loss_plain,
    tf_param_leaves,
    tf_params_from_leaves,
)

SPEC = Seq2SeqSpec(source_vocab_size=20, target_vocab_size=15, input_size=16, hidden_size=12,
                   num_layers=2)
BATCH, LS, LT = 6, 7, 5


def _inputs(seed):
    rs = np.random.RandomState(seed)
    src = rs.randint(4, SPEC.source_vocab_size, (BATCH, LS)) * (
        np.arange(LS)[None, :] < rs.randint(1, LS + 1, (BATCH, 1)))
    tgt = rs.randint(4, SPEC.target_vocab_size, (BATCH, LT)) * (
        np.arange(LT)[None, :] < rs.randint(1, LT + 1, (BATCH, 1)))
    src[0] = 0
    dloss = torch.from_numpy(rs.rand(BATCH).astype(np.float32) + 0.5)
    params = init_seq2seq_params(torch.Generator().manual_seed(seed), SPEC)
    return params, torch.from_numpy(src), torch.from_numpy(tgt), dloss


@pytest.fixture
def launchers(monkeypatch):
    r"""Swap K4f and K4b for the plain versions; records each K4f call's
    ``keep`` and each K4b call."""
    calls = {"keep": [], "backward": 0}

    def forward(packed, spec, src, tgt, reinforce_norm, keep=False, dropout_masks=None):
        calls["keep"].append(keep)
        loss = tf_loss_plain(calls["params"], spec, src, tgt, reinforce_norm,
                             dropout_masks).detach()
        return (loss, (spec, src, tgt, reinforce_norm)) if keep else loss

    def backward(residuals, dloss):
        calls["backward"] += 1
        spec, src, tgt, reinforce_norm = residuals
        return tf_grads_plain(calls["params"], spec, src, tgt, dloss, reinforce_norm)

    monkeypatch.setattr(seq2seq_train, "tf_forward_cuda", forward)
    monkeypatch.setattr(seq2seq_train, "tf_backward_cuda", backward)
    return calls


def _leaves(params, requires_grad):
    return [p.detach().clone().requires_grad_(r) for p, r in zip(tf_param_leaves(params),
                                                                 requires_grad)]


@pytest.mark.parametrize("case,want_keep", [
    ("every_leaf", True), ("one_leaf", True), ("no_leaf", False), ("no_grad", False),
])
def test_kernels_keep_residuals_exactly_when_a_gradient_is_taken(launchers, case, want_keep):
    params, src, tgt, _ = _inputs(1)
    launchers["params"] = params
    n = len(tf_param_leaves(params))
    flags = {"every_leaf": [True] * n, "one_leaf": [False] * (n - 1) + [True],
             "no_leaf": [False] * n, "no_grad": [True] * n}[case]
    leaves = _leaves(params, flags)
    if case == "no_grad":
        with torch.no_grad():
            loss = fused_tf_kernels(tf_params_from_leaves(leaves), SPEC, src, tgt)
    else:
        loss = fused_tf_kernels(tf_params_from_leaves(leaves), SPEC, src, tgt)
    assert launchers["keep"] == [want_keep]
    assert loss.requires_grad == want_keep
    torch.testing.assert_close(loss, tf_loss_plain(params, SPEC, src, tgt), rtol=0, atol=0)


@pytest.mark.parametrize("reinforce_norm", [False, True])
def test_every_leaf_gets_its_own_gradient(launchers, reinforce_norm):
    params, src, tgt, dloss = _inputs(2)
    launchers["params"] = params
    leaves = _leaves(params, [True] * len(tf_param_leaves(params)))
    loss = fused_tf_kernels(tf_params_from_leaves(leaves), SPEC, src, tgt, reinforce_norm)
    (loss * dloss).sum().backward()
    want = tf_param_leaves(tf_grads_plain(params, SPEC, src, tgt, dloss, reinforce_norm))
    assert launchers["keep"] == [True] and launchers["backward"] == 1
    assert len(leaves) == len(want) == 2 + 4 * SPEC.num_layers + 4 + 2
    for leaf, w in zip(leaves, want):
        assert leaf.grad.shape == leaf.shape
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)


def test_second_backward_through_one_forward_raises(launchers):
    params, src, tgt, dloss = _inputs(3)
    launchers["params"] = params
    leaves = _leaves(params, [True] * len(tf_param_leaves(params)))
    total = (fused_tf_kernels(tf_params_from_leaves(leaves), SPEC, src, tgt) * dloss).sum()
    total.backward(retain_graph=True)
    first = [leaf.grad.clone() for leaf in leaves]
    with pytest.raises(RuntimeError, match="second time"):
        total.backward()
    assert launchers["backward"] == 1
    assert all(torch.equal(leaf.grad, g) for leaf, g in zip(leaves, first))


def test_backward_launcher_refuses_consumed_residuals():
    params, _, _, dloss = _inputs(4)
    residuals = TFResiduals(None, pack_tf_weights(params, SPEC), SPEC, (BATCH, LS, LT),
                            (16, 12, 2, 20, 15), False)
    assert residuals.nbytes == 0
    with pytest.raises(RuntimeError, match="already consumed"):
        tf_backward_cuda(residuals, dloss)
