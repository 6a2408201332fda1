"""K4's decoder sweeps on the CPU. On the card, K4f's decoder steps and
K4b's reverse decoder steps each run as one thread-block-cluster launch a
pass (``csrc/tf_decoder_sweep.cuh``); what can be fixed without the card is
fixed here:

- the Python twins of both sweeps' launch plans at H = 64, 128 and 256 and
  B = 1, 128, 256 and 300: the cluster size, the rows a cluster, shared
  memory within 227 KiB, and waves only above what the card runs at once;
- H = 264: no cluster holds the cell, so K4f takes its per-step route and
  K4b refuses, both decided from H before any launch;
- the twins carry the constants of the CUDA source;
- the plain by-step reference of the decoder's reverse step
  (``tf_decoder_reverse_plain``: dpre, dcat, ds, denc and the gradient
  reaching h_prev, written out as the JAX kernel's ``dec_bwd``), which the
  card check of the reverse sweep uses in float64, against autograd
  through the plain decoder in float64 and against interpret-mode JAX
  ``fused_tf_loss``'s VJP in float32, in both modes, at one row, an all-pad
  target row, one decoder step, one real source position and rows that end
  early."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu.ops.pallas.seq2seq_train import fused_tf_loss as jax_fused_tf_loss
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.models import seq2seq
from probnmn_tpu_torch.models.seq2seq import _decode_step, _encode
from probnmn_tpu_torch.ops.kernels import seq2seq_train
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    decoder_row_cap, decoder_sweep_holds, decoder_sweep_smem, tf_decoder_plan_twin,
    tf_decoder_reverse_plain, tf_grads_plain, tf_param_leaves, tf_params_from_leaves,
    _tf_head_loss, _tf_step_inputs,
)

CSRC = Path(seq2seq_train.__file__).resolve().parents[2] / "csrc"

# The H100's clusters at once with one CTA an SM (more than half its shared
# memory), by cluster size (cudaOccupancyMaxActiveClusters on the card).
H100_FIT = {4: 33, 8: 15, 16: 7}
SOURCE = 45  # question tokens: 46 source positions with @end@


@pytest.mark.parametrize("batch", [1, 128, 256, 300])
@pytest.mark.parametrize("forward", [True, False], ids=["forward", "reverse"])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_decoder_plan_twins(hidden, forward, batch):
    n = hidden // 16
    plan = tf_decoder_plan_twin(batch, SOURCE, hidden, forward, H100_FIT[n])
    assert (plan["cluster"], plan["units"], plan["threads"]) == (n, 16, 256)
    assert plan["smem_bytes"] <= 227 * 1024
    assert plan["rows"] * plan["clusters"] >= batch > plan["rows"] * (plan["clusters"] - 1)
    assert plan["rows"] <= plan["r_max"] <= decoder_row_cap(hidden, forward)
    assert -(-plan["rows"] // n) <= seq2seq_train.DEC_MAX_OWN
    # The rows run every cluster at once while shared memory allows it; a
    # batch above what fits runs in waves of the widest rows.
    assert plan["clusters"] <= plan["fit"] or plan["rows"] == plan["r_max"]
    one_more = decoder_sweep_smem(hidden, SOURCE, plan["r_max"] + 1, forward)
    assert plan["r_max"] == decoder_row_cap(hidden, forward) or one_more > 227 * 1024
    if hidden == 256:
        # 16 CTAs of 128 KiB of resident weights: 32 rows a cluster at most,
        # 7 clusters at once; a pass of 128 rows in one wave, 256 in two.
        assert plan["r_max"] == 32
        want = {1: (1, 1), 128: (19, 7), 256: (32, 8), 300: (32, 10)}[batch]
        assert (plan["rows"], plan["clusters"]) == want
        assert (plan["clusters"] > plan["fit"]) == (batch >= 256)


def test_above_a_cluster_the_forward_steps_and_the_reverse_refuses():
    r"""H = 264: no cluster holds the decoder cell. Both twins refuse; K4f
    takes its per-step route (tf_attend, lstm_fwd_step) and K4b refuses
    with cudaErrorInvalidValue before any launch, both from H alone."""
    assert decoder_sweep_holds(256) and not decoder_sweep_holds(264)
    for forward in (True, False):
        with pytest.raises(ValueError, match="no cluster holds"):
            tf_decoder_plan_twin(4, 6, 264, forward, 7)
    source = (CSRC / "tf_train.cu").read_text()
    forward_pass = source[source.index("cudaError_t forward_pass("):]
    route = forward_pass.index("if (dec_sweep_holds(d.H))")
    assert route < forward_pass.index("dec_sweep_launch(s, a, true)") < forward_pass.index(
        "decoder_steps(d, wt, ws, enc, s)")
    steps = source[source.index("cudaError_t decoder_steps("):source.index(
        "cudaError_t forward_pass(")]
    assert "tf_attend<<<" in steps and "lstm_fwd_step<<<" in steps
    backward = source[source.index("cudaError_t backward_pass("):]
    refusal = backward.index(
        "if (!dec_sweep_holds(d.H) || !sweep_holds(d.H)) return cudaErrorInvalidValue;")
    assert refusal < backward.index("<<<") and refusal < backward.index("dec_sweep_launch")
    # The per-step reverse is gone: its kernel and its loop.
    assert "tf_attend_bwd" not in source and "lstm_bwd_step" not in source


def test_the_twin_has_the_constants_of_the_cuda_source():
    source = (CSRC / "tf_decoder_sweep.cuh").read_text()

    def constant(name, text=source):
        return int(re.search(rf"\b{name} = (\d+)", text).group(1))

    assert constant("kDecThreads") == seq2seq_train.DEC_THREADS
    assert constant("kDecMaxUnits") == seq2seq_train.DEC_MAX_UNITS
    assert constant("kDecMaxCluster") == seq2seq_train.DEC_MAX_CLUSTER
    assert constant("kDecFwdMaxRows") == seq2seq_train.DEC_FWD_MAX_ROWS
    assert constant("kDecMaxOwn") == seq2seq_train.DEC_MAX_OWN
    assert constant("kDecBwdMaxRpt") == seq2seq_train.DEC_BWD_MAX_RPT
    sweep = (CSRC / "cluster_sweep.cuh").read_text()
    assert constant("kSweepMaxSmem", sweep) == seq2seq_train.SWEEP_MAX_SMEM
    assert "return 2 * fwd_depth(H) + 4;" in source and "return fwd_depth(H) + 4;" in source
    assert "(R + n - 1) / n" in source and "(S + 3) / 4 * 4" in source


# (hidden = input size, batch, source tokens, target tokens, what the rows hold)
REVERSE_CASES = {
    "one_row": (12, 1, 7, 5, None),
    "all_pad_target_row": (12, 5, 6, 5, "pad_target"),
    "one_step": (12, 4, 6, 1, None),
    "one_real_source_position": (12, 5, 1, 5, "empty_source"),
    "rows_end_early": (16, 6, 8, 7, None),
}


def _case(name, reinforce_norm):
    hidden, batch, ls, lt, what = REVERSE_CASES[name]
    rs = np.random.RandomState(len(name) + 7 * reinforce_norm)

    def tokens(length, vocab):
        tok = rs.randint(4, vocab, (batch, length))
        tok *= np.arange(length)[None, :] < rs.randint(1, length + 1, (batch, 1))
        tok[0] = rs.randint(4, vocab, (length,))
        return tok.astype(np.int32)

    src, tgt = tokens(ls, 30), tokens(lt, 20)
    if reinforce_norm:  # a trimmed z: @end@ after the last token where it fits
        lens = (tgt != 0).sum(1)
        for b in np.flatnonzero(lens < lt):
            tgt[b, lens[b]] = 3
    if what == "pad_target":
        tgt[2] = 0
    if what == "empty_source":  # attention sees @end@ alone
        src[1:] = 0
    w = rs.rand(batch).astype(np.float32) + 0.5
    sizes = dict(source_vocab_size=30, target_vocab_size=20, input_size=hidden,
                 hidden_size=hidden, num_layers=2, max_decoding_steps=lt)
    return sizes, src, tgt, w


def _double(params):
    return tf_params_from_leaves([p.detach().to(torch.float64) for p in tf_param_leaves(params)])


@pytest.mark.parametrize("reinforce_norm", [False, True], ids=["ce", "reinforce"])
@pytest.mark.parametrize("case", list(REVERSE_CASES))
def test_decoder_reverse_reference_matches_autograd(case, reinforce_norm):
    r"""Float64: the reference's decoder cell gradient against autograd
    through ``tf_loss_plain`` (``tf_grads_plain``), and its gradients of the
    encoder outputs and of the initial h against autograd through the plain
    decoder (``_decode_step``) from the same encoder."""
    sizes, src, tgt, w = _case(case, reinforce_norm)
    spec = seq2seq.Seq2SeqSpec(**sizes)
    params = _double(seq2seq.init_seq2seq_params(torch.Generator().manual_seed(len(case)), spec))
    src_t, tgt_t = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    dloss = torch.from_numpy(w).double()
    ref = tf_decoder_reverse_plain(params, spec, src_t, tgt_t, dloss, reinforce_norm)
    T = tgt.shape[1] + (0 if reinforce_norm else 1)
    H, B, S = spec.hidden_size, src.shape[0], src.shape[1] + 1
    assert ref["dpre"].shape == (B, T, 4 * H) and ref["dcat"].shape == (B, T, 2 * H)
    assert ref["ds"].shape == (B, T, S) and ref["dh"].shape == (B, T + 1, H)
    assert ref["denc"].shape == (B, S, H)

    want = tf_grads_plain(params, spec, src_t, tgt_t, dloss, reinforce_norm)["decoder_cell"]
    for name, got in (("w_ih", ref["w_ih"]), ("w_hh", ref["w_hh"]), ("b_ih", ref["b"]),
                      ("b_hh", ref["b"])):
        torch.testing.assert_close(got, want[name], rtol=1e-9, atol=1e-12, msg=name)

    enc, mask, h0, c0 = _encode(params, spec, src_t)
    enc, h0 = enc.detach().requires_grad_(True), h0.detach().requires_grad_(True)
    step_inputs, labels = _tf_step_inputs(spec, tgt_t, reinforce_norm)
    h, c, outs = h0, c0, []
    for t in range(T):
        _, h, c = _decode_step(params, spec, step_inputs[:, t], h, c, enc, mask)
        outs.append(h)
    loss = _tf_head_loss(params, spec, torch.stack(outs, 1), labels, reinforce_norm)
    denc, dh0 = torch.autograd.grad(loss, [enc, h0], grad_outputs=dloss)
    torch.testing.assert_close(ref["denc"], denc, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(ref["dh"][:, 0], dh0, rtol=1e-9, atol=1e-12)
    # Masked source positions get no attention and no score gradient.
    masked = ~mask[:, None, :].expand_as(ref["ds"])
    assert (ref["ds"][masked] == 0).all()
    if case == "all_pad_target_row" and not reinforce_norm:
        assert ref["dpre"][2, 1:].abs().max() == 0  # only the @end@ label of the empty row counts
    if case == "all_pad_target_row" and reinforce_norm:
        assert ref["dpre"][2].abs().max() == 0  # an empty z has no loss


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree)


@pytest.mark.parametrize("reinforce_norm", [False, True], ids=["ce", "reinforce"])
@pytest.mark.parametrize("case", list(REVERSE_CASES))
def test_decoder_reverse_reference_matches_jax_vjp(case, reinforce_norm):
    r"""The reference's decoder cell gradient (float64, from the float32
    parameters) against interpret-mode JAX ``fused_tf_loss``'s VJP in
    float32, within 5e-6: the tolerance of the plain versions against JAX
    (tests/test_torch_port_lstm_edges.py)."""
    sizes, src, tgt, w = _case(case, reinforce_norm)
    jspec, spec = jseq2seq.Seq2SeqSpec(**sizes), seq2seq.Seq2SeqSpec(**sizes)
    jp = jseq2seq.init_seq2seq_params(jax.random.PRNGKey(len(case) + 3), jspec)
    tp = interop.program_generator_from_jax(_to_numpy(jp))
    jsrc, jtgt = jnp.asarray(src), jnp.asarray(tgt)
    jgrad = jax.grad(lambda p: (jnp.asarray(w) * jax_fused_tf_loss(
        p, jspec, jsrc, jtgt, reinforce_norm, jnp.float32, 4, True)).sum())(jp)
    want = _to_numpy(interop.program_generator_from_jax(_to_numpy(jgrad)))["decoder_cell"]
    ref = tf_decoder_reverse_plain(_double(tp), spec, torch.from_numpy(src).long(),
                                   torch.from_numpy(tgt).long(), torch.from_numpy(w).double(),
                                   reinforce_norm)
    for name, got in (("w_ih", ref["w_ih"]), ("w_hh", ref["w_hh"]), ("b_ih", ref["b"]),
                      ("b_hh", ref["b"])):
        np.testing.assert_allclose(got.numpy(), want[name], atol=5e-6, rtol=0, err_msg=name)
