r"""
Kernels K2, K5 and K6: the NMN program interpreter, its training forward and
its backward, in CUDA (``probnmn_tpu_torch/csrc/nmn_interpreter.cu``).

- K2 replaces ``probnmn_tpu/ops/pallas/nmn_interpreter.py::_interpreter_kernel``
  (entry ``execute_programs_pallas``): :func:`execute_programs_kernel`.
- K5 replaces ``_interpreter_train_kernel`` (entry
  ``_execute_train_fwd_pallas``): :func:`execute_programs_train_kernel`, K2's
  kernel body with the residual stores switched on. Besides the final
  encodings and invalid flags (K2's, bit for bit) it returns ``otraj``
  (B, T, H*W, C), the out register at the entry of every executed step, and
  ``atraj`` (B, T, 2, H*W, C), the outputs of the two 3x3 convs of every
  attention, query and compare step, both in the compute dtype: the JAX
  package's layout. Steps that did not run are left unwritten.
- K6 replaces ``_interpreter_bwd_kernel`` in its no-replay mode (entry
  ``_execute_bwd_pallas`` with residuals): :func:`interpreter_grads_kernel`,
  the reverse sweep over each valid example's steps that reads K5's
  residuals (relate's chain is recomputed from its entry register) and gives
  d(stem features) and the gradients of every bank. Invalid examples get
  zero gradients. It is deterministic: the 3x3 bank's and compare
  projection's weight gradients are summed from a workspace of (input,
  g_z) pairs by :func:`weight_grad_kernel`, each target's entries cut into
  chunks in (example, step) order that run side by side on the SMs, then
  each target's chunks added in chunk order (:func:`weight_grad_plan`); the
  small banks from per-example partials in example order; no float atomics.
- K6's replay mode replaces the same kernel with ``no_replay=False``
  (``_execute_bwd_pallas`` without residuals): :func:`interpreter_grads_kernel`
  without ``otraj``/``atraj``. Each block of a grid sized to what fits on the
  card at once re-runs its examples' programs on K5's device code into its
  own slice of a scratch, then runs the same sweep, so both modes give the
  same bits while the residual memory scales with the grid, not the batch.
- :func:`execute_programs_diff` puts K5 and K6 (or, in replay mode, K2 and
  K6's replay mode, selected as the JAX package selects it, by
  ``PROBNMN_NMN_REPLAY_BWD=1``) behind one ``torch.autograd.Function`` (the
  JAX package's custom VJP ``_execute_diff``).

Each program runs exactly: the tag machine walks the reversed tokens from the
first non-pad step, runs only the module chain of each step's kind and stops
at the first invalid op.

What bounds them on an H100: the 3x3 convs, 57.8 MFLOP each (15.1 per valid
CLEVR program: 224 GFLOP per batch of 256, 0.23 ms at the bf16 tensor peak,
against ~48 MB of bytes, 14 µs), and the longest program's chain of convs,
which one block runs in series; K6 runs each conv's two gradient products,
about twice K5's work. Design: a block runs an example, so the scalar tag
machine is uniform within a block and never diverges; the grid is
persistent, at most one block an SM, taking the examples longest program
first (:func:`interpreter_plan`: the convs each program runs, counted on the
card, and a stable descending sort; no host read) from a shared counter;
each example's results go to its own rows, so the order moves no bit. The
conv input and output tiles (14 x 14 x 128, unpadded, plus one zero row that
out-of-range taps read) live in shared memory. In bfloat16 at C = 128 (the
serving and training paths) each forward conv (K2, K5, K6's replay and its
recomputes of relate's chain and compare's projection) runs on ``wgmma``
m64n128k16 with float32 sums: the weights of each tap arrive by TMA in a
ring of shared-memory stages that thread 0 fills in the order the program
will read them, A comes from the shared tile through ``ldmatrix``; K6's
input gradients stay on ``mma.sync`` m16n8k16, reading the banks as stored.
bfloat16 at other widths raises. float32 runs float32 FMAs on the SIMT
cores: the reference that checks the kernels' arithmetic at a tight
tolerance. K6's weight-gradient stage in bfloat16 stages its operands by TMA
into a two-stage ring and multiplies on ``wgmma`` too.

The registers ``out`` and ``saved`` live in a per-example global scratch, in
the compute type. Attentions are stored broadcast over all C channels so
AND/OR min/max stay exact, as in the JAX package.

Beside the kernels: :func:`build_tables` / :func:`build_banks` (the dispatch
tables and unified weight banks, in the JAX package's slot order; the banks
are differentiable in the params), :func:`execute_programs_plain` (the
batched register machine K2 and K5 are held against, and that runs for CPU
tensors), :func:`interpreter_grads_plain` (autograd through it, K6's
plain version; :func:`interpreter_grads_plain_by_row` recomputes the rows
whose float32 ReLU inputs sit on a kink alone), :func:`interpreter_plan_plain`
(the persistent kernels' order) and :func:`weight_grad_plain` (K6's
weight-gradient stage).
"""
from __future__ import annotations

import ctypes
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from probnmn_tpu_torch.ops import gconv
from probnmn_tpu_torch.ops.common import as_operand
from probnmn_tpu_torch.ops.kernels import _build

# Module kinds and register tags (must match models/nmn.py and the CUDA source).
NOP, SCENE, AND, OR, ATTENTION, QUERY, RELATE, SAME, COMPARE = range(9)
TAG_NONE, TAG_ATTN, TAG_FEAT = 0, 1, 2

MAX_CHAIN = 5  # relate has 5 3x3 convs; attention/query/compare use 2
RELATE_DILATIONS = (1, 2, 4, 8, 1)
MMA_CHANNELS = 128      # the tensor-core path: bf16, C == 128
FORWARD_MAX_PIXELS = 256  # K2 / K5 in bf16: four 64-pixel wgmma tiles
MMA_MAX_PIXELS = 224    # K6 and its weight-gradient stage in bf16
GRAD_MAX_PIXELS = 256   # K6 keeps one float per pixel in shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The banks that take gradients, in the order execute_programs_diff passes them.
DIFF_BANKS = ("w3", "b3", "w1", "b1", "same_wf", "same_wa", "same_b", "wcmp", "bcmp")


# ------------------------------------------------------------------ host tables -------
def build_tables(spec, device="cpu") -> Dict[str, torch.Tensor]:
    r"""Per-token dispatch tables (int32), equal to the JAX package's
    ``build_tables``.

    Slot order in the unified 3x3 bank (must match :func:`build_banks`):
    attention slots interleaved [conv1 s, conv2 s], then query [conv1 s,
    conv2 s], then relate [conv1..conv5 per slot], then compare [conv1 s,
    conv2 s]. The 1x1 head bank is [attention conv3 per slot | relate conv6
    per slot].
    """
    kind = np.asarray(spec.token_kind)
    bank = np.asarray(spec.token_bank)
    vocab = kind.shape[0]
    nb = spec.bank_sizes
    na, nq, nr = nb["attention"], nb["query"], nb["relate"]
    q_base = 2 * na
    r_base = q_base + 2 * nq
    c_base = r_base + 5 * nr

    chain_len = np.zeros(vocab, np.int32)
    slot3 = np.zeros((vocab, MAX_CHAIN), np.int32)
    head_slot = np.full(vocab, -1, np.int32)
    cmp_slot = np.zeros(vocab, np.int32)
    same_slot = np.zeros(vocab, np.int32)
    for t in range(vocab):
        k, s = int(kind[t]), int(bank[t])
        if k == ATTENTION:
            chain_len[t] = 2
            slot3[t, :2] = (2 * s, 2 * s + 1)
            head_slot[t] = s
        elif k == QUERY:
            chain_len[t] = 2
            slot3[t, :2] = (q_base + 2 * s, q_base + 2 * s + 1)
        elif k == RELATE:
            chain_len[t] = 5
            slot3[t, :5] = [r_base + 5 * s + l for l in range(5)]
            head_slot[t] = na + s
        elif k == COMPARE:
            chain_len[t] = 2
            slot3[t, :2] = (c_base + 2 * s, c_base + 2 * s + 1)
            cmp_slot[t] = s
        elif k == SAME:
            same_slot[t] = s

    tables = {
        "kind": kind.astype(np.int32), "chain_len": chain_len, "slot3": slot3,
        "head_slot": head_slot, "cmp_slot": cmp_slot, "same_slot": same_slot,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in tables.items()}


def build_banks(params: Dict[str, Any], spec, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    r"""Flatten the per-class parameter banks into the kernel's unified banks.

    ``w3`` (S3, 9, C, C): per slot, tap-major (ky*3 + kx), then C_in x C_out.
    ``w1`` (S1, C) 1x1 attention heads; ``same_wf`` (Ss, C) with the
    attention-channel weight split out as ``same_wa`` (Ss,) float32; ``wcmp``
    (Sc, 2C, C). Weights are in ``dtype``; biases are float32 holding
    ``dtype``-rounded values, as the TPU kernel's bias planes did. Every bank
    is differentiable in ``params``.
    """
    C = spec.module_channels
    p = params

    def interleave3(convs):
        w = torch.stack([c["w"] for c in convs], dim=1)  # (n, L, 3, 3, C, C)
        n, L = w.shape[:2]
        b = torch.stack([c["b"] for c in convs], dim=1).reshape(n * L, C)
        return w.reshape(n * L, 9, C, C), b

    att_w, att_b = interleave3([p["attention"]["conv1"], p["attention"]["conv2"]])
    qry_w, qry_b = interleave3([p["query"]["conv1"], p["query"]["conv2"]])
    rel_w, rel_b = interleave3([p["relate"][f"conv{i}"] for i in range(1, 6)])
    cmp_w, cmp_b = interleave3([p["compare"]["conv1"], p["compare"]["conv2"]])

    def weight(w):
        return w.to(torch.float32).to(dtype).contiguous()

    def bias(b):
        return as_operand(b.to(torch.float32), dtype).contiguous()

    same_w = p["same"]["conv"]["w"]  # (ns, C+1, 1)
    banks = {
        "w3": weight(torch.cat([att_w, qry_w, rel_w, cmp_w])),
        "b3": bias(torch.cat([att_b, qry_b, rel_b, cmp_b])),
        "w1": weight(torch.cat([p["attention"]["conv3"]["w"], p["relate"]["conv6"]["w"]])[..., 0]),
        "b1": bias(torch.cat([p["attention"]["conv3"]["b"], p["relate"]["conv6"]["b"]])[..., 0]),
        "same_wf": weight(same_w[:, :C, 0]),
        "same_wa": same_w[:, C, 0].to(torch.float32).contiguous(),
        "same_b": bias(p["same"]["conv"]["b"][:, 0]),
        "wcmp": weight(p["compare"]["projection"]["w"]),
        "bcmp": bias(p["compare"]["projection"]["b"]),
    }
    return banks


# ------------------------------------------------------------------ plain versions ----
def _broadcast(attn: torch.Tensor, channels: int) -> torch.Tensor:
    r"""(n, H, W) attention -> (n, H, W, C), stored over every channel."""
    return attn[..., None].expand(*attn.shape, channels)


def execute_programs_plain(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec,
    stem_feats: torch.Tensor,
    programs: torch.Tensor,
    record: bool = False,
):
    r"""Plain PyTorch version of K2 (and, with ``record``, of K5): the batched
    register machine of ``probnmn_tpu/models/nmn.py::execute_programs`` over
    the unified banks.

    stem_feats: (B, H, W, C) in the compute dtype; programs: (B, T) int.
    Returns (final encodings (B, H, W, C) in the compute dtype, invalid (B,)
    bool), and with ``record`` also K5's residuals ``otraj`` (B, T, H*W, C)
    and ``atraj`` (B, T, 2, H*W, C), zero where a step ran no two-conv chain.
    Each step runs every module kind for the rows whose token has that kind;
    rows stop changing at their first invalid op. Values are kept float32 and
    rounded to the compute dtype where the kernel stores them; a float64
    ``stem_feats`` runs every step in float64 (the witness K6's float32 check
    is weighed against, ``tools/k6_kinks.py``). Differentiable in
    ``stem_feats`` and the banks (K6's plain version differentiates it).
    """
    batch, h, w, c = stem_feats.shape
    dtype = stem_feats.dtype
    device = stem_feats.device
    steps = programs.shape[1]

    def rd(v):
        return as_operand(v, dtype)

    acc = torch.float64 if dtype == torch.float64 else torch.float32
    x = stem_feats.to(acc)
    w3 = {"w": banks["w3"].to(acc), "b": banks["b3"].to(acc)}
    cmp_bank = {"w": banks["wcmp"].to(acc), "b": banks["bcmp"].to(acc)}
    w1, b1 = banks["w1"].to(acc), banks["b1"].to(acc)
    tab = {k: v.to(device=device, dtype=torch.long) for k, v in tables.items()}

    out = x.clone()
    saved = torch.zeros_like(x)
    out_tag = torch.full((batch,), TAG_FEAT, dtype=torch.long, device=device)
    saved_tag = torch.full((batch,), TAG_NONE, dtype=torch.long, device=device)
    invalid = torch.zeros(batch, dtype=torch.bool, device=device)
    if record:
        otraj = torch.zeros(batch, steps, h * w, c, dtype=dtype, device=device)
        atraj = torch.zeros(batch, steps, 2, h * w, c, dtype=dtype, device=device)

    def chain(a, tok, dilations, acts=None):
        for layer, d in enumerate(dilations):
            a = rd(torch.relu(gconv.gathered_conv3x3(a, w3, tab["slot3"][tok, layer], d)))
            if acts is not None:
                acts.append(a)
        return a

    def keep(rows, t, acts):
        if record:
            atraj[rows, t] = torch.stack(acts, dim=1).reshape(rows.numel(), 2, h * w, c).to(dtype)

    def head(a, slots):
        logit = torch.einsum("nhwc,nc->nhw", a, w1[slots]) + b1[slots][:, None, None]
        return _broadcast(rd(torch.sigmoid(logit)), c)

    # Reversed prefix order (reference nmn.py:203): last token executes first.
    tokens_rev = programs.to(device=device, dtype=torch.long).flip(1)
    for t in range(steps):
        if record:
            otraj[:, t] = out.detach().reshape(batch, h * w, c).to(dtype)
        tok = tokens_rev[:, t]
        kind = tab["kind"][tok]
        has_head = tab["head_slot"][tok] >= 0
        valid = ~invalid
        is_binop = (kind == AND) | (kind == OR)
        is_chain = (kind == ATTENTION) | (kind == QUERY) | (kind == RELATE)
        scene_ok = valid & (kind == SCENE)
        binop_ok = valid & is_binop & (saved_tag != TAG_NONE)
        do_chain = valid & is_chain & (out_tag == TAG_ATTN)
        do_cmp = valid & (kind == COMPARE) & (out_tag == TAG_FEAT) & (saved_tag == TAG_FEAT)
        do_same = valid & (kind == SAME) & (out_tag == TAG_ATTN)
        invalid_now = (
            (is_binop & (saved_tag == TAG_NONE))
            | (is_chain & (out_tag != TAG_ATTN))
            | ((kind == COMPARE) & ((out_tag != TAG_FEAT) | (saved_tag != TAG_FEAT)))
            | ((kind == SAME) & (out_tag != TAG_ATTN))
        )

        new_out = out.clone()
        new_out[scene_ok] = 1.0
        rows = binop_ok.nonzero()[:, 0]
        if rows.numel():
            lo = torch.minimum(out[rows], saved[rows])
            hi = torch.maximum(out[rows], saved[rows])
            new_out[rows] = torch.where((kind[rows] == AND)[:, None, None, None], lo, hi)
        for relate in (True, False):
            rows = (do_chain & ((kind == RELATE) == relate)).nonzero()[:, 0]
            if not rows.numel():
                continue
            acts = None if relate else []
            a = chain(rd(x[rows] * out[rows]), tok[rows], RELATE_DILATIONS if relate else (1, 1),
                      acts)
            if not relate:
                keep(rows, t, acts)
            heads = has_head[rows]
            res = a.clone()
            if heads.any():
                res[heads] = head(a[heads], tab["head_slot"][tok[rows][heads]])
            new_out[rows] = res
        rows = do_cmp.nonzero()[:, 0]
        if rows.numel():
            both = torch.cat([out[rows], saved[rows]], dim=-1)
            proj = rd(torch.relu(gconv.gathered_conv1x1(both, cmp_bank, tab["cmp_slot"][tok[rows]])))
            acts = []
            new_out[rows] = chain(proj, tok[rows], (1, 1), acts)
            keep(rows, t, acts)
        rows = do_same.nonzero()[:, 0]
        if rows.numel():
            # Argmax-location feature gather (first max, like torch max_pool2d
            # indices) + a 1x1 over concat(x * vec, attention).
            ss = tab["same_slot"][tok[rows]]
            xs = x[rows]
            attn = out[rows][..., 0]
            am = attn.reshape(rows.numel(), -1).argmax(dim=1)
            vec = xs.reshape(rows.numel(), h * w, c)[torch.arange(rows.numel(), device=device), am]
            xsel = rd(xs * vec[:, None, None, :])
            logit = (
                torch.einsum("nhwc,nc->nhw", xsel, banks["same_wf"].to(acc)[ss])
                + attn * banks["same_wa"].to(acc)[ss][:, None, None]
                + banks["same_b"].to(acc)[ss][:, None, None]
            )
            new_out[rows] = _broadcast(rd(torch.sigmoid(logit)), c)

        both_attn = (out_tag == TAG_ATTN) & (saved_tag == TAG_ATTN)
        new_out_tag = torch.where(scene_ok | do_same, TAG_ATTN, out_tag)
        new_out_tag = torch.where(
            binop_ok, torch.where(both_attn, TAG_ATTN, TAG_FEAT), new_out_tag
        )
        new_out_tag = torch.where(
            do_chain, torch.where(has_head, TAG_ATTN, TAG_FEAT), new_out_tag
        )
        new_out_tag = torch.where(do_cmp, TAG_FEAT, new_out_tag)
        saved = torch.where(scene_ok[:, None, None, None], out, saved)
        saved_tag = torch.where(scene_ok, out_tag, saved_tag)
        out, out_tag = new_out, new_out_tag
        invalid = invalid | (valid & invalid_now)

    # Program must end in an "encoding", not an "attention" (reference nmn.py:231-232).
    invalid = invalid | (out_tag != TAG_FEAT)
    final = torch.where(invalid[:, None, None, None], torch.zeros_like(out), out).to(dtype)
    if record:
        return final, invalid, otraj, atraj
    return final, invalid


def interpreter_grads_plain(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec,
    stem_feats: torch.Tensor,
    programs: torch.Tensor,
    g_final: torch.Tensor,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    r"""Plain PyTorch version of K6: ``torch.autograd.grad`` through
    :func:`execute_programs_plain` with respect to the banks of
    :data:`DIFF_BANKS` and ``stem_feats``, under the cotangent ``g_final``
    (B, H, W, C). Returns (d_banks in each bank's dtype, d_stem in the stem
    dtype). min / max split a tie 0.5 / 0.5, as the kernel does; invalid
    rows get zero gradients because the forward zeroed their output."""
    leaves = {k: banks[k].detach().requires_grad_(True) for k in DIFF_BANKS}
    stem = stem_feats.detach().requires_grad_(True)
    with torch.enable_grad():
        final, _ = execute_programs_plain(dict(banks, **leaves), tables, spec, stem, programs)
        inputs = [stem] + [leaves[k] for k in DIFF_BANKS]
        grads = torch.autograd.grad(final, inputs, g_final.to(final.dtype), allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(inputs, grads)]
    return dict(zip(DIFF_BANKS, grads[1:])), grads[0]


def interpreter_grads_plain_by_row(banks, tables, spec, stem_feats, programs, g_final, d_stem,
                                   tol: float):
    r"""K6's float32 reference where a ReLU input lies within float32
    rounding of 0: :func:`interpreter_grads_plain` over the batch, except for
    the rows where such an input sits. Such an input can take one side in
    the batched plain forward and the other in K5's (and in the row's own
    plain forward, whose sums run in the row's own order), which flips that
    element's gradient: it moves the row's d(stem) far above the rounding
    of the rest (one such row of a float32 batch of 128 stood at 0.89 of
    its limit, the others at 0.0065 or less) and a bank's gradient by up to
    that element's g. The rows taken alone are those whose d(stem) stands
    off the kernel's ``d_stem`` by more than a tenth of ``tol`` of its scale
    (max(1, max |d(stem)|)), and those with a ReLU output of a two-conv
    chain whose sign differs between the batched plain forward and K5's
    (relate's chains keep no residual to compare). They are recomputed
    alone, and their bank gradients replace their share of the batch's (the
    batch again under a cotangent zeroed on them: gradients are linear in
    it). Returns (d_banks, d_stem, {row: flipped ReLU outputs of its two-conv
    chains})."""
    w_banks, w_stem = interpreter_grads_plain(banks, tables, spec, stem_feats, programs, g_final)
    err = (d_stem.float() - w_stem.float()).abs().reshape(len(programs), -1).amax(1)
    off = err > tol / 10 * max(1.0, float(w_stem.float().abs().max()))
    _, _, _, atraj = execute_programs_train_kernel(banks, tables, spec, stem_feats, programs)
    _, _, _, plain_atraj = execute_programs_plain(banks, tables, spec, stem_feats, programs,
                                                  record=True)
    # Flips count only on the steps that ran a two-conv chain: K5 leaves the
    # others unwritten.
    ran = plain_atraj.flatten(2).abs().amax(2) > 0
    flips = (((plain_atraj > 0) != (atraj > 0)).flatten(2).sum(2) * ran).sum(1)
    rows = (off | (flips > 0)).nonzero().flatten().tolist()
    if not rows:
        return w_banks, w_stem, {}
    others = g_final.clone()
    others[rows] = 0
    w_banks, w_stem = interpreter_grads_plain(banks, tables, spec, stem_feats, programs, others)
    w_stem = w_stem.clone()
    for row in rows:
        one = slice(row, row + 1)
        row_banks, w_stem[one] = interpreter_grads_plain(banks, tables, spec, stem_feats[one],
                                                         programs[one], g_final[one])
        w_banks = {k: w_banks[k] + row_banks[k] for k in DIFF_BANKS}
    return w_banks, w_stem, {row: int(flips[row]) for row in rows}


# A decision of K5 / K6 that float64 takes the other way counts as a tie
# broken by rounding when its float64 margin lies within this share of its
# scale (the ReLU input against its sum of |products|, the argmax and
# min / max gaps against the larger value).
BRANCH_TOL = 1e-5


def _branch_entries(tab, rev, start: int, base: int) -> Dict[Tuple[int, Any], int]:
    r"""K6's workspace entry of each conv of one valid row, in its sweep
    order (the last step first; a chain's last conv first; compare's second
    conv, first conv, then the projection's two entries): {(step, layer or
    "proj"): entry}."""
    entry, out = base, {}
    for t in range(len(rev) - 1, start - 1, -1):
        kind = int(tab["kind"][rev[t]])
        if kind in (ATTENTION, QUERY, RELATE):
            for layer in reversed(range(5 if kind == RELATE else 2)):
                out[(t, layer)] = entry
                entry += 1
        elif kind == COMPARE:
            out[(t, 1)], out[(t, 0)], out[(t, "proj")] = entry, entry + 1, entry + 2
            entry += 4
    return out


def interpreter_grads_on_branch(banks, tables, spec, stem_feats, programs, g_final, invalid,
                                otraj=None, atraj=None, workspace=None, tol: float = BRANCH_TOL):
    r"""K6's float32 reference: the gradient in float64 of the branch of the
    interpreter that K5 and K6 took. The interpreter is smooth between its
    discrete decisions (each ReLU's side, ``same``'s argmax, ``and`` /
    ``or``'s pick); at an input within float32 rounding of a tie, K5's sums
    (or a plain forward's, in another order) can fall on either side, which
    moves an element's gradient by up to its upstream gradient, far above
    the rounding of the rest. So each valid row runs alone, every step in
    float64 from the float32 banks, stem and cotangent, but takes each
    decision as the kernels took it: the ReLU sides from K5's ``atraj``
    (two-conv chains) and K6's ``workspace`` (relate's chains from each
    conv's input, its last conv from where K6 passed a gradient, compare's
    projection), ``same``'s argmax and the min / max picks from K5's
    ``otraj`` (ties split 0.5 / 0.5). Given none of them, each decision is
    float64's own. A decision float64 takes the other way counts in the
    report as ``taken`` when its float64 margin lies within ``tol`` of its
    scale, else as ``far``: a kernel's fault. ``entries`` counts workspace
    entries whose target differs from the conv's slot (the sweep order
    assumed here is the kernel's), ``rows`` the rows ``invalid`` passes
    that the tag machine here finds invalid; both are faults too.

    Returns (d_banks of :data:`DIFF_BANKS`, d_stem and the final encodings
    of that branch in float64, zero on the rows ``invalid`` flags, and the
    report {"taken", "gap" (the largest taken margin over its scale),
    "far", "far_gap", "entries", "rows"})."""
    f64 = torch.float64
    device = stem_feats.device
    batch, h, w, c = stem_feats.shape
    steps = programs.shape[1]
    tab = {k: v.cpu().long().numpy() for k, v in tables.items()}
    progs = programs.cpu().long().numpy()
    inv = invalid.cpu().numpy().astype(bool)
    leaves = {k: banks[k].detach().to(f64).requires_grad_(True) for k in DIFF_BANKS}
    absolute = {k: leaves[k].detach().abs() for k in ("w3", "b3", "wcmp", "bcmp")}
    stem = stem_feats.detach().to(f64).requires_grad_(True)
    g = g_final.detach().to(device=device, dtype=f64)
    finals = torch.zeros(batch, h, w, c, dtype=f64, device=device)
    report = {"entries": 0, "rows": 0}
    # taken, far, the largest taken and far shares: summed on the device,
    # read once at the end.
    tally = torch.zeros(4, dtype=f64, device=device)
    if workspace is not None:
        per_token = (tab["chain_len"] + 2 * (tab["kind"] == COMPARE)).astype(np.int64)
        upper = per_token[progs].sum(1) * ~inv
        bases = np.cumsum(upper) - upper
        ws_inp, ws_g = workspace["inp"], workspace["g"]
        ws_tag = workspace["tag"].cpu().numpy()
    s3 = banks["w3"].shape[0]

    def decide(own, hint, margin, scale, known=None):
        r"""The kernels' decision where given (``known``: where it is
        read), float64's elsewhere; counts where they differ."""
        if hint is None:
            return own
        differ = hint != own
        if known is not None:
            differ = differ & known
        count(differ, margin / scale.clamp_min(1e-300))
        return torch.where(differ, hint, own)

    def count(differ, share):
        near = differ & (share <= tol)
        far = differ & ~near
        zero = torch.zeros((), dtype=f64, device=device)
        tally.add_(torch.stack([near.sum().to(f64), far.sum().to(f64), zero, zero]))
        tally[2:] = torch.maximum(tally[2:], torch.stack([
            torch.where(near, share, zero).max(), torch.where(far, share, zero).max()]))

    def relu_layer(a, slot, d, hint, known=None):
        pre = gconv.gathered_conv3x3(a[None], {"w": leaves["w3"], "b": leaves["b3"]},
                                     torch.tensor([slot], device=device), d)[0]
        scale = gconv.gathered_conv3x3(a.detach().abs()[None],
                                       {"w": absolute["w3"], "b": absolute["b3"]},
                                       torch.tensor([slot], device=device), d)[0]
        mask = decide(pre.detach() > 0, hint, pre.detach().abs(), scale, known)
        return pre * mask

    def pick(a, other, kind, hint_a, hint_other):
        r"""and / or's weight of ``a`` (1, 0, or 0.5 at a tie)."""
        def weight(p, q):
            return ((p < q) if kind == AND else (p > q)).to(f64) + 0.5 * (p == q).to(f64)
        own = weight(a.detach(), other.detach())
        if hint_a is None:
            return own
        hint = weight(hint_a, hint_other)
        scale = torch.maximum(a.detach().abs(), other.detach().abs())
        return decide(own, hint, (a.detach() - other.detach()).abs(), scale)

    for b in range(batch):
        if inv[b]:
            continue
        rev = progs[b, ::-1]
        start = int(np.argmax(rev != 0)) if (rev != 0).any() else steps
        entries = {}
        if workspace is not None:
            entries = _branch_entries(tab, rev, start, int(bases[b]))
        x = stem[b]
        out, saved = x, torch.zeros_like(x)
        out_tag, saved_tag, last_scene, valid = TAG_FEAT, TAG_NONE, -1, True

        def ws_entry(t, layer, slot):
            e = entries[(t, layer)]
            report["entries"] += int(ws_tag[e] != slot)
            return e

        for t in range(start, steps):
            tok = int(rev[t])
            kind, head = int(tab["kind"][tok]), int(tab["head_slot"][tok])
            if kind == SCENE:
                saved, saved_tag, last_scene = out, out_tag, t
                out, out_tag = torch.ones_like(x), TAG_ATTN
            elif kind in (AND, OR):
                if saved_tag == TAG_NONE:
                    valid = False
                    break
                hints = ((otraj[b, t].to(f64).reshape(h, w, c),
                          otraj[b, last_scene].to(f64).reshape(h, w, c))
                         if otraj is not None else (None, None))
                wt = pick(out, saved, kind, *hints)
                both_attn = out_tag == TAG_ATTN and saved_tag == TAG_ATTN
                out = wt * out + (1 - wt) * saved
                out_tag = TAG_ATTN if both_attn else TAG_FEAT
            elif kind in (ATTENTION, QUERY, RELATE):
                if out_tag != TAG_ATTN:
                    valid = False
                    break
                relate = kind == RELATE
                a = x * out
                dilations = RELATE_DILATIONS if relate else (1, 1)
                for layer, d in enumerate(dilations):
                    slot = int(tab["slot3"][tok, layer])
                    hint = known = None
                    if not relate and atraj is not None:
                        hint = atraj[b, t, layer].reshape(h, w, c) > 0
                    elif relate and workspace is not None and layer < 4:
                        nxt = int(tab["slot3"][tok, layer + 1])
                        hint = ws_inp[ws_entry(t, layer + 1, nxt)].reshape(h, w, c) > 0
                    elif relate and workspace is not None:
                        # K6 passed a gradient where its mask was 1; where a
                        # pixel passed none, its mask is not read here.
                        gz = ws_g[ws_entry(t, layer, slot)].reshape(h, w, c) != 0
                        hint = gz
                        known = gz.any(-1, keepdim=True).expand_as(gz) & (
                            leaves["w1"].detach()[head] != 0)
                    a = relu_layer(a, slot, d, hint, known)
                if head >= 0:
                    logit = torch.einsum("hwc,c->hw", a, leaves["w1"][head]) + leaves["b1"][head]
                    out, out_tag = torch.sigmoid(logit)[..., None].expand(h, w, c), TAG_ATTN
                else:
                    out, out_tag = a, TAG_FEAT
            elif kind == COMPARE:
                if out_tag != TAG_FEAT or saved_tag != TAG_FEAT:
                    valid = False
                    break
                cs = int(tab["cmp_slot"][tok])
                both = torch.cat([out, saved], dim=-1)
                pre = both @ leaves["wcmp"][cs] + leaves["bcmp"][cs]
                scale = both.detach().abs() @ absolute["wcmp"][cs] + absolute["bcmp"][cs]
                hint = None
                if workspace is not None:
                    ws_entry(t, "proj", s3 + 2 * cs)
                    e = ws_entry(t, 0, int(tab["slot3"][tok, 0]))
                    hint = ws_inp[e].reshape(h, w, c) > 0
                a = pre * decide(pre.detach() > 0, hint, pre.detach().abs(), scale)
                for layer in range(2):
                    hint = atraj[b, t, layer].reshape(h, w, c) > 0 if atraj is not None else None
                    a = relu_layer(a, int(tab["slot3"][tok, layer]), 1, hint)
                out, out_tag = a, TAG_FEAT
            elif kind == SAME:
                if out_tag != TAG_ATTN:
                    valid = False
                    break
                ss = int(tab["same_slot"][tok])
                attn = out[..., 0].reshape(-1)
                am = attn.detach().argmax()
                if otraj is not None:
                    hint_am = otraj[b, t].reshape(h * w, c)[:, 0].argmax()
                    top = attn.detach()[am]
                    count(hint_am != am, (top - attn.detach()[hint_am]) / top.abs())
                    am = hint_am
                vec = x.reshape(h * w, c)[am]
                logit = (torch.einsum("hwc,c->hw", x * vec, leaves["same_wf"][ss])
                         + out[..., 0] * leaves["same_wa"][ss] + leaves["same_b"][ss])
                out, out_tag = torch.sigmoid(logit)[..., None].expand(h, w, c), TAG_ATTN
        if not valid or out_tag != TAG_FEAT:
            report["rows"] += 1  # a row K5 ran as valid
            continue
        finals[b] = out.detach()
        (out * g[b]).sum().backward()
    taken, far, gap, far_gap = tally.tolist()
    report.update(taken=int(taken), gap=gap, far=int(far), far_gap=far_gap)
    d_banks = {k: leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(leaves[k])
               for k in DIFF_BANKS}
    d_stem = stem.grad if stem.grad is not None else torch.zeros_like(stem)
    return d_banks, d_stem, finals, report


def interpreter_plan_plain(tables: Dict[str, torch.Tensor], programs: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Plain PyTorch version of the interpreter kernels' plan: (convs (B,)
    int32, the 3x3 convs each program runs, counted by the tag machine up to
    its first invalid op: two a run attention, query or compare, five a run
    relate; order (B,) int32, a stable sort of the rows by convs, longest
    first). Rows are walked together, step by step, as in
    :func:`execute_programs_plain`: a pad is a no-op."""
    device = programs.device
    tab = {k: tables[k].to(device=device, dtype=torch.long) for k in ("kind", "head_slot")}
    tokens_rev = programs.to(dtype=torch.long).flip(1)
    batch = programs.shape[0]
    out_tag = torch.full((batch,), TAG_FEAT, dtype=torch.long, device=device)
    saved_tag = torch.full((batch,), TAG_NONE, dtype=torch.long, device=device)
    stopped = torch.zeros(batch, dtype=torch.bool, device=device)
    convs = torch.zeros(batch, dtype=torch.long, device=device)
    for t in range(tokens_rev.shape[1]):
        tok = tokens_rev[:, t]
        kind = tab["kind"][tok]
        run = ~stopped
        is_binop = (kind == AND) | (kind == OR)
        is_chain = (kind == ATTENTION) | (kind == QUERY) | (kind == RELATE)
        scene_ok = run & (kind == SCENE)
        binop_ok = run & is_binop & (saved_tag != TAG_NONE)
        do_chain = run & is_chain & (out_tag == TAG_ATTN)
        do_cmp = run & (kind == COMPARE) & (out_tag == TAG_FEAT) & (saved_tag == TAG_FEAT)
        do_same = run & (kind == SAME) & (out_tag == TAG_ATTN)
        invalid = run & ((is_binop & (saved_tag == TAG_NONE))
                         | (is_chain & (out_tag != TAG_ATTN))
                         | ((kind == COMPARE) & ((out_tag != TAG_FEAT) | (saved_tag != TAG_FEAT)))
                         | ((kind == SAME) & (out_tag != TAG_ATTN)))
        convs += torch.where(do_chain, torch.where(kind == RELATE, 5, 2), 0) + 2 * do_cmp.long()
        both_attn = (out_tag == TAG_ATTN) & (saved_tag == TAG_ATTN)
        new_out = torch.where(scene_ok | do_same, TAG_ATTN, out_tag)
        new_out = torch.where(binop_ok, torch.where(both_attn, TAG_ATTN, TAG_FEAT), new_out)
        new_out = torch.where(
            do_chain, torch.where(tab["head_slot"][tok] >= 0, TAG_ATTN, TAG_FEAT), new_out)
        new_out = torch.where(do_cmp, TAG_FEAT, new_out)
        saved_tag = torch.where(scene_ok, out_tag, saved_tag)
        out_tag = new_out
        stopped = stopped | invalid
    order = torch.argsort(convs, descending=True, stable=True)
    return convs.to(torch.int32), order.to(torch.int32)


# ------------------------------------------------------------------ kernel wrappers ---
def interpreter_plan(tables: Dict[str, torch.Tensor], programs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""The order in which the persistent interpreter kernels (K2, K5, K6)
    take the examples, a drop-in for :func:`interpreter_plan_plain`: CPU
    ``programs`` run the plain version; CUDA ones launch ``nmn_plan_kernel``
    (the tag machine, one thread a row, counting each program's 3x3 convs)
    and sort on the card, with no read back to the host. Returns (convs (B,)
    int32, order (B,) int32, longest program first, ties in batch order)."""
    if programs.device.type == "cpu":
        return interpreter_plan_plain(tables, programs)
    if programs.device.type != "cuda":
        raise ValueError(f"unsupported device {programs.device}")
    progs = programs.to(dtype=torch.int32).contiguous()
    kind = tables["kind"].to(device=progs.device, dtype=torch.int32).contiguous()
    head = tables["head_slot"].to(device=progs.device, dtype=torch.int32).contiguous()
    convs = torch.empty(progs.shape[0], dtype=torch.int32, device=progs.device)
    code = _build.library().probnmn_nmn_plan(
        progs.data_ptr(), progs.shape[0], progs.shape[1], kind.data_ptr(), head.data_ptr(),
        convs.data_ptr(), torch.cuda.current_stream(progs.device).cuda_stream)
    _build.check(code, "NMN plan kernel")
    interpreter_plan.launches += 1
    order = torch.argsort(convs, descending=True, stable=True).to(torch.int32)
    return convs, order


interpreter_plan.launches = 0


def interpreter_launch(dtype: torch.dtype, batch: int, height: int, width: int,
                       channels: int) -> Dict[str, int]:
    r"""How K2 and K5 launch at this shape on the current card: the
    persistent ``grid`` (blocks) and the bf16 weight ring's ``stages`` (0 in
    float32). Needs the CUDA library; raises where the kernel cannot launch."""
    stages = ctypes.c_int(0)
    grid = _build.library().probnmn_nmn_interpret_grid(
        _DTYPE_CODES[dtype], batch, height, width, channels, ctypes.byref(stages))
    if grid <= 0:
        raise RuntimeError(f"the interpreter kernel cannot launch at H={height}, W={width}, "
                           f"C={channels} in {dtype}")
    return {"grid": grid, "stages": stages.value}


def _check_operands(banks, stem_feats, programs, max_pixels) -> None:
    r"""Raise on what the CUDA kernels do not take (bf16: at most
    ``max_pixels`` pixels)."""
    device = stem_feats.device
    dtype = stem_feats.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported compute dtype {dtype}")
    batch, h, w, c = stem_feats.shape
    if dtype == torch.bfloat16:
        if c != MMA_CHANNELS or h * w > max_pixels:
            raise ValueError(
                f"bfloat16 runs on the tensor cores only: it needs C={MMA_CHANNELS} and "
                f"H*W <= {max_pixels}; got C={c}, H*W={h * w}")
    elif c % 4 or 256 % (c // 4):
        raise ValueError(f"the float32 kernel needs C/4 to divide 256; got C={c}")
    if programs.dim() != 2 or programs.shape[0] != batch:
        raise ValueError(f"programs must be ({batch}, T), got {tuple(programs.shape)}")
    for name in ("w3", "w1", "same_wf", "wcmp"):
        if banks[name].dtype != dtype or banks[name].device != device:
            raise ValueError(f"bank {name} must be {dtype} on {device}")
        if banks[name].shape[-1] != c:
            raise ValueError(f"bank {name} has {banks[name].shape[-1]} channels, features {c}")


def _operands(banks, tables, stem_feats, programs):
    r"""The leading C arguments every interpreter entry point takes (dtype,
    programs, tables, stem features, banks, the banks' slots, the examples'
    order from :func:`interpreter_plan` and the blocks' counter), and the
    tensors behind them."""
    device = stem_feats.device
    progs = programs.to(device=device, dtype=torch.int32).contiguous()
    tab = {k: v.to(device=device, dtype=torch.int32).contiguous() for k, v in tables.items()}
    _, order = interpreter_plan(tab, progs)
    counter = torch.empty(1, dtype=torch.int32, device=device)
    args = [
        _DTYPE_CODES[stem_feats.dtype],
        progs.data_ptr(), progs.shape[0], progs.shape[1],
        tab["kind"].data_ptr(), tab["slot3"].data_ptr(), tab["head_slot"].data_ptr(),
        tab["cmp_slot"].data_ptr(), tab["same_slot"].data_ptr(),
        stem_feats.data_ptr(),
        banks["w3"].data_ptr(), banks["b3"].data_ptr(),
        banks["w1"].data_ptr(), banks["b1"].data_ptr(),
        banks["same_wf"].data_ptr(), banks["same_wa"].data_ptr(), banks["same_b"].data_ptr(),
        banks["wcmp"].data_ptr(), banks["bcmp"].data_ptr(),
        banks["w3"].shape[0], banks["wcmp"].shape[0],
        order.data_ptr(), counter.data_ptr(),
    ]
    return args, (progs, tab, order, counter)


def _interpret(banks, tables, stem_feats, programs, train: bool):
    r"""Launch K2 (``train`` False) or K5 on CUDA tensors."""
    if stem_feats.device.type != "cuda":
        raise ValueError(f"unsupported device {stem_feats.device}")
    _check_operands(banks, stem_feats, programs, FORWARD_MAX_PIXELS)
    stem_feats = stem_feats.contiguous()
    batch, h, w, c = stem_feats.shape
    args, keep_alive = _operands(banks, tables, stem_feats, programs)
    out = torch.empty_like(stem_feats)
    saved = torch.empty_like(stem_feats)
    invalid = torch.empty(batch, dtype=torch.int32, device=stem_feats.device)
    otraj = atraj = None
    if train:
        steps = programs.shape[1]
        otraj = stem_feats.new_empty(batch, steps, h * w, c)
        atraj = stem_feats.new_empty(batch, steps, 2, h * w, c)
    code = _build.library().probnmn_nmn_interpret(
        *args,
        out.data_ptr(), saved.data_ptr(), invalid.data_ptr(),
        otraj.data_ptr() if train else None, atraj.data_ptr() if train else None,
        h, w, c,
        torch.cuda.current_stream(stem_feats.device).cuda_stream,
    )
    _build.check(code, "NMN training forward kernel" if train else "NMN interpreter kernel")
    return out, invalid.bool(), otraj, atraj


def execute_programs_kernel(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec,
    stem_feats: torch.Tensor,
    programs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""K2, a drop-in for :func:`execute_programs_plain`: a CPU ``stem_feats``
    runs the plain version, a CUDA one launches the kernel (and raises if it
    cannot). Program tokens must lie in the program vocabulary of ``tables``:
    the kernel indexes the tables with them unchecked."""
    if stem_feats.device.type == "cpu":
        return execute_programs_plain(banks, tables, spec, stem_feats, programs)
    out, invalid, _, _ = _interpret(banks, tables, stem_feats, programs, train=False)
    execute_programs_kernel.launches += 1
    return out, invalid


execute_programs_kernel.launches = 0


def execute_programs_train_kernel(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec,
    stem_feats: torch.Tensor,
    programs: torch.Tensor,
):
    r"""K5: (final, invalid, otraj, atraj). A CPU ``stem_feats`` runs
    :func:`execute_programs_plain` with ``record``; a CUDA one launches the
    kernel (and raises if it cannot). final and invalid equal K2's on the
    same inputs, bit for bit."""
    if stem_feats.device.type == "cpu":
        return execute_programs_plain(banks, tables, spec, stem_feats, programs, record=True)
    result = _interpret(banks, tables, stem_feats, programs, train=True)
    execute_programs_train_kernel.launches += 1
    return result


execute_programs_train_kernel.launches = 0


def _entries_per_token(tables) -> torch.Tensor:
    r"""Workspace entries K6 writes for a token: one per conv of its chain,
    and two more for compare's projection (one per weight half)."""
    return (tables["chain_len"].long()
            + 2 * (tables["kind"].long() == COMPARE).long())


def interpreter_grads_kernel(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec,
    stem_feats: torch.Tensor,
    programs: torch.Tensor,
    invalid: torch.Tensor,
    g_final: torch.Tensor,
    otraj: Optional[torch.Tensor] = None,
    atraj: Optional[torch.Tensor] = None,
    workspace: Dict[str, torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    r"""K6: (d_banks of :data:`DIFF_BANKS` in each bank's dtype, d_stem in the
    stem dtype) from the forward's ``invalid`` and the cotangent ``g_final``
    of the final encodings, over a persistent grid of as many blocks as fit
    on the card at once, which take the examples longest program first
    (:func:`interpreter_plan`). Given K5's ``otraj`` and ``atraj`` it runs
    the no-replay mode; without them the replay mode (the JAX kernel's
    ``no_replay=False``): each block re-runs its examples' programs into a
    scratch of (grid, T, 3, H*W, C) in the compute dtype before sweeping
    back, with the same result bit for bit. A CPU ``stem_feats`` runs
    :func:`interpreter_grads_plain` (which needs no residuals) in both modes;
    a CUDA one launches the kernels (and raises if they cannot).

    On CUDA the workspace is sized from an upper bound of the entries each
    valid example writes (its tokens' chain lengths, plus two per compare),
    read back to the host once; the weight gradients are summed in float32
    by :func:`weight_grad_kernel` and cast to the bank's dtype at the end, as
    the JAX package does. A ``workspace`` dict receives the sweep's entries,
    the float32 weight gradients (for :func:`workspace_errors` and
    :func:`weight_grad_plain`), the chunk size and the partials' bytes."""
    if (otraj is None) != (atraj is None):
        raise ValueError("pass both of otraj and atraj (no-replay mode) or neither (replay mode)")
    if stem_feats.device.type == "cpu":
        return interpreter_grads_plain(banks, tables, spec, stem_feats, programs, g_final)
    device, dtype = stem_feats.device, stem_feats.dtype
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check_operands(banks, stem_feats, programs, MMA_MAX_PIXELS)
    batch, h, w, c = stem_feats.shape
    if h * w > GRAD_MAX_PIXELS:
        raise ValueError(f"the backward kernel needs H*W <= {GRAD_MAX_PIXELS}, got {h * w}")
    steps = programs.shape[1]
    replay = otraj is None
    if not replay and (otraj.shape != (batch, steps, h * w, c)
                       or atraj.shape != (batch, steps, 2, h * w, c)):
        raise ValueError("otraj / atraj do not match the training forward's layout")
    stem_feats = stem_feats.contiguous()
    args, keep_alive = _operands(banks, tables, stem_feats, programs)
    progs, tab = keep_alive[:2]
    s3, s1 = banks["w3"].shape[0], banks["w1"].shape[0]
    ss, sc = banks["same_wf"].shape[0], banks["wcmp"].shape[0]
    n_targets = s3 + 2 * sc
    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    grid = lib.probnmn_nmn_backward_grid(_DTYPE_CODES[dtype], batch, h, w, c)
    if grid <= 0:
        raise RuntimeError(f"the backward kernel cannot launch at H={h}, W={w}, C={c}")
    if replay:
        traj = stem_feats.new_empty(grid, steps, 3, h * w, c)
    else:
        traj = None
        otraj, atraj = otraj.contiguous(), atraj.contiguous()

    upper = _entries_per_token(tab)[progs.long()].sum(1) * (~invalid.to(device)).long()
    base = (torch.cumsum(upper, 0) - upper).to(torch.int32)
    n_entries = max(int(upper.sum()), 1)  # the one host read of the backward
    ent_inp = stem_feats.new_empty(n_entries, h * w, c)
    ent_g = stem_feats.new_empty(n_entries, h * w, c)
    ent_tag = torch.full((n_entries,), n_targets, dtype=torch.int32, device=device)
    ent_dil = torch.zeros(n_entries, dtype=torch.int32, device=device)
    part_floats = lib.probnmn_nmn_partial_floats(s3, s1, ss, sc, c)
    part = torch.zeros(batch, part_floats, dtype=torch.float32, device=device)
    scratch = torch.empty(grid, 4, h * w, c, dtype=torch.float32, device=device)
    acts = stem_feats.new_empty(grid, 6, h * w, c)
    dx = torch.empty(batch, h * w, c, dtype=torch.float32, device=device)
    inv = invalid.to(device=device, dtype=torch.int32).contiguous()
    gfin = g_final.to(device=device, dtype=torch.float32).contiguous()
    code = lib.probnmn_nmn_backward(
        *args,
        inv.data_ptr(), gfin.data_ptr(),
        None if replay else otraj.data_ptr(), None if replay else atraj.data_ptr(),
        traj.data_ptr() if replay else None, grid,
        scratch.data_ptr(), acts.data_ptr(),
        ent_inp.data_ptr(), ent_g.data_ptr(), ent_tag.data_ptr(), ent_dil.data_ptr(),
        base.data_ptr(), part.data_ptr(),
        s1, ss, dx.data_ptr(), h, w, c, stream,
    )
    _build.check(code, "NMN replay backward kernel" if replay else "NMN backward kernel")
    interpreter_grads_kernel.launches += 1
    interpreter_grads_kernel.replay_launches += int(replay)

    dw3, dwc = weight_grad_kernel(ent_inp, ent_g, ent_tag, ent_dil, s3, sc, h, w)
    small = torch.empty(part_floats, dtype=torch.float32, device=device)
    code = lib.probnmn_nmn_sum_rows(part.data_ptr(), batch, part_floats, small.data_ptr(), stream)
    _build.check(code, "NMN partial-sum kernel")
    if workspace is not None:
        workspace.update(inp=ent_inp, g=ent_g, tag=ent_tag, dil=ent_dil, dw3=dw3, dwc=dwc)

    sizes = [s3 * c, s1 * c, s1, ss * c, ss, ss, sc * c]
    db3, dw1, db1, dwf, dwa, dsb, dbc = torch.split(small, sizes)
    grads = {
        "w3": dw3, "b3": db3.reshape(s3, c), "w1": dw1.reshape(s1, c), "b1": db1,
        "same_wf": dwf.reshape(ss, c), "same_wa": dwa, "same_b": dsb,
        "wcmp": dwc.reshape(sc, 2 * c, c), "bcmp": dbc.reshape(sc, c),
    }
    d_banks = {k: grads[k].to(banks[k].dtype) for k in DIFF_BANKS}
    return d_banks, dx.reshape(batch, h, w, c).to(dtype)


interpreter_grads_kernel.launches = 0         # every launch of K6's sweep
interpreter_grads_kernel.replay_launches = 0  # those in replay mode


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    r"""(n, H, W, C) -> y with y[:, i, j] = x[:, i + dy, j + dx], zero outside."""
    h, w = x.shape[1:3]
    out = torch.zeros_like(x)
    if abs(dy) < h and abs(dx) < w:
        out[:, max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = (
            x[:, max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)])
    return out


def _taps(d: int):
    r"""(tap, dy, dx) of a 3x3 conv at dilation d, or the one tap of a 1x1 (d = 0)."""
    if d == 0:
        return [(0, 0, 0)]
    return [(tap, (tap // 3 - 1) * d, (tap % 3 - 1) * d) for tap in range(9)]


# ------------------------------------------------------------------ weight gradients ---
# Chunks of a target's entries: at least WEIGHT_GRAD_MIN_CHUNK, and few enough
# that a workspace of E entries has at most WEIGHT_GRAD_CHUNKS of them (so at
# most 2 * WEIGHT_GRAD_CHUNKS partial slots: 75.5 MB at C = 128).
WEIGHT_GRAD_MIN_CHUNK = 16
WEIGHT_GRAD_CHUNKS = 64


def weight_grad_chunk(n_entries: int) -> int:
    r"""Entries a chunk holds for a workspace of ``n_entries``: a function of
    the workspace's size alone, so the sums' order never depends on the card."""
    return max(WEIGHT_GRAD_MIN_CHUNK, -(-n_entries // WEIGHT_GRAD_CHUNKS))


def weight_grad_slots(n_entries: int) -> int:
    r"""Partial slots, each (9, C, C) in float32, that the weight-gradient
    kernel allocates for a workspace of ``n_entries``: 2 E // chunk, at
    least 1 (a target that needs slots has two chunks or more)."""
    return max(1, 2 * n_entries // weight_grad_chunk(n_entries))


def weight_grad_plan(ent_tag: torch.Tensor, n_targets: int) -> Dict[str, Any]:
    r"""The weight-gradient kernel's work list, built on the tags' device with
    no read back to the host. Entries of target t (tag t < ``n_targets``; any
    other tag is no entry) keep the (example, step) order the sweep wrote
    them in (``order``, a stable sort by tag) and are cut into chunks of
    ``chunk`` consecutive entries. Chunk j belongs to ``chunk_target[j]``
    (``n_targets`` past the last chunk), starts at ``order[chunk_first[j]]``
    and holds ``chunk_count[j]`` entries; its sum goes to partial slot
    ``chunk_slot[j]``, or straight to the target's gradient (-1) when it is
    the target's only chunk. A target's chunks are consecutive, in entry
    order, and so are its slots (``target_slot``, ``target_chunks``).
    ``n_chunks`` and ``n_slots`` bound the chunks and slots from the
    workspace's size: J = E // chunk + min(E, n_targets) and 2 E // chunk."""
    device = ent_tag.device
    n_entries = ent_tag.numel()
    chunk = weight_grad_chunk(n_entries)
    tag = ent_tag.long().clamp(max=n_targets)
    order = torch.argsort(tag, stable=True)
    # bincount would read its largest tag back to the host: count by index_add_.
    counts = torch.zeros(n_targets + 1, dtype=torch.long, device=device).index_add_(
        0, tag, torch.ones_like(tag))[:n_targets]
    seg_start = torch.cumsum(counts, 0) - counts
    chunks = (counts + chunk - 1) // chunk
    chunk_end = torch.cumsum(chunks, 0)
    n_chunks = n_entries // chunk + min(n_entries, n_targets)
    j = torch.arange(n_chunks, device=device)
    target = torch.searchsorted(chunk_end, j, right=True)
    live = target < n_targets
    t = target.clamp(max=n_targets - 1)
    q = j - (chunk_end - chunks)[t]
    multi = chunks > 1
    slots = torch.where(multi, chunks, torch.zeros_like(chunks))
    target_slot = torch.cumsum(slots, 0) - slots
    i32 = torch.int32
    return {
        "chunk": chunk, "n_chunks": n_chunks, "n_slots": weight_grad_slots(n_entries),
        "order": order.to(i32),
        "chunk_target": torch.where(live, target, torch.full_like(target, n_targets)).to(i32),
        "chunk_first": torch.where(live, seg_start[t] + q * chunk, torch.zeros_like(q)).to(i32),
        "chunk_count": torch.where(live, (counts[t] - q * chunk).clamp(max=chunk),
                                   torch.zeros_like(q)).to(i32),
        "chunk_slot": torch.where(live & multi[t], target_slot[t] + q, torch.full_like(q, -1)).to(i32),
        "target_chunks": chunks.to(i32), "target_slot": target_slot.to(i32),
    }


def weight_grad_plain(ent_inp: torch.Tensor, ent_g: torch.Tensor, ent_tag: torch.Tensor,
                      ent_dil: torch.Tensor, S3: int, Sc: int, height: int, width: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Plain PyTorch version of K6's weight-gradient stage: (dw3 (S3, 9, C, C),
    dwc (Sc, 2, C, C)) in float32 from the sweep's workspace, entries (E,
    H*W, C) of conv inputs and their g_z, each entry's target (tag; S3 + 2k
    + half for compare k's two 1x1 halves, S3 + 2 Sc for no entry) and
    dilation (0 for a 1x1). dw3[t][tap] is the sum over target t's entries
    of shift_tap(inp)^T . g_z, zero padded; dwc[k][half] the sum of inp^T .
    g_z. It sums in the kernel's order (:func:`weight_grad_plan`): each
    chunk's entries in entry order, then each target's chunks in chunk
    order; a target without entries is exactly 0."""
    n_targets = S3 + 2 * Sc
    plan = weight_grad_plan(ent_tag, n_targets)
    c = ent_inp.shape[-1]
    inp = ent_inp.float().reshape(-1, height, width, c)
    gz = ent_g.float().reshape(-1, height, width, c)
    dil = ent_dil.long()
    live = (plan["chunk_target"] < n_targets).nonzero()[:, 0]
    first, count = plan["chunk_first"].long()[live], plan["chunk_count"].long()[live]
    order = plan["order"].long()
    acc = torch.zeros(live.numel(), 9, c, c, dtype=torch.float32, device=inp.device)
    for k in range(int(count.max()) if live.numel() else 0):
        rows = (count > k).nonzero()[:, 0]
        entries = order[first[rows] + k]
        for d in dil[entries].unique().tolist():
            sel = dil[entries] == d
            r, e = rows[sel], entries[sel]
            for tap, dy, dx in _taps(d):
                acc[r, tap] += torch.einsum("nhwi,nhwo->nio", _shift(inp[e], dy, dx), gz[e])
    # A target's chunks are consecutive: add its q-th chunk at step q.
    chunks = plan["target_chunks"].long()
    first_chunk = torch.cumsum(chunks, 0) - chunks
    dw = torch.zeros(n_targets, 9, c, c, dtype=torch.float32, device=inp.device)
    for q in range(int(chunks.max())):
        ts = (chunks > q).nonzero()[:, 0]
        dw[ts] += acc[first_chunk[ts] + q]
    return dw[:S3].contiguous(), dw[S3:, 0].reshape(Sc, 2, c, c).contiguous()


def weight_grad_kernel(ent_inp: torch.Tensor, ent_g: torch.Tensor, ent_tag: torch.Tensor,
                       ent_dil: torch.Tensor, S3: int, Sc: int, height: int, width: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""K6's weight-gradient stage, a drop-in for :func:`weight_grad_plain`: a
    CPU workspace runs the plain version, a CUDA one launches the chunk
    kernel (bf16: TMA and ``wgmma``, C = 128 and H*W <= 224 only; float32:
    SIMT FMAs) over :func:`weight_grad_plan`'s work list and the second pass
    that adds each target's partials in chunk order (and raises if they
    cannot launch)."""
    if ent_inp.device.type == "cpu":
        return weight_grad_plain(ent_inp, ent_g, ent_tag, ent_dil, S3, Sc, height, width)
    device, dtype = ent_inp.device, ent_inp.dtype
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported compute dtype {dtype}")
    n_entries, c = ent_inp.shape[0], ent_inp.shape[-1]
    if (ent_inp.shape != (n_entries, height * width, c) or ent_g.shape != ent_inp.shape
            or ent_tag.shape != (n_entries,) or ent_dil.shape != (n_entries,)):
        raise ValueError("the entries must be (E, H*W, C), their tags and dilations (E,)")
    if dtype == torch.bfloat16 and (c != MMA_CHANNELS or height * width > MMA_MAX_PIXELS):
        raise ValueError(f"bfloat16 runs on the tensor cores only: it needs C={MMA_CHANNELS} and "
                         f"H*W <= {MMA_MAX_PIXELS}; got C={c}, H*W={height * width}")
    if c % 8:
        raise ValueError(f"the weight-gradient kernels need C % 8 == 0; got C={c}")
    plan = weight_grad_plan(ent_tag, S3 + 2 * Sc)
    ent_inp, ent_g = ent_inp.contiguous(), ent_g.contiguous()
    dil = ent_dil.to(device=device, dtype=torch.int32).contiguous()
    dw3 = torch.empty(S3, 9, c, c, dtype=torch.float32, device=device)
    dwc = torch.empty(Sc, 2, c, c, dtype=torch.float32, device=device)
    partial = torch.empty(plan["n_slots"], 9, c, c, dtype=torch.float32, device=device)
    code = _build.library().probnmn_nmn_weight_grad(
        _DTYPE_CODES[dtype], ent_inp.data_ptr(), ent_g.data_ptr(), dil.data_ptr(), n_entries,
        plan["order"].data_ptr(), plan["chunk_target"].data_ptr(), plan["chunk_first"].data_ptr(),
        plan["chunk_count"].data_ptr(), plan["chunk_slot"].data_ptr(), plan["n_chunks"],
        plan["target_chunks"].data_ptr(), plan["target_slot"].data_ptr(), S3, Sc,
        dw3.data_ptr(), dwc.data_ptr(), partial.data_ptr(), height, width, c,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "NMN weight-gradient kernel")
    weight_grad_kernel.launches += 1
    return dw3, dwc


weight_grad_kernel.launches = 0


def workspace_errors(workspace: Dict[str, torch.Tensor], banks: Dict[str, torch.Tensor],
                     tables: Dict[str, torch.Tensor], spec) -> Dict[str, float]:
    r"""How far two pieces of K6 stand from float64 sums over the very
    operands its sweep wrote to the workspace (``interpreter_grads_kernel(...,
    workspace=ws)``), so none of the rounding the sweep does on the way is
    compared:

    - ``weight_grad``: the weight-gradient kernel's float32 dw3 and dwc
      against the float64 sum, over each target's entries, of
      shift_tap(inp)^T . g_z;
    - ``input_grad``: each conv's input gradient (g_z through the bank as
      stored, taps flipped) where the sweep's next entry holds it: layer
      l >= 1 of a chain hands round((inp_l > 0) * dinp_l) to layer l - 1 as
      its g_z, and compare's first conv hands it to the projection. The
      rounding to the compute type (2**-8 of |value| in bfloat16) is taken off
      the difference.

    Each error is the largest difference over a target (or entry) over the
    largest float64 sum of absolute products there, the scale that bounds a
    float32 sum's error; a target without entries must be exactly 0."""
    f64 = torch.float64
    h, w = spec.height, spec.width
    tag, dil = workspace["tag"].long(), workspace["dil"].long()
    c = workspace["inp"].shape[-1]
    inp = workspace["inp"].to(f64).reshape(-1, h, w, c)
    gz = workspace["g"].to(f64).reshape(-1, h, w, c)
    s3, sc = banks["w3"].shape[0], banks["wcmp"].shape[0]
    n_targets = s3 + 2 * sc

    want = torch.zeros(n_targets, 9, c, c, dtype=f64, device=inp.device)
    scale = torch.zeros_like(want)
    for d in dil[tag < n_targets].unique().tolist():
        rows = ((dil == d) & (tag < n_targets)).nonzero()[:, 0]
        for tap, dy, dx in _taps(d):
            xs = _shift(inp[rows], dy, dx)
            want[:, tap].index_add_(0, tag[rows], torch.einsum("nhwi,nhwo->nio", xs, gz[rows]))
            scale[:, tap].index_add_(
                0, tag[rows], torch.einsum("nhwi,nhwo->nio", xs.abs(), gz[rows].abs()))
    got3 = workspace["dw3"].to(f64)
    gotc = workspace["dwc"].to(f64).reshape(2 * sc, c, c)
    err = torch.cat([(got3 - want[:s3]).abs().amax(dim=(1, 2, 3)),
                     (gotc - want[s3:, 0]).abs().amax(dim=(1, 2))])
    top = torch.cat([scale[:s3].amax(dim=(1, 2, 3)), scale[s3:, 0].amax(dim=(1, 2))])
    weight_grad = float((err / top.clamp_min(1e-300)).max())

    layer = torch.full((s3,), -1, dtype=torch.long)
    slot3 = tables["slot3"].cpu()
    for t, length in enumerate(tables["chain_len"].tolist()):
        layer[slot3[t, :length].long()] = torch.arange(length)
    layer = layer.to(tag.device)
    first, nxt = tag[:-1], tag[1:]
    is3 = first < s3
    chained = is3 & (nxt < n_targets) & ((layer[first.clamp(max=s3 - 1)] >= 1) | (nxt >= s3))
    rows = chained.nonzero()[:, 0]
    ig = torch.zeros(rows.numel(), h, w, c, dtype=f64, device=inp.device)
    ig_abs = torch.zeros_like(ig)
    w3 = banks["w3"].to(f64)
    for d in dil[rows].unique().tolist():
        sel = (dil[rows] == d).nonzero()[:, 0]
        for tap, dy, dx in _taps(d):
            gs = _shift(gz[rows[sel]], -dy, -dx)
            wt = w3[tag[rows[sel]], tap]
            ig[sel] += torch.einsum("nhwo,nio->nhwi", gs, wt)
            ig_abs[sel] += torch.einsum("nhwo,nio->nhwi", gs.abs(), wt.abs())
    ig = torch.where(inp[rows] > 0, ig, torch.zeros_like(ig))
    unit = 2.0 ** -8 if workspace["g"].dtype == torch.bfloat16 else 2.0 ** -24
    excess = ((gz[rows + 1] - ig).abs() - unit * ig.abs()).clamp_min(0)
    ratio = excess.amax(dim=(1, 2, 3)) / ig_abs.amax(dim=(1, 2, 3)).clamp_min(1e-300)
    return {"weight_grad": weight_grad, "input_grad": float(ratio.max()) if rows.numel() else 0.0,
            "entries": int((tag < n_targets).sum()), "chained": int(rows.numel())}


class _InterpreterFunction(torch.autograd.Function):
    r"""The JAX package's ``_execute_diff``: K5 forward and K6 backward, or
    with ``replay`` K2 forward (no residuals) and K6 in replay mode. The
    differentiable inputs are ``stem_feats`` and the banks of
    :data:`DIFF_BANKS`; the tables and the programs take none."""

    @staticmethod
    def forward(ctx, tables, spec, programs, replay, stem_feats, *leaves):
        banks = dict(zip(DIFF_BANKS, leaves))
        if replay:
            final, invalid = execute_programs_kernel(banks, tables, spec, stem_feats, programs)
            otraj = atraj = None
        else:
            final, invalid, otraj, atraj = execute_programs_train_kernel(
                banks, tables, spec, stem_feats, programs)
        ctx.mark_non_differentiable(invalid)
        ctx.save_for_backward(stem_feats, programs, invalid, otraj, atraj, *leaves)
        ctx.tables, ctx.spec = tables, spec
        return final, invalid

    @staticmethod
    def backward(ctx, g_final, _g_invalid):
        stem_feats, programs, invalid, otraj, atraj, *leaves = ctx.saved_tensors
        banks = dict(zip(DIFF_BANKS, leaves))
        d_banks, d_stem = interpreter_grads_kernel(
            banks, ctx.tables, ctx.spec, stem_feats, programs, invalid, g_final, otraj, atraj)
        return (None, None, None, None, d_stem, *[d_banks[k] for k in DIFF_BANKS])


def execute_programs_diff(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec,
    stem_feats: torch.Tensor,
    programs: torch.Tensor,
    replay: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Differentiable interpreter (counterpart of the JAX package's
    ``execute_programs_pallas_diff``) through one ``torch.autograd.Function``:
    K5 forward and K6 backward by default; in replay mode (``replay=True``,
    or ``PROBNMN_NMN_REPLAY_BWD=1`` when ``replay`` is None) K2 forward,
    which keeps no residuals, and K6 in replay mode, with the same gradients.
    Gradients reach ``stem_feats`` and the banks of :data:`DIFF_BANKS`, and
    through :func:`build_banks` the params. Returns (final encodings,
    invalid (B,) bool)."""
    if replay is None:  # the JAX package's switch, read at each call
        replay = os.environ.get("PROBNMN_NMN_REPLAY_BWD", "") == "1"
    return _InterpreterFunction.apply(tables, spec, programs, bool(replay), stem_feats,
                                      *[banks[k] for k in DIFF_BANKS])
