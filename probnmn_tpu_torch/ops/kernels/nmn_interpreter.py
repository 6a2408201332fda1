r"""
Kernel K2: the NMN program interpreter, inference path, in one CUDA launch
(``probnmn_tpu_torch/csrc/nmn_interpreter.cu``).

Replaces ``probnmn_tpu/ops/pallas/nmn_interpreter.py::_interpreter_kernel``
(entry ``execute_programs_pallas``). Each example's program runs exactly: the
tag machine walks the reversed tokens from the first non-pad step, runs only
the module chain of each step's kind and stops at the first invalid op.

What bounds it on an H100: the 3x3 convs, 57.8 MFLOP each (15.1 per valid
CLEVR program, 224 GFLOP per batch of 256: 0.23 ms at the bf16 tensor peak,
against ~48 MB of bytes, 14 µs) — it is compute-bound. Design: one block per
example, so the scalar tag machine is uniform within a block and never
diverges; the conv input and output tiles (14 x 14 x 128, unpadded, plus one
zero row that out-of-range taps read) live in shared memory; weights stream
tap by tap from the 22 MB unified bank, which stays in L2. In bfloat16 at
C = 128 (the serving path) each conv is an implicit GEMM on the tensor cores
(``mma.sync`` m16n8k16, float32 accumulate), reading the bank transposed to
(tap, C_out, C_in) (``w3t``/``wcmpt`` from :func:`build_banks`); bfloat16 at
other widths raises. float32 runs float32 FMAs on the SIMT cores: the
reference that checks the kernel's arithmetic at a tight tolerance. Neither
uses ``wgmma`` or TMA yet: making it fast is later work.

The registers ``out`` and ``saved`` live in a per-example global scratch, in
the compute type. Attentions are stored broadcast over all C channels so
AND/OR min/max stay exact, as in the JAX package.

Beside the kernel: :func:`build_tables` / :func:`build_banks` (the dispatch
tables and unified weight banks, in the JAX package's slot order) and
:func:`execute_programs_plain`, the batched register machine that the kernel
is held against and that runs for CPU tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

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
MMA_CHANNELS = 128      # the tensor-core path: bf16, C == 128, H * W <= 224
MMA_MAX_PIXELS = 224
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    ``dtype``-rounded values, as the TPU kernel's bias planes did.
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
    if dtype == torch.bfloat16 and C == MMA_CHANNELS:
        # The kernel's tensor-core path reads B fragments along C_in.
        banks["w3t"] = banks["w3"].transpose(-1, -2).contiguous()
        banks["wcmpt"] = banks["wcmp"].reshape(-1, 2, C, C).transpose(-1, -2).contiguous()
    return banks


# ------------------------------------------------------------------ plain version -----
def _broadcast(attn: torch.Tensor, channels: int) -> torch.Tensor:
    r"""(n, H, W) attention -> (n, H, W, C), stored over every channel."""
    return attn[..., None].expand(*attn.shape, channels)


def execute_programs_plain(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec,
    stem_feats: torch.Tensor,
    programs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Plain PyTorch version of K2: the batched register machine of
    ``probnmn_tpu/models/nmn.py::execute_programs`` over the unified banks.

    stem_feats: (B, H, W, C) in the compute dtype; programs: (B, T) int.
    Returns (final encodings (B, H, W, C) in the compute dtype, invalid (B,)
    bool). Each step runs every module kind for the rows whose token has that
    kind; rows stop changing at their first invalid op. Values are kept
    float32 and rounded to the compute dtype where the kernel stores them.
    """
    batch, h, w, c = stem_feats.shape
    dtype = stem_feats.dtype
    device = stem_feats.device

    def rd(v):
        return as_operand(v, dtype)

    x = stem_feats.float()
    w3 = {"w": banks["w3"].float(), "b": banks["b3"]}
    cmp_bank = {"w": banks["wcmp"].float(), "b": banks["bcmp"]}
    w1, b1 = banks["w1"].float(), banks["b1"]
    tab = {k: v.to(device=device, dtype=torch.long) for k, v in tables.items()}

    out = x.clone()
    saved = torch.zeros_like(x)
    out_tag = torch.full((batch,), TAG_FEAT, dtype=torch.long, device=device)
    saved_tag = torch.full((batch,), TAG_NONE, dtype=torch.long, device=device)
    invalid = torch.zeros(batch, dtype=torch.bool, device=device)

    def chain(a, tok, dilations):
        for layer, d in enumerate(dilations):
            a = rd(torch.relu(gconv.gathered_conv3x3(a, w3, tab["slot3"][tok, layer], d)))
        return a

    def head(a, slots):
        logit = torch.einsum("nhwc,nc->nhw", a, w1[slots]) + b1[slots][:, None, None]
        return _broadcast(rd(torch.sigmoid(logit)), c)

    # Reversed prefix order (reference nmn.py:203): last token executes first.
    tokens_rev = programs.to(device=device, dtype=torch.long).flip(1)
    for t in range(tokens_rev.shape[1]):
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
            a = chain(rd(x[rows] * out[rows]), tok[rows], RELATE_DILATIONS if relate else (1, 1))
            heads = has_head[rows]
            res = a.clone()
            if heads.any():
                res[heads] = head(a[heads], tab["head_slot"][tok[rows][heads]])
            new_out[rows] = res
        rows = do_cmp.nonzero()[:, 0]
        if rows.numel():
            both = torch.cat([out[rows], saved[rows]], dim=-1)
            proj = rd(torch.relu(gconv.gathered_conv1x1(both, cmp_bank, tab["cmp_slot"][tok[rows]])))
            new_out[rows] = chain(proj, tok[rows], (1, 1))
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
                torch.einsum("nhwc,nc->nhw", xsel, banks["same_wf"].float()[ss])
                + attn * banks["same_wa"][ss][:, None, None]
                + banks["same_b"][ss][:, None, None]
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
    final = torch.where(invalid[:, None, None, None], torch.zeros_like(out), out)
    return final.to(dtype), invalid


# ------------------------------------------------------------------ kernel wrapper ----
def execute_programs_kernel(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec,
    stem_feats: torch.Tensor,
    programs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Drop-in for :func:`execute_programs_plain`: a CPU ``stem_feats`` runs the
    plain version, a CUDA one launches the kernel (and raises if it cannot).
    Program tokens must lie in the program vocabulary of ``tables``: the
    kernel indexes the tables with them unchecked."""
    device = stem_feats.device
    if device.type == "cpu":
        return execute_programs_plain(banks, tables, spec, stem_feats, programs)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    dtype = stem_feats.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported compute dtype {dtype}")
    batch, h, w, c = stem_feats.shape
    if dtype == torch.bfloat16:
        if c != MMA_CHANNELS or h * w > MMA_MAX_PIXELS or "w3t" not in banks:
            raise ValueError(
                f"bfloat16 runs on the tensor cores only: it needs C={MMA_CHANNELS}, "
                f"H*W <= {MMA_MAX_PIXELS} and banks from build_banks; got C={c}, H*W={h * w}")
    elif c % 4 or 256 % (c // 4):
        raise ValueError(f"the float32 kernel needs C/4 to divide 256; got C={c}")
    if programs.dim() != 2 or programs.shape[0] != batch:
        raise ValueError(f"programs must be ({batch}, T), got {tuple(programs.shape)}")
    for name in ("w3", "w1", "same_wf", "wcmp"):
        if banks[name].dtype != dtype or banks[name].device != device:
            raise ValueError(f"bank {name} must be {dtype} on {device}")
        if banks[name].shape[-1] != c:
            raise ValueError(f"bank {name} has {banks[name].shape[-1]} channels, features {c}")
    stem_feats = stem_feats.contiguous()
    progs = programs.to(device=device, dtype=torch.int32).contiguous()
    tab = {k: v.to(device=device, dtype=torch.int32).contiguous() for k, v in tables.items()}
    use_mma = dtype == torch.bfloat16
    out = torch.empty_like(stem_feats)
    saved = torch.empty_like(stem_feats)
    invalid = torch.empty(batch, dtype=torch.int32, device=device)
    code = _build.library().probnmn_nmn_interpret(
        _DTYPE_CODES[dtype],
        progs.data_ptr(), batch, progs.shape[1],
        tab["kind"].data_ptr(), tab["slot3"].data_ptr(), tab["head_slot"].data_ptr(),
        tab["cmp_slot"].data_ptr(), tab["same_slot"].data_ptr(),
        stem_feats.data_ptr(),
        banks["w3"].data_ptr(), banks["w3t"].data_ptr() if use_mma else None,
        banks["b3"].data_ptr(),
        banks["w1"].data_ptr(), banks["b1"].data_ptr(),
        banks["same_wf"].data_ptr(), banks["same_wa"].data_ptr(), banks["same_b"].data_ptr(),
        banks["wcmp"].data_ptr(), banks["wcmpt"].data_ptr() if use_mma else None,
        banks["bcmp"].data_ptr(),
        out.data_ptr(), saved.data_ptr(), invalid.data_ptr(),
        h, w, c,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "NMN interpreter kernel")
    execute_programs_kernel.launches += 1
    return out, invalid.bool()


execute_programs_kernel.launches = 0
