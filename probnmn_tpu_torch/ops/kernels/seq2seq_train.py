r"""
The training kernels of the seq2seq models, each pair bound into one
``torch.autograd.Function``:

- K3f and K3b (``probnmn_tpu_torch/csrc/lm_train.cu``), the ProgramPrior LM
  loss and its backward, behind :func:`fused_lm_loss`. They replace
  ``probnmn_tpu/ops/pallas/seq2seq_train.py::_lm_forward_kernel`` and
  ``::_lm_backward_kernel`` (the custom VJP ``fused_lm_loss``).
- K4f and K4b (``probnmn_tpu_torch/csrc/tf_train.cu``), the teacher-forced
  attentive seq2seq loss and its backward, behind :func:`fused_tf_loss`.
  They replace ``::_tf_forward_kernel`` and ``::_tf_backward_kernel`` (the
  custom VJP ``fused_tf_loss``), in both of its modes: the masked sequence
  cross entropy, and REINFORCE (the length-normalized -log q(z|x) of a
  trimmed sampled z).

Each forward kernel computes the per-example loss, and each backward kernel
the gradient of ``sum(dloss * loss)`` with respect to every parameter. K3b
replays the forward, keeping every step's states and gates in a workspace
taken from the caching allocator; K4b starts from the residuals K4f kept
(:class:`TFResiduals`), which :func:`fused_tf_kernels` asks for exactly when
a gradient will be taken. Each LSTM layer's recurrence (K3f's, K3b's replay,
K4f's encoder, and K4b's encoder backward) is one cluster-resident launch a
layer up to H = 256 (:func:`tf_sweep_plan`). All run in float32 on the SIMT
cores, as the JAX trainers do; the sources say how the work is laid out and
what bounds it.

Inter-layer dropout (a training pass of a config with ``DROPOUT > 0``):
each entry takes the encoder's keep masks, ``dropout_masks`` (L-1, B, T, H),
as the plain versions do (``ops/rnn.py``). The kernels drop each layer's
output below the top in place before the layer above reads it, and scale
the gradient reaching it alike in the backward; K3b's replay and K4b's
residuals see the same mask as the forward. Without masks nothing more is
launched and the bits are those of a build without dropout.

CPU tokens run the plain versions (:func:`lm_loss_plain`,
:func:`tf_loss_plain`, and autograd through them); CUDA tokens launch the
kernels or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from probnmn_tpu_torch.models.program_prior import ProgramPriorSpec, program_prior_loss
from probnmn_tpu_torch.models.seq2seq import (
    GREEDY,
    Seq2SeqSpec,
    _encode,
    seq2seq_forward,
    teacher_forced_logits,
)
from probnmn_tpu_torch.ops.common import (
    add_boundary,
    length_normalized_logprob_loss,
    masked_softmax,
    sequence_cross_entropy,
)
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.rnn import keep_bytes

_LEAF_NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")


def lm_loss_plain(
    params: Dict[str, Any], spec: ProgramPriorSpec, tokens: torch.Tensor,
    dropout_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Plain PyTorch version of K3f: ``program_prior_forward``'s loss, with
    the inter-layer ``dropout_masks`` (L-1, B, Lt + 2, H) of a training pass."""
    return program_prior_loss(params, spec, tokens, dropout_masks)


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    r"""The params in one fixed order: embedding, projection, then each
    layer's w_ih, w_hh, b_ih, b_hh."""
    leaves = [params["embedding"], params["projection"]]
    for layer in params["encoder"]:
        leaves += [layer[name] for name in _LEAF_NAMES]
    return leaves


def params_from_leaves(leaves: List[torch.Tensor]) -> Dict[str, Any]:
    encoder = [dict(zip(_LEAF_NAMES, leaves[i:i + 4])) for i in range(2, len(leaves), 4)]
    return {"embedding": leaves[0], "projection": leaves[1], "encoder": encoder}


def lm_grads_plain(
    params: Dict[str, Any], spec: ProgramPriorSpec, tokens: torch.Tensor, dloss: torch.Tensor,
    dropout_masks: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    r"""Plain PyTorch version of K3b: ``torch.autograd.grad`` of the plain
    loss, weighted by the per-example cotangent ``dloss``."""
    leaves = [p.detach().requires_grad_(True) for p in param_leaves(params)]
    with torch.enable_grad():
        loss = lm_loss_plain(params_from_leaves(leaves), spec, tokens, dropout_masks)
        grads = torch.autograd.grad(loss, leaves, grad_outputs=dloss)
    return params_from_leaves(list(grads))


def pack_lm_weights(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    r"""The kernels' weight layout: the layers' w_ih one after another (flat),
    w_hh stacked (L, 4H, H), biases summed (L, 4H); float32, contiguous."""
    def f32(t):
        return t.detach().to(torch.float32).contiguous()

    enc = params["encoder"]
    return {
        "emb": f32(params["embedding"]),
        "proj": f32(params["projection"]),
        "w_ih": torch.cat([f32(p["w_ih"]).reshape(-1) for p in enc]),
        "w_hh": torch.stack([f32(p["w_hh"]) for p in enc]),
        "bias": torch.stack([f32(p["b_ih"] + p["b_hh"]) for p in enc]),
    }


def _kernel_args(packed: Dict[str, torch.Tensor], spec: ProgramPriorSpec, tokens: torch.Tensor):
    r"""Validate the kernels' inputs; returns the int32 tokens and the sizes."""
    if tokens.device.type != "cuda" or tokens.dim() != 2:
        raise ValueError(f"tokens must be a (B, Lt) CUDA tensor, got {tuple(tokens.shape)} "
                         f"on {tokens.device}")
    V, D, H, L = spec.vocab_size, spec.input_size, spec.hidden_size, spec.num_layers
    want = {"emb": (V, D), "proj": (D, H), "w_ih": (4 * H * (D + (L - 1) * H),),
            "w_hh": (L, 4 * H, H), "bias": (L, 4 * H)}
    for name, shape in want.items():
        t = packed[name]
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != tokens.device:
            raise ValueError(f"{name}: want float32 {shape} on {tokens.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return tokens.to(torch.int32).contiguous(), (V, D, H, L)


def _dropout_args(keep: Optional[torch.Tensor], dropout: float) -> Tuple:
    r"""The kernels' three dropout arguments: the keep bytes' pointer (None:
    no dropout), their steps and the scale 1 / (1 - p)."""
    if keep is None:
        return None, 0, 1.0
    return keep.data_ptr(), keep.shape[2], 1.0 / (1.0 - dropout)


def _lm_keep(spec: ProgramPriorSpec, tok: torch.Tensor, dropout_masks) -> Optional[torch.Tensor]:
    batch, lt = tok.shape
    return keep_bytes(dropout_masks, spec.num_layers, batch, lt + 1, spec.hidden_size, tok.device)


def _workspace(batch: int, lt: int, sizes, backward: bool, device) -> torch.Tensor:
    V, D, H, L = sizes
    n = _build.library().probnmn_lm_workspace_floats(batch, lt, D, H, L, V, int(backward))
    return torch.empty(n, dtype=torch.float32, device=device)


def lm_forward_cuda(
    packed: Dict[str, torch.Tensor], spec: ProgramPriorSpec, tokens: torch.Tensor,
    dropout_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Launch K3f: per-example loss (B,) float32; ``dropout_masks`` (L-1, B,
    >= Lt + 1, H) on the card: the LM's inter-layer dropout at
    ``spec.dropout``."""
    tok, sizes = _kernel_args(packed, spec, tokens)
    keep = _lm_keep(spec, tok, dropout_masks)
    batch, lt = tok.shape
    ws = _workspace(batch, lt, sizes, False, tok.device)
    loss = torch.empty(batch, dtype=torch.float32, device=tok.device)
    p = packed
    code = _build.library().probnmn_lm_forward(
        tok.data_ptr(), batch, lt, p["emb"].data_ptr(), p["proj"].data_ptr(),
        p["w_ih"].data_ptr(), p["w_hh"].data_ptr(), p["bias"].data_ptr(),
        ws.data_ptr(), loss.data_ptr(), *_dropout_args(keep, spec.dropout), *sizes,
        spec.pad_index, spec.start_index, spec.end_index,
        torch.cuda.current_stream(tok.device).cuda_stream,
    )
    _build.check(code, "LM forward kernel")
    lm_forward_cuda.launches += 1
    return loss


lm_forward_cuda.launches = 0


def lm_backward_cuda(
    packed: Dict[str, torch.Tensor], spec: ProgramPriorSpec, tokens: torch.Tensor,
    dloss: torch.Tensor, dropout_masks: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    r"""Launch K3b: the gradient of ``sum(dloss * loss)`` as a params dict
    (``b_ih`` and ``b_hh`` get equal gradients, as separate tensors). Its
    replay of the forward takes ``dropout_masks``, the ones K3f took."""
    tok, sizes = _kernel_args(packed, spec, tokens)
    keep = _lm_keep(spec, tok, dropout_masks)
    batch, lt = tok.shape
    if tuple(dloss.shape) != (batch,):
        raise ValueError(f"dloss must be ({batch},), got {tuple(dloss.shape)}")
    dloss = dloss.to(device=tok.device, dtype=torch.float32).contiguous()
    V, D, H, L = sizes
    ws = _workspace(batch, lt, sizes, True, tok.device)
    grads = {name: torch.empty_like(t) for name, t in packed.items()}
    g = grads
    code = _build.library().probnmn_lm_backward(
        tok.data_ptr(), batch, lt, packed["emb"].data_ptr(), packed["proj"].data_ptr(),
        packed["w_ih"].data_ptr(), packed["w_hh"].data_ptr(), packed["bias"].data_ptr(),
        dloss.data_ptr(), ws.data_ptr(),
        g["emb"].data_ptr(), g["proj"].data_ptr(), g["w_ih"].data_ptr(),
        g["w_hh"].data_ptr(), g["bias"].data_ptr(), *_dropout_args(keep, spec.dropout), *sizes,
        spec.pad_index, spec.start_index, spec.end_index,
        torch.cuda.current_stream(tok.device).cuda_stream,
    )
    _build.check(code, "LM backward kernel")
    lm_backward_cuda.launches += 1
    encoder, offset = [], 0
    for layer in range(L):
        din = D if layer == 0 else H
        encoder.append({
            "w_ih": g["w_ih"][offset:offset + 4 * H * din].view(4 * H, din),
            "w_hh": g["w_hh"][layer],
            "b_ih": g["bias"][layer],
            "b_hh": g["bias"][layer].clone(),
        })
        offset += 4 * H * din
    return {"embedding": g["emb"], "projection": g["proj"], "encoder": encoder}


lm_backward_cuda.launches = 0


class _FusedLMLoss(torch.autograd.Function):
    r"""Forward: K3f. Backward: K3b with the incoming per-example cotangent
    (and the forward's dropout masks)."""

    @staticmethod
    def forward(ctx, spec, tokens, dropout_masks, *leaves):
        packed = pack_lm_weights(params_from_leaves(list(leaves)))
        ctx.spec = spec
        ctx.packed = packed
        ctx.tokens = tokens
        ctx.dropout_masks = dropout_masks
        return lm_forward_cuda(packed, spec, tokens, dropout_masks)

    @staticmethod
    def backward(ctx, dloss):
        grads = lm_backward_cuda(ctx.packed, ctx.spec, ctx.tokens, dloss, ctx.dropout_masks)
        return (None, None, None, *param_leaves(grads))


def fused_lm_loss(
    params: Dict[str, Any], spec: ProgramPriorSpec, tokens: torch.Tensor,
    dropout_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Per-example ProgramPrior LM cross entropy (B,), differentiable with
    respect to every parameter; the tied embedding's gradient sums its
    output-layer and input-lookup parts. Equals ``program_prior_forward``'s
    loss; with ``dropout_masks`` (L-1, B, Lt + 2, H), its ``train=True``
    loss under those masks. CPU tokens: plain version; CUDA tokens: K3f, and
    K3b in backward."""
    if tokens.device.type == "cpu":
        return lm_loss_plain(params, spec, tokens, dropout_masks)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    return _FusedLMLoss.apply(spec, tokens, dropout_masks, *param_leaves(params))


# ============================================================ K4: teacher-forced seq2seq
_CUDA_ERROR_INVALID_VALUE = 1
TF_MAX_SOURCE = 4095  # source tokens the attention kernels take (tf_train.cu kMaxSource - 1)
_TF_PACKED = ("src_emb", "tgt_emb", "enc_wih", "enc_whh", "enc_bias",
              "dec_w", "dec_wx", "dec_bias", "proj_w", "proj_b")


def _tf_step_inputs(spec: Seq2SeqSpec, target_tokens: torch.Tensor, reinforce_norm: bool):
    r"""The decoder's step inputs and labels, as tf_loss_plain feeds them."""
    if reinforce_norm:
        start = torch.full_like(target_tokens[:, :1], spec.start_index)
        return torch.cat([start, target_tokens[:, :-1]], dim=1), target_tokens
    targets = add_boundary(target_tokens, spec.pad_index, spec.start_index, spec.end_index)
    return targets[:, :-1], targets[:, 1:]


def tf_loss_plain(
    params: Dict[str, Any], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, reinforce_norm: bool = False,
    dropout_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Plain PyTorch version of K4f: the per-example teacher-forced loss (B,).

    Cross-entropy mode: ``seq2seq_forward(..., target_tokens=...)``'s loss,
    the masked mean CE over the targets with @end@ appended (eps 1e-13).
    REINFORCE mode: ``target_tokens`` is a trimmed sampled z, fed as
    ``[start, z[:-1]]``; the loss is the length-normalized negative logprob
    of z's tokens (eps 1e-12), the free-running loss at that z.
    ``dropout_masks`` (L-1, B, Ls + 1, H): the encoder's inter-layer dropout
    of a training pass."""
    if not reinforce_norm:
        return seq2seq_forward(params, spec, source_tokens, GREEDY,
                               target_tokens=target_tokens, dropout_masks=dropout_masks)["loss"]
    step_inputs, _ = _tf_step_inputs(spec, target_tokens, True)
    logits = teacher_forced_logits(params, spec, source_tokens, step_inputs, dropout_masks)
    logprobs = torch.log_softmax(logits, dim=-1).gather(-1, target_tokens[..., None])[..., 0]
    return length_normalized_logprob_loss(logprobs, target_tokens, spec.pad_index)


def tf_param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    r"""The seq2seq params in one fixed order: the two embeddings, each
    encoder layer's w_ih, w_hh, b_ih, b_hh, the decoder cell's, then the
    output projection's w and b."""
    leaves = [params["source_embedding"], params["target_embedding"]]
    for layer in params["encoder"]:
        leaves += [layer[name] for name in _LEAF_NAMES]
    leaves += [params["decoder_cell"][name] for name in _LEAF_NAMES]
    return leaves + [params["output_projection"]["w"], params["output_projection"]["b"]]


def tf_params_from_leaves(leaves: List[torch.Tensor]) -> Dict[str, Any]:
    encoder = [dict(zip(_LEAF_NAMES, leaves[i:i + 4])) for i in range(2, len(leaves) - 6, 4)]
    return {
        "source_embedding": leaves[0], "target_embedding": leaves[1], "encoder": encoder,
        "decoder_cell": dict(zip(_LEAF_NAMES, leaves[-6:-2])),
        "output_projection": {"w": leaves[-2], "b": leaves[-1]},
    }


def tf_grads_plain(
    params: Dict[str, Any], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, dloss: torch.Tensor, reinforce_norm: bool = False,
    dropout_masks: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    r"""Plain PyTorch version of K4b: ``torch.autograd.grad`` of the plain
    loss, weighted by the per-example cotangent ``dloss``."""
    leaves = [p.detach().requires_grad_(True) for p in tf_param_leaves(params)]
    with torch.enable_grad():
        loss = tf_loss_plain(tf_params_from_leaves(leaves), spec, source_tokens, target_tokens,
                             reinforce_norm, dropout_masks)
        grads = torch.autograd.grad(loss, leaves, grad_outputs=dloss)
    return tf_params_from_leaves(list(grads))


def pack_tf_weights(params: Dict[str, Any], spec: Seq2SeqSpec) -> Dict[str, torch.Tensor]:
    r"""K4's weight layout, float32 and contiguous: the encoder as K3's (w_ih
    flat, w_hh stacked, biases summed); the decoder cell's w_ih split into
    its attended half, set beside w_hh as ``dec_w`` (4H, 2H) for the
    recurrent product over [attended, h_prev], and its embedded half
    ``dec_wx`` (4H, D); the projection as it is."""
    def f32(t):
        return t.detach().to(torch.float32).contiguous()

    H = spec.hidden_size
    enc = params["encoder"]
    cell = params["decoder_cell"]
    w_ih = f32(cell["w_ih"])
    return {
        "src_emb": f32(params["source_embedding"]),
        "tgt_emb": f32(params["target_embedding"]),
        "enc_wih": torch.cat([f32(p["w_ih"]).reshape(-1) for p in enc]),
        "enc_whh": torch.stack([f32(p["w_hh"]) for p in enc]),
        "enc_bias": torch.stack([f32(p["b_ih"] + p["b_hh"]) for p in enc]),
        "dec_w": torch.cat([w_ih[:, :H], f32(cell["w_hh"])], dim=1).contiguous(),
        "dec_wx": w_ih[:, H:].contiguous(),
        "dec_bias": f32(cell["b_ih"] + cell["b_hh"]),
        "proj_w": f32(params["output_projection"]["w"]),
        "proj_b": f32(params["output_projection"]["b"]),
    }


def _tf_kernel_args(packed, spec: Seq2SeqSpec, source_tokens, target_tokens):
    r"""Validate K4's inputs; returns the int32 tokens and the sizes."""
    for name, tok in (("source_tokens", source_tokens), ("target_tokens", target_tokens)):
        if tok.device.type != "cuda" or tok.dim() != 2:
            raise ValueError(f"{name} must be a (B, L) CUDA tensor, got {tuple(tok.shape)} on "
                             f"{tok.device}")
    batch, ls = source_tokens.shape
    lt = target_tokens.shape[1]
    if target_tokens.shape[0] != batch or batch == 0 or lt == 0 or not 0 < ls <= TF_MAX_SOURCE:
        raise ValueError(f"K4 takes B >= 1, 1 <= Ls <= {TF_MAX_SOURCE} and Lt >= 1; got source "
                         f"{tuple(source_tokens.shape)}, target {tuple(target_tokens.shape)}")
    D, H, L = spec.input_size, spec.hidden_size, spec.num_layers
    Vs, Vt = spec.source_vocab_size, spec.target_vocab_size
    want = {"src_emb": (Vs, D), "tgt_emb": (Vt, D), "enc_wih": (4 * H * (D + (L - 1) * H),),
            "enc_whh": (L, 4 * H, H), "enc_bias": (L, 4 * H), "dec_w": (4 * H, 2 * H),
            "dec_wx": (4 * H, D), "dec_bias": (4 * H,), "proj_w": (Vt, H), "proj_b": (Vt,)}
    for name, shape in want.items():
        t = packed[name]
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != source_tokens.device:
            raise ValueError(f"{name}: want float32 {shape} on {source_tokens.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    src = source_tokens.to(torch.int32).contiguous()
    tgt = target_tokens.to(device=src.device, dtype=torch.int32).contiguous()
    return src, tgt, (D, H, L, Vs, Vt)


def _tf_call_args(spec: Seq2SeqSpec, sizes, reinforce_norm: bool, device):
    return (*sizes, int(bool(reinforce_norm)), spec.pad_index, spec.start_index, spec.end_index,
            torch.cuda.current_stream(device).cuda_stream)


def tf_sweep_plan(batch: int, hidden: int, forward: bool = False) -> Dict[str, int]:
    r"""How a layer of ``batch`` rows and ``hidden`` units is swept on this
    card (``csrc/lstm_sweep.cuh``): back, as K4b sweeps an encoder layer, or
    with ``forward``, as K4f's encoder, K3f and K3b's replay run a layer.
    The cluster size, the units, rows and threads of a CTA, the clusters, how
    many clusters the card runs at once, the shared memory of a CTA in bytes
    and the registers of a thread. Raises where no cluster holds the layer
    (above H = 256, where the forward takes one launch a step)."""
    out = (ctypes.c_int * 8)()
    what = "forward" if forward else "reverse"
    _build.check(_build.library().probnmn_tf_sweep_plan(batch, hidden, int(bool(forward)), out),
                 f"the {what} layer sweep at B={batch}, H={hidden}")
    keys = ("cluster", "units", "rows", "threads", "clusters", "fit", "smem_bytes", "registers")
    return dict(zip(keys, out))


# K4's decoder sweeps (csrc/tf_decoder_sweep.cuh): the constants their plans
# use, mirrored for the plans' twin.
DEC_THREADS = 256        # kDecThreads
DEC_MAX_UNITS = 16       # kDecMaxUnits
DEC_MAX_CLUSTER = 16     # kDecMaxCluster
DEC_FWD_MAX_ROWS = 64    # kDecFwdMaxRows
DEC_MAX_OWN = 4          # kDecMaxOwn
DEC_BWD_MAX_RPT = 16     # kDecBwdMaxRpt
SWEEP_MAX_SMEM = 232448  # kSweepMaxSmem: the H100's shared memory a block can use
_PLAN_KEYS = ("cluster", "units", "rows", "threads", "clusters", "fit", "smem_bytes", "registers")


def tf_decoder_plan(batch: int, source_len: int, hidden: int,
                    forward: bool = False) -> Dict[str, int]:
    r"""How K4's decoder is swept on this card (``csrc/tf_decoder_sweep.cuh``)
    for ``batch`` rows of ``hidden`` units over a source of ``source_len``
    tokens: forward, as K4f runs it, or in reverse, as K4b. The keys of
    :func:`tf_sweep_plan`. Raises above H = 256, where no cluster holds the
    cell (K4f then takes two launches a step, and K4b refuses)."""
    out = (ctypes.c_int * 8)()
    what = "forward" if forward else "reverse"
    _build.check(_build.library().probnmn_tf_decoder_plan(batch, source_len, hidden,
                                                          int(bool(forward)), out),
                 f"the decoder's {what} sweep at B={batch}, H={hidden}")
    return dict(zip(_PLAN_KEYS, out))


def decoder_sweep_holds(hidden: int) -> bool:
    r"""Whether a cluster holds the decoder cell (``dec_sweep_holds``): K4f's
    route, decided from H before any launch."""
    return 0 < hidden <= DEC_MAX_CLUSTER * DEC_MAX_UNITS


def _depth(hidden: int) -> int:
    return (hidden + 3) // 4 * 4  # fwd_depth


def decoder_sweep_smem(hidden: int, source_len: int, rows: int, forward: bool) -> int:
    r"""A decoder sweep CTA's shared memory in bytes for ``rows`` rows a
    cluster (``dec_fwd_smem_bytes`` / ``dec_bwd_smem_bytes``)."""
    n, units = _decoder_cluster(hidden)
    hp, sp = _depth(hidden), (source_len + 1 + 3) // 4 * 4
    own = -(-rows // n)
    weights = 4 * units * (2 * hp + 4)
    if forward:
        return 4 * (weights + 3 * rows * (hp + 4) + own * sp)
    return 4 * (weights + 4 * rows * units + own * n * 2 * hp + own * 8 * hp + 3 * own * sp
                + (own + 3) // 4 * 4)


def _decoder_cluster(hidden: int) -> Tuple[int, int]:
    n = 1
    while -(-hidden // n) > DEC_MAX_UNITS:
        n *= 2
    return n, (-(-hidden // n) + 3) // 4 * 4


def decoder_row_cap(hidden: int, forward: bool) -> int:
    r"""Rows a decoder sweep cluster owns at most (``dec_row_cap``)."""
    n, _ = _decoder_cluster(hidden)
    sets = DEC_THREADS // (_depth(hidden) // 2)
    return min(DEC_MAX_OWN * n, DEC_FWD_MAX_ROWS if forward else DEC_BWD_MAX_RPT * sets)


def tf_decoder_plan_twin(batch: int, source_len: int, hidden: int, forward: bool,
                         fit: int) -> Dict[str, int]:
    r"""What :func:`tf_decoder_plan` computes without the card, given ``fit``,
    the clusters the card runs at once at the widest shared memory: the
    cluster size and units, the largest rows a cluster that shared memory
    holds (``r_max``), then the fewest rows that run every cluster at once,
    up to ``r_max``. Raises above H = 256."""
    if not decoder_sweep_holds(hidden):
        raise ValueError(f"no cluster holds a decoder cell of {hidden} units (H > 256)")
    n, units = _decoder_cluster(hidden)
    r_max = decoder_row_cap(hidden, forward)
    while r_max > 0 and decoder_sweep_smem(hidden, source_len, r_max, forward) > SWEEP_MAX_SMEM:
        r_max -= 1
    if r_max == 0:
        raise ValueError("not one row of the decoder sweep fits in shared memory")
    rows = min(-(-batch // fit), r_max)
    return {"cluster": n, "units": units, "rows": rows, "threads": DEC_THREADS,
            "clusters": -(-batch // rows), "fit": fit,
            "smem_bytes": decoder_sweep_smem(hidden, source_len, rows, forward), "r_max": r_max}


def _tf_head_loss(params, spec: Seq2SeqSpec, h_out: torch.Tensor, labels: torch.Tensor,
                  reinforce_norm: bool) -> torch.Tensor:
    r"""The per-example loss of the decoder's outputs ``h_out`` (B, T, H)."""
    proj = params["output_projection"]
    logits = h_out @ proj["w"].T + proj["b"]
    if reinforce_norm:
        logprobs = torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
        return length_normalized_logprob_loss(logprobs, labels, spec.pad_index)
    return sequence_cross_entropy(logits, labels, labels != spec.pad_index)


def tf_decoder_reverse_plain(
    params: Dict[str, Any], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, dloss: torch.Tensor, reinforce_norm: bool = False,
    dropout_masks: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    r"""Plain version of K4b's decoder reverse sweep, step by step as the JAX
    kernel's ``dec_bwd`` writes it, in the dtype of ``params`` (float64 for
    the card's check of the reverse sweep). The forward is the plain one
    (the encoder, then the attentive decoder cell step by step); the head's
    gradient reaching each step's h, ``dh_head``, comes from autograd
    through the projection and the loss under the cotangent ``dloss``.

    Returns, with T steps, S = Ls + 1 source positions: ``dpre`` (B, T, 4H),
    the gradient of each step's gate pre-activations; ``dcat`` (B, T, 2H),
    the gradient reaching [attended, h_prev]; ``ds`` (B, T, S), that of the
    attention scores; ``dh`` (B, T + 1, H), the gradient reaching each
    step's h_prev (``dh[:, 0]`` reaches the initial h, the top encoder
    layer's final state); ``denc`` (B, S, H), the attention's gradient of the
    encoder outputs; and the decoder cell's gradients ``w_ih`` (4H, H + D),
    ``w_hh`` (4H, H), ``b`` (4H,) (b_ih's and b_hh's alike)."""
    H = spec.hidden_size
    step_inputs, labels = _tf_step_inputs(spec, target_tokens, reinforce_norm)
    with torch.no_grad():
        enc, src_mask, h, c = _encode(params, spec, source_tokens, dropout_masks=dropout_masks)
        cell = params["decoder_cell"]
        emb = params["target_embedding"][step_inputs]  # (B, T, D)
        bias = cell["b_ih"] + cell["b_hh"]
        hs, cs, gates, weights, cats = [h], [], [], [], []
        for t in range(step_inputs.shape[1]):
            w = masked_softmax(torch.einsum("bsh,bh->bs", enc, h), src_mask)
            att = torch.einsum("bs,bsh->bh", w, enc)
            pre = torch.cat([att, emb[:, t]], -1) @ cell["w_ih"].T + h @ cell["w_hh"].T + bias
            i, f, g, o = pre.split(H, -1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
            c = f * (cs[-1] if cs else torch.zeros_like(h)) + i * g
            cats.append(torch.cat([att, h], -1))
            h = o * torch.tanh(c)
            hs.append(h)
            cs.append(c)
            gates.append((i, f, g, o))
            weights.append(w)
    h_out = torch.stack(hs[1:], 1).requires_grad_(True)
    with torch.enable_grad():
        loss = _tf_head_loss(params, spec, h_out, labels, reinforce_norm)
        dh_head, = torch.autograd.grad(loss, h_out, grad_outputs=dloss.to(loss.dtype))

    dec_w = torch.cat([cell["w_ih"][:, :H], cell["w_hh"]], 1)  # (4H, 2H)
    T = len(gates)
    dh, dc = torch.zeros_like(h), torch.zeros_like(h)
    denc = torch.zeros_like(enc)
    dpres, dcats, dss, dhs = [None] * T, [None] * T, [None] * T, [None] * (T + 1)
    for t in reversed(range(T)):
        i, f, g, o = gates[t]
        dh = dh + dh_head[:, t]
        c_prev = cs[t - 1] if t > 0 else torch.zeros_like(h)
        tc = torch.tanh(cs[t])
        do = dh * tc
        dc_t = dc + dh * o * (1.0 - tc * tc)
        dpre = torch.cat([dc_t * g * i * (1.0 - i), dc_t * c_prev * f * (1.0 - f),
                          dc_t * i * (1.0 - g * g), do * o * (1.0 - o)], -1)
        dcat = dpre @ dec_w
        datt = dcat[:, :H]
        w = weights[t]
        wdw = w * torch.einsum("bsh,bh->bs", enc, datt)
        ds = wdw - w * wdw.sum(-1, keepdim=True)
        dh = dcat[:, H:] + torch.einsum("bs,bsh->bh", ds, enc)
        denc = denc + ds[..., None] * hs[t][:, None] + w[..., None] * datt[:, None]
        dc = dc_t * f
        dpres[t], dcats[t], dss[t], dhs[t] = dpre, dcat, ds, dh
    dhs[T] = dh_head[:, T - 1]
    dpre_all = torch.stack(dpres, 1)
    cat_all = torch.stack(cats, 1)
    x_all = torch.cat([cat_all[..., :H], emb], -1)  # [attended, embedded]
    return {
        "dpre": dpre_all, "dcat": torch.stack(dcats, 1), "ds": torch.stack(dss, 1),
        "dh": torch.stack(dhs, 1), "denc": denc,
        "w_ih": torch.einsum("btg,btk->gk", dpre_all, x_all),
        "w_hh": torch.einsum("btg,btk->gk", dpre_all, cat_all[..., H:]),
        "b": dpre_all.sum((0, 1)),
    }


@dataclasses.dataclass
class TFResiduals:
    r"""What K4f keeps for K4b (``tf_forward_cuda(..., keep=True)``): its
    workspace in the residual layout (every encoder layer's gates, h, c and
    y; every decoder step's [attended, h_prev] row, attention weights,
    gates, h and c; the logits; the token streams), with the packed weights
    and the sizes K4b needs. K4b consumes the workspace in place (dpre over
    the gates, dlogits over the logits) and lets it go, so one forward
    serves one backward."""

    workspace: Optional[torch.Tensor]
    packed: Optional[Dict[str, torch.Tensor]]
    spec: Seq2SeqSpec
    shape: Tuple[int, int, int]  # (B, Ls, Lt)
    sizes: Tuple[int, ...]  # (D, H, L, Vs, Vt)
    reinforce_norm: bool
    keep: Optional[torch.Tensor] = None  # the dropout mask K4f took (bytes), or None

    @property
    def nbytes(self) -> int:
        r"""Bytes held from forward to backward (0 once consumed)."""
        return 0 if self.workspace is None else self.workspace.numel() * 4


def tf_forward_cuda(
    packed: Dict[str, torch.Tensor], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, reinforce_norm: bool = False, keep: bool = False,
    dropout_masks: Optional[torch.Tensor] = None,
):
    r"""Launch K4f: the per-example loss (B,) float32; with ``keep``,
    ``(loss, residuals)``, the :class:`TFResiduals` K4b starts from.
    ``dropout_masks`` (L-1, B, >= Ls + 1, H) on the card: the encoder's
    inter-layer dropout at ``spec.dropout``."""
    src, tgt, sizes = _tf_kernel_args(packed, spec, source_tokens, target_tokens)
    (batch, ls), lt = src.shape, tgt.shape[1]
    kept = keep_bytes(dropout_masks, spec.num_layers, batch, ls + 1, spec.hidden_size,
                      src.device)
    n = _build.library().probnmn_tf_workspace_floats(batch, ls, lt, *sizes,
                                                     int(bool(reinforce_norm)), int(bool(keep)))
    ws = torch.empty(n, dtype=torch.float32, device=src.device)
    loss = torch.empty(batch, dtype=torch.float32, device=src.device)
    code = _build.library().probnmn_tf_forward(
        src.data_ptr(), tgt.data_ptr(), batch, ls, lt,
        _build.pointers([packed[name] for name in _TF_PACKED]),
        ws.data_ptr(), loss.data_ptr(), int(bool(keep)), *_dropout_args(kept, spec.dropout),
        *_tf_call_args(spec, sizes, reinforce_norm, src.device),
    )
    _build.check(code, "teacher-forced forward kernel")
    tf_forward_cuda.launches += 1
    if not keep:
        return loss
    return loss, TFResiduals(ws, packed, spec, (batch, ls, lt), sizes, bool(reinforce_norm), kept)


tf_forward_cuda.launches = 0


def tf_backward_cuda(residuals: TFResiduals, dloss: torch.Tensor) -> Dict[str, Any]:
    r"""Launch K4b from K4f's ``residuals``, which it consumes: the gradient
    of ``sum(dloss * loss)`` as a params dict (``b_ih`` and ``b_hh`` get
    equal gradients, as separate tensors). Raises on residuals already
    consumed."""
    if residuals.workspace is None:
        raise RuntimeError(
            "K4b has already consumed these residuals: it overwrites K4f's gates and logits "
            "with their gradients and frees them, so each forward serves one backward")
    ws, residuals.workspace = residuals.workspace, None
    packed, spec, sizes = residuals.packed, residuals.spec, residuals.sizes
    batch, ls, lt = residuals.shape
    if tuple(dloss.shape) != (batch,):
        raise ValueError(f"dloss must be ({batch},), got {tuple(dloss.shape)}")
    dloss = dloss.to(device=ws.device, dtype=torch.float32).contiguous()
    flag = int(residuals.reinforce_norm)
    scratch = torch.empty(_build.library().probnmn_tf_scratch_floats(batch, ls, lt, *sizes, flag),
                          dtype=torch.float32, device=ws.device)
    g = {name: torch.empty_like(packed[name]) for name in _TF_PACKED}
    code = _build.library().probnmn_tf_backward(
        batch, ls, lt, _build.pointers([packed[name] for name in _TF_PACKED]),
        dloss.data_ptr(), ws.data_ptr(), scratch.data_ptr(),
        _build.pointers([g[name] for name in _TF_PACKED]),
        *_dropout_args(residuals.keep, spec.dropout),
        *_tf_call_args(spec, sizes, residuals.reinforce_norm, ws.device),
    )
    if code == _CUDA_ERROR_INVALID_VALUE:
        raise RuntimeError(
            f"teacher-forced backward kernel: cudaErrorInvalidValue at B={batch}, H={sizes[1]}: "
            f"no thread-block cluster holds the decoder's and the encoder's reverse sweeps "
            f"above H = 256")
    _build.check(code, "teacher-forced backward kernel")
    tf_backward_cuda.launches += 1
    residuals.packed = residuals.keep = None
    D, H, L = sizes[:3]
    encoder, offset = [], 0
    for layer in range(L):
        din = D if layer == 0 else H
        encoder.append({
            "w_ih": g["enc_wih"][offset:offset + 4 * H * din].view(4 * H, din),
            "w_hh": g["enc_whh"][layer],
            "b_ih": g["enc_bias"][layer],
            "b_hh": g["enc_bias"][layer].clone(),
        })
        offset += 4 * H * din
    return {
        "source_embedding": g["src_emb"],
        "target_embedding": g["tgt_emb"],
        "encoder": encoder,
        "decoder_cell": {
            "w_ih": torch.cat([g["dec_w"][:, :H], g["dec_wx"]], dim=1),
            "w_hh": g["dec_w"][:, H:].contiguous(),
            "b_ih": g["dec_bias"],
            "b_hh": g["dec_bias"].clone(),
        },
        "output_projection": {"w": g["proj_w"], "b": g["proj_b"]},
    }


tf_backward_cuda.launches = 0


class _FusedTFLoss(torch.autograd.Function):
    r"""Forward: K4f (with the encoder's dropout masks, or None), keeping its
    residuals when ``keep``. Backward: K4b from them with the incoming
    per-example cotangent; a second backward raises."""

    @staticmethod
    def forward(ctx, spec, reinforce_norm, keep, source_tokens, target_tokens, dropout_masks,
                *leaves):
        packed = pack_tf_weights(tf_params_from_leaves(list(leaves)), spec)
        ctx.residuals = None
        if not keep:
            return tf_forward_cuda(packed, spec, source_tokens, target_tokens, reinforce_norm,
                                   dropout_masks=dropout_masks)
        loss, ctx.residuals = tf_forward_cuda(packed, spec, source_tokens, target_tokens,
                                              reinforce_norm, keep=True,
                                              dropout_masks=dropout_masks)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        residuals, ctx.residuals = ctx.residuals, None
        if residuals is None:
            raise RuntimeError(
                "Trying to backward through fused_tf_loss a second time (or directly after "
                "the first backward freed its saved residuals): K4b consumes K4f's residuals "
                "in place. Call fused_tf_loss again for another backward.")
        grads = tf_backward_cuda(residuals, dloss)
        return (None, None, None, None, None, None, *tf_param_leaves(grads))


def fused_tf_loss(
    params: Dict[str, Any], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, reinforce_norm: bool = False,
    dropout_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Per-example teacher-forced seq2seq loss (B,), differentiable with
    respect to every parameter (the tokens carry no gradient). Equals
    :func:`tf_loss_plain` in either mode, with the encoder's inter-layer
    ``dropout_masks`` (L-1, B, Ls + 1, H) of a training pass when given.
    CPU tokens: plain version; CUDA tokens: :func:`fused_tf_kernels`."""
    if source_tokens.device.type == "cpu":
        return tf_loss_plain(params, spec, source_tokens, target_tokens, reinforce_norm,
                             dropout_masks)
    if source_tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {source_tokens.device}")
    return fused_tf_kernels(params, spec, source_tokens, target_tokens, reinforce_norm,
                            dropout_masks)


def fused_tf_kernels(
    params: Dict[str, Any], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, reinforce_norm: bool = False,
    dropout_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""K4f, and K4b in backward. Whether a gradient will be taken is decided
    here, since grad mode is off inside ``Function.forward``: when grad is
    enabled and a leaf requires grad, K4f keeps its residuals for K4b;
    otherwise it runs lean and keeps nothing."""
    leaves = tf_param_leaves(params)
    keep = torch.is_grad_enabled() and any(leaf.requires_grad for leaf in leaves)
    return _FusedTFLoss.apply(spec, bool(reinforce_norm), keep, source_tokens, target_tokens,
                              dropout_masks, *leaves)
