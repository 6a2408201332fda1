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

Each forward kernel computes the per-example loss; each backward kernel
replays the forward, keeping every step's states and gates in a workspace
taken from the caching allocator, and returns the gradient of
``sum(dloss * loss)`` with respect to every parameter. All run in float32 on
the SIMT cores, as the JAX trainers do; the sources say how the work is laid
out and what bounds it.

CPU tokens run the plain versions (:func:`lm_loss_plain`,
:func:`tf_loss_plain`, and autograd through them); CUDA tokens launch the
kernels or raise.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from probnmn_tpu_torch.models.program_prior import ProgramPriorSpec, program_prior_loss
from probnmn_tpu_torch.models.seq2seq import (
    GREEDY,
    Seq2SeqSpec,
    seq2seq_forward,
    teacher_forced_logits,
)
from probnmn_tpu_torch.ops.common import length_normalized_logprob_loss
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.rnn import check_no_dropout

_LEAF_NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")


def lm_loss_plain(
    params: Dict[str, Any], spec: ProgramPriorSpec, tokens: torch.Tensor
) -> torch.Tensor:
    r"""Plain PyTorch version of K3f: ``program_prior_forward``'s loss."""
    return program_prior_loss(params, spec, tokens)


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
    params: Dict[str, Any], spec: ProgramPriorSpec, tokens: torch.Tensor, dloss: torch.Tensor
) -> Dict[str, Any]:
    r"""Plain PyTorch version of K3b: ``torch.autograd.grad`` of the plain
    loss, weighted by the per-example cotangent ``dloss``."""
    leaves = [p.detach().requires_grad_(True) for p in param_leaves(params)]
    with torch.enable_grad():
        loss = lm_loss_plain(params_from_leaves(leaves), spec, tokens)
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


def _workspace(batch: int, lt: int, sizes, backward: bool, device) -> torch.Tensor:
    V, D, H, L = sizes
    n = _build.library().probnmn_lm_workspace_floats(batch, lt, D, H, L, V, int(backward))
    return torch.empty(n, dtype=torch.float32, device=device)


def lm_forward_cuda(
    packed: Dict[str, torch.Tensor], spec: ProgramPriorSpec, tokens: torch.Tensor
) -> torch.Tensor:
    r"""Launch K3f: per-example loss (B,) float32."""
    tok, sizes = _kernel_args(packed, spec, tokens)
    batch, lt = tok.shape
    ws = _workspace(batch, lt, sizes, False, tok.device)
    loss = torch.empty(batch, dtype=torch.float32, device=tok.device)
    p = packed
    code = _build.library().probnmn_lm_forward(
        tok.data_ptr(), batch, lt, p["emb"].data_ptr(), p["proj"].data_ptr(),
        p["w_ih"].data_ptr(), p["w_hh"].data_ptr(), p["bias"].data_ptr(),
        ws.data_ptr(), loss.data_ptr(), *sizes,
        spec.pad_index, spec.start_index, spec.end_index,
        torch.cuda.current_stream(tok.device).cuda_stream,
    )
    _build.check(code, "LM forward kernel")
    lm_forward_cuda.launches += 1
    return loss


lm_forward_cuda.launches = 0


def lm_backward_cuda(
    packed: Dict[str, torch.Tensor], spec: ProgramPriorSpec, tokens: torch.Tensor,
    dloss: torch.Tensor,
) -> Dict[str, Any]:
    r"""Launch K3b: the gradient of ``sum(dloss * loss)`` as a params dict
    (``b_ih`` and ``b_hh`` get equal gradients, as separate tensors)."""
    tok, sizes = _kernel_args(packed, spec, tokens)
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
        g["w_hh"].data_ptr(), g["bias"].data_ptr(), *sizes,
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
    r"""Forward: K3f. Backward: K3b with the incoming per-example cotangent."""

    @staticmethod
    def forward(ctx, spec, tokens, *leaves):
        packed = pack_lm_weights(params_from_leaves(list(leaves)))
        ctx.spec = spec
        ctx.packed = packed
        ctx.tokens = tokens
        return lm_forward_cuda(packed, spec, tokens)

    @staticmethod
    def backward(ctx, dloss):
        grads = lm_backward_cuda(ctx.packed, ctx.spec, ctx.tokens, dloss)
        return (None, None, *param_leaves(grads))


def fused_lm_loss(
    params: Dict[str, Any], spec: ProgramPriorSpec, tokens: torch.Tensor
) -> torch.Tensor:
    r"""Per-example ProgramPrior LM cross entropy (B,), differentiable with
    respect to every parameter; the tied embedding's gradient sums its
    output-layer and input-lookup parts. Equals ``program_prior_forward``'s
    loss. CPU tokens: plain version; CUDA tokens: K3f, and K3b in backward."""
    check_no_dropout(spec.dropout)
    if tokens.device.type == "cpu":
        return lm_loss_plain(params, spec, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    return _FusedLMLoss.apply(spec, tokens, *param_leaves(params))


# ============================================================ K4: teacher-forced seq2seq
TF_MAX_SOURCE = 4095  # source tokens the attention kernels take (tf_train.cu kMaxSource - 1)
_TF_PACKED = ("src_emb", "tgt_emb", "enc_wih", "enc_whh", "enc_bias",
              "dec_w", "dec_wx", "dec_bias", "proj_w", "proj_b")


def tf_loss_plain(
    params: Dict[str, Any], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, reinforce_norm: bool = False,
) -> torch.Tensor:
    r"""Plain PyTorch version of K4f: the per-example teacher-forced loss (B,).

    Cross-entropy mode: ``seq2seq_forward(..., target_tokens=...)``'s loss,
    the masked mean CE over the targets with @end@ appended (eps 1e-13).
    REINFORCE mode: ``target_tokens`` is a trimmed sampled z, fed as
    ``[start, z[:-1]]``; the loss is the length-normalized negative logprob
    of z's tokens (eps 1e-12), the free-running loss at that z."""
    if not reinforce_norm:
        return seq2seq_forward(params, spec, source_tokens, GREEDY,
                               target_tokens=target_tokens)["loss"]
    start = torch.full_like(target_tokens[:, :1], spec.start_index)
    step_inputs = torch.cat([start, target_tokens[:, :-1]], dim=1)
    logits = teacher_forced_logits(params, spec, source_tokens, step_inputs)
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
) -> Dict[str, Any]:
    r"""Plain PyTorch version of K4b: ``torch.autograd.grad`` of the plain
    loss, weighted by the per-example cotangent ``dloss``."""
    leaves = [p.detach().requires_grad_(True) for p in tf_param_leaves(params)]
    with torch.enable_grad():
        loss = tf_loss_plain(tf_params_from_leaves(leaves), spec, source_tokens, target_tokens,
                             reinforce_norm)
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


def _tf_workspace(batch, ls, lt, sizes, reinforce_norm, backward, device) -> torch.Tensor:
    n = _build.library().probnmn_tf_workspace_floats(batch, ls, lt, *sizes, int(bool(reinforce_norm)),
                                                     int(backward))
    return torch.empty(n, dtype=torch.float32, device=device)


def tf_forward_cuda(
    packed: Dict[str, torch.Tensor], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, reinforce_norm: bool = False,
) -> torch.Tensor:
    r"""Launch K4f: per-example loss (B,) float32."""
    src, tgt, sizes = _tf_kernel_args(packed, spec, source_tokens, target_tokens)
    (batch, ls), lt = src.shape, tgt.shape[1]
    ws = _tf_workspace(batch, ls, lt, sizes, reinforce_norm, False, src.device)
    loss = torch.empty(batch, dtype=torch.float32, device=src.device)
    code = _build.library().probnmn_tf_forward(
        src.data_ptr(), tgt.data_ptr(), batch, ls, lt,
        _build.pointers([packed[name] for name in _TF_PACKED]),
        ws.data_ptr(), loss.data_ptr(), *_tf_call_args(spec, sizes, reinforce_norm, src.device),
    )
    _build.check(code, "teacher-forced forward kernel")
    tf_forward_cuda.launches += 1
    return loss


tf_forward_cuda.launches = 0


def tf_backward_cuda(
    packed: Dict[str, torch.Tensor], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, dloss: torch.Tensor, reinforce_norm: bool = False,
) -> Dict[str, Any]:
    r"""Launch K4b: the gradient of ``sum(dloss * loss)`` as a params dict
    (``b_ih`` and ``b_hh`` get equal gradients, as separate tensors)."""
    src, tgt, sizes = _tf_kernel_args(packed, spec, source_tokens, target_tokens)
    (batch, ls), lt = src.shape, tgt.shape[1]
    if tuple(dloss.shape) != (batch,):
        raise ValueError(f"dloss must be ({batch},), got {tuple(dloss.shape)}")
    dloss = dloss.to(device=src.device, dtype=torch.float32).contiguous()
    ws = _tf_workspace(batch, ls, lt, sizes, reinforce_norm, True, src.device)
    g = {name: torch.empty_like(packed[name]) for name in _TF_PACKED}
    code = _build.library().probnmn_tf_backward(
        src.data_ptr(), tgt.data_ptr(), batch, ls, lt,
        _build.pointers([packed[name] for name in _TF_PACKED]),
        dloss.data_ptr(), ws.data_ptr(), _build.pointers([g[name] for name in _TF_PACKED]),
        *_tf_call_args(spec, sizes, reinforce_norm, src.device),
    )
    _build.check(code, "teacher-forced backward kernel")
    tf_backward_cuda.launches += 1
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
    r"""Forward: K4f. Backward: K4b with the incoming per-example cotangent."""

    @staticmethod
    def forward(ctx, spec, reinforce_norm, source_tokens, target_tokens, *leaves):
        packed = pack_tf_weights(tf_params_from_leaves(list(leaves)), spec)
        ctx.spec = spec
        ctx.reinforce_norm = reinforce_norm
        ctx.packed = packed
        ctx.tokens = (source_tokens, target_tokens)
        return tf_forward_cuda(packed, spec, source_tokens, target_tokens, reinforce_norm)

    @staticmethod
    def backward(ctx, dloss):
        grads = tf_backward_cuda(ctx.packed, ctx.spec, *ctx.tokens, dloss, ctx.reinforce_norm)
        return (None, None, None, None, *tf_param_leaves(grads))


def fused_tf_loss(
    params: Dict[str, Any], spec: Seq2SeqSpec, source_tokens: torch.Tensor,
    target_tokens: torch.Tensor, reinforce_norm: bool = False,
) -> torch.Tensor:
    r"""Per-example teacher-forced seq2seq loss (B,), differentiable with
    respect to every parameter (the tokens carry no gradient). Equals
    :func:`tf_loss_plain` in either mode. CPU tokens: plain version; CUDA
    tokens: K4f, and K4b in backward."""
    check_no_dropout(spec.dropout)
    if source_tokens.device.type == "cpu":
        return tf_loss_plain(params, spec, source_tokens, target_tokens, reinforce_norm)
    if source_tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {source_tokens.device}")
    return _FusedTFLoss.apply(spec, bool(reinforce_norm), source_tokens, target_tokens,
                              *tf_param_leaves(params))
