r"""
Kernels K3f and K3b: the ProgramPrior LM loss and its backward
(``probnmn_tpu_torch/csrc/lm_train.cu``), bound into one
``torch.autograd.Function`` behind :func:`fused_lm_loss`.

Replace ``probnmn_tpu/ops/pallas/seq2seq_train.py::_lm_forward_kernel`` and
``::_lm_backward_kernel`` (the custom VJP ``fused_lm_loss``). K3f computes
the per-example loss; K3b replays the forward, keeping every step's h, c and
gates in a workspace, and returns the gradient of ``sum(dloss * loss)`` with
respect to every parameter. Both run in float32 on the SIMT cores, as the
JAX trainer does; the source says how the work is laid out and what bounds
it.

A CPU ``tokens`` runs the plain versions (:func:`lm_loss_plain`, and
autograd through it); a CUDA one launches the kernels or raises.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from probnmn_tpu_torch.models.program_prior import ProgramPriorSpec, program_prior_loss
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
