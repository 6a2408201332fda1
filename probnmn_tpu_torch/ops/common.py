r"""
Shared functional ops: embeddings, linears, boundary handling, masked softmax,
vectorized @end@-trimming, the free-running loss and parameter init.

Counterparts of ``probnmn_tpu/ops/common.py``, reproducing the AllenNLP/torch
behaviours the reference relies on:

- ``add_boundary``  = ``allennlp.nn.util.add_sentence_boundary_token_ids``
  (reference ``seq2seq_base.py:127-137``).
- ``trim_at_end``   = the per-row trimming loop in reference
  ``seq2seq_base.py:278-293``, as one vectorized mask.
- ``length_normalized_logprob_loss`` = reference ``seq2seq_base.py:235-246``.
- ``sequence_cross_entropy`` = ``allennlp.nn.util.sequence_cross_entropy_with_logits``
  with ``average=None`` (per-example masked mean CE, eps 1e-13).
- ``sample_with_blocked_tokens`` = ``torch.multinomial`` over a softmax whose
  blocked entries were zeroed (reference ``seq2seq_base.py:211-215``), drawn
  as Gumbel-max.

Initializers and samplers take an explicit ``torch.Generator`` and draw on
the CPU; callers move the results to their device afterwards.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

NEG_INF = -1e9


def as_operand(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    r"""Round float32 ``x`` to ``compute_dtype`` and back: the value a kernel
    multiplies when its operands are stored in ``compute_dtype`` and it
    accumulates in float32. The identity for float32."""
    if compute_dtype == torch.float32 or x.dtype == compute_dtype:
        return x
    return x.to(compute_dtype).to(x.dtype)


# ------------------------------------------------------------------ params ------------
def xavier_uniform(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    r"""allennlp Embedding default init."""
    fan_in, fan_out = shape[-1], shape[-2] if len(shape) > 1 else shape[-1]
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    return uniform(gen, shape, bound)


def uniform(gen: torch.Generator, shape: Tuple[int, ...], bound: float) -> torch.Tensor:
    r"""U(-bound, bound) in float32."""
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_embedding(
    gen: torch.Generator, vocab_size: int, dim: int, pad_index: Optional[int] = None
) -> torch.Tensor:
    weight = xavier_uniform(gen, (vocab_size, dim))
    if pad_index is not None:
        weight[pad_index] = 0.0
    return weight


def embed(
    weight: torch.Tensor, tokens: torch.Tensor, pad_index: Optional[int] = None
) -> torch.Tensor:
    r"""Embedding lookup. With ``pad_index`` the pad row contributes zeros (torch
    ``padding_idx``)."""
    out = weight[tokens]
    if pad_index is not None:
        out = out * (tokens != pad_index).unsqueeze(-1).to(out.dtype)
    return out


def init_linear(
    gen: torch.Generator, in_dim: int, out_dim: int, bias: bool = True
) -> Dict[str, torch.Tensor]:
    r"""Torch ``nn.Linear`` default init; weight stored as (out, in)."""
    bound = 1.0 / (in_dim ** 0.5)
    params = {"w": uniform(gen, (out_dim, in_dim), bound)}
    if bias:
        params["b"] = uniform(gen, (out_dim,), bound)
    return params


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    out = x @ params["w"].T
    if "b" in params:
        out = out + params["b"]
    return out


# ------------------------------------------------------------------ sequences ---------
def add_boundary(
    tokens: torch.Tensor, pad_index: int, start_index: int, end_index: int
) -> torch.Tensor:
    r"""Prepend @start@ and append @end@ right after each row's last valid token.

    tokens: (B, T) with right-padding. Returns (B, T+2).
    """
    batch, length = tokens.shape
    mask = tokens != pad_index
    lengths = mask.sum(dim=1)
    out = torch.cat(
        [
            torch.full((batch, 1), start_index, dtype=tokens.dtype, device=tokens.device),
            torch.where(mask, tokens, torch.zeros_like(tokens)),
            torch.zeros((batch, 1), dtype=tokens.dtype, device=tokens.device),
        ],
        dim=1,
    )
    positions = torch.arange(length + 2, device=tokens.device)
    end_onehot = (positions[None, :] == (lengths + 1)[:, None]).to(tokens.dtype)
    return out + end_onehot * end_index


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    r"""Softmax with masked entries receiving zero weight (allennlp masked_softmax)."""
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=dim)


def trim_at_end(predictions: torch.Tensor, end_index: int) -> torch.Tensor:
    r"""Zero out everything after (exclusive of) the first @end@ token per row.

    Matches the reference exactly: rows whose first @end@ is at position 0 become all
    zeros; rows without @end@ are kept whole; the @end@ token itself is kept.
    """
    length = predictions.shape[1]
    is_end = predictions == end_index
    has_end = is_end.any(dim=-1)
    first_end = torch.argmax(is_end.to(torch.int32), dim=-1)
    positions = torch.arange(length, device=predictions.device)
    keep = positions[None, :] <= first_end[:, None]
    keep = torch.where(
        has_end[:, None] & (first_end[:, None] > 0), keep, ~has_end[:, None]
    )
    return predictions * keep.to(predictions.dtype)


def sequence_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    r"""Per-example masked mean token cross entropy.

    logits: (B, T, V); targets, weights: (B, T). Returns (B,), with allennlp's
    1e-13 epsilon in the denominator.
    """
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, targets.unsqueeze(-1)).squeeze(-1)
    weights = weights.to(logits.dtype)
    return (nll * weights).sum(-1) / (weights.sum(-1) + 1e-13)


def sample_with_blocked_tokens(
    logits: torch.Tensor,
    blocked: Sequence[int],
    gen: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Categorical sample over the last axis with the ``blocked`` ids given zero
    probability: ``argmax(logits + Gumbel noise)`` with blocked logits at
    NEG_INF, which is the distribution of the reference's zero-then-multinomial.
    The noise is ``noise`` (the logits' shape) when given, else standard
    Gumbel noise drawn on the CPU from ``gen``."""
    masked = logits.clone()
    masked[..., list(blocked)] = NEG_INF
    if noise is None:
        u = torch.rand(tuple(logits.shape), generator=gen)
        noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(masked + noise.to(device=logits.device, dtype=logits.dtype), dim=-1)


def length_normalized_logprob_loss(
    logprobs: torch.Tensor, predictions: torch.Tensor, pad_index: int
) -> torch.Tensor:
    r"""loss = -(sum step-logprobs over non-pad positions) / (count + 1e-12).

    The REINFORCE "loss" for free-running decode (reference
    ``seq2seq_base.py:235-246``), with positions after the first @end@ masked
    out through the already-trimmed predictions.
    """
    mask = (predictions != pad_index).to(logprobs.dtype)
    total = (logprobs * mask).sum(-1)
    count = mask.sum(-1)
    return -(total / (count + 1e-12))
