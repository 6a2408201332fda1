r"""
ProgramPrior: LSTM language model over CLEVR programs, with tied input/output
embeddings (counterpart of ``probnmn_tpu/models/program_prior.py``; reference
``probnmn/models/program_prior.py``).

Architecture: embedding (pad row zero) -> masked multi-layer LSTM ->
``Linear(hidden, input, bias=False)`` projection -> logits through the *tied*
embedding matrix. Teacher-forced next-token CE per example; "predictions" are
per-position categorical samples with @start@/@@PADDING@@/@@UNKNOWN@@ blocked.

``program_prior_sample`` keeps the reference's quirk: per-step logprobs come
from ``log_softmax(projection output)`` over the ``input_size`` axis, not
from the vocabulary logits. It is a diagnostic API, off the training path.

The training loss goes through ``ops/kernels/seq2seq_train.py::fused_lm_loss``
(kernels K3f/K3b on the card); :func:`program_prior_loss` here is its plain
version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from probnmn_tpu_torch.ops import rnn
from probnmn_tpu_torch.ops.common import (
    add_boundary,
    embed,
    init_embedding,
    length_normalized_logprob_loss,
    sample_with_blocked_tokens,
    sequence_cross_entropy,
    trim_at_end,
    uniform,
)


@dataclass(frozen=True)
class ProgramPriorSpec:
    vocab_size: int
    input_size: int = 256
    hidden_size: int = 256
    num_layers: int = 2
    dropout: float = 0.0
    pad_index: int = 0
    unk_index: int = 1
    start_index: int = 2
    end_index: int = 3


def init_program_prior_params(gen: torch.Generator, spec: ProgramPriorSpec) -> Dict[str, Any]:
    r"""float32 params on the CPU: ``embedding`` (V, D) doubling as the output
    layer, ``encoder`` (torch-layout LSTM layers) and ``projection`` (D, H),
    ``Linear(hidden, input, bias=False)`` with torch's default init."""
    return {
        "embedding": init_embedding(gen, spec.vocab_size, spec.input_size, spec.pad_index),
        "encoder": rnn.init_lstm_params(gen, spec.input_size, spec.hidden_size, spec.num_layers),
        "projection": uniform(gen, (spec.input_size, spec.hidden_size),
                              1.0 / (spec.hidden_size ** 0.5)),
    }


def _lm_logits(params: Dict[str, Any], encoded: torch.Tensor):
    projected = encoded @ params["projection"].T
    return projected @ params["embedding"].T, projected


def lm_dropout_masks(gen: Optional[torch.Generator], spec: ProgramPriorSpec,
                     program_tokens: torch.Tensor) -> Optional[torch.Tensor]:
    r"""The LM's inter-layer dropout masks for a training pass over
    ``program_tokens`` (B, Lt): (L-1, B, Lt + 2, H) bool (the steps of
    [start, program, end]) from ``gen`` on the tokens' device, or None when
    ``spec.dropout`` is 0 (or one layer)."""
    batch, lt = program_tokens.shape
    return rnn.draw_dropout_masks(gen, spec.dropout, spec.num_layers, batch, lt + 2,
                                  spec.hidden_size, program_tokens.device)


def _teacher_forced(params: Dict[str, Any], spec: ProgramPriorSpec, program_tokens: torch.Tensor,
                    dropout_masks: Optional[torch.Tensor] = None):
    tokens = add_boundary(program_tokens, spec.pad_index, spec.start_index, spec.end_index)
    mask = tokens != spec.pad_index
    embedded = embed(params["embedding"], tokens, pad_index=spec.pad_index)
    encoded, _ = rnn.lstm_encode(params["encoder"], embedded, mask,
                                 dropout_masks=dropout_masks, dropout=spec.dropout)
    logits, _ = _lm_logits(params, encoded)
    loss = sequence_cross_entropy(logits[:, :-1], tokens[:, 1:], mask[:, 1:])
    return loss, logits, mask


def program_prior_loss(
    params: Dict[str, Any], spec: ProgramPriorSpec, program_tokens: torch.Tensor,
    dropout_masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Per-example teacher-forced LM cross entropy (B,), in plain PyTorch ops
    (differentiable by autograd). ``dropout_masks`` (L-1, B, Lt + 2, H): the
    inter-layer dropout of a training pass (:func:`lm_dropout_masks`)."""
    return _teacher_forced(params, spec, program_tokens, dropout_masks)[0]


def program_prior_forward(
    params: Dict[str, Any],
    spec: ProgramPriorSpec,
    program_tokens: torch.Tensor,
    gen: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    r"""Teacher-forced LM pass: ``{"predictions": (B, T+1), "loss": (B,)}``,
    predictions drawn per position from ``gen``."""
    loss, logits, mask = _teacher_forced(params, spec, program_tokens)
    blocked = (spec.start_index, spec.pad_index, spec.unk_index)
    predictions = sample_with_blocked_tokens(logits, blocked, gen=gen)
    predictions = predictions[:, :-1] * mask[:, 1:]
    return {"predictions": predictions, "loss": loss}


def program_prior_sample(
    params: Dict[str, Any],
    spec: ProgramPriorSpec,
    gen: Optional[torch.Generator] = None,
    num_samples: int = 1,
    max_sequence_length: int = 28,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    r"""Free-running ancestral sampling from @start@ (reference
    ``program_prior.py:174-301``).

    Returns predictions sorted by ascending loss (length-normalized negative
    "logprob", with the reference's projection log-softmax quirk). Each step's
    Gumbel noise is ``noise[t]`` (num_steps, num_samples, V) when given, else
    drawn from ``gen``.
    """
    num_steps = max_sequence_length - 1
    blocked = (spec.start_index, spec.pad_index, spec.unk_index)
    device = params["embedding"].device
    hs = torch.zeros(spec.num_layers, num_samples, spec.hidden_size, device=device)
    cs = torch.zeros_like(hs)
    last = torch.full((num_samples,), spec.start_index, dtype=torch.long, device=device)
    step_preds, step_logprobs = [], []
    for t in range(num_steps):
        embedded = embed(params["embedding"], last, pad_index=spec.pad_index)
        out, hs, cs = rnn.lstm_step_stacked(params["encoder"], embedded, hs, cs)
        logits, projected = _lm_logits(params, out)
        last = sample_with_blocked_tokens(
            logits, blocked, gen=gen, noise=None if noise is None else noise[t])
        # Reference quirk: logprobs over the projection activations, not vocab
        # logits. An id past the projection width reads NaN, as the JAX
        # package's take_along_axis does (only when vocab_size > input_size).
        quirk_logprobs = torch.log_softmax(projected, dim=-1)
        width = quirk_logprobs.shape[-1]
        chosen = quirk_logprobs.gather(-1, last.clamp(max=width - 1)[:, None])[:, 0]
        step_preds.append(last)
        step_logprobs.append(torch.where(last < width, chosen, torch.full_like(chosen, float("nan"))))
    predictions = trim_at_end(torch.stack(step_preds, dim=1), spec.end_index)
    loss = length_normalized_logprob_loss(
        torch.stack(step_logprobs, dim=1), predictions, spec.pad_index)
    order = torch.argsort(loss, stable=True)  # ascending loss = most probable first
    return {"predictions": predictions[order], "loss": loss[order]}
