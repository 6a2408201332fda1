r"""
Attentive seq2seq LSTM — the stack under the ProgramGenerator (counterpart of
``probnmn_tpu/models/seq2seq.py``), reproducing the reference's
``Seq2SeqBase`` (an AllenNLP ``SimpleSeq2Seq`` subclass):

- encoder: source embedding (pad row zero) -> masked multi-layer LSTM;
- decoder init: hidden = final encoder state of the top layer, context = zeros;
- per decode step: embed the last token, dot-product attention of the
  *previous* decoder hidden over the encoder outputs (masked softmax),
  LSTMCell over ``concat(attended, embedded)``, projection to the target vocab;
- greedy argmax, or Gumbel-max sampling with @@PADDING@@/@@UNKNOWN@@/@start@
  blocked; the chosen token's logprob comes from the *unblocked* log-softmax;
- loss = length-normalized negative logprob of the decoded tokens after
  @end@-trimming.

Sampling takes explicit Gumbel noise, ``argmax(blocked_logits + noise[t])``,
which is a categorical draw from the blocked distribution. Random streams
cannot match across frameworks, so the tests hand the same noise to this
module and to the JAX package. The serving entry, the JAX package's
``sampling_forward_serving``, is
``ops/kernels/seq2seq_decode.py::fused_sampling_forward``: on a CUDA tensor
it runs the sampling kernel, on a CPU tensor its plain version, both from
Philox noise seeded by the caller.

Teacher forcing and beam search are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from probnmn_tpu_torch.ops import rnn
from probnmn_tpu_torch.ops.common import (
    NEG_INF,
    add_boundary,
    as_operand,
    embed,
    init_embedding,
    init_linear,
    length_normalized_logprob_loss,
    masked_softmax,
    trim_at_end,
)

GREEDY = "greedy"
SAMPLING = "sampling"


@dataclass(frozen=True)
class Seq2SeqSpec:
    r"""Static architecture/vocabulary facts."""
    source_vocab_size: int
    target_vocab_size: int
    input_size: int = 256
    hidden_size: int = 256
    num_layers: int = 2
    dropout: float = 0.0
    max_decoding_steps: int = 30
    pad_index: int = 0
    unk_index: int = 1
    start_index: int = 2
    end_index: int = 3


def init_seq2seq_params(gen: torch.Generator, spec: Seq2SeqSpec) -> Dict[str, Any]:
    r"""Random parameters in the JAX package's layout (torch-style (out, in)
    matrices), drawn on the CPU from ``gen``."""
    return {
        "source_embedding": init_embedding(
            gen, spec.source_vocab_size, spec.input_size, pad_index=spec.pad_index
        ),
        "encoder": rnn.init_lstm_params(
            gen, spec.input_size, spec.hidden_size, spec.num_layers
        ),
        "target_embedding": init_embedding(gen, spec.target_vocab_size, spec.input_size),
        "decoder_cell": rnn.init_lstm_cell_params(
            gen, spec.hidden_size + spec.input_size, spec.hidden_size
        ),
        "output_projection": init_linear(
            gen, spec.hidden_size, spec.target_vocab_size, bias=True
        ),
    }


def _encode(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    source_tokens: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
):
    r"""Boundary-add, strip @start@, embed, run the masked encoder (reference
    forward:127-145). Encoder outputs are rounded to ``compute_dtype``, the
    type the kernel stores them in."""
    source = add_boundary(source_tokens, spec.pad_index, spec.start_index, spec.end_index)
    source = source[:, 1:]  # "@start@" is removed from source sequences
    source_mask = source != spec.pad_index
    embedded = embed(
        as_operand(params["source_embedding"], compute_dtype), source,
        pad_index=spec.pad_index,
    )
    encoder_outputs, finals = rnn.lstm_encode(
        params["encoder"], embedded, source_mask, compute_dtype
    )
    decoder_hidden = finals[-1][0]
    decoder_context = torch.zeros_like(decoder_hidden)
    return (
        as_operand(encoder_outputs, compute_dtype), source_mask,
        decoder_hidden, decoder_context,
    )


def _decode_step(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    token: torch.Tensor,
    decoder_hidden: torch.Tensor,
    decoder_context: torch.Tensor,
    encoder_outputs: torch.Tensor,
    source_mask: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
):
    r"""One ``_prepare_output_projections`` step. token: (B,). Returns (logits, h, c)."""
    embedded = as_operand(params["target_embedding"], compute_dtype)[token]
    # Dot-product attention with the PREVIOUS decoder hidden state.
    h_op = as_operand(decoder_hidden, compute_dtype)
    scores = torch.einsum("bsh,bh->bs", encoder_outputs, h_op)
    weights = as_operand(masked_softmax(scores, source_mask), compute_dtype)
    attended = torch.einsum("bs,bsh->bh", weights, encoder_outputs)
    cell_input = torch.cat([attended, embedded], dim=-1)
    decoder_hidden, decoder_context = rnn.lstm_cell(
        params["decoder_cell"], cell_input, (decoder_hidden, decoder_context),
        compute_dtype,
    )
    proj = params["output_projection"]
    logits = (
        as_operand(decoder_hidden, compute_dtype)
        @ as_operand(proj["w"], compute_dtype).T
        + proj["b"]
    )
    return logits, decoder_hidden, decoder_context


def seq2seq_forward(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    source_tokens: torch.Tensor,
    decoding_strategy: str = SAMPLING,
    noise: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    r"""Free-running decode for ``max_decoding_steps``.

    ``GREEDY`` takes the argmax of the logits; ``SAMPLING`` takes
    ``argmax(blocked_logits + noise[t])`` with ``noise`` (T, B, >=V) Gumbel
    noise. Returns ``predictions`` (B, T) trimmed at @end@, ``loss`` (B,),
    ``logits`` (B, T, V) and ``logprobs`` (B, T) of the chosen tokens.
    """
    if decoding_strategy not in (GREEDY, SAMPLING):
        raise ValueError(f"unknown decoding strategy: {decoding_strategy!r}")
    if decoding_strategy == SAMPLING and noise is None:
        raise ValueError("sampling decode requires Gumbel noise")
    batch = source_tokens.shape[0]
    encoder_outputs, source_mask, h, c = _encode(params, spec, source_tokens, compute_dtype)
    vocab = spec.target_vocab_size
    blocked = torch.zeros(vocab, dtype=torch.bool, device=source_tokens.device)
    blocked[[spec.pad_index, spec.unk_index, spec.start_index]] = True

    token = torch.full(
        (batch,), spec.start_index, dtype=torch.long, device=source_tokens.device
    )
    step_logits, step_preds, step_logprobs = [], [], []
    for t in range(spec.max_decoding_steps):
        logits, h, c = _decode_step(
            params, spec, token, h, c, encoder_outputs, source_mask, compute_dtype
        )
        if decoding_strategy == GREEDY:
            token = torch.argmax(logits, dim=-1)
        else:
            masked = torch.where(blocked, torch.full_like(logits, NEG_INF), logits)
            token = torch.argmax(masked + noise[t, :, :vocab], dim=-1)
        # Step logprob of the chosen token, from the full (unblocked) distribution.
        log_probs = torch.log_softmax(logits, dim=-1)
        step_logits.append(logits)
        step_preds.append(token)
        step_logprobs.append(log_probs.gather(1, token[:, None])[:, 0])

    predictions = trim_at_end(torch.stack(step_preds, dim=1), spec.end_index)
    logprobs = torch.stack(step_logprobs, dim=1)
    return {
        "predictions": predictions,
        "loss": length_normalized_logprob_loss(logprobs, predictions, spec.pad_index),
        "logits": torch.stack(step_logits, dim=1),
        "logprobs": logprobs,
    }

