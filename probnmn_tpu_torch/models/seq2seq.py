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
- free-running loss = length-normalized negative logprob of the decoded
  tokens after @end@-trimming; teacher-forced loss = per-example masked
  sequence cross entropy with the shifted-target scheme (reference
  ``seq2seq_base.py:235-254``, ``295-341``).

Sampling takes explicit Gumbel noise, ``argmax(blocked_logits + noise[t])``,
which is a categorical draw from the blocked distribution. Random streams
cannot match across frameworks, so the tests hand the same noise to this
module and to the JAX package. The serving entry, the JAX package's
``sampling_forward_serving``, is
``ops/kernels/seq2seq_decode.py::fused_sampling_forward``: on a CUDA tensor
it runs the sampling kernel, on a CPU tensor its plain version, both from
Philox noise seeded by the caller.

Teacher forcing (``target_tokens``) is the plain version of the training
kernels K4f/K4b (``ops/kernels/seq2seq_train.py::fused_tf_loss``) in its
cross-entropy mode, and the evaluator's greedy forward.
:func:`beam_search_forward` is the JAX package's beam decoding, plain PyTorch
as the JAX function is plain XLA.
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
    sequence_cross_entropy,
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


def teacher_forced_logits(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    source_tokens: torch.Tensor,
    step_inputs: torch.Tensor,
) -> torch.Tensor:
    r"""Decoder logits (B, T, V) with the given token ``step_inputs[:, t]``
    fed at step t, in float32."""
    encoder_outputs, source_mask, h, c = _encode(params, spec, source_tokens)
    step_logits = []
    for t in range(step_inputs.shape[1]):
        logits, h, c = _decode_step(
            params, spec, step_inputs[:, t], h, c, encoder_outputs, source_mask
        )
        step_logits.append(logits)
    return torch.stack(step_logits, dim=1)


def seq2seq_forward(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    source_tokens: torch.Tensor,
    decoding_strategy: str = SAMPLING,
    noise: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
    target_tokens: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    r"""Free-running decode for ``max_decoding_steps``, or teacher forcing
    with ``target_tokens``.

    ``GREEDY`` takes the argmax of the logits; ``SAMPLING`` takes
    ``argmax(blocked_logits + noise[t])`` with ``noise`` (T, B, >=V) Gumbel
    noise. Free-running returns ``predictions`` (B, T) trimmed at @end@,
    ``loss`` (B,), ``logits`` (B, T, V) and ``logprobs`` (B, T) of the
    chosen tokens. Teacher forcing (``GREEDY``, float32) feeds the gold token
    of the boundary-added targets at each step and returns ``predictions``
    (the argmax tokens, trimmed), ``logits``, the per-example masked sequence
    cross entropy ``loss``, ``relevant_targets`` (the targets after @start@)
    and ``relevant_mask`` (where they are not pad).
    """
    if decoding_strategy not in (GREEDY, SAMPLING):
        raise ValueError(f"unknown decoding strategy: {decoding_strategy!r}")
    if decoding_strategy == SAMPLING and noise is None:
        raise ValueError("sampling decode requires Gumbel noise")
    if target_tokens is not None:
        if decoding_strategy != GREEDY or compute_dtype != torch.float32:
            raise ValueError("teacher forcing takes greedy predictions in float32")
        targets = add_boundary(target_tokens, spec.pad_index, spec.start_index, spec.end_index)
        logits = teacher_forced_logits(params, spec, source_tokens, targets[:, :-1])
        relevant_targets = targets[:, 1:]
        relevant_mask = relevant_targets != spec.pad_index
        return {
            "predictions": trim_at_end(torch.argmax(logits, dim=-1), spec.end_index),
            "logits": logits,
            "loss": sequence_cross_entropy(logits, relevant_targets, relevant_mask),
            "relevant_targets": relevant_targets,
            "relevant_mask": relevant_mask,
        }

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


def beam_search_forward(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    source_tokens: torch.Tensor,
    beam_size: int,
) -> Dict[str, torch.Tensor]:
    r"""Width-``beam_size`` beam decode in float32 (counterpart of the JAX
    package's ``beam_search_forward``, beyond the reference, which decodes
    without a beam). Returns ``predictions`` (B, T) trimmed at @end@ and
    ``loss`` (B,), as a free-running :func:`seq2seq_forward`, plus every
    hypothesis: ``beam_predictions`` (B, K, T) and ``beam_scores`` (B, K),
    best first.

    Scores are raw cumulative logprobs of the unblocked softmax, the
    distribution greedy decoding argmaxes over, so ``beam_size=1`` gives the
    greedy tokens. Only hypothesis 0 is live at t = 0, so the first expansion
    takes K distinct tokens. A finished hypothesis (it emitted @end@) extends
    only with @@PADDING@@, at an unchanged score."""
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    batch, K = source_tokens.shape[0], beam_size
    vocab, num_steps = spec.target_vocab_size, spec.max_decoding_steps
    device = source_tokens.device

    encoder_outputs, source_mask, h, c = _encode(params, spec, source_tokens)
    # (B, ...) -> (B*K, ...), hypothesis-major within an example.
    enc_k = encoder_outputs.repeat_interleave(K, dim=0)
    mask_k = source_mask.repeat_interleave(K, dim=0)
    h, c = h.repeat_interleave(K, dim=0), c.repeat_interleave(K, dim=0)

    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=device)
    token = torch.full((batch, K), spec.start_index, dtype=torch.long, device=device)
    scores = torch.where(torch.arange(K, device=device) == 0, 0.0, neg_inf).repeat(batch, 1)
    finished = torch.zeros((batch, K), dtype=torch.bool, device=device)
    seqs = torch.zeros((batch, K, num_steps), dtype=torch.long, device=device)
    logps = torch.zeros((batch, K, num_steps), dtype=torch.float32, device=device)
    pad_only = torch.where(torch.arange(vocab, device=device) == spec.pad_index, 0.0, neg_inf)
    rows = torch.arange(batch, device=device)[:, None] * K

    for t in range(num_steps):
        logits, h_new, c_new = _decode_step(
            params, spec, token.reshape(batch * K), h, c, enc_k, mask_k)
        log_probs = torch.log_softmax(logits, dim=-1).reshape(batch, K, vocab)
        cand = scores[:, :, None] + torch.where(finished[:, :, None], pad_only, log_probs)
        scores, top = torch.topk(cand.reshape(batch, K * vocab), K, dim=-1)
        parent, token = top // vocab, top % vocab
        flat_parent = (rows + parent).reshape(-1)
        h, c = h_new[flat_parent], c_new[flat_parent]
        finished = finished.gather(1, parent)
        seqs = seqs.gather(1, parent[:, :, None].expand(-1, -1, num_steps)).clone()
        logps = logps.gather(1, parent[:, :, None].expand(-1, -1, num_steps)).clone()
        step_logp = log_probs.gather(1, parent[:, :, None].expand(-1, -1, vocab))
        step_logp = step_logp.gather(2, token[:, :, None])[..., 0]
        seqs[:, :, t] = token
        logps[:, :, t] = torch.where(finished, 0.0, step_logp)
        finished = finished | (token == spec.end_index)

    # topk keeps each row sorted descending, so hypothesis 0 is the best.
    trimmed = trim_at_end(seqs.reshape(batch * K, num_steps), spec.end_index)
    trimmed = trimmed.reshape(batch, K, num_steps)
    predictions = trimmed[:, 0]
    return {
        "predictions": predictions,
        "loss": length_normalized_logprob_loss(logps[:, 0], predictions, spec.pad_index),
        "beam_predictions": trimmed,
        "beam_scores": scores,
    }
