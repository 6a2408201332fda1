r"""
QuestionReconstructor: seq2seq from program tokens to question tokens
(counterpart of ``probnmn_tpu/models/question_reconstructor.py``; reference
``probnmn/models/question_reconstructor.py``): a ``Seq2SeqSpec`` with source
namespace "programs", target "questions", and ``max_decoding_steps = 45``
(maximum question length in CLEVR v1.0 train split).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models.seq2seq import Seq2SeqSpec, init_seq2seq_params

MAX_DECODING_STEPS = 45


def make_spec(vocabulary: Vocabulary, config=None) -> Seq2SeqSpec:
    kwargs = {}
    if config is not None:
        c = config.QUESTION_RECONSTRUCTOR
        kwargs = dict(
            input_size=c.INPUT_SIZE,
            hidden_size=c.HIDDEN_SIZE,
            num_layers=c.NUM_LAYERS,
            dropout=c.DROPOUT,
        )
    return Seq2SeqSpec(
        source_vocab_size=vocabulary.get_vocab_size("programs"),
        target_vocab_size=vocabulary.get_vocab_size("questions"),
        max_decoding_steps=MAX_DECODING_STEPS,
        **kwargs,
    )


def init_params(gen: torch.Generator, spec: Seq2SeqSpec) -> Dict[str, Any]:
    return init_seq2seq_params(gen, spec)
