r"""
ProgramGenerator: seq2seq from question tokens to program tokens
(reference ``probnmn/models/program_generator.py``): a ``Seq2SeqSpec`` with
source namespace "questions", target "programs", and ``max_decoding_steps = 26``
(maximum program length in CLEVR v1.0 train split).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models.seq2seq import Seq2SeqSpec, init_seq2seq_params

MAX_DECODING_STEPS = 26


def make_spec(vocabulary: Vocabulary, config=None) -> Seq2SeqSpec:
    kwargs = {}
    if config is not None:
        c = config.PROGRAM_GENERATOR
        kwargs = dict(
            input_size=c.INPUT_SIZE,
            hidden_size=c.HIDDEN_SIZE,
            num_layers=c.NUM_LAYERS,
            dropout=c.DROPOUT,
        )
    return Seq2SeqSpec(
        source_vocab_size=vocabulary.get_vocab_size("questions"),
        target_vocab_size=vocabulary.get_vocab_size("programs"),
        max_decoding_steps=MAX_DECODING_STEPS,
        **kwargs,
    )


def init_params(gen: torch.Generator, spec: Seq2SeqSpec) -> Dict[str, Any]:
    return init_seq2seq_params(gen, spec)
