r"""
Phase datasets (counterpart of ``probnmn_tpu/data/datasets.py``; reference
``probnmn/data/datasets.py``), numpy-native: ``__len__`` and the vectorized
``get_batch(indices)`` that the batch pipeline gathers with. Each also builds
from in-memory token arrays (``from_programs``, ``from_tokens``).

The question_coding supervision subset is drawn with the *global* NumPy RNG,
as the reference does (``datasets.py:67-78``): questions longer than
``supervision_question_max_length`` are filtered out, then
``np.random.choice(..., replace=False)``. The CLI seeds it with
``RANDOM_SEED``, so the same seed picks the same supervised examples as the
JAX package and the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from probnmn_tpu_torch.data.readers import ClevrTokensReader


def check_token_ids(tokens: np.ndarray, vocab_size: int, what: str) -> None:
    r"""Raise unless every id of ``tokens`` lies in [0, ``vocab_size``): the
    training kernels clamp ids into their embeddings, where the plain path
    would raise."""
    bad = (tokens < 0) | (tokens >= vocab_size)
    if bad.any():
        row = int(np.argwhere(bad)[0][0])
        raise ValueError(f"{what} {row} has a token id outside [0, {vocab_size}): "
                         f"{tokens[row].tolist()}")


class ProgramPriorDataset:
    r"""Yields {"program"} only (reference ``datasets.py:8-32``)."""

    def __init__(self, tokens_h5path: str):
        reader = ClevrTokensReader(tokens_h5path)
        self._programs = reader.programs
        self._split = reader.split

    @classmethod
    def from_programs(cls, programs: np.ndarray, split: str = "train") -> "ProgramPriorDataset":
        r"""A dataset over an in-memory (N, Lt) array of program tokens."""
        dataset = cls.__new__(cls)
        dataset._programs = np.asarray(programs)
        dataset._split = split
        return dataset

    def check_tokens(self, vocab_size: int) -> None:
        r"""Raise unless every token id lies in [0, ``vocab_size``)."""
        check_token_ids(self._programs, vocab_size, f"{self._split} program")

    def __len__(self):
        return len(self._programs)

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return {"program": self._programs[indices].astype(np.int64)}

    @property
    def split(self):
        return self._split


def _make_supervision_list(
    questions: np.ndarray, split: str, num_supervision: int, supervision_question_max_length: int
) -> np.ndarray:
    supervision_list = np.zeros(len(questions))
    if split == "train" and num_supervision < len(questions):
        example_indices = np.ones(len(questions))
        question_lengths = (questions != 0).sum(-1)
        example_indices[question_lengths > supervision_question_max_length] = 0
        example_indices = example_indices.nonzero()[0]
        # Deterministic for a fixed global numpy seed (set by the train CLI).
        supervision_examples = np.random.choice(
            example_indices, replace=False, size=num_supervision
        )
        supervision_list[supervision_examples] = 1
    else:
        supervision_list += 1
    return supervision_list.astype(np.int64)


class QuestionCodingDataset:
    r"""{"program", "question", "supervision"} (reference ``datasets.py:35-107``)."""

    def __init__(
        self,
        tokens_h5path: str,
        num_supervision: int = 699989,
        supervision_question_max_length: int = 40,
    ):
        reader = ClevrTokensReader(tokens_h5path)
        self._setup(reader.programs, reader.questions, reader.split, num_supervision,
                    supervision_question_max_length)

    @classmethod
    def from_tokens(
        cls,
        programs: np.ndarray,
        questions: np.ndarray,
        split: str = "train",
        num_supervision: int = 699989,
        supervision_question_max_length: int = 40,
    ) -> "QuestionCodingDataset":
        r"""A dataset over in-memory (N, Lp) programs and (N, Lq) questions."""
        dataset = cls.__new__(cls)
        dataset._setup(np.asarray(programs), np.asarray(questions), split, num_supervision,
                       supervision_question_max_length)
        return dataset

    def _setup(self, programs, questions, split, num_supervision, max_length):
        if len(programs) != len(questions):
            raise ValueError(f"{len(programs)} programs for {len(questions)} questions")
        self._programs = programs
        self._questions = questions
        self._split = split
        self._supervision_list = _make_supervision_list(questions, split, num_supervision,
                                                        max_length)

    def check_tokens(self, program_vocab_size: int, question_vocab_size: int) -> None:
        r"""Raise unless every program and question token id lies in its vocabulary."""
        check_token_ids(self._programs, program_vocab_size, f"{self._split} program")
        check_token_ids(self._questions, question_vocab_size, f"{self._split} question")

    def __len__(self):
        return len(self._questions)

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "program": self._programs[indices].astype(np.int64),
            "question": self._questions[indices].astype(np.int64),
            "supervision": self._supervision_list[indices],
        }

    def get_supervision_list(self) -> np.ndarray:
        return self._supervision_list

    @property
    def split(self):
        return self._split
