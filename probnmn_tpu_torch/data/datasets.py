r"""
Phase datasets (counterpart of ``probnmn_tpu/data/datasets.py``; reference
``probnmn/data/datasets.py``), numpy-native: ``__len__`` and the vectorized
``get_batch(indices)`` that the batch pipeline gathers with. Each also builds
from in-memory arrays (``from_programs``, ``from_tokens``, ``from_arrays``).

The question_coding supervision subset is drawn with the *global* NumPy RNG,
as the reference does (``datasets.py:67-78``): questions longer than
``supervision_question_max_length`` are filtered out, then
``np.random.choice(..., replace=False)``. The CLI seeds it with
``RANDOM_SEED``, so the same seed picks the same supervised examples as the
JAX package and the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from probnmn_tpu_torch.data.readers import (
    ClevrImageFeaturesReader,
    ClevrTokensReader,
    SharedFeatures,
)


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


class ModuleTrainingDataset:
    r"""{"question", "answer", "image", "program"} (reference
    ``datasets.py:110-146``); ``image`` is float32 NCHW as stored, gathered
    through each question's ``image_indices`` entry. ``shared_features``
    (in memory) reads the features into shared memory, one copy for every
    rank of a data-parallel launch (:class:`SharedFeatures`; ``from_arrays``
    takes one as ``features``)."""

    def __init__(self, tokens_h5path: str, features_h5path: str, in_memory: bool = True,
                 shared_features: bool = False):
        tokens = ClevrTokensReader(tokens_h5path)
        self._setup(tokens.programs, tokens.questions, tokens.answers, tokens.image_indices,
                    ClevrImageFeaturesReader(features_h5path, in_memory, shared_features),
                    tokens.split)

    @classmethod
    def from_arrays(
        cls,
        programs: np.ndarray,
        questions: np.ndarray,
        answers: np.ndarray,
        image_indices: np.ndarray,
        features: np.ndarray,
        split: str = "train",
    ) -> "ModuleTrainingDataset":
        r"""A dataset over in-memory (N, Lp) programs, (N, Lq) questions, (N,)
        answers and (N,) indices into ``features`` (M, C, H, W)."""
        dataset = cls.__new__(cls)
        dataset._setup(np.asarray(programs), np.asarray(questions), np.asarray(answers),
                       np.asarray(image_indices),
                       features if isinstance(features, SharedFeatures) else np.asarray(features),
                       split)
        return dataset

    def _setup(self, programs, questions, answers, image_indices, features, split):
        if not len(programs) == len(questions) == len(answers) == len(image_indices):
            raise ValueError("programs, questions, answers and image_indices differ in length")
        self._programs = programs
        self._questions = questions
        self._answers = answers
        self._image_indices = image_indices
        self._features = features
        self._split = split

    def check_tokens(self, program_vocab_size: int, question_vocab_size: int) -> None:
        r"""Raise unless every program and question token id lies in its vocabulary."""
        check_token_ids(self._programs, program_vocab_size, f"{self._split} program")
        check_token_ids(self._questions, question_vocab_size, f"{self._split} question")

    def __len__(self):
        return len(self._questions)

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "question": self._questions[indices].astype(np.int64),
            "answer": self._answers[indices].astype(np.int64),
            "image": np.asarray(self._features[self._image_indices[indices]], np.float32),
            "program": self._programs[indices].astype(np.int64),
        }

    @property
    def split(self):
        return self._split


class JointTrainingDataset:
    r"""The union of the two above (reference ``datasets.py:149-240``): the
    train and val splits give {"question", "answer", "program", "image",
    "supervision"}, the test split {"question_index", "question", "image"}.
    The supervision subset is drawn as :class:`QuestionCodingDataset` draws
    it, from the global numpy seed. ``shared_features`` (in memory) reads
    the features into shared memory, one copy for every rank of a
    data-parallel launch, as :class:`ModuleTrainingDataset` does."""

    def __init__(
        self,
        tokens_h5path: str,
        features_h5path: str,
        num_supervision: int = 699989,
        supervision_question_max_length: int = 30,
        in_memory: bool = True,
        shared_features: bool = False,
    ):
        tokens = ClevrTokensReader(tokens_h5path)
        test = tokens.split == "test"
        self._setup(None if test else tokens.programs, tokens.questions,
                    None if test else tokens.answers, tokens.image_indices,
                    ClevrImageFeaturesReader(features_h5path, in_memory, shared_features),
                    tokens.split, num_supervision, supervision_question_max_length)

    @classmethod
    def from_arrays(
        cls,
        programs: Optional[np.ndarray],
        questions: np.ndarray,
        answers: Optional[np.ndarray],
        image_indices: np.ndarray,
        features: np.ndarray,
        split: str = "train",
        num_supervision: int = 699989,
        supervision_question_max_length: int = 30,
    ) -> "JointTrainingDataset":
        r"""A dataset over in-memory (N, Lp) programs, (N, Lq) questions, (N,)
        answers and (N,) indices into ``features`` (M, C, H, W; an array or a
        :class:`SharedFeatures`); the test split takes None for programs and
        answers."""
        dataset = cls.__new__(cls)
        dataset._setup(None if programs is None else np.asarray(programs), np.asarray(questions),
                       None if answers is None else np.asarray(answers), np.asarray(image_indices),
                       features if isinstance(features, SharedFeatures) else np.asarray(features),
                       split, num_supervision, supervision_question_max_length)
        return dataset

    def _setup(self, programs, questions, answers, image_indices, features, split,
               num_supervision, max_length):
        if split != "test" and not (len(programs) == len(questions) == len(answers)
                                    == len(image_indices)):
            raise ValueError("programs, questions, answers and image_indices differ in length")
        self._programs = programs
        self._questions = questions
        self._answers = answers
        self._image_indices = image_indices
        self._features = features
        self._split = split
        self._supervision_list = _make_supervision_list(questions, split, num_supervision,
                                                        max_length)

    def check_tokens(self, program_vocab_size: int, question_vocab_size: int) -> None:
        r"""Raise unless every program and question token id lies in its vocabulary."""
        if self._programs is not None:
            check_token_ids(self._programs, program_vocab_size, f"{self._split} program")
        check_token_ids(self._questions, question_vocab_size, f"{self._split} question")

    def __len__(self):
        return len(self._questions)

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        image = np.asarray(self._features[self._image_indices[indices]], np.float32)
        if self._split == "test":
            return {
                "question_index": np.asarray(indices, np.int64),
                "question": self._questions[indices].astype(np.int64),
                "image": image,
            }
        return {
            "question": self._questions[indices].astype(np.int64),
            "answer": self._answers[indices].astype(np.int64),
            "program": self._programs[indices].astype(np.int64),
            "image": image,
            "supervision": self._supervision_list[indices],
        }

    def get_supervision_list(self) -> np.ndarray:
        return self._supervision_list

    @property
    def split(self):
        return self._split
