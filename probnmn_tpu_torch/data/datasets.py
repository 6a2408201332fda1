r"""
Phase datasets (counterpart of ``probnmn_tpu/data/datasets.py``; reference
``probnmn/data/datasets.py``), numpy-native: ``__len__`` and the vectorized
``get_batch(indices)`` that the batch pipeline gathers with.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from probnmn_tpu_torch.data.readers import ClevrTokensReader


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
        r"""Raise unless every token id lies in [0, ``vocab_size``): kernel K3f
        clamps ids into the embedding, where the plain path would raise."""
        bad = (self._programs < 0) | (self._programs >= vocab_size)
        if bad.any():
            row = int(np.argwhere(bad)[0][0])
            raise ValueError(f"{self._split} program {row} has a token id outside "
                             f"[0, {vocab_size}): {self._programs[row].tolist()}")

    def __len__(self):
        return len(self._programs)

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return {"program": self._programs[indices].astype(np.int64)}

    @property
    def split(self):
        return self._split
