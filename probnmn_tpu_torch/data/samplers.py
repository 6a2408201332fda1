r"""
Index samplers (a copy of ``probnmn_tpu/data/samplers.py``; reference
``probnmn/data/samplers.py``). numpy ``RandomState``s, so a seed gives the
same order as the JAX package's samplers.
"""
from __future__ import annotations

import numpy as np


class RandomSampler:
    r"""Uniform shuffling without replacement, re-shuffled every epoch."""

    def __init__(self, num_examples: int, seed: int = 0):
        self._num = num_examples
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._num

    def epoch(self) -> np.ndarray:
        return self._rng.permutation(self._num)


class SequentialSampler:
    def __init__(self, num_examples: int):
        self._num = num_examples

    def __len__(self) -> int:
        return self._num

    def epoch(self) -> np.ndarray:
        return np.arange(self._num)
