r"""
Index samplers (a copy of ``probnmn_tpu/data/samplers.py``; reference
``probnmn/data/samplers.py``). numpy ``RandomState``s, so a seed gives the
same order as the JAX package's samplers.

``SupervisionWeightedRandomSampler`` draws with replacement, weighting
supervised examples by 1/num_supervised and unsupervised ones by
1/num_unsupervised, so every mini-batch is about half supervised.
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


class SupervisionWeightedRandomSampler:
    def __init__(self, supervision_list: np.ndarray, seed: int = 0):
        supervision_list = np.asarray(supervision_list).astype(np.float64)
        num_supervision = supervision_list.sum()
        num_no_supervision = len(supervision_list) - num_supervision
        weights = np.zeros_like(supervision_list)
        weights[supervision_list == 1] = 1.0 / max(num_supervision, 1)
        weights[supervision_list == 0] = 1.0 / max(num_no_supervision, 1)
        self._p = weights / weights.sum()
        self._num = len(supervision_list)
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._num

    def epoch(self) -> np.ndarray:
        return self._rng.choice(self._num, size=self._num, replace=True, p=self._p)
