r"""
Host-side metric accumulators (a copy of ``Average`` from
``probnmn_tpu/utils/metrics.py``; reference allennlp ``Average``).
"""
from __future__ import annotations


class Average:
    def __init__(self):
        self._total = 0.0
        self._count = 0

    def __call__(self, value: float) -> None:
        self._total += float(value)
        self._count += 1

    def get_metric(self, reset: bool = True) -> float:
        value = self._total / self._count if self._count else 0.0
        if reset:
            self._total, self._count = 0.0, 0
        return value
