r"""
Training observability (``StepTimer`` from ``probnmn_tpu/utils/observability.py``)
and ``RecordingWriter``, an in-memory stand-in for the trainer's scalar writer.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional


class StepTimer:
    r"""Rolling step-time and throughput tracker.

    Call :meth:`tick` once per training step, after the step's loss has
    reached the host: PyTorch returns before the card finishes, and the
    fetch waits for it, so each interval is a whole step.
    """

    def __init__(self, window: int = 50, batch_size: Optional[int] = None):
        self._times: deque = deque(maxlen=window)
        self._last: Optional[float] = None
        self._batch_size = batch_size

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def step_time_ms(self) -> float:
        if not self._times:
            return 0.0
        return 1000.0 * sum(self._times) / len(self._times)

    @property
    def examples_per_sec(self) -> float:
        if not self._times or not self._batch_size:
            return 0.0
        return self._batch_size / (sum(self._times) / len(self._times))

    def metrics(self) -> dict:
        out = {"step_time_ms": self.step_time_ms}
        if self._batch_size:
            out["examples_per_sec"] = self.examples_per_sec
        return out


class RecordingWriter:
    r"""The trainer's scalar writer, in memory: ``scalars`` holds every
    ``(tag, value, step)`` written, with no event files and no tensorboardX."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def add_scalars(self, tag, values, step):
        for key, value in values.items():
            self.add_scalar(f"{tag}/{key}", value, step)
