r"""
Training observability (counterpart of ``probnmn_tpu/utils/observability.py``):
``StepTimer``, :func:`profile_trace` and :func:`annotate` on ``torch.profiler``
(the JAX package's are on ``jax.profiler``), ``RecordingWriter``, an
in-memory stand-in for the trainer's scalar writer, and ``NullWriter``, the
writer of a data-parallel rank other than rank 0, which writes nothing.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Iterator, Optional

logger = logging.getLogger(__name__)


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


class NullWriter:
    r"""A scalar writer that drops every scalar: the ranks other than rank 0
    of a data-parallel run (``parallel/mesh.py``) log nothing."""

    def add_scalar(self, tag, value, step):
        pass

    def add_scalars(self, tag, values, step):
        pass


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[object]:
    r"""``torch.profiler`` over the block, the host's activity and, where a
    card is present, the card's (its kernels by name), written on exit as a
    Chrome trace ``trace_<pid>_<time>.json`` into ``log_dir`` (open it in
    Perfetto or ``chrome://tracing``). Yields the profiler. With a card, the
    card idles 20 ms after the trace starts and before it stops: without
    that gap the profiler on the H100 now and then lost a trace's first
    kernels, or all of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if card:
            torch.cuda.synchronize()
            time.sleep(0.02)
        yield prof
        if card:
            torch.cuda.synchronize()
            time.sleep(0.02)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("Wrote profiler trace to %s", path)


def annotate(name: str):
    r"""A named range in profiler traces (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)
