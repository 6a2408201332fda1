r"""
Host -> device batch pipeline (counterpart of ``probnmn_tpu/data/pipeline.py``).

- :class:`BatchIterator`: a cyclic iterator of fixed-size batches over
  vectorized dataset gathers. Sampler epochs are concatenated and the
  remainder at an epoch end is dropped. A background thread does the host
  gather, a bounded queue ahead of the consumer; the consumer stages each
  batch in pinned host memory and starts its copy to the card with
  ``non_blocking=True`` one batch ahead, so the copy overlaps the current
  step. With ``sort_descending_by`` (the semi-supervised phases pass
  "supervision") each batch is stable-sorted by that field, descending, and
  carries the host-side count of its nonzero rows under ``_num_<key>``, a
  plain int that never goes to the card: the trainer takes the exact
  supervised and unsupervised subsets with it.
- :class:`EpochIterator`: one pass for evaluation, dropping the final partial
  batch unless ``include_last=True`` (test-split inference, which must cover
  every row).
- :func:`image_to_nhwc`: image features arrive NCHW from the H5 files
  (reference layout (N, 1024, 14, 14)); the port's NMN functions take NHWC,
  like the JAX package's, so the two can be compared on the same arrays.

Both iterators put batches on ``cuda`` unless the caller asks for the CPU.
Not ported yet: ``transform`` (its caller comes with a later slice).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from probnmn_tpu_torch.device import resolve_device


def image_to_nhwc(image: torch.Tensor) -> torch.Tensor:
    r"""NCHW -> NHWC (a view; callers that need contiguity copy)."""
    return image.permute(0, 2, 3, 1)


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    r"""numpy batch -> tensors on ``device``; for a CUDA device staged in pinned
    host memory and copied asynchronously on the current stream. Keys that
    start with "_" are host-side metadata and stay as they are."""
    out = {}
    for key, value in batch.items():
        if key.startswith("_"):
            out[key] = value
            continue
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            tensor = tensor.pin_memory().to(device, non_blocking=True)
        out[key] = tensor
    return out


class BatchIterator:
    r"""Cyclic iterator of fixed-size batches: sampler epochs are concatenated and
    the remainder at an epoch boundary is dropped (every batch has the same
    shape)."""

    PREFETCH = 2  # host batches gathered ahead of the consumer

    def __init__(self, dataset, sampler, batch_size: int, device="cuda",
                 sort_descending_by: Optional[str] = None):
        self._dataset = dataset
        self._sampler = sampler
        self._batch_size = batch_size
        self._device = resolve_device(device)
        self._sort_key = sort_descending_by
        # Rolling per-stage timers: how long the consumer waited on the
        # host-gather queue, and how long staging and starting the copy took.
        self._wait_times: deque = deque(maxlen=50)
        self._put_times: deque = deque(maxlen=50)

    def stage_metrics(self) -> Dict[str, float]:
        r"""Rolling per-stage averages in ms: ``prefetch_wait_ms`` (consumer
        blocked on the host-gather queue) and ``h2d_dispatch_ms`` (pinning the
        batch and enqueueing its copy; the copy itself is asynchronous)."""
        out = {}
        if self._wait_times:
            out["prefetch_wait_ms"] = 1e3 * sum(self._wait_times) / len(self._wait_times)
        if self._put_times:
            out["h2d_dispatch_ms"] = 1e3 * sum(self._put_times) / len(self._put_times)
        return out

    def _index_stream(self) -> Iterator[np.ndarray]:
        while True:
            order = self._sampler.epoch()
            for start in range(0, len(order) - self._batch_size + 1, self._batch_size):
                yield order[start : start + self._batch_size]

    def _host_batches(self) -> Iterator[Dict[str, Any]]:
        for indices in self._index_stream():
            batch = self._dataset.get_batch(indices)
            if self._sort_key is not None:
                key_values = np.asarray(batch[self._sort_key])
                order = np.argsort(-key_values.astype(np.int64), kind="stable")
                batch = {k: v[order] for k, v in batch.items()}
                batch["_num_" + self._sort_key] = int(np.count_nonzero(key_values))
            yield batch

    def _put(self, batch):
        t0 = time.perf_counter()
        out = to_device(batch, self._device)
        self._put_times.append(time.perf_counter() - t0)
        return out

    def __iter__(self):
        it = self._host_batches()
        # The host gather runs on a background thread, bounded by a
        # PREFETCH-deep queue; the copy to the card is enqueued on the
        # consumer's thread (PyTorch's current stream is per thread), one
        # batch ahead of the one handed out.
        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()
        done = object()

        def worker():
            try:
                for batch in it:
                    if stop.is_set():
                        return
                    q.put(batch)
                q.put(done)
            except BaseException as e:  # surface reader errors on the consumer
                q.put(e)

        thread = threading.Thread(target=worker, daemon=True, name="probnmn-batch-prefetch")
        thread.start()
        try:
            device_ahead = []
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self._wait_times.append(time.perf_counter() - t0)
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                device_ahead.append(self._put(item))
                if len(device_ahead) > 1:
                    yield device_ahead.pop(0)
            while device_ahead:
                yield device_ahead.pop(0)
        finally:
            stop.set()
            # Unblock a worker stuck in q.put so it can observe `stop`.
            try:
                q.get_nowait()
            except queue.Empty:
                pass


class EpochIterator:
    r"""Single-pass (evaluation) iterator; drops the final partial batch,
    mirroring the reference evaluator's fixed ``num_batches`` loop, unless
    ``include_last=True``, which yields it too (with a smaller first axis):
    test-split inference must cover every example, and the serving engine
    pads any ``n <= batch_size`` to its batch anyway."""

    def __init__(self, dataset, batch_size: int, device="cuda", include_last: bool = False):
        self._dataset = dataset
        self._batch_size = batch_size
        self._device = resolve_device(device)
        self._include_last = include_last

    def __len__(self):
        n = len(self._dataset)
        if self._include_last:
            return -(-n // self._batch_size)
        return n // self._batch_size

    def __iter__(self):
        n = len(self._dataset)
        for start in range(0, len(self) * self._batch_size, self._batch_size):
            indices = np.arange(start, min(start + self._batch_size, n))
            yield to_device(self._dataset.get_batch(indices), self._device)
