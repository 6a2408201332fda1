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
  supervised and unsupervised subsets with it. With ``world_size`` above 1
  it also carries ``_num_<key>_global``, the count over the whole global
  batch, which the trainers divide their sums by (at ``world_size`` 1 the
  batch is the global batch and ``_num_<key>`` is that count).
- :class:`EpochIterator`: one pass for evaluation, dropping the final partial
  batch unless ``include_last=True`` (test-split inference, which must cover
  every row).
- :func:`image_to_nhwc`: image features arrive NCHW from the H5 files
  (reference layout (N, 1024, 14, 14)); the port's NMN functions take NHWC,
  like the JAX package's, so the two can be compared on the same arrays.

Both iterators put batches on ``cuda`` unless the caller asks for the CPU.
Both take ``rank`` and ``world_size`` (``parallel/mesh.py``): every rank
walks the same global batches and keeps its contiguous block of rows,
``[rank * B / n, (rank + 1) * B / n)``, before it gathers, so a rank
gathers, pins and uploads only its B / n rows (the JAX package's batch
sharding over the mesh's ``data`` axis). At ``world_size`` 1 a rank's block
is the whole batch. Both take ``transform``, a function of a host batch (a dict of numpy
arrays) that returns the batch to use, applied on the host right after the
gather and before the sort and the copy to the card, as the JAX package
applies it.

A sorted batch over ranks: each rank sorts its own block supervised-first,
so every rank holds a random mix of both subsets. The JAX package sorts the
global batch and then splits it, which at 2 ranks puts nearly all the
unsupervised rows on one device; here that rank alone would run K1, the
REINFORCE passes and K3f while the other waits at the all-reduce. Either
layout gives the same step, because the trainers' means are sums over the
global batch divided by its counts. Every rank walks the same global
batches (one sampler, one seed), so each counts the global batch's nonzero
rows on the host from the global indices and the dataset's
``get_<key>_list()``, with no collective.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional

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


def rank_rows(batch_size: int, rank: int, world_size: int) -> slice:
    r"""The rows of a global batch that ``rank`` of ``world_size`` holds."""
    if batch_size % world_size != 0:
        raise ValueError(f"batch size {batch_size} does not split over {world_size} ranks")
    rows = batch_size // world_size
    return slice(rank * rows, (rank + 1) * rows)


class BatchIterator:
    r"""Cyclic iterator of fixed-size batches: sampler epochs are concatenated and
    the remainder at an epoch boundary is dropped (every batch has the same
    shape). With ``world_size`` above 1 each batch is this rank's rows of
    the global batch of ``batch_size``."""

    PREFETCH = 2  # host batches gathered ahead of the consumer

    def __init__(self, dataset, sampler, batch_size: int, device="cuda",
                 sort_descending_by: Optional[str] = None,
                 transform: Optional[Callable] = None, rank: int = 0, world_size: int = 1):
        self._rows = rank_rows(batch_size, rank, world_size)
        # Every row's value of the sort key, for the global batch's count.
        self._key_values = (np.asarray(getattr(dataset, f"get_{sort_descending_by}_list")())
                            if sort_descending_by is not None and world_size > 1 else None)
        self._dataset = dataset
        self._sampler = sampler
        self._batch_size = batch_size
        self._transform = transform
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
        r"""The global batches' indices."""
        while True:
            order = self._sampler.epoch()
            for start in range(0, len(order) - self._batch_size + 1, self._batch_size):
                yield order[start : start + self._batch_size]

    def _host_batches(self) -> Iterator[Dict[str, Any]]:
        for global_indices in self._index_stream():
            indices = global_indices[self._rows]
            batch = self._dataset.get_batch(indices)
            if self._transform is not None:
                batch = self._transform(batch)
            if self._sort_key is not None:
                key_values = np.asarray(batch[self._sort_key])
                order = np.argsort(-key_values.astype(np.int64), kind="stable")
                batch = {k: v[order] for k, v in batch.items()}
                count = int(np.count_nonzero(key_values))
                batch["_num_" + self._sort_key] = count
                if self._key_values is not None:
                    if count != int(np.count_nonzero(self._key_values[indices])):
                        raise ValueError(f"the transform changed {self._sort_key!r}, which the "
                                         "ranks count from the dataset")
                    batch[f"_num_{self._sort_key}_global"] = int(
                        np.count_nonzero(self._key_values[global_indices]))
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
    pads any ``n <= batch_size`` to its batch anyway. With ``world_size``
    above 1 each batch is this rank's rows of the global batch, and the
    number of batches counts global batches."""

    def __init__(self, dataset, batch_size: int, device="cuda", include_last: bool = False,
                 transform: Optional[Callable] = None, rank: int = 0, world_size: int = 1):
        if include_last and world_size > 1:
            raise NotImplementedError("a partial last batch over several ranks (inference) is "
                                      "ROADMAP.md queue 1 item 5, piece (d)")
        self._rows = rank_rows(batch_size, rank, world_size)
        self._dataset = dataset
        self._batch_size = batch_size
        self._transform = transform
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
            indices = np.arange(start, min(start + self._batch_size, n))[self._rows]
            batch = self._dataset.get_batch(indices)
            if self._transform is not None:
                batch = self._transform(batch)
            yield to_device(batch, self._device)
