r"""
Serving engine: question tokens + image features -> CLEVR answers
(counterpart of ``probnmn_tpu/serving.py``; the reference's closest surface
is its batch script, reference ``inference.py:74-95``).

- **Fixed batches.** :meth:`InferenceEngine.predict` pads every request batch
  to ``batch_size`` and un-pads the answers, so the device always sees the
  same shapes; larger requests run in chunks.
- **The pipeline.** ProgramGenerator decode (sampling by default, as the
  reference's inference script; greedy; or beam, beyond the reference) ->
  NMN stem -> program interpreter -> classifier. On ``cuda`` sampling runs
  the fused sampling kernel and the interpreter runs the interpreter kernel;
  on ``cpu`` both run their plain PyTorch versions.
- **Sampling** draws one Philox seed per batch from the engine's
  ``torch.Generator`` (seeded by ``rng_seed``), unless the caller passes one.
- **Compute dtype.** bfloat16 on ``cuda`` and float32 on ``cpu`` unless the
  caller or the NMN spec says otherwise (the JAX package's "auto").
- **Compute-dtype uploads.** A batch's request groups are written in one
  pass into a host staging buffer already in the compute dtype (float32 ->
  bfloat16 by PyTorch's cast, which rounds to nearest even as ``ml_dtypes``
  does in the JAX engine, a NaN staying a NaN; pad rows zero), pinned on
  ``cuda``, and copied to the card without blocking. The buffers come from
  PyTorch's caching host allocator, which reuses a block only once the copy
  out of it has completed.
- **Micro-batching.** :meth:`InferenceEngine.submit` / :meth:`submit_many`
  enqueue requests and return futures; :meth:`start` runs a dispatcher that
  coalesces them up to ``batch_size`` or a deadline, pads each batch to the
  smallest *bucket* of a short ladder (``batch_size // 4**k``, e.g.
  4/16/64/256) and launches it on the engine's own CUDA streams, with up to
  ``pipeline_depth`` batches dispatched and not yet fetched.
- **Several cards** (``num_devices``, the JAX engine's data mesh): one
  process, one *replica* a card (its stream, K1's packed weights, the NMN's
  banks and tables). Each padded batch is split into equal contiguous
  shards, shard k on card k, each launched under that card's device guard
  (the kernels launch on the calling thread's current device); the batch's
  answers meet in one pinned host buffer and it keeps one sync point. The
  count follows the JAX policy (``parallel/mesh.py::auto_world``), and the
  bucket ladder keeps only sizes the count divides. The batch draws one
  Philox seed and shard k draws rows ``[k B / n, (k + 1) B / n)`` of its
  stream (K1's ``row_base``), so sampling answers do not depend on the
  card count. ``share_card=True`` puts every shard on the engine's card (a
  one-card rehearsal); on the CPU the shards run one after another.

- **From a checkpoint.** :meth:`InferenceEngine.from_checkpoint` reads the
  ProgramGenerator and the NMN from a checkpoint of the port, of the JAX
  package (its ``.ckpt``) or of the reference (its ``.pth``).

- **Warm restarts.** ``compilation_cache_dir=...`` roots the kernels' build
  cache there (``utils/compilation_cache.py``; ``"auto"`` resolves as the JAX
  package resolves its XLA cache), so that a restarted process loads the
  kernels instead of building them.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext
from concurrent.futures import Future
from queue import Empty, Queue
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from probnmn_tpu_torch.data.pipeline import image_to_nhwc
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.models import nmn as nmn_lib
from probnmn_tpu_torch.models import program_generator
from probnmn_tpu_torch.models.nmn import cast_params, resolve_compute_dtype
from probnmn_tpu_torch.models.seq2seq import GREEDY, beam_search_forward, seq2seq_forward
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward, pack_weights
from probnmn_tpu_torch.parallel.mesh import auto_world, available_devices

_SEED_RANGE = 2 ** 62


class _Launched(NamedTuple):
    r"""A dispatched batch: its answers (on ``cuda`` a pinned host buffer
    each shard copies its rows into behind its pipeline), the events each
    shard recorded after its copy (none on the CPU), the valid rows and the
    padded size, and the device tensors made on the shards' streams, held
    until :meth:`InferenceEngine._finish` returns."""
    answers: torch.Tensor
    done: tuple
    n: int
    pad_to: int
    keep: tuple


class _Replica(NamedTuple):
    r"""One card's copy of the model: its device, its own stream (None on
    the CPU), the float32 ProgramGenerator parameters, K1's packed weights
    (sampling on ``cuda``; else None) and the NMN forward with its banks and
    tables on that card."""
    device: torch.device
    stream: Optional[torch.cuda.Stream]
    pg_params: Dict[str, Any]
    pg_packed: Optional[Dict[str, torch.Tensor]]
    nmn_forward: Any


class InferenceEngine:
    def __init__(
        self,
        vocabulary: Vocabulary,
        pg_spec,
        nmn_spec,
        pg_params: Dict[str, Any],
        nmn_params: Dict[str, Any],
        batch_size: int = 256,
        rng_seed: int = 0,
        decoding: str = "sampling",
        device="cuda",
        compute_dtype: Optional[str] = None,
        beam_size: int = 1,
        compilation_cache_dir: Optional[str] = None,
        num_devices: Optional[int] = None,
        share_card: bool = False,
    ):
        r"""``decoding``: ``"sampling"`` (the reference inference default,
        ``inference.py:80``), ``"greedy"`` (the reference evaluators') or
        ``"beam"`` (width ``beam_size``; 1 gives the greedy tokens).
        ``compute_dtype``: ``"float32"``, ``"bfloat16"`` or None (the NMN
        spec's, else bfloat16 on ``cuda`` and float32 on ``cpu``).
        ``compilation_cache_dir``: where the kernels' build cache lives
        (``"auto"``: ``$PROBNMN_COMPILATION_CACHE`` or the default; None:
        ``build/torch_kernels`` beside the package).
        ``num_devices``: cards to shard each batch over, one replica a card
        (None or 1: one; 0: every card; N: the largest count <= N that
        divides ``batch_size``; on the CPU, N shards in turn).
        Over several cards shard k lives on ``cuda:k``, so ``device`` must
        then name card 0; ``share_card``: every shard on ``device``'s card."""
        if decoding not in ("sampling", "greedy", "beam"):
            raise ValueError(f"unknown decoding strategy: {decoding!r}")
        if beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        if compilation_cache_dir is not None:
            from probnmn_tpu_torch.utils.compilation_cache import enable_compilation_cache

            enable_compilation_cache(compilation_cache_dir)
        self._device = resolve_device(device)
        self._vocabulary = vocabulary
        self._pg_spec = pg_spec
        self._nmn_spec = nmn_spec
        self._batch_size = batch_size
        self._decoding = decoding
        self._beam_size = beam_size
        self._generator = torch.Generator().manual_seed(rng_seed)
        dtype = resolve_compute_dtype(compute_dtype or nmn_spec.compute_dtype, self._device)
        self._compute_dtype = dtype

        self._cuda = self._device.type == "cuda"
        available = ((num_devices or 1) if share_card
                     else available_devices(self._device.type, num_devices))
        shards = auto_world(num_devices, batch_size, available)
        spread = self._cuda and not share_card and shards > 1
        if spread and self._device.index not in (None, 0):
            raise ValueError(f"shards over {shards} cards start at cuda:0; {self._device} "
                             f"names another card")
        self._replicas = [
            self._make_replica(torch.device("cuda", k) if spread else self._device,
                               pg_params, nmn_params)
            for k in range(shards)
        ]

        # Bucket ladder batch_size // 4**k that the shard count divides,
        # floored at max(2, shards) (a size-1 bucket buys negligible latency
        # over the next one up), the full batch always in: the dispatcher
        # pads each batch to the smallest bucket covering it; predict() pads
        # to the full batch.
        bucket_floor = max(2, shards)
        buckets = []
        b = batch_size
        while b >= bucket_floor or b == batch_size:
            if b % shards == 0:
                buckets.append(b)
            if b // 4 < bucket_floor:
                break
            b //= 4
        self._buckets = sorted(set(buckets))

        # Batches are enqueued one at a time (predict callers and the
        # dispatcher share the streams); each stages its own buffer first.
        self._launch_lock = threading.Lock()

        # Micro-batching state.
        self._queue: Queue = Queue()
        self._dispatcher: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._join_timeout = 30.0
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0}
        # Sliding window of dispatcher request latencies (submit -> result).
        self._latencies: deque = deque(maxlen=16384)
        # Request-level backlog (the queue holds groups).
        self._queued_requests = 0
        # Dispatcher batches dispatched and not yet fetched, and the most seen.
        self._in_flight = 0
        self._max_in_flight = 0
        self._started_at = time.monotonic()

    def _make_replica(self, device: torch.device, pg_params, nmn_params) -> _Replica:
        r"""The model on ``device``; every batch runs on the replica's own
        stream, and its weights are made on the card's default one."""
        with torch.cuda.device(device) if device.type == "cuda" else nullcontext():
            pg = cast_params(pg_params, torch.float32, device)
            # The sampling kernel's weight layout, packed once.
            packed = (pack_weights(pg, self._pg_spec, self._compute_dtype, device)
                      if device.type == "cuda" and self._decoding == "sampling" else None)
            nmn_forward = nmn_lib.make_fast_inference_fn(
                cast_params(nmn_params, torch.float32, device), self._nmn_spec,
                device=device, dtype=self._compute_dtype,
            )
            stream = None
            if device.type == "cuda":
                stream = torch.cuda.Stream(device)
                torch.cuda.synchronize(device)
        return _Replica(device, stream, pg, packed, nmn_forward)

    @classmethod
    def from_checkpoint(
        cls,
        config,
        checkpoint_path: str,
        batch_size: Optional[int] = None,
        compute_dtype: Optional[str] = None,
        decoding: str = "sampling",
        beam_size: int = 1,
        device="cuda",
        compilation_cache_dir: Optional[str] = None,
        num_devices: Optional[int] = None,
    ) -> "InferenceEngine":
        r"""An engine over the ``program_generator`` and ``nmn`` of a
        checkpoint (a joint_training one holds both): the port's, the JAX
        package's ``.ckpt`` or the reference's ``.pth``, told apart by their
        content (the JAX package's ``from_checkpoint``). The vocabulary, the
        specs, the batch size (unless given) and the sampling seed come from
        ``config``; ``num_devices`` as in the engine."""
        from probnmn_tpu_torch.training._trainer import load_models

        vocabulary = Vocabulary.from_files(config.DATA.VOCABULARY)
        pg_spec = program_generator.make_spec(vocabulary, config)
        nmn_spec = nmn_lib.make_spec(vocabulary, config)
        models = load_models(checkpoint_path,
                             {"program_generator": pg_spec, "nmn": nmn_spec}, vocabulary)
        return cls(
            vocabulary, pg_spec, nmn_spec, models["program_generator"], models["nmn"],
            batch_size=batch_size or config.OPTIM.BATCH_SIZE, rng_seed=config.RANDOM_SEED,
            decoding=decoding, device=device, compute_dtype=compute_dtype,
            beam_size=beam_size, compilation_cache_dir=compilation_cache_dir,
            num_devices=num_devices,
        )

    @property
    def vocabulary(self) -> Vocabulary:
        return self._vocabulary

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def compute_dtype(self) -> torch.dtype:
        return self._compute_dtype

    @property
    def num_devices(self) -> int:
        r"""The shards each batch is split over, one replica each."""
        return len(self._replicas)

    # ------------------------------------------------------------------ sync
    def predict(
        self,
        questions: np.ndarray,   # (n, Tq) int tokens
        images: np.ndarray,      # (n, C, H, W) features (reference H5 layout)
        seed: Optional[int] = None,
    ) -> List[str]:
        r"""Answer ``n`` requests, ``batch_size`` per device call (each padded
        to ``batch_size``); answers detokenized via the vocabulary. ``seed``
        fixes the sampling noise (one Philox seed per chunk, drawn from it)."""
        questions = np.asarray(questions)
        images = np.asarray(images)
        self._check_inputs(questions, images)
        n = questions.shape[0]
        if n == 0:
            return []
        if n > self._batch_size:
            starts = range(0, n, self._batch_size)
            # Decorrelate chunks: one caller seed must not give every chunk
            # the same sampling noise.
            chunk_gen = torch.Generator().manual_seed(seed) if seed is not None else None
            out: List[str] = []
            for start in starts:
                chunk_seed = (
                    self._draw_seed(chunk_gen) if chunk_gen is not None else None
                )
                out.extend(self.predict(
                    questions[start:start + self._batch_size],
                    images[start:start + self._batch_size], chunk_seed,
                ))
            return out
        return self._run_padded(questions, images, seed, self._batch_size)

    def _check_inputs(self, questions: np.ndarray, images: np.ndarray) -> None:
        r"""Reject requests the kernels cannot take: a token outside the
        question vocabulary would index past the embedding table on the card."""
        spec = self._nmn_spec
        want = (spec.feature_channels, spec.height, spec.width)
        if questions.ndim != 2 or not np.issubdtype(questions.dtype, np.integer):
            raise ValueError(f"questions must be (n, length) integer tokens, got "
                             f"{questions.dtype} {questions.shape}")
        if images.ndim != 4 or images.shape[1:] != want or len(images) != len(questions):
            raise ValueError(f"images must be ({len(questions)}, {want[0]}, {want[1]}, "
                             f"{want[2]}), got {images.shape}")
        vocab = self._pg_spec.source_vocab_size
        if questions.size and (questions.min() < 0 or questions.max() >= vocab):
            raise ValueError(f"question tokens must lie in [0, {vocab})")

    @staticmethod
    def _draw_seed(gen: torch.Generator) -> int:
        return int(torch.randint(0, _SEED_RANGE, (1,), generator=gen))

    def _run_padded(
        self,
        questions: np.ndarray,
        images: np.ndarray,
        seed: Optional[int],
        pad_to: int,
        count_stats: bool = True,
    ) -> List[str]:
        r"""Pad ``n <= pad_to`` requests to ``pad_to`` rows, run the pipeline,
        unpad and detokenize: :meth:`_launch_padded_groups`, then
        :meth:`_finish`. ``count_stats=False`` (warmup) keeps synthetic
        traffic out of the counters."""
        return self._finish(self._launch_padded_groups([questions], [images], seed, pad_to),
                            count_stats)

    def _stage(self, q_groups: List[np.ndarray], im_groups: List[np.ndarray],
               pad_to: int) -> Tuple[torch.Tensor, torch.Tensor]:
        r"""Write the request groups into a new staging buffer in one pass
        (the features cast to the compute dtype on the way), pad rows zero;
        returns (questions int64, images). Each group is checked first: a
        malformed one raises before anything is written."""
        for qg, img in zip(q_groups, im_groups):
            self._check_inputs(qg, img)
        n = sum(g.shape[0] for g in q_groups)
        if n > pad_to:
            raise ValueError(f"{n} requests do not fit a batch of {pad_to}")
        spec = self._nmn_spec
        questions = torch.empty((pad_to, q_groups[0].shape[1]), dtype=torch.int64,
                                pin_memory=self._cuda)
        images = torch.empty((pad_to, spec.feature_channels, spec.height, spec.width),
                             dtype=self._compute_dtype, pin_memory=self._cuda)
        cursor = 0
        for qg, img in zip(q_groups, im_groups):
            k = qg.shape[0]
            questions[cursor:cursor + k] = torch.from_numpy(qg.astype(np.int64, copy=False))
            images[cursor:cursor + k] = torch.from_numpy(np.ascontiguousarray(img, np.float32))
            cursor += k
        questions[n:].zero_()
        images[n:].zero_()
        return questions, images

    def _launch_padded_groups(
        self,
        q_groups: List[np.ndarray],
        im_groups: List[np.ndarray],
        seed: Optional[int],
        pad_to: int,
    ) -> _Launched:
        r"""Stage the request groups (:meth:`_stage`); for each shard, under
        its card's device guard and on its stream, copy its rows of the
        buffer to the card without blocking and enqueue the pipeline and its
        answers' copy into one pinned host buffer; returns without a sync
        (:meth:`_finish` is the batch's one sync point). The seed is drawn
        from the engine's generator unless given."""
        n = sum(g.shape[0] for g in q_groups)
        if seed is None:
            with self._lock:
                seed = self._draw_seed(self._generator)
        questions, images = self._stage(q_groups, im_groups, pad_to)
        rows = pad_to // len(self._replicas)
        if not self._cuda:
            with self._launch_lock:
                answers = torch.cat([
                    self._pipeline(questions[lo:lo + rows], images[lo:lo + rows], seed, k, lo)
                    for k, lo in enumerate(range(0, pad_to, rows))])
            return _Launched(answers, (), n, pad_to, ())
        host = torch.empty(pad_to, dtype=torch.int64, pin_memory=True)
        done, keep = [], []
        with self._launch_lock:
            for k, replica in enumerate(self._replicas):
                lo = k * rows
                # The kernels launch on the thread's current device: the
                # guard, not the stream, makes it this card.
                with torch.cuda.device(replica.device), torch.cuda.stream(replica.stream):
                    q = questions[lo:lo + rows].to(replica.device, non_blocking=True)
                    im = images[lo:lo + rows].to(replica.device, non_blocking=True)
                    answers = self._pipeline(q, im, seed, k, lo)
                    host[lo:lo + rows].copy_(answers, non_blocking=True)
                    event = torch.cuda.Event(blocking=True)
                    event.record(replica.stream)
                done.append(event)
                keep.append((q, im, answers))
        return _Launched(host, tuple(done), n, pad_to, tuple(keep))

    def _pipeline(self, questions: torch.Tensor, images: torch.Tensor, seed: int,
                  shard: int = 0, row_base: int = 0) -> torch.Tensor:
        r"""Answers of one shard's rows on its replica; ``row_base``: the
        shard's first row in the batch (its rows of the batch's Philox
        stream)."""
        replica = self._replicas[shard]
        if self._decoding == "beam":
            programs = beam_search_forward(
                replica.pg_params, self._pg_spec, questions, self._beam_size)["predictions"]
        elif self._decoding == GREEDY:
            programs = seq2seq_forward(
                replica.pg_params, self._pg_spec, questions, GREEDY
            )["predictions"]
        else:
            programs = fused_sampling_forward(
                replica.pg_params, self._pg_spec, questions, seed=seed, row_base=row_base,
                compute_dtype=self._compute_dtype, packed=replica.pg_packed,
            )["predictions"]
        return replica.nmn_forward(image_to_nhwc(images), programs)["predictions"]

    def _fetch(self, launched: _Launched) -> List[int]:
        r"""Wait for every shard's answers on the host; the valid rows."""
        for event in launched.done:
            event.synchronize()
        return launched.answers[:launched.n].tolist()

    def _finish(self, launched: _Launched, count_stats: bool = True) -> List[str]:
        r"""Wait for a dispatched batch (its one synchronization point) and
        detokenize its valid rows. The counters count the batch only once
        its answers are in."""
        answers = [self._vocabulary.get_token_from_index(int(a), "answers")
                   for a in self._fetch(launched)]
        if count_stats:
            with self._lock:
                self._stats["requests"] += launched.n
                self._stats["batches"] += 1
                self._stats["padded_slots"] += launched.pad_to - launched.n
        return answers

    def bucket_for(self, n: int) -> int:
        r"""Smallest micro-batch bucket covering ``n`` requests."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._batch_size

    def warmup(self, question_length: Optional[int] = None) -> None:
        r"""Run the pipeline once at every bucket (the full batch among
        them) on every card, so no live request pays a kernel build, a
        module load, a first allocation or a staging buffer.
        ``question_length`` must match the callers' padded question width
        (the reference's fixed 45 by default)."""
        if question_length is None:
            from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH

            question_length = MAX_QUESTION_LENGTH
        self._load_kernels()
        spec = self._nmn_spec
        for b in self._buckets:
            self._run_padded(
                np.zeros((1, question_length), np.int64),
                np.zeros((1, spec.feature_channels, spec.height, spec.width), np.float32),
                None, b, count_stats=False,
            )

    def _load_kernels(self) -> None:
        r"""On ``cuda``, build or load the kernel library here, on the
        caller's thread, and never inside the dispatcher's threads."""
        if self._cuda:
            from probnmn_tpu_torch.ops.kernels import _build

            _build.library()

    # ------------------------------------------------------------ micro-batch
    def start(self, max_batch_delay: float = 0.005, pipeline_depth: int = 2) -> None:
        r"""Start the micro-batching dispatcher: queued :meth:`submit`
        requests coalesce until the batch fills or ``max_batch_delay``
        seconds pass since the oldest queued request.

        A *launcher* thread coalesces, stages, uploads and enqueues each
        batch on the engine's stream, then hands it to a *completer* thread
        that waits for its answers and resolves the futures, so batch N+1's
        host assembly and upload overlap batch N's device work. The launcher
        reserves one of ``pipeline_depth`` slots before it stages a batch
        and the completer frees it once the batch's futures are resolved:
        at most ``pipeline_depth`` batches are dispatched and not yet
        fetched. ``pipeline_depth=1`` is one thread, launch then fetch."""
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if self._dispatcher is not None:
            if self._running.is_set():
                return
            if any(t is not None and t.is_alive() for t in (self._dispatcher, self._completer)):
                raise RuntimeError("a stopped dispatcher thread is still alive; the engine "
                                   "does not start a second one on its queue")
            self._dispatcher = self._completer = None
        self._load_kernels()
        if self._cuda:
            for replica in self._replicas:
                torch.cuda.synchronize(replica.device)
        self._running.set()
        pipelined = pipeline_depth > 1
        slots = threading.BoundedSemaphore(pipeline_depth)
        completions: Queue = Queue()

        def fail(pending, total, error):
            for p in pending:
                for fut in p[2]:
                    fut.set_exception(error)
            self._note_dequeued(total)

        def launch():
            # A group that would overflow the batch is carried to the next
            # cycle: one device batch a cycle.
            carry = None
            while self._running.is_set():
                if carry is not None:
                    first, carry = carry, None
                else:
                    try:
                        first = self._queue.get(timeout=0.05)
                    except Empty:
                        continue
                # Queue items are groups: (questions (n, Tq), images (n, ...),
                # [n futures], t_submit).
                pending = [first]
                total = first[0].shape[0]
                deadline = time.monotonic() + max_batch_delay
                while total < self._batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        group = self._queue.get(timeout=remaining)
                    except Empty:
                        break
                    if total + group[0].shape[0] > self._batch_size:
                        carry = group
                        break
                    pending.append(group)
                    total += group[0].shape[0]
                if not total:
                    continue
                slots.acquire()
                with self._lock:
                    self._in_flight += 1
                    self._max_in_flight = max(self._max_in_flight, self._in_flight)
                # One malformed request fails its batch's futures; the
                # threads live on.
                try:
                    launched = self._launch_padded_groups(
                        [p[0] for p in pending], [p[1] for p in pending], None,
                        self.bucket_for(total))
                except Exception as error:
                    release()
                    fail(pending, total, error)
                    continue
                if pipelined:
                    completions.put((launched, pending, total))
                else:
                    resolve(launched, pending, total)
            if pipelined:
                completions.put(None)  # stops the completer behind the batches in flight

        def release():
            with self._lock:
                self._in_flight -= 1
            slots.release()

        def resolve(launched, pending, total):
            try:
                resolved = self._finish(launched)
            except Exception as error:
                release()
                fail(pending, total, error)
                return
            release()
            done = time.monotonic()
            latencies = []
            cursor = 0
            for p in pending:
                k = p[0].shape[0]
                latencies.extend([done - p[3]] * k)
                for fut, answer in zip(p[2], resolved[cursor:cursor + k]):
                    fut.set_result(answer)
                cursor += k
            with self._lock:
                self._latencies.extend(latencies)
            self._note_dequeued(total)

        def complete():
            while True:
                item = completions.get()
                if item is None:
                    return
                resolve(*item)

        self._dispatcher = threading.Thread(
            target=launch, daemon=True, name="probnmn-serving-launcher")
        self._dispatcher.start()
        if pipelined:
            self._completer = threading.Thread(
                target=complete, daemon=True, name="probnmn-serving-completer")
            self._completer.start()

    def stop(self) -> None:
        r"""Stop the dispatcher once the batches in flight are resolved.
        Raises if a thread does not stop within the join timeout (30 s); its
        handle is kept, so :meth:`start` cannot put a second launcher on the
        same queue."""
        if self._dispatcher is None:
            return
        self._running.clear()
        # The launcher leaves within its 50 ms poll (or after its cycle) and
        # queues the completer's stop behind the batches still in flight.
        for name in ("_dispatcher", "_completer"):
            thread = getattr(self, name)
            if thread is None:
                continue
            thread.join(timeout=self._join_timeout)
            if thread.is_alive():
                raise RuntimeError(f"the dispatcher's thread {thread.name} did not stop within "
                                   f"{self._join_timeout} s; its handle is kept")
        self._completer = None
        self._dispatcher = None

    def submit(self, question: np.ndarray, image: np.ndarray) -> Future:
        r"""Enqueue one request for the micro-batching dispatcher; returns a
        Future resolving to the answer string. ``start()`` must be running."""
        return self.submit_many(np.asarray(question)[None], np.asarray(image)[None])[0]

    def submit_many(self, questions: np.ndarray, images: np.ndarray) -> List[Future]:
        r"""Enqueue ``n`` requests as one dispatcher group (one queue
        round-trip; more than ``batch_size`` requests as groups of
        ``batch_size``); returns one Future per request. Groups coalesce with
        other pending requests up to the batch size, and a group is never
        split across batches."""
        if self._dispatcher is None or not self._running.is_set():
            raise RuntimeError("call start() before submit()")
        questions = np.asarray(questions)
        images = np.asarray(images)
        futures: List[Future] = [Future() for _ in range(questions.shape[0])]
        with self._lock:
            self._queued_requests += len(futures)
        now = time.monotonic()
        for start in range(0, len(futures), self._batch_size):
            end = start + self._batch_size
            self._queue.put((questions[start:end], images[start:end], futures[start:end], now))
        return futures

    def _note_dequeued(self, n: int) -> None:
        with self._lock:
            self._queued_requests -= n

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        r"""The JAX engine's counters (requests, batches and padded slots of
        the batches answered, questions/s since the engine was made, the
        queue depth in requests, and submit-to-result latency percentiles in
        seconds over the dispatcher's last 16,384 requests), and
        ``max_in_flight``: the most dispatcher batches dispatched and not
        yet fetched at once."""
        with self._lock:
            s = dict(self._stats)
            lat = np.asarray(self._latencies, np.float64)
            s["queue_depth"] = self._queued_requests
            s["max_in_flight"] = self._max_in_flight
        s["qps"] = s["requests"] / max(time.monotonic() - self._started_at, 1e-9)
        if lat.size:
            s["latency_p50"], s["latency_p95"], s["latency_p99"] = (
                float(np.percentile(lat, q)) for q in (50, 95, 99))
            s["latency_count"] = int(lat.size)
        return s
