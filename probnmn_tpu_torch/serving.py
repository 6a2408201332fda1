r"""
Serving engine: question tokens + image features -> CLEVR answers
(counterpart of ``probnmn_tpu/serving.py``; the reference's closest surface
is its batch script, reference ``inference.py:74-95``).

- **Fixed batches.** :meth:`InferenceEngine.predict` pads every request batch
  to ``batch_size`` and un-pads the answers, so the device always sees the
  same shapes; larger requests run in chunks.
- **The pipeline.** ProgramGenerator decode (sampling by default, as the
  reference's inference script; or greedy) -> NMN stem -> program
  interpreter -> classifier. On ``cuda`` sampling runs the fused sampling
  kernel and the interpreter runs the interpreter kernel; on ``cpu`` both run
  their plain PyTorch versions.
- **Sampling** draws one Philox seed per batch from the engine's
  ``torch.Generator`` (seeded by ``rng_seed``), unless the caller passes one.
- **Compute dtype.** bfloat16 on ``cuda`` and float32 on ``cpu`` unless the
  caller or the NMN spec says otherwise (the JAX package's "auto"). Feature
  batches are uploaded as float32 and cast on the device.

Not ported yet: the multi-device mesh, the compilation cache, the
``submit()``/``start()``/``stop()`` micro-batching dispatcher,
``from_checkpoint`` and beam decoding.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from probnmn_tpu_torch.data.pipeline import image_to_nhwc
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.models import nmn as nmn_lib
from probnmn_tpu_torch.models.nmn import cast_params, resolve_compute_dtype
from probnmn_tpu_torch.models.seq2seq import GREEDY, seq2seq_forward
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward, pack_weights

_SEED_RANGE = 2 ** 62


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
    ):
        r"""``decoding``: ``"sampling"`` (the reference inference default,
        ``inference.py:80``) or ``"greedy"`` (the reference evaluators').
        ``compute_dtype``: ``"float32"``, ``"bfloat16"`` or None (the NMN
        spec's, else bfloat16 on ``cuda`` and float32 on ``cpu``)."""
        if decoding not in ("sampling", "greedy"):
            raise ValueError(f"unknown decoding strategy: {decoding!r}")
        self._device = resolve_device(device)
        self._vocabulary = vocabulary
        self._pg_spec = pg_spec
        self._nmn_spec = nmn_spec
        self._batch_size = batch_size
        self._decoding = decoding
        self._generator = torch.Generator().manual_seed(rng_seed)
        dtype = resolve_compute_dtype(compute_dtype or nmn_spec.compute_dtype, self._device)
        self._compute_dtype = dtype

        self._pg_params = cast_params(pg_params, torch.float32, self._device)
        # The sampling kernel's weight layout, packed once.
        self._pg_packed = (
            pack_weights(self._pg_params, pg_spec, dtype, self._device)
            if self._device.type == "cuda" and decoding == "sampling" else None
        )
        self._nmn_forward = nmn_lib.make_fast_inference_fn(
            cast_params(nmn_params, torch.float32, self._device), nmn_spec,
            device=self._device, dtype=dtype,
        )

        # Bucket ladder batch_size // 4**k, floored at 2 (a size-1 bucket buys
        # negligible latency over the next one up). It has no caller yet: the
        # micro-batching dispatcher that picks a bucket is not ported, and
        # predict() always pads to the full batch.
        bucket_floor = 2
        buckets = []
        b = batch_size
        while b >= bucket_floor or b == batch_size:
            buckets.append(b)
            if b // 4 < bucket_floor:
                break
            b //= 4
        self._buckets = sorted(set(buckets))

    @property
    def vocabulary(self) -> Vocabulary:
        return self._vocabulary

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def compute_dtype(self) -> torch.dtype:
        return self._compute_dtype

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
    ) -> List[str]:
        r"""Pad ``n <= pad_to`` requests to ``pad_to`` rows, run the pipeline,
        unpad and detokenize."""
        n = questions.shape[0]
        if seed is None:
            seed = self._draw_seed(self._generator)
        q = torch.zeros((pad_to, questions.shape[1]), dtype=torch.long, device=self._device)
        q[:n] = torch.from_numpy(questions.astype(np.int64)).to(self._device)
        # The features cross to the device as they come (float32, no host
        # copy) and are cast there; pad rows are zeros made on the device.
        im = torch.zeros((pad_to,) + images.shape[1:], dtype=self._compute_dtype,
                         device=self._device)
        im[:n] = torch.from_numpy(np.asarray(images, dtype=np.float32)).to(self._device)
        answers = self._pipeline(q, im, seed)
        return self._finish(answers, n)

    def _pipeline(self, questions: torch.Tensor, images: torch.Tensor, seed: int) -> torch.Tensor:
        if self._decoding == GREEDY:
            programs = seq2seq_forward(
                self._pg_params, self._pg_spec, questions, GREEDY
            )["predictions"]
        else:
            programs = fused_sampling_forward(
                self._pg_params, self._pg_spec, questions, seed=seed,
                compute_dtype=self._compute_dtype, packed=self._pg_packed,
            )["predictions"]
        return self._nmn_forward(image_to_nhwc(images), programs)["predictions"]

    def _finish(self, answers: torch.Tensor, n: int) -> List[str]:
        r"""Copy the answers to the host (the batch's one synchronization
        point) and detokenize the ``n`` valid rows."""
        return [
            self._vocabulary.get_token_from_index(int(a), "answers")
            for a in answers[:n].cpu().tolist()
        ]

    def bucket_for(self, n: int) -> int:
        r"""Smallest micro-batch bucket covering ``n`` requests."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._batch_size

    def warmup(self, question_length: Optional[int] = None) -> None:
        r"""Run the pipeline once at ``batch_size``, the one shape
        :meth:`predict` sends, so no live request pays a kernel build or a
        first allocation. ``question_length`` defaults to the reference's
        fixed 45."""
        if question_length is None:
            from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH

            question_length = MAX_QUESTION_LENGTH
        spec = self._nmn_spec
        self._run_padded(
            np.zeros((1, question_length), np.int64),
            np.zeros((1, spec.feature_channels, spec.height, spec.width), np.float32),
            None, self._batch_size,
        )
