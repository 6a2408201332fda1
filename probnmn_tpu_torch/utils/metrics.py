r"""
Host-side numpy metric accumulators, copies of ``probnmn_tpu/utils/metrics.py``
(the behaviour of the allennlp 0.9 metrics the reference uses):

- ``Average``; perplexity is reported as ``2 ** average(natural-log CE)``, the
  reference's 2-vs-e mismatch kept (``seq2seq_base.py:370``).
- ``SequenceAccuracy``: exact match over masked positions, with a beam
  dimension.
- ``UnigramRecall``: fraction of (non-pad) gold tokens present in any beam;
  word error rate = 1 - unigram recall.
- ``BleuScore``: corpus BLEU-4, uniform weights, ngrams containing
  pad/@start@/@end@ excluded, with brevity penalty and 1e-13 log-smoothing.
- ``BooleanAccuracy``: elementwise exact match (answer accuracy).
- ``SemanticQuestionReconstructionAccuracy``: CLEVR synonym rewrites, then
  sequence accuracy (reference ``probnmn/utils/metrics.py:9-118``).

Each accumulator gives its counters as a flat list of floats (``counters``)
and takes such a list back (``restore``), so that an evaluator over several
ranks sums every metric's counters in one all-reduce
(:func:`reduce_metrics`). ``Average`` of per-batch means over ranks is the
mean over the global batches, since every rank holds as many rows.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.parallel.mesh import global_sums


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

    def counters(self) -> List[float]:
        return [self._total, float(self._count)]

    def restore(self, values: Sequence[float]) -> None:
        self._total, self._count = float(values[0]), int(values[1])


class BooleanAccuracy:
    def __init__(self):
        self._correct = 0
        self._total = 0

    def __call__(self, predictions: np.ndarray, gold: np.ndarray) -> None:
        predictions = np.asarray(predictions)
        gold = np.asarray(gold)
        self._correct += int((predictions == gold).sum())
        self._total += predictions.shape[0]

    def get_metric(self, reset: bool = True) -> float:
        value = self._correct / self._total if self._total else 0.0
        if reset:
            self._correct, self._total = 0, 0
        return value

    def counters(self) -> List[float]:
        return [float(self._correct), float(self._total)]

    def restore(self, values: Sequence[float]) -> None:
        self._correct, self._total = int(values[0]), int(values[1])


class SequenceAccuracy:
    r"""Exact-match over masked positions; predictions carry a beam dimension."""

    def __init__(self):
        self._correct = 0.0
        self._total = 0

    def __call__(
        self,
        predictions: np.ndarray,  # (B, beams, T)
        gold: np.ndarray,  # (B, T)
        mask: Optional[np.ndarray] = None,  # (B, T)
    ) -> None:
        predictions = np.asarray(predictions)
        gold = np.asarray(gold)
        if mask is None:
            mask = np.ones_like(gold)
        mask = np.asarray(mask).astype(bool)
        masked_gold = np.where(mask, gold, 0)[:, None, :]
        masked_pred = np.where(mask[:, None, :], predictions, 0)
        eq = (masked_pred == masked_gold).all(-1).any(-1)
        self._correct += float(eq.sum())
        self._total += predictions.shape[0]

    def get_metric(self, reset: bool = True) -> float:
        value = self._correct / self._total if self._total else 0.0
        if reset:
            self._correct, self._total = 0.0, 0
        return value

    def counters(self) -> List[float]:
        return [self._correct, float(self._total)]

    def restore(self, values: Sequence[float]) -> None:
        self._correct, self._total = float(values[0]), int(values[1])


class UnigramRecall:
    r"""Fraction of non-pad gold tokens found in any prediction beam."""

    def __init__(self):
        self._total = 0.0
        self._count = 0

    def __call__(
        self,
        predictions: np.ndarray,  # (B, beams, T)
        gold: np.ndarray,  # (B, T)
        mask: Optional[np.ndarray] = None,
    ) -> None:
        predictions = np.asarray(predictions)
        gold = np.asarray(gold)
        for i in range(gold.shape[0]):
            row_gold = gold[i] if mask is None else gold[i] * np.asarray(mask)[i]
            cleaned = [int(t) for t in row_gold if t != 0]
            if not cleaned:
                self._count += 1
                continue
            hit = 0
            beams = predictions[i]
            for token in cleaned:
                if any(token in beam for beam in beams):
                    hit += 1
            self._total += hit / len(cleaned)
            self._count += 1

    def get_metric(self, reset: bool = True) -> float:
        value = self._total / self._count if self._count else 0.0
        if reset:
            self._total, self._count = 0.0, 0
        return value

    def counters(self) -> List[float]:
        return [self._total, float(self._count)]

    def restore(self, values: Sequence[float]) -> None:
        self._total, self._count = float(values[0]), int(values[1])


class BleuScore:
    r"""Corpus BLEU with uniform 4-gram weights; ngrams containing any excluded
    index are skipped; brevity penalty over non-excluded token counts."""

    def __init__(self, exclude_indices=(0, 2, 3), max_order: int = 4):
        self._exclude = set(exclude_indices)
        self._max_order = max_order
        self.reset()

    def reset(self):
        self._matches = [0] * self._max_order
        self._totals = [0] * self._max_order
        self._pred_len = 0
        self._gold_len = 0

    def counters(self) -> List[float]:
        r"""The n-gram matches and totals, then the two lengths."""
        return [float(v) for v in (*self._matches, *self._totals, self._pred_len,
                                   self._gold_len)]

    def restore(self, values: Sequence[float]) -> None:
        n = self._max_order
        values = [int(v) for v in values]
        self._matches, self._totals = values[:n], values[n:2 * n]
        self._pred_len, self._gold_len = values[2 * n:]

    def _ngrams(self, row: np.ndarray, n: int) -> Counter:
        counts: Counter = Counter()
        for start in range(len(row) - n + 1):
            ngram = tuple(int(x) for x in row[start : start + n])
            if any(tok in self._exclude for tok in ngram):
                continue
            counts[ngram] += 1
        return counts

    def __call__(self, predictions: np.ndarray, gold: np.ndarray) -> None:
        predictions = np.asarray(predictions)
        gold = np.asarray(gold)
        for pred_row, gold_row in zip(predictions, gold):
            for n in range(1, self._max_order + 1):
                pred_counts = self._ngrams(pred_row, n)
                gold_counts = self._ngrams(gold_row, n)
                for ngram, count in pred_counts.items():
                    self._matches[n - 1] += min(count, gold_counts.get(ngram, 0))
                self._totals[n - 1] += sum(pred_counts.values())
            self._pred_len += int(sum(1 for t in pred_row if int(t) not in self._exclude))
            self._gold_len += int(sum(1 for t in gold_row if int(t) not in self._exclude))

    def get_metric(self, reset: bool = True) -> Dict[str, float]:
        # allennlp-0.9 semantics exactly (the reference's BLEU source,
        # allennlp/training/metrics/bleu.py): 1e-13 log-smoothing — zero
        # n-gram matches yield a tiny but NONZERO BLEU, not 0 — and a brevity
        # penalty of 1 when predictions are longer, 0 when either side has no
        # valid tokens.
        if self._pred_len > self._gold_len:
            brevity = 1.0
        elif self._gold_len == 0 or self._pred_len == 0:
            brevity = 0.0
        else:
            brevity = np.exp(1.0 - self._gold_len / self._pred_len)
        log_precision = sum(
            (np.log(m + 1e-13) - np.log(t + 1e-13)) / self._max_order
            for m, t in zip(self._matches, self._totals)
        )
        bleu = float(brevity * np.exp(log_precision))
        if reset:
            self.reset()
        return {"BLEU": bleu}


class SemanticQuestionReconstructionAccuracy(SequenceAccuracy):
    r"""Sequence accuracy after CLEVR synonym canonicalization of both sequences
    (synonym table from clevr-dataset-gen, reference ``metrics.py:24-40``)."""

    SYNONYM_TUPLES = [
        ("on the left side of", "left"),
        ("to the left of", "left"),
        ("left of", "left"),
        ("on the right side of", "right"),
        ("to the right of", "right"),
        ("right of", "right"),
        ("in front of", "front"),
        ("object", "thing"),
        ("ball", "sphere"),
        ("block", "cube"),
        ("big", "large"),
        ("tiny", "small"),
        ("shiny", "metal"),
        ("metallic", "metal"),
        ("matte", "rubber"),
    ]

    def __init__(self, vocabulary: Vocabulary):
        super().__init__()
        self._vocabulary = vocabulary

    def _canonicalize(self, rows: np.ndarray, max_length: int) -> np.ndarray:
        out: List[List[int]] = []
        for row in rows:
            tokens = [
                self._vocabulary.get_token_from_index(int(t), "questions") for t in row
            ]
            text = " ".join(tokens)
            for src, dst in self.SYNONYM_TUPLES:
                text = text.replace(src, dst)
            tokens = text.split(" ")
            if len(tokens) < max_length:
                tokens.extend(["@@PADDING@@"] * (max_length - len(tokens)))
            out.append(
                [self._vocabulary.get_token_index(t, "questions") for t in tokens[:max_length]]
            )
        return np.asarray(out)

    def __call__(self, predictions, gold_questions, mask=None):
        predictions = np.asarray(predictions)
        if predictions.ndim == 3:
            predictions = predictions[:, 0]
        max_length = predictions.shape[1]
        predictions = self._canonicalize(predictions, max_length)
        gold = self._canonicalize(np.asarray(gold_questions), max_length)
        super().__call__(predictions[:, None, :], gold, mask)


def reduce_metrics(parallel, metrics: Sequence) -> None:
    r"""Sum the counters of ``metrics`` over the ranks of ``parallel`` (a
    ``parallel/mesh.py`` ``DataParallel``; None: one process, nothing to
    do) in one all-reduce and restore each metric to the sums."""
    if parallel is None:
        return
    counters = [metric.counters() for metric in metrics]
    flat = global_sums(parallel, [v for values in counters for v in values])
    offset = 0
    for metric, values in zip(metrics, counters):
        metric.restore(flat[offset:offset + len(values)])
        offset += len(values)
