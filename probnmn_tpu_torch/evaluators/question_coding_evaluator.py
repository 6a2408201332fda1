r"""
Evaluator for the ``question_coding`` phase (counterpart of
``probnmn_tpu/evaluators/question_coding_evaluator.py``; reference
``probnmn/evaluators/question_coding_evaluator.py``): a teacher-forced greedy
forward of both seq2seq models over the val split, accumulating BLEU,
perplexity (``2 ** avg CE``), sequence accuracy and word error rate, with
the semantic (synonym-canonicalized) sequence accuracy for the
reconstructor (reference ``question_reconstructor.py:48``).

The forward is ``seq2seq_forward(..., target_tokens=...)`` in plain PyTorch
on the trainer's device: the JAX package leaves it to XLA too, so it is not
a kernel. When the trainer is a rank of a data-parallel run each batch is
the rank's rows of the global batch, and ``_collect`` sums every metric's
counters over the ranks in one all-reduce, so every rank reports the whole
split's metrics; rank 0 alone logs the decoded examples.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import QuestionCodingDataset
from probnmn_tpu_torch.data.pipeline import EpochIterator
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.evaluators._evaluator import _Evaluator
from probnmn_tpu_torch.models.seq2seq import GREEDY, seq2seq_forward
from probnmn_tpu_torch.parallel.mesh import shard_of
from probnmn_tpu_torch.utils.metrics import (
    Average,
    BleuScore,
    SemanticQuestionReconstructionAccuracy,
    SequenceAccuracy,
    UnigramRecall,
    reduce_metrics,
)

logger = logging.getLogger(__name__)

NUM_LOGGED = 5


class _Seq2SeqMetrics:
    r"""The four seq2seq eval metrics the reference records per model
    (``seq2seq_base.py:93-99``, ``343-375``)."""

    def __init__(self, sequence_accuracy):
        self.bleu = BleuScore()
        self.log2_perplexity = Average()
        self.sequence_accuracy = sequence_accuracy
        self.unigram_recall = UnigramRecall()

    def update(self, output: Dict[str, Any]) -> None:
        predictions = output["predictions"].cpu().numpy()
        relevant_targets = output["relevant_targets"].cpu().numpy()
        relevant_mask = output["relevant_mask"].cpu().numpy().astype(np.int64)
        self.bleu(predictions, relevant_targets)
        self.log2_perplexity(float(output["loss"].mean()))
        clipped = predictions[:, : relevant_targets.shape[-1]][:, None, :]
        self.sequence_accuracy(clipped, relevant_targets, relevant_mask)
        self.unigram_recall(clipped, relevant_targets, relevant_mask)

    @property
    def accumulators(self):
        return [self.bleu, self.log2_perplexity, self.sequence_accuracy, self.unigram_recall]

    def collect(self) -> Dict[str, float]:
        metrics = self.bleu.get_metric(reset=True)
        metrics.update(
            {
                "perplexity": 2 ** self.log2_perplexity.get_metric(reset=True),
                "sequence_accuracy": self.sequence_accuracy.get_metric(reset=True),
                "word_error_rate": 1 - self.unigram_recall.get_metric(reset=True),
            }
        )
        return metrics


class QuestionCodingEvaluator(_Evaluator):
    r"""``dataset``: the val set; None reads ``config.DATA.VAL_TOKENS``."""

    def __init__(self, config: Config, trainer, dataset: Optional[QuestionCodingDataset] = None):
        if dataset is None:
            dataset = QuestionCodingDataset(config.DATA.VAL_TOKENS)
        self._pg_spec = trainer.pg_spec
        self._qr_spec = trainer.qr_spec
        dataset.check_tokens(self._pg_spec.target_vocab_size, self._pg_spec.source_vocab_size)
        super().__init__(
            config, trainer, EpochIterator(dataset, config.OPTIM.BATCH_SIZE, device=trainer.device,
                                           **shard_of(trainer.parallel))
        )
        self._vocabulary = Vocabulary.from_files(config.DATA.VOCABULARY)
        self._pg_metrics = _Seq2SeqMetrics(SequenceAccuracy())
        self._qr_metrics = _Seq2SeqMetrics(
            SemanticQuestionReconstructionAccuracy(self._vocabulary)
        )
        self._printed = False

    def _begin(self) -> None:
        self._printed = False

    def _do_iteration(self, batch: Dict[str, Any]) -> None:
        params = self._trainer.params
        pg_out = seq2seq_forward(params["program_generator"], self._pg_spec, batch["question"],
                                 GREEDY, target_tokens=batch["program"])
        qr_out = seq2seq_forward(params["question_reconstructor"], self._qr_spec,
                                 batch["program"], GREEDY, target_tokens=batch["question"])
        self._pg_metrics.update(pg_out)
        self._qr_metrics.update(qr_out)

        if not self._printed and self._trainer.is_writer:
            self._printed = True
            rows = zip(batch["program"][:NUM_LOGGED].cpu().numpy(),
                       pg_out["predictions"][:NUM_LOGGED].cpu().numpy(),
                       batch["question"][:NUM_LOGGED].cpu().numpy(),
                       qr_out["predictions"][:NUM_LOGGED].cpu().numpy())
            for program, decoded, question, reconstruction in rows:
                logger.info("GT program    : %s", self._detok(program, "programs"))
                logger.info("Decoded prog  : %s", self._detok(decoded, "programs"))
                logger.info("GT question   : %s", self._detok(question, "questions"))
                logger.info("Reconstruction: %s", self._detok(reconstruction, "questions"))

    def _detok(self, tokens: np.ndarray, namespace: str) -> str:
        return " ".join(
            self._vocabulary.get_token_from_index(int(t), namespace) for t in tokens if t != 0
        )

    def _collect(self) -> Dict[str, Any]:
        reduce_metrics(self._trainer.parallel,
                       self._pg_metrics.accumulators + self._qr_metrics.accumulators)
        return {
            "program_generator": self._pg_metrics.collect(),
            "question_reconstructor": self._qr_metrics.collect(),
        }
