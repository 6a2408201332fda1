r"""
Evaluator for the ``joint_training`` phase (counterpart of
``probnmn_tpu/evaluators/joint_training_evaluator.py``; reference
``probnmn/evaluators/joint_training_evaluator.py``): the trainer's
ProgramGenerator and NMN over the val split, accumulating the generator's
seq2seq metrics (teacher-forced greedy against the ground-truth programs),
the NMN's answer accuracy and the average count of invalid programs per
batch.

``program_decode``:

- ``"tf_greedy"`` (the default, the reference evaluator's semantics): the NMN
  runs the generator's per-step argmax under teacher forcing;
- ``"free_greedy"``: the NMN runs programs decoded free-running greedy from
  the question alone, the inference condition. The generator's seq2seq
  metrics stay teacher-forced either way, so they remain comparable.

The decodes are plain PyTorch in float32, as the JAX evaluator leaves them
to XLA. The NMN runs ``fast_forward_from_tables``: kernel K2 on ``cuda`` over
banks rebuilt from the live params at the start of each pass, its plain
version on the CPU. When the trainer is a rank of a data-parallel run each
batch is the rank's rows of the global batch, and ``_collect`` sums every
metric's counters over the ranks in one all-reduce.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import JointTrainingDataset
from probnmn_tpu_torch.data.pipeline import EpochIterator, image_to_nhwc
from probnmn_tpu_torch.evaluators._evaluator import _Evaluator
from probnmn_tpu_torch.evaluators.question_coding_evaluator import _Seq2SeqMetrics
from probnmn_tpu_torch.models import nmn
from probnmn_tpu_torch.models.seq2seq import GREEDY, seq2seq_forward
from probnmn_tpu_torch.parallel.mesh import shard_of
from probnmn_tpu_torch.utils.metrics import (
    Average,
    BooleanAccuracy,
    SequenceAccuracy,
    reduce_metrics,
)


class JointTrainingEvaluator(_Evaluator):
    r"""``dataset``: the val set; None reads ``config.DATA.VAL_TOKENS`` and
    ``config.DATA.VAL_FEATURES`` (streamed with ``in_memory_features=False``)."""

    def __init__(self, config: Config, trainer, dataset: Optional[JointTrainingDataset] = None,
                 in_memory_features: bool = True, program_decode: str = "tf_greedy"):
        if program_decode not in ("tf_greedy", "free_greedy"):
            raise ValueError(f"unknown program_decode: {program_decode!r}")
        self._free_decode = program_decode == "free_greedy"
        if dataset is None:
            dataset = JointTrainingDataset(config.DATA.VAL_TOKENS, config.DATA.VAL_FEATURES,
                                           in_memory=in_memory_features)
        self._pg_spec = trainer.pg_spec
        self._nmn_spec = trainer.nmn_spec
        dataset.check_tokens(self._pg_spec.target_vocab_size, self._pg_spec.source_vocab_size)
        super().__init__(
            config, trainer, EpochIterator(dataset, config.OPTIM.BATCH_SIZE, device=trainer.device,
                                           **shard_of(trainer.parallel))
        )
        self._pg_metrics = _Seq2SeqMetrics(SequenceAccuracy())
        self._answer_accuracy = BooleanAccuracy()
        self._average_invalid = Average()
        self._banks = None

    def _begin(self) -> None:
        dtype = nmn.resolve_compute_dtype(self._nmn_spec.compute_dtype, self._trainer.device)
        self._banks = nmn.build_banks(self._params["nmn"], self._nmn_spec, dtype)

    def _do_iteration(self, batch: Dict[str, Any]) -> None:
        params = self._params
        pg_out = seq2seq_forward(params["program_generator"], self._pg_spec, batch["question"],
                                 GREEDY, target_tokens=batch["program"])
        programs = pg_out["predictions"]
        if self._free_decode:
            programs = seq2seq_forward(params["program_generator"], self._pg_spec,
                                       batch["question"], GREEDY)["predictions"]
        nmn_params = params["nmn"]
        out = nmn.fast_forward_from_tables(
            self._banks, self._trainer.tables, self._nmn_spec, nmn_params["stem"],
            nmn_params["classifier"], image_to_nhwc(batch["image"]), programs, batch["answer"])
        self._pg_metrics.update(pg_out)
        self._answer_accuracy(out["predictions"].cpu().numpy(), batch["answer"].cpu().numpy())
        # A count over the global batch: each of the n data ranks adds n
        # times its rows' count, so that the data ranks' summed counters
        # average to the global batch's.
        self._average_invalid(float(out["invalid"].sum()) * self._trainer.data_size)

    def _collect(self) -> Dict[str, Any]:
        reduce_metrics(self._trainer.parallel, self._pg_metrics.accumulators + [
            self._answer_accuracy, self._average_invalid])
        return {
            "program_generator": self._pg_metrics.collect(),
            "question_reconstructor": {},
            "nmn": {
                "answer_accuracy": self._answer_accuracy.get_metric(reset=True),
                "average_invalid": self._average_invalid.get_metric(reset=True),
            },
        }
