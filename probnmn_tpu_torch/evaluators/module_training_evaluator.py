r"""
Evaluator for the ``module_training`` phase (counterpart of
``probnmn_tpu/evaluators/module_training_evaluator.py``; reference
``probnmn/evaluators/module_training_evaluator.py``): decodes a program per
question with the trainer's frozen ProgramGenerator, runs the NMN over it
and accumulates answer accuracy and the average count of invalid programs
per batch.

``program_decode``:

- ``"tf_greedy"`` (the default, the reference evaluator's semantics): the
  per-step argmax under teacher forcing against the ground-truth program
  (``seq2seq_forward(..., GREEDY, target_tokens=...)``);
- ``"free_greedy"``: free-running greedy decoding from the question alone,
  the inference condition.

Both decodes are plain PyTorch in float32, as the JAX evaluator leaves them
to XLA. The NMN runs ``fast_forward_from_tables``: kernel K2 on ``cuda``
over banks rebuilt from the live params at the start of each pass, its
plain version on the CPU. In a data-parallel run each batch's correct
answers, rows and invalid programs are summed over the ranks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import ModuleTrainingDataset
from probnmn_tpu_torch.data.pipeline import EpochIterator, image_to_nhwc
from probnmn_tpu_torch.evaluators._evaluator import _Evaluator
from probnmn_tpu_torch.models import nmn
from probnmn_tpu_torch.models.seq2seq import GREEDY, seq2seq_forward
from probnmn_tpu_torch.parallel.mesh import global_sums, shard_of
from probnmn_tpu_torch.utils.metrics import Average


class ModuleTrainingEvaluator(_Evaluator):
    r"""``dataset``: the val set; None reads ``config.DATA.VAL_TOKENS`` and
    ``config.DATA.VAL_FEATURES`` (streamed with ``in_memory_features=False``)."""

    def __init__(self, config: Config, trainer, dataset: Optional[ModuleTrainingDataset] = None,
                 in_memory_features: bool = True, program_decode: str = "tf_greedy"):
        if program_decode not in ("tf_greedy", "free_greedy"):
            raise ValueError(f"unknown program_decode: {program_decode!r}")
        self._free_decode = program_decode == "free_greedy"
        if dataset is None:
            dataset = ModuleTrainingDataset(config.DATA.VAL_TOKENS, config.DATA.VAL_FEATURES,
                                            in_memory=in_memory_features)
        self._pg_spec = trainer.pg_spec
        self._nmn_spec = trainer.nmn_spec
        dataset.check_tokens(self._pg_spec.target_vocab_size, self._pg_spec.source_vocab_size)
        super().__init__(
            config, trainer, EpochIterator(dataset, config.OPTIM.BATCH_SIZE, device=trainer.device,
                                           **shard_of(trainer.parallel))
        )
        self._correct = self._rows = 0.0
        self._average_invalid = Average()
        self._banks = None

    def _begin(self) -> None:
        nmn_params = self._trainer.params["nmn"]
        dtype = nmn.resolve_compute_dtype(self._nmn_spec.compute_dtype, self._trainer.device)
        self._banks = nmn.build_banks(nmn_params, self._nmn_spec, dtype)

    def _do_iteration(self, batch: Dict[str, Any]) -> None:
        target = None if self._free_decode else batch["program"]
        programs = seq2seq_forward(self._trainer.pg_params, self._pg_spec, batch["question"],
                                   GREEDY, target_tokens=target)["predictions"]
        nmn_params = self._trainer.params["nmn"]
        out = nmn.fast_forward_from_tables(
            self._banks, self._trainer.tables, self._nmn_spec, nmn_params["stem"],
            nmn_params["classifier"], image_to_nhwc(batch["image"]), programs, batch["answer"])
        correct, rows, invalid = global_sums(self._trainer.parallel, [
            (out["predictions"] == batch["answer"]).sum(), len(batch["answer"]),
            out["invalid"].sum()])
        self._correct += correct
        self._rows += rows
        self._average_invalid(invalid)

    def _collect(self) -> Dict[str, Any]:
        accuracy = self._correct / self._rows if self._rows else 0.0
        self._correct = self._rows = 0.0
        return {
            "nmn": {
                "answer_accuracy": accuracy,
                "average_invalid": self._average_invalid.get_metric(reset=True),
            }
        }
