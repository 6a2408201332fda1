r"""
Base evaluation runtime (counterpart of ``probnmn_tpu/evaluators/_evaluator.py``;
reference ``probnmn/evaluators/_evaluator.py``).

Evaluation iterates the val split in fixed-size batches and accumulates
host-side metric objects. ``evaluate(num_batches)`` processes exactly
``num_batches`` batches (the reference processes two extra,
``_evaluator.py:88-94``; not replicated, the metrics are averages either way).

When the trainer is one rank of a data-parallel run (``trainer.parallel``),
each val batch is the rank's rows of the global batch (the JAX package's
``eval_sharding``), ``num_batches`` counts global batches, and the phase
evaluators all-reduce each batch's sums, so every rank reports the global
batch's metrics. Over a model axis (``parallel/mesh.py``) ``evaluate``
first gathers the trainer's full leaves from the model group
(``trainer.full_params()``), which the phase evaluators read as
``self._params``, and the sums run over the data ranks alone.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from probnmn_tpu_torch.config import Config


class _Evaluator:
    def __init__(self, config: Config, trainer, val_batches):
        self._C = config
        self._trainer = trainer
        self._val_batches = val_batches
        self._params = None  # the trainer's full leaves, during evaluate()

    @torch.no_grad()
    def evaluate(self, num_batches: Optional[int] = None) -> Dict[str, Any]:
        self._params = self._trainer.full_params()
        self._begin()
        for iteration, batch in enumerate(iter(self._val_batches)):
            if num_batches is not None and iteration >= num_batches:
                break
            self._do_iteration(batch)
        metrics = self._collect()
        self._params = None
        return metrics

    def _begin(self) -> None:
        pass

    def _do_iteration(self, batch: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _collect(self) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def models(self):
        return self._trainer.params
