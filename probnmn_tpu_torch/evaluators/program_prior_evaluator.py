r"""
Evaluator for the ``program_prior`` phase (counterpart of
``probnmn_tpu/evaluators/program_prior_evaluator.py``; reference
``probnmn/evaluators/program_prior_evaluator.py``): perplexity
``2 ** mean(CE)`` over the val split (the reference's base 2 over a
natural-log CE, kept) and five GT / Pred pairs in the log.

The loss goes through ``fused_lm_loss`` under ``torch.no_grad()``: kernel
K3f on ``cuda``. The logged predictions come from ``program_prior_forward``
on the first batch's five rows (rank 0's, in a data-parallel run; each
batch's mean CE there is the global batch's, from the ranks' sums).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import ProgramPriorDataset
from probnmn_tpu_torch.data.pipeline import EpochIterator
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.evaluators._evaluator import _Evaluator
from probnmn_tpu_torch.models.program_prior import program_prior_forward
from probnmn_tpu_torch.ops.kernels.seq2seq_train import fused_lm_loss
from probnmn_tpu_torch.parallel.mesh import global_sums, shard_of
from probnmn_tpu_torch.utils.metrics import Average

logger = logging.getLogger(__name__)

NUM_LOGGED = 5


class ProgramPriorEvaluator(_Evaluator):
    r"""``dataset``: the val set; None reads ``config.DATA.VAL_TOKENS``."""

    def __init__(self, config: Config, trainer, dataset: Optional[ProgramPriorDataset] = None):
        if dataset is None:
            dataset = ProgramPriorDataset(config.DATA.VAL_TOKENS)
        dataset.check_tokens(trainer.spec.vocab_size)
        super().__init__(
            config, trainer, EpochIterator(dataset, config.OPTIM.BATCH_SIZE, device=trainer.device,
                                           **shard_of(trainer.parallel))
        )
        self._vocabulary = Vocabulary.from_files(config.DATA.VOCABULARY)
        self._spec = trainer.spec
        self._log2_perplexity = Average()
        self._generator = torch.Generator().manual_seed(config.RANDOM_SEED + 1)
        self._printed = False

    def _begin(self) -> None:
        self._printed = False

    def _do_iteration(self, batch: Dict[str, Any]) -> None:
        params = self._params["program_prior"]
        loss = fused_lm_loss(params, self._spec, batch["program"])
        total, rows = global_sums(self._trainer.parallel, [loss.sum(), loss.numel()])
        self._log2_perplexity(total / rows)

        if not self._printed and self._trainer.is_writer:
            self._printed = True
            programs = batch["program"][:NUM_LOGGED]
            out = program_prior_forward(params, self._spec, programs, gen=self._generator)
            for gt, pred in zip(programs.cpu().numpy(), out["predictions"].cpu().numpy()):
                logger.info("GT   : %s", self._detokenize(gt))
                logger.info("Pred : %s", self._detokenize(pred))

    def _detokenize(self, tokens: np.ndarray) -> str:
        words = [
            self._vocabulary.get_token_from_index(int(t), "programs")
            for t in tokens
            if t != 0
        ]
        return " ".join(words)

    def _collect(self) -> Dict[str, Any]:
        return {
            "program_prior": {
                "perplexity": 2 ** self._log2_perplexity.get_metric(reset=True)
            }
        }
