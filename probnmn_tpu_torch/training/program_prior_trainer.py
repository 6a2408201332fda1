r"""
Phase 1 trainer: the ProgramPrior LSTM language model over CLEVR programs
(counterpart of ``probnmn_tpu/training/program_prior_trainer.py``; reference
``probnmn/trainers/program_prior_trainer.py``).

A step is ``fused_lm_loss(...).mean()``, ``backward()``, clamp and Adam: on
``cuda`` the loss is kernel K3f and its gradient kernel K3b
(``ops/kernels/seq2seq_train.py``), on the CPU their plain versions. With
``PROGRAM_PRIOR.DROPOUT > 0`` each step draws the LM's inter-layer dropout
masks (the JAX package's ``program_prior_forward(train=True)``).

With ``parallel`` (``parallel/mesh.py``) the trainer is one rank: K3f and
K3b run on the rank's B / n rows, the gradients' mean over the ranks is the
global batch's (the loss is a mean over equal shards), and the logged loss
is the global batch's mean. Each rank draws its own dropout masks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import ProgramPriorDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator
from probnmn_tpu_torch.data.samplers import RandomSampler
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.models.program_prior import (
    ProgramPriorSpec,
    init_program_prior_params,
    lm_dropout_masks,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_train import fused_lm_loss
from probnmn_tpu_torch.parallel.mesh import global_sums, shard_of
from probnmn_tpu_torch.training._trainer import _Trainer


def make_prior_spec(config: Config, vocabulary: Vocabulary) -> ProgramPriorSpec:
    return ProgramPriorSpec(
        vocab_size=vocabulary.get_vocab_size("programs"),
        input_size=config.PROGRAM_PRIOR.INPUT_SIZE,
        hidden_size=config.PROGRAM_PRIOR.HIDDEN_SIZE,
        num_layers=config.PROGRAM_PRIOR.NUM_LAYERS,
        dropout=config.PROGRAM_PRIOR.DROPOUT,
    )


class ProgramPriorTrainer(_Trainer):
    r"""``dataset``: the training set; None reads ``config.DATA.TRAIN_TOKENS``."""

    def __init__(self, config: Config, serialization_dir: str, device="cuda",
                 writer=None, dataset: Optional[ProgramPriorDataset] = None, parallel=None):
        if config.PHASE != "program_prior":
            raise ValueError(f"Expected PHASE program_prior, found {config.PHASE}")
        device = resolve_device(device)

        vocabulary = Vocabulary.from_files(config.DATA.VOCABULARY)
        if dataset is None:
            dataset = ProgramPriorDataset(config.DATA.TRAIN_TOKENS)
        self.spec = make_prior_spec(config, vocabulary)
        dataset.check_tokens(self.spec.vocab_size)
        batches = BatchIterator(
            dataset,
            RandomSampler(len(dataset), seed=config.RANDOM_SEED),
            config.OPTIM.BATCH_SIZE,
            device=device,
            **shard_of(parallel),
        )
        params = init_program_prior_params(
            torch.Generator().manual_seed(config.RANDOM_SEED), self.spec
        )
        super().__init__(config, batches, {"program_prior": params}, serialization_dir,
                         device=device, writer=writer, parallel=parallel)
        self._vocabulary = vocabulary

    def _do_iteration(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        programs = batch["program"]
        masks = lm_dropout_masks(self.dropout_generator, self.spec, programs)
        loss = fused_lm_loss(self._live["program_prior"], self.spec, programs, masks).mean()
        self._apply_gradients(loss)
        total, rows = global_sums(self._parallel, [loss.detach().double() * len(programs),
                                                   len(programs)])
        return {"loss": total / rows}

    def model_specs(self) -> Dict[str, Any]:
        return {"program_prior": self.spec}

    def after_validation(self, val_metrics: Dict[str, Any], iteration=None) -> None:
        # Reciprocate perplexity to make it "higher is better".
        val_metrics["metric"] = 1.0 / val_metrics["program_prior"]["perplexity"]
        super().after_validation(val_metrics, iteration)
