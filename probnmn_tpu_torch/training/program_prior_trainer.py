r"""
Phase 1 trainer: the ProgramPrior LSTM language model over CLEVR programs
(counterpart of ``probnmn_tpu/training/program_prior_trainer.py``; reference
``probnmn/trainers/program_prior_trainer.py``).

A step is ``fused_lm_loss(...).mean()``, ``backward()``, clamp and Adam: on
``cuda`` the loss is kernel K3f and its gradient kernel K3b
(``ops/kernels/seq2seq_train.py``), on the CPU their plain versions.
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
from probnmn_tpu_torch.models.program_prior import ProgramPriorSpec, init_program_prior_params
from probnmn_tpu_torch.ops.kernels.seq2seq_train import fused_lm_loss
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
                 writer=None, dataset: Optional[ProgramPriorDataset] = None):
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
        )
        params = init_program_prior_params(
            torch.Generator().manual_seed(config.RANDOM_SEED), self.spec
        )
        super().__init__(config, batches, {"program_prior": params}, serialization_dir,
                         device=device, writer=writer)
        self._vocabulary = vocabulary

    def _do_iteration(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        loss = fused_lm_loss(self._params["program_prior"], self.spec, batch["program"]).mean()
        self._optimizer.zero_grad()
        loss.backward()
        self._optimizer.step()
        return {"loss": loss.detach()}

    def model_specs(self) -> Dict[str, Any]:
        return {"program_prior": self.spec}

    def after_validation(self, val_metrics: Dict[str, Any], iteration=None) -> None:
        # Reciprocate perplexity to make it "higher is better".
        val_metrics["metric"] = 1.0 / val_metrics["program_prior"]["perplexity"]
        super().after_validation(val_metrics, iteration)
