r"""
Phase 3 trainer: Module Training, the Neural Module Network over cached image
features with programs sampled from the frozen ProgramGenerator (counterpart
of ``probnmn_tpu/training/module_training_trainer.py``; reference
``probnmn/trainers/module_training_trainer.py``).

A step over a batch of questions, answers and NCHW image features:

- the frozen ProgramGenerator samples a program per question (kernel K1,
  bfloat16, a Philox seed drawn from the trainer's generator; no gradient;
  no dropout, whatever its DROPOUT, since the JAX trainer's sampling call
  is not a training pass);
- ``nmn_forward_fast`` runs the NMN: the unified banks built from the live
  params, the stem, the interpreter (kernel K5 forward, K6 backward on
  ``cuda``), the classifier; the loss is the batch mean of its per-example
  loss (3.33 for an invalid program);
- ``backward()``, clamp and Adam over the NMN's params.

The generator comes from ``CHECKPOINTS.QUESTION_CODING``: a checkpoint of
the port's ``QuestionCodingTrainer``, of the JAX package's or the
reference's. The NMN params are initialised from ``RANDOM_SEED``.

With ``parallel`` (``parallel/mesh.py``) the trainer is one rank: every rank
loads the frozen generator, K1 samples the rank's B / n rows from a Philox
seed of the rank's own generator, K5 and K6 run on those rows, and the
gradients (K6's banks and weights with the rest) are all-reduced. The
logged loss and answer accuracy are the global batch's means, from sums and
counts over the ranks, and ``average_invalid`` its count of invalid
programs, as the JAX trainer logs them over the mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import ModuleTrainingDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator, image_to_nhwc
from probnmn_tpu_torch.data.samplers import RandomSampler
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.models import nmn, program_generator
from probnmn_tpu_torch.models.seq2seq import Seq2SeqSpec
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward
from probnmn_tpu_torch.parallel.mesh import global_sums, shard_of
from probnmn_tpu_torch.training._trainer import _Trainer, load_frozen


def load_frozen_generator(path: str, spec: Seq2SeqSpec, device: torch.device) -> Dict[str, Any]:
    r"""The ``program_generator`` params of a checkpoint (the port's, the JAX
    package's or the reference's), as float32 tensors on ``device`` that need
    no gradient (:func:`load_frozen`)."""
    template = program_generator.init_params(torch.Generator().manual_seed(0), spec)
    return load_frozen(path, "program_generator", template, device, spec, None)


class ModuleTrainingTrainer(_Trainer):
    r"""``dataset``: the training set; None reads ``config.DATA.TRAIN_TOKENS``
    and ``config.DATA.TRAIN_FEATURES`` (all features in host memory, or
    streamed from the file with ``in_memory_features=False``)."""

    def __init__(self, config: Config, serialization_dir: str, device="cuda", writer=None,
                 dataset: Optional[ModuleTrainingDataset] = None,
                 in_memory_features: bool = True, parallel=None):
        if config.PHASE != "module_training":
            raise ValueError(f"Expected PHASE module_training, found {config.PHASE}")
        device = resolve_device(device)

        vocabulary = Vocabulary.from_files(config.DATA.VOCABULARY)
        self.nmn_spec = nmn.make_spec(vocabulary, config)
        self.pg_spec = program_generator.make_spec(vocabulary, config)
        if dataset is None:
            dataset = ModuleTrainingDataset(config.DATA.TRAIN_TOKENS, config.DATA.TRAIN_FEATURES,
                                            in_memory=in_memory_features)
        dataset.check_tokens(self.pg_spec.target_vocab_size, self.pg_spec.source_vocab_size)
        batches = BatchIterator(dataset, RandomSampler(len(dataset), seed=config.RANDOM_SEED),
                                config.OPTIM.BATCH_SIZE, device=device, **shard_of(parallel))
        params = nmn.init_nmn_params(torch.Generator().manual_seed(config.RANDOM_SEED),
                                     self.nmn_spec)
        super().__init__(config, batches, {"nmn": params}, serialization_dir, device=device,
                         writer=writer, parallel=parallel)
        self._vocabulary = vocabulary
        self._pg_params = load_frozen_generator(config.CHECKPOINTS.QUESTION_CODING, self.pg_spec,
                                                self._device)
        self._tables = nmn.build_tables(self.nmn_spec, self._device)

    def sample_programs(self, questions: torch.Tensor) -> torch.Tensor:
        r"""Programs (N, 26) trimmed at @end@, sampled from the frozen generator
        by kernel K1 in bfloat16 from a Philox seed drawn from the trainer's
        generator."""
        seed = int(torch.randint(2 ** 62, (1,), generator=self._generator))
        with torch.no_grad():
            out = fused_sampling_forward(self._pg_params, self.pg_spec, questions, seed=seed,
                                         compute_dtype=torch.bfloat16)
        return out["predictions"]

    def module_training_loss(self, params: Dict[str, Any], batch: Dict[str, Any],
                             programs: torch.Tensor) -> Dict[str, Any]:
        r"""``nmn_forward_fast`` over the batch at the given programs; its
        ``loss`` is per example."""
        return nmn.nmn_forward_fast(params["nmn"], self.nmn_spec, image_to_nhwc(batch["image"]),
                                    programs, batch["answer"], tables=self._tables)

    def _do_iteration(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        programs = self.sample_programs(batch["question"])
        out = self.module_training_loss(self._live, batch, programs)
        loss = out["loss"].mean()
        self._apply_gradients(loss)
        metrics = out["metrics"]
        rows = len(programs)
        total, correct, invalid, n = global_sums(self._parallel, [
            loss.detach().double() * rows, metrics["answer_accuracy"].double() * rows,
            metrics["average_invalid"], rows])
        return {"loss": total / n,
                "metrics": {"answer_accuracy": correct / n, "average_invalid": invalid}}

    def model_specs(self) -> Dict[str, Any]:
        return {"nmn": self.nmn_spec}

    def after_validation(self, val_metrics: Dict[str, Any], iteration=None) -> None:
        val_metrics["metric"] = val_metrics["nmn"]["answer_accuracy"]
        super().after_validation(val_metrics, iteration)

    @property
    def pg_params(self) -> Dict[str, Any]:
        return self._pg_params

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        r"""The NMN's dispatch tables on the trainer's device."""
        return self._tables
