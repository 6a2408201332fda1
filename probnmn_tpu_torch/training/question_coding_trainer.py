r"""
Phase 2 trainer: Question Coding, the semi-supervised seq2seq VAE with
REINFORCE (counterpart of ``probnmn_tpu/training/question_coding_trainer.py``;
reference ``probnmn/trainers/question_coding_trainer.py``).

A step over a batch sorted supervised-first (``BatchIterator(...,
sort_descending_by="supervision")``, which also counts the supervised rows
on the host) runs:

- on the supervised rows ``[:n_sup]``: the ProgramGenerator (PG,
  question → program) and the QuestionReconstructor (QR, program → question)
  teacher-forced, through ``fused_tf_loss`` (kernels K4f/K4b on ``cuda``);
- with OBJECTIVE ``ours``, on the unsupervised rows ``[n_sup:]``: a program z
  sampled from PG (kernel K1, bfloat16, a Philox seed drawn from the
  trainer's generator; sampling carries no gradient), PG's
  length-normalized log q(z|x) (K4 in REINFORCE mode), QR's log p(x|z) (K4)
  and the frozen ProgramPrior's log p(z) (kernel K3f, no gradient); then the
  reward, REINFORCE with the moving-average baseline and the ELBO
  (``modules/elbo.py``);
- ``backward()``, clamp and Adam.

Dropout. With ``DROPOUT > 0`` on the generator or the reconstructor, every
pass above is a training pass of the JAX package's (``seq2seq_forward(...,
train=True)``): each draws its encoder's inter-layer dropout masks
(:func:`question_coding_dropout_masks`, from the trainer's
``dropout_generator``). PG's unsupervised pass is one call in JAX, which
samples z and scores it with one encoder pass; here K1 samples and K4 scores
in REINFORCE mode, so both take the one mask drawn for those rows. The
frozen prior takes none.

Sub-batches. PyTorch runs eagerly, so each pass takes its *exact* subset, as
the reference does (``question_coding_trainer.py:112-113``). The JAX package
cannot take dynamic shapes under ``jit``: it runs fixed windows of 3B/4 rows
(``training/_subbatch.py``) with the supervision mask applied inside them,
and falls back to the full masked batch; its own docstring says both equal
the exact subsets. The windows are not carried over. At ``n_sup == 0`` the
supervised passes are skipped and their means are 0; at ``n_sup == B`` the
unsupervised passes are skipped, the ELBO terms are 0 and the baseline does
not move. That is what the JAX package's masked means give there.

The frozen prior comes from ``CHECKPOINTS.PROGRAM_PRIOR``: a checkpoint of
the port's ``ProgramPriorTrainer``, of the JAX package's or the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import QuestionCodingDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator
from probnmn_tpu_torch.data.samplers import SupervisionWeightedRandomSampler
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.models import program_generator, question_reconstructor
from probnmn_tpu_torch.models.seq2seq import encoder_dropout_masks
from probnmn_tpu_torch.models.program_prior import ProgramPriorSpec, init_program_prior_params
from probnmn_tpu_torch.modules.elbo import elbo_with_reinforce, masked_mean, question_coding_reward
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    fused_tf_loss,
    lm_forward_cuda,
    lm_loss_plain,
    pack_lm_weights,
)
from probnmn_tpu_torch.ops.rnn import draw_dropout_masks
from probnmn_tpu_torch.training._trainer import _Trainer, load_frozen
from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec

SORT_KEY = "supervision"
COUNT_KEY = "_num_" + SORT_KEY  # attached by BatchIterator(sort_descending_by=SORT_KEY)


def load_frozen_prior(path: str, spec: ProgramPriorSpec, device: torch.device) -> Dict[str, Any]:
    r"""The ``program_prior`` params of a checkpoint (the port's, the JAX
    package's or the reference's), as float32 tensors on ``device`` that need
    no gradient (:func:`load_frozen`)."""
    template = init_program_prior_params(torch.Generator().manual_seed(0), spec)
    return load_frozen(path, "program_prior", template, device, spec, None)


def question_coding_dropout_masks(gen: torch.Generator, pg_spec, qr_spec,
                                  batch: Dict[str, Any]) -> Dict[str, Optional[torch.Tensor]]:
    r"""The encoders' dropout masks of a supervised-first batch's training
    passes, drawn from ``gen``: ``pg_sup`` / ``qr_sup`` over the supervised
    questions / programs, ``pg_unsup`` over the unsupervised questions (K1's
    sampling and PG's REINFORCE pass share it) and ``qr_unsup`` over the
    sampled programs z (``pg_spec.max_decoding_steps`` tokens). Each is None
    where its model has no dropout or its subset no rows."""
    n_sup = batch[COUNT_KEY]
    questions, programs = batch["question"], batch["program"]
    n_unsup = questions.shape[0] - n_sup
    return {
        "pg_sup": encoder_dropout_masks(gen, pg_spec, questions[:n_sup]),
        "qr_sup": encoder_dropout_masks(gen, qr_spec, programs[:n_sup]),
        "pg_unsup": encoder_dropout_masks(gen, pg_spec, questions[n_sup:]),
        "qr_unsup": draw_dropout_masks(gen, qr_spec.dropout, qr_spec.num_layers, n_unsup,
                                       pg_spec.max_decoding_steps + 1, qr_spec.hidden_size,
                                       questions.device),
    }


def frozen_prior_logprobs(params: Dict[str, Any], packed: Optional[Dict[str, torch.Tensor]],
                          spec: ProgramPriorSpec, z: torch.Tensor) -> torch.Tensor:
    r"""log p(z) under the frozen prior: kernel K3f over its ``packed``
    weights (:func:`pack_lm_weights`) for a CUDA ``z``, the plain loss over
    ``params`` for a CPU one; no gradient."""
    with torch.no_grad():
        if z.device.type == "cuda":
            return -lm_forward_cuda(packed, spec, z)
        return -lm_loss_plain(params, spec, z)


class QuestionCodingTrainer(_Trainer):
    r"""``dataset``: the training set; None reads ``config.DATA.TRAIN_TOKENS``
    (the supervision subset drawn from the global numpy seed)."""

    def __init__(self, config: Config, serialization_dir: str, device="cuda",
                 writer=None, dataset: Optional[QuestionCodingDataset] = None):
        if config.PHASE != "question_coding":
            raise ValueError(f"Expected PHASE question_coding, found {config.PHASE}")
        if config.OBJECTIVE not in ("baseline", "ours"):
            raise ValueError(f"unknown OBJECTIVE {config.OBJECTIVE!r}")
        device = resolve_device(device)

        vocabulary = Vocabulary.from_files(config.DATA.VOCABULARY)
        self.pg_spec = program_generator.make_spec(vocabulary, config)
        self.qr_spec = question_reconstructor.make_spec(vocabulary, config)
        self.prior_spec = make_prior_spec(config, vocabulary)
        if dataset is None:
            dataset = QuestionCodingDataset(
                config.DATA.TRAIN_TOKENS,
                num_supervision=config.SUPERVISION,
                supervision_question_max_length=config.SUPERVISION_QUESTION_MAX_LENGTH,
            )
        dataset.check_tokens(self.pg_spec.target_vocab_size, self.pg_spec.source_vocab_size)
        batches = BatchIterator(
            dataset,
            SupervisionWeightedRandomSampler(dataset.get_supervision_list(),
                                             seed=config.RANDOM_SEED),
            config.OPTIM.BATCH_SIZE,
            device=device,
            sort_descending_by=SORT_KEY,
        )
        gen = torch.Generator().manual_seed(config.RANDOM_SEED)
        models = {
            "program_generator": program_generator.init_params(gen, self.pg_spec),
            "question_reconstructor": question_reconstructor.init_params(gen, self.qr_spec),
        }
        super().__init__(config, batches, models, serialization_dir, device=device, writer=writer)
        self._vocabulary = vocabulary

        self._prior_params = load_frozen_prior(config.CHECKPOINTS.PROGRAM_PRIOR, self.prior_spec,
                                               self._device)
        self._prior_packed = (pack_lm_weights(self._prior_params)
                              if self._device.type == "cuda" else None)

    # ------------------------------------------------------------------ the step ------
    def sample_programs(self, questions: torch.Tensor,
                        dropout_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        r"""z ~ q(z|x): (N, 26) programs trimmed at @end@, sampled by kernel K1
        in bfloat16 from a Philox seed drawn from the trainer's generator,
        with the encoder's ``dropout_masks`` of this training pass."""
        seed = int(torch.randint(2 ** 62, (1,), generator=self._generator))
        with torch.no_grad():
            out = fused_sampling_forward(self._params["program_generator"], self.pg_spec,
                                         questions, seed=seed, compute_dtype=torch.bfloat16,
                                         dropout_masks=dropout_masks)
        return out["predictions"]

    def draw_dropout_masks(self, batch: Dict[str, Any]) -> Dict[str, Optional[torch.Tensor]]:
        r"""This step's dropout masks (:func:`question_coding_dropout_masks`)."""
        return question_coding_dropout_masks(self.dropout_generator, self.pg_spec, self.qr_spec,
                                             batch)

    def question_coding_objective(
        self, params: Dict[str, Any], batch: Dict[str, Any], z: Optional[torch.Tensor],
        baseline: torch.Tensor, dropout_masks: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
        r"""(total loss, new baseline, logs) of one supervised-first batch
        (``batch[COUNT_KEY]`` supervised rows) with the programs ``z`` sampled
        for its unsupervised rows (None when there are none, or with
        OBJECTIVE ``baseline``), under the passes' ``dropout_masks`` (the keys
        of :func:`question_coding_dropout_masks`; None: no dropout). The logs
        are detached 0-dim tensors."""
        masks = dropout_masks or {}
        n_sup = batch[COUNT_KEY]
        questions, programs = batch["question"], batch["program"]
        pg, qr = params["program_generator"], params["question_reconstructor"]
        zero = torch.zeros((), dtype=torch.float32, device=questions.device)

        pg_loss_sup = qr_loss_sup = zero
        if n_sup > 0:
            q_sup, p_sup = questions[:n_sup], programs[:n_sup]
            ones = torch.ones(n_sup, dtype=torch.float32, device=questions.device)
            pg_loss_sup = masked_mean(
                fused_tf_loss(pg, self.pg_spec, q_sup, p_sup, dropout_masks=masks.get("pg_sup")),
                ones)
            qr_loss_sup = masked_mean(
                fused_tf_loss(qr, self.qr_spec, p_sup, q_sup, dropout_masks=masks.get("qr_sup")),
                ones)
        logs = {"loss": {"question_reconstruction_gt": qr_loss_sup.detach(),
                         "program_generation_gt": pg_loss_sup.detach()}}
        if self._C.OBJECTIVE == "baseline":
            return pg_loss_sup + qr_loss_sup, baseline, logs

        elbo, new_baseline = zero, baseline
        diagnostics = {"reconstruction_likelihood": zero, "kl_divergence": zero,
                       "reinforce_reward": zero}
        if z is not None:
            q_unsup = questions[n_sup:]
            logprobs_generation = -fused_tf_loss(pg, self.pg_spec, q_unsup, z, True,
                                                 masks.get("pg_unsup"))
            logprobs_reconstruction = -fused_tf_loss(qr, self.qr_spec, z, q_unsup,
                                                     dropout_masks=masks.get("qr_unsup"))
            logprobs_prior = frozen_prior_logprobs(self._prior_params, self._prior_packed,
                                                   self.prior_spec, z)
            reward = question_coding_reward(logprobs_reconstruction, logprobs_generation,
                                            logprobs_prior, self._C.BETA)
            diagnostics, new_baseline = elbo_with_reinforce(
                logprobs_generation, logprobs_reconstruction, reward, baseline, self._C.BETA,
                self._C.DELTA, mask=torch.ones_like(reward),
            )
            elbo = diagnostics.pop("elbo")
            diagnostics.pop("elbo_per_example")
        logs["elbo"] = {k: v.detach() for k, v in dict(diagnostics, elbo=elbo).items()}
        total = -elbo + self._C.ALPHA * (qr_loss_sup + pg_loss_sup)
        return total, new_baseline.detach(), logs

    def _do_iteration(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        n_unsup = batch["question"].shape[0] - batch[COUNT_KEY]
        masks = self.draw_dropout_masks(batch)
        z = None
        if self._C.OBJECTIVE == "ours" and n_unsup > 0:
            z = self.sample_programs(batch["question"][batch[COUNT_KEY]:], masks["pg_unsup"])
        total, self._baseline, logs = self.question_coding_objective(
            self._params, batch, z, self._baseline, masks)
        self._optimizer.zero_grad()
        if total.requires_grad:
            total.backward()
        self._optimizer.step()
        return logs

    def model_specs(self) -> Dict[str, Any]:
        return {"program_generator": self.pg_spec, "question_reconstructor": self.qr_spec}

    def after_validation(self, val_metrics: Dict[str, Any], iteration=None) -> None:
        val_metrics["metric"] = val_metrics["program_generator"]["sequence_accuracy"]
        super().after_validation(val_metrics, iteration)

    @property
    def prior_params(self) -> Dict[str, Any]:
        return self._prior_params
