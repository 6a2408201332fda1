r"""
Phase 4 trainer: Joint Training, the full ELBO with the γ-scaled answer
log-likelihood in the REINFORCE reward (counterpart of
``probnmn_tpu/training/joint_training_trainer.py``; reference
``probnmn/trainers/joint_training_trainer.py``).

A step over a batch sorted supervised-first (``BatchIterator(...,
sort_descending_by="supervision")``) runs, with OBJECTIVE ``ours``:

- on the unsupervised rows ``[n_sup:]``: a program z sampled from the
  ProgramGenerator (PG; kernel K1, bfloat16, a Philox seed drawn from the
  trainer's generator, no gradient); PG's length-normalized log q(z|x)
  (K4 in REINFORCE mode, with gradient); the QuestionReconstructor's (QR)
  log p(x|z) (K4); the frozen ProgramPrior's log p(z) (K3f); the NMN's
  answer log-likelihood at z over the rows' image features
  (``nmn_forward_fast``: K5 forward and K6 backward, or K2 and K6's replay
  mode, see below); then ``joint_training_reward`` and
  ``elbo_with_reinforce``;
- on the supervised rows ``[:n_sup]``: PG and QR teacher-forced (K4, twice);
- total = γ·nmn − elbo + α·(pg_sup + qr_sup); ``backward()``, clamp, Adam
  over PG, QR and the NMN.

OBJECTIVE ``baseline`` rewards the answer log-likelihood alone: REINFORCE of
PG's loss at z over the unsupervised rows, total = γ·nmn − elbo, and no QR,
prior or supervised pass (JAX trainer :229-245).

As in the question_coding trainer, each pass takes its *exact* subset; the
JAX package's fixed windows (``training/_subbatch.py``) are not carried
over. An empty subset skips its passes: its means are 0 and the baseline
does not move, which is what the JAX package's masked means give there.

Models: PG and QR come, trainable, from ``CHECKPOINTS.QUESTION_CODING``, the
NMN from ``CHECKPOINTS.MODULE_TRAINING``, the frozen prior from
``CHECKPOINTS.PROGRAM_PRIOR``: each a checkpoint of the port's earlier
phase, of the JAX package's or of the reference's.

The NMN's backward: by default K5 stores the residuals K6 reads (about 1 GB
at batch 256 in bfloat16); ``replay=True`` or ``PROBNMN_NMN_REPLAY_BWD=1``
(the JAX package's switch) runs K2, which stores none, and K6 in replay
mode, with the same gradients.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import JointTrainingDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator, image_to_nhwc
from probnmn_tpu_torch.data.samplers import SupervisionWeightedRandomSampler
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.models import nmn, program_generator, question_reconstructor
from probnmn_tpu_torch.modules.elbo import (
    elbo_with_reinforce,
    joint_training_reward,
    masked_mean,
    reinforce,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_train import fused_tf_loss, pack_lm_weights
from probnmn_tpu_torch.ops.rnn import check_no_dropout
from probnmn_tpu_torch.training._trainer import _Trainer, load_frozen
from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec
from probnmn_tpu_torch.training.question_coding_trainer import (
    COUNT_KEY,
    SORT_KEY,
    QuestionCodingTrainer,
    frozen_prior_logprobs,
    load_frozen_prior,
)


class JointTrainingTrainer(_Trainer):
    r"""``dataset``: the training set; None reads ``config.DATA.TRAIN_TOKENS``
    and ``config.DATA.TRAIN_FEATURES`` (the supervision subset drawn from the
    global numpy seed; features in host memory, or streamed with
    ``in_memory_features=False``). ``replay`` selects the NMN's backward
    (None: ``PROBNMN_NMN_REPLAY_BWD``)."""

    def __init__(self, config: Config, serialization_dir: str, device="cuda", writer=None,
                 dataset: Optional[JointTrainingDataset] = None,
                 in_memory_features: bool = True, replay: Optional[bool] = None):
        if config.PHASE != "joint_training":
            raise ValueError(f"Expected PHASE joint_training, found {config.PHASE}")
        if config.OBJECTIVE not in ("baseline", "ours"):
            raise ValueError(f"unknown OBJECTIVE {config.OBJECTIVE!r}")
        device = resolve_device(device)

        vocabulary = Vocabulary.from_files(config.DATA.VOCABULARY)
        self.pg_spec = program_generator.make_spec(vocabulary, config)
        self.qr_spec = question_reconstructor.make_spec(vocabulary, config)
        self.nmn_spec = nmn.make_spec(vocabulary, config)
        self.prior_spec = make_prior_spec(config, vocabulary)
        for spec in (self.pg_spec, self.qr_spec, self.prior_spec):
            check_no_dropout(spec.dropout)
        if dataset is None:
            dataset = JointTrainingDataset(
                config.DATA.TRAIN_TOKENS, config.DATA.TRAIN_FEATURES,
                num_supervision=config.SUPERVISION,
                supervision_question_max_length=config.SUPERVISION_QUESTION_MAX_LENGTH,
                in_memory=in_memory_features,
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
        # Templates of the right shapes; every trainable param is read from a
        # checkpoint of the port's earlier phases (reference :85-90).
        gen = torch.Generator().manual_seed(config.RANDOM_SEED)
        qc_path, mt_path = config.CHECKPOINTS.QUESTION_CODING, config.CHECKPOINTS.MODULE_TRAINING
        models = {
            "program_generator": load_frozen(
                qc_path, "program_generator", program_generator.init_params(gen, self.pg_spec),
                device, self.pg_spec, vocabulary),
            "question_reconstructor": load_frozen(
                qc_path, "question_reconstructor",
                question_reconstructor.init_params(gen, self.qr_spec), device, self.qr_spec,
                vocabulary),
            "nmn": load_frozen(mt_path, "nmn", nmn.init_nmn_params(gen, self.nmn_spec), device,
                               self.nmn_spec, vocabulary),
        }
        super().__init__(config, batches, models, serialization_dir, device=device, writer=writer)
        self._vocabulary = vocabulary
        self._replay = replay
        self._tables = nmn.build_tables(self.nmn_spec, self._device)
        self._prior_params = load_frozen_prior(config.CHECKPOINTS.PROGRAM_PRIOR, self.prior_spec,
                                               self._device)
        self._prior_packed = (pack_lm_weights(self._prior_params)
                              if self._device.type == "cuda" else None)

    # ------------------------------------------------------------------ the step ------
    # z ~ q(z|x) from the live ProgramGenerator, as question_coding samples it.
    sample_programs = QuestionCodingTrainer.sample_programs

    def joint_training_objective(
        self, params: Dict[str, Any], batch: Dict[str, Any], z: Optional[torch.Tensor],
        baseline: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
        r"""(total loss, new baseline, logs) of one supervised-first batch
        (``batch[COUNT_KEY]`` supervised rows) with the programs ``z`` sampled
        for its unsupervised rows (None when there are none). The logs are
        detached 0-dim tensors under the JAX trainer's keys."""
        c = self._C
        n_sup = batch[COUNT_KEY]
        questions, programs = batch["question"], batch["program"]
        pg, qr = params["program_generator"], params["question_reconstructor"]
        zero = torch.zeros((), dtype=torch.float32, device=questions.device)

        nmn_loss = elbo = zero
        new_baseline = baseline
        diagnostics = {"reconstruction_likelihood": zero, "kl_divergence": zero,
                       "reinforce_reward": zero}
        if z is not None:
            q_unsup = questions[n_sup:]
            pg_loss = fused_tf_loss(pg, self.pg_spec, q_unsup, z, True)
            nmn_out = nmn.nmn_forward_fast(
                params["nmn"], self.nmn_spec, image_to_nhwc(batch["image"][n_sup:]), z,
                batch["answer"][n_sup:], tables=self._tables, replay=self._replay)
            ones = torch.ones_like(pg_loss)
            nmn_loss = masked_mean(nmn_out["loss"], ones)
            logprobs_answering = -nmn_out["loss"]
            if c.OBJECTIVE == "baseline":
                reinforce_term, new_baseline = reinforce(pg_loss, logprobs_answering, baseline,
                                                         c.DELTA, mask=ones)
                elbo = masked_mean(reinforce_term, ones)
                diagnostics = {"reinforce_reward": masked_mean(logprobs_answering, ones)}
            else:
                logprobs_generation = -pg_loss
                logprobs_reconstruction = -fused_tf_loss(qr, self.qr_spec, z, q_unsup)
                logprobs_prior = frozen_prior_logprobs(self._prior_params, self._prior_packed,
                                                       self.prior_spec, z)
                reward = joint_training_reward(logprobs_reconstruction, logprobs_generation,
                                               logprobs_prior, logprobs_answering, c.BETA,
                                               c.GAMMA)
                diagnostics, new_baseline = elbo_with_reinforce(
                    logprobs_generation, logprobs_reconstruction, reward, baseline, c.BETA,
                    c.DELTA, mask=ones,
                )
                elbo = diagnostics.pop("elbo")
                diagnostics.pop("elbo_per_example")
        elif c.OBJECTIVE == "baseline":
            diagnostics = {"reinforce_reward": zero}

        total = c.GAMMA * nmn_loss - elbo
        losses = {"nmn": nmn_loss}
        if c.OBJECTIVE == "ours":
            pg_loss_sup = qr_loss_sup = zero
            if n_sup > 0:
                q_sup, p_sup = questions[:n_sup], programs[:n_sup]
                ones = torch.ones(n_sup, dtype=torch.float32, device=questions.device)
                pg_loss_sup = masked_mean(fused_tf_loss(pg, self.pg_spec, q_sup, p_sup), ones)
                qr_loss_sup = masked_mean(fused_tf_loss(qr, self.qr_spec, p_sup, q_sup), ones)
            losses.update(question_reconstruction_gt=qr_loss_sup, program_generation_gt=pg_loss_sup)
            total = total + c.ALPHA * (pg_loss_sup + qr_loss_sup)
        logs = {"loss": {k: v.detach() for k, v in losses.items()},
                "elbo": {k: v.detach() for k, v in dict(diagnostics, elbo=elbo).items()}}
        return total, new_baseline.detach(), logs

    def _do_iteration(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        n_sup = batch[COUNT_KEY]
        z = None
        if batch["question"].shape[0] > n_sup:
            z = self.sample_programs(batch["question"][n_sup:])
        total, self._baseline, logs = self.joint_training_objective(
            self._params, batch, z, self._baseline)
        self._optimizer.zero_grad()
        if total.requires_grad:
            total.backward()
        self._optimizer.step()
        return logs

    def model_specs(self) -> Dict[str, Any]:
        return {"program_generator": self.pg_spec, "question_reconstructor": self.qr_spec,
                "nmn": self.nmn_spec}

    def after_validation(self, val_metrics: Dict[str, Any], iteration=None) -> None:
        val_metrics["metric"] = val_metrics["nmn"]["answer_accuracy"]
        super().after_validation(val_metrics, iteration)

    @property
    def prior_params(self) -> Dict[str, Any]:
        return self._prior_params

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        r"""The NMN's dispatch tables on the trainer's device."""
        return self._tables
