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
  ``elbo_rows``;
- on the supervised rows ``[:n_sup]``: PG and QR teacher-forced (K4, twice);
- total = γ·nmn − elbo + α·(pg_sup + qr_sup); ``backward()``, clamp, Adam
  over PG, QR and the NMN.

OBJECTIVE ``baseline`` rewards the answer log-likelihood alone: REINFORCE of
PG's loss at z over the unsupervised rows, total = γ·nmn − elbo, and no QR,
prior or supervised pass (JAX trainer :229-245).

With ``DROPOUT > 0`` every PG and QR pass draws its encoder's inter-layer
dropout masks as question_coding's do (K1 and PG's REINFORCE pass share
theirs); the frozen prior and the NMN take none.

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

Every mean is a subset's sum over the global batch's count, as in the
question_coding trainer, whose data-parallel scheme this trainer keeps with
``parallel``: a rank's block of each global batch, sorted supervised-first
inside it; its rows' sums over the global counts, the ranks' gradients
summed; one all-reduce of a fixed float64 vector (:data:`JT_SUMS`) after
the backward for the logs and the baseline, the same on every rank. The
NMN's K5 and K6 run on the rank's unsupervised rows. The launcher hands
every rank one copy of the features in shared memory
(``JointTrainingDataset(shared_features=True)``).
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
    elbo_rows,
    joint_training_reward,
    mean_over,
    reinforce_rows,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_train import fused_tf_loss, pack_lm_weights
from probnmn_tpu_torch.parallel.mesh import shard_of
from probnmn_tpu_torch.training._trainer import _Trainer, load_frozen
from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec
from probnmn_tpu_torch.training.question_coding_trainer import (
    COUNT_KEY,
    ELBO_LOGS,
    SORT_KEY,
    SUP_LOGS,
    QuestionCodingTrainer,
    frozen_prior_logprobs,
    global_means,
    load_frozen_prior,
    subset_counts,
)

# The sums a step all-reduces, in order: question_coding's and the NMN's loss.
JT_SUMS = ("nmn", "program_generation_gt", "question_reconstruction_gt",
           "reconstruction_likelihood", "kl_divergence", "elbo", "reinforce_reward",
           "centered_reward")


class JointTrainingTrainer(_Trainer):
    r"""``dataset``: the training set; None reads ``config.DATA.TRAIN_TOKENS``
    and ``config.DATA.TRAIN_FEATURES`` (the supervision subset drawn from the
    global numpy seed; features in host memory, or streamed with
    ``in_memory_features=False``). ``replay`` selects the NMN's backward
    (None: ``PROBNMN_NMN_REPLAY_BWD``). ``parallel``: the rank's
    ``DataParallel`` handle, or None for one process."""

    def __init__(self, config: Config, serialization_dir: str, device="cuda", writer=None,
                 dataset: Optional[JointTrainingDataset] = None,
                 in_memory_features: bool = True, replay: Optional[bool] = None,
                 parallel=None):
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
            **shard_of(parallel),
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
        super().__init__(config, batches, models, serialization_dir, device=device, writer=writer,
                         parallel=parallel)
        self._vocabulary = vocabulary
        self._replay = replay
        self._tables = nmn.build_tables(self.nmn_spec, self._device)
        self._prior_params = load_frozen_prior(config.CHECKPOINTS.PROGRAM_PRIOR, self.prior_spec,
                                               self._device)
        self._prior_packed = (pack_lm_weights(self._prior_params)
                              if self._device.type == "cuda" else None)

    # ------------------------------------------------------------------ the step ------
    # z ~ q(z|x) from the live ProgramGenerator, as question_coding samples it,
    # and the passes' dropout masks, drawn as question_coding draws them.
    sample_programs = QuestionCodingTrainer.sample_programs
    draw_dropout_masks = QuestionCodingTrainer.draw_dropout_masks

    def joint_training_objective(
        self, params: Dict[str, Any], batch: Dict[str, Any], z: Optional[torch.Tensor],
        baseline: torch.Tensor, dropout_masks: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
        r"""(total loss, new baseline, logs) of one supervised-first batch
        (``batch[COUNT_KEY]`` supervised rows) with the programs ``z`` sampled
        for its unsupervised rows (None when there are none), under the
        passes' ``dropout_masks`` (``question_coding_dropout_masks``' keys;
        None: no dropout). The logs are detached 0-dim tensors under the JAX
        trainer's keys. On a rank the total is the rank's share of the
        global batch's, and the baseline and logs are the global batch's,
        after one all-reduce."""
        total, sums = self.joint_training_sums(params, batch, z, baseline, dropout_masks)
        new_baseline, logs = self.logs_of_sums(sums, batch, baseline)
        return total, new_baseline, logs

    def joint_training_sums(
        self, params: Dict[str, Any], batch: Dict[str, Any], z: Optional[torch.Tensor],
        baseline: torch.Tensor, dropout_masks: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        r"""(this batch's share of the global total loss, the detached sums
        over its rows of every :data:`JT_SUMS` term): each mean is the rows'
        sum over the global batch's count of the subset."""
        masks = dropout_masks or {}
        c = self._C
        n_sup = batch[COUNT_KEY]
        sup_count, unsup_count = subset_counts(batch, self.world_size)
        questions, programs = batch["question"], batch["program"]
        pg, qr = params["program_generator"], params["question_reconstructor"]
        zero = torch.zeros((), dtype=torch.float32, device=questions.device)
        sums = {key: zero.double() for key in JT_SUMS}

        nmn_loss = elbo = zero
        if z is not None:
            q_unsup = questions[n_sup:]
            pg_loss = fused_tf_loss(pg, self.pg_spec, q_unsup, z, True, masks.get("pg_unsup"))
            nmn_out = nmn.nmn_forward_fast(
                params["nmn"], self.nmn_spec, image_to_nhwc(batch["image"][n_sup:]), z,
                batch["answer"][n_sup:], tables=self._tables, replay=self._replay)
            nmn_loss = mean_over(nmn_out["loss"].sum(), unsup_count)
            sums["nmn"] = nmn_out["loss"].detach().double().sum()
            logprobs_answering = -nmn_out["loss"]
            if c.OBJECTIVE == "baseline":
                rows, elbo_sums = reinforce_rows(pg_loss, logprobs_answering, baseline)
            else:
                logprobs_reconstruction = -fused_tf_loss(qr, self.qr_spec, z, q_unsup,
                                                         dropout_masks=masks.get("qr_unsup"))
                logprobs_prior = frozen_prior_logprobs(self._prior_params, self._prior_packed,
                                                       self.prior_spec, z)
                reward = joint_training_reward(logprobs_reconstruction, -pg_loss,
                                               logprobs_prior, logprobs_answering, c.BETA,
                                               c.GAMMA)
                rows, elbo_sums = elbo_rows(-pg_loss, logprobs_reconstruction, reward, baseline,
                                            c.BETA)
            elbo = mean_over(rows.sum(), unsup_count)
            sums.update(elbo_sums)

        total = c.GAMMA * nmn_loss - elbo
        if c.OBJECTIVE == "ours" and n_sup > 0:
            q_sup, p_sup = questions[:n_sup], programs[:n_sup]
            pg_rows = fused_tf_loss(pg, self.pg_spec, q_sup, p_sup,
                                    dropout_masks=masks.get("pg_sup"))
            qr_rows = fused_tf_loss(qr, self.qr_spec, p_sup, q_sup,
                                    dropout_masks=masks.get("qr_sup"))
            total = total + c.ALPHA * (mean_over(pg_rows.sum(), sup_count)
                                       + mean_over(qr_rows.sum(), sup_count))
            sums["program_generation_gt"] = pg_rows.detach().double().sum()
            sums["question_reconstruction_gt"] = qr_rows.detach().double().sum()
        return total, sums

    def logs_of_sums(self, sums: Dict[str, torch.Tensor], batch: Dict[str, Any],
                     baseline: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
        r"""(new baseline, logs) from this batch's :data:`JT_SUMS`
        (``global_means``)."""
        new_baseline, means = global_means(self._parallel, sums, JT_SUMS, batch, self.world_size,
                                           baseline, self._C.DELTA)
        losses = {"nmn": means["nmn"]}
        elbo_keys = ("reinforce_reward", "elbo")
        if self._C.OBJECTIVE == "ours":
            losses.update({key: means[key] for key in SUP_LOGS})
            elbo_keys = ELBO_LOGS
        return new_baseline, {"loss": losses, "elbo": {key: means[key] for key in elbo_keys}}

    def _do_iteration(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        n_sup = batch[COUNT_KEY]
        masks = self.draw_dropout_masks(batch)
        z = None
        if batch["question"].shape[0] > n_sup:
            z = self.sample_programs(batch["question"][n_sup:], masks["pg_unsup"])
        total, sums = self.joint_training_sums(self._params, batch, z, self._baseline, masks)
        self._apply_gradients(total, average=False)
        self._baseline, logs = self.logs_of_sums(sums, batch, self._baseline)
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
