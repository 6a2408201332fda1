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

Means over the global batch. Every mean of the step (the two supervised
losses, the ELBO and its diagnostics, the baseline's update) is a subset's
sum over the global batch's count of that subset, as the JAX package's
masked means are under GSPMD. With ``parallel`` (``parallel/mesh.py``) the
trainer is one rank: its batch is its block of each global batch, sorted
supervised-first inside the block, and carries the global batch's
supervised count (``data/pipeline.py``). Each rank divides its rows' sums
by the global counts, so the ranks' gradients are summed, not averaged
(``_apply_gradients(..., average=False)``); after the backward one
all-reduce of a fixed float64 vector (:data:`QC_SUMS`) gives every rank the
global sums of the logged terms and of the centered reward, from which every
rank computes the same logs and the same new baseline. K1 samples a rank's
rows from a Philox seed of the rank's own generator (seeded by
(``RANDOM_SEED``, data index)), the counterpart of the JAX package's per-shard
``fold_in``. A rank whose block holds no row of a subset skips its passes
and still joins both all-reduces, so every step runs the same collectives.
In one process the same code runs with the batch as the global batch.
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
from probnmn_tpu_torch.modules.elbo import (
    baseline_update,
    elbo_rows,
    mean_over,
    question_coding_reward,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    fused_tf_loss,
    lm_forward_cuda,
    lm_loss_plain,
    pack_lm_weights,
)
from probnmn_tpu_torch.ops.rnn import draw_dropout_masks
from probnmn_tpu_torch.parallel.mesh import global_sum_vector, shard_of
from probnmn_tpu_torch.training._trainer import _Trainer, load_frozen
from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec

SORT_KEY = "supervision"
COUNT_KEY = "_num_" + SORT_KEY  # attached by BatchIterator(sort_descending_by=SORT_KEY)
# The global batch's count, attached over several ranks.
GLOBAL_COUNT_KEY = COUNT_KEY + "_global"
# The sums a step all-reduces, in order: the supervised losses, the ELBO's
# diagnostics and the centered reward of the baseline's update.
QC_SUMS = ("program_generation_gt", "question_reconstruction_gt", "reconstruction_likelihood",
           "kl_divergence", "elbo", "reinforce_reward", "centered_reward")
ELBO_LOGS = ("reconstruction_likelihood", "kl_divergence", "reinforce_reward", "elbo")
# The logged terms that are means over the supervised rows; every other sum
# is over the unsupervised rows.
SUP_LOGS = ("question_reconstruction_gt", "program_generation_gt")


def subset_counts(batch: Dict[str, Any], data_size: int) -> Tuple[int, int]:
    r"""(supervised, unsupervised) rows of the global batch whose block of
    ``batch`` a rank of ``data_size`` data ranks holds (one process: 1;
    the ranks of a model group hold the same block). Over data ranks the
    batch must carry the global count that ``BatchIterator`` attaches."""
    n_sup = batch[COUNT_KEY] if data_size == 1 else batch[GLOBAL_COUNT_KEY]
    return n_sup, batch["question"].shape[0] * data_size - n_sup


def global_means(parallel, sums: Dict[str, torch.Tensor], keys: Tuple[str, ...],
                 batch: Dict[str, Any], data_size: int, baseline: torch.Tensor, delta: float
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    r"""(new baseline, {key: the global batch's mean}) from a rank's
    detached ``sums`` at ``keys`` (which end with ``centered_reward``): one
    all-reduce of them over the ranks, then each over its subset's global
    count (:data:`SUP_LOGS` over the supervised rows, the rest over the
    unsupervised ones), and the baseline moved by the mean centered reward.
    Every rank computes the same bits; with no unsupervised row the
    baseline holds."""
    sup_count, unsup_count = subset_counts(batch, data_size)
    total = dict(zip(keys, global_sum_vector(parallel, [sums[k] for k in keys],
                                             baseline.device)))
    means = {k: mean_over(total[k], sup_count if k in SUP_LOGS else unsup_count) for k in keys}
    return baseline_update(baseline, total["centered_reward"], unsup_count, delta), means


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
    (the supervision subset drawn from the global numpy seed: every rank of
    a data-parallel run must hold the same one, so the launcher builds it
    once and hands it to the ranks)."""

    def __init__(self, config: Config, serialization_dir: str, device="cuda",
                 writer=None, dataset: Optional[QuestionCodingDataset] = None, parallel=None):
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
            **shard_of(parallel),
        )
        gen = torch.Generator().manual_seed(config.RANDOM_SEED)
        models = {
            "program_generator": program_generator.init_params(gen, self.pg_spec),
            "question_reconstructor": question_reconstructor.init_params(gen, self.qr_spec),
        }
        super().__init__(config, batches, models, serialization_dir, device=device, writer=writer,
                         parallel=parallel)
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
        are detached 0-dim tensors. On a rank the total is the rank's share
        of the global batch's (the ranks' totals sum to it), and the baseline
        and logs are the global batch's, after one all-reduce."""
        total, sums = self.question_coding_sums(params, batch, z, baseline, dropout_masks)
        new_baseline, logs = self.logs_of_sums(sums, batch, baseline)
        return total, new_baseline, logs

    def question_coding_sums(
        self, params: Dict[str, Any], batch: Dict[str, Any], z: Optional[torch.Tensor],
        baseline: torch.Tensor, dropout_masks: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        r"""(this batch's share of the global total loss, the detached sums
        over its rows of every :data:`QC_SUMS` term): each mean of the
        objective is the rows' sum over the global batch's count of the
        subset (:func:`subset_counts`)."""
        masks = dropout_masks or {}
        n_sup = batch[COUNT_KEY]
        sup_count, unsup_count = subset_counts(batch, self.data_size)
        questions, programs = batch["question"], batch["program"]
        pg, qr = params["program_generator"], params["question_reconstructor"]
        zero = torch.zeros((), dtype=torch.float32, device=questions.device)
        sums = {key: zero.double() for key in QC_SUMS}

        pg_loss_sup = qr_loss_sup = zero
        if n_sup > 0:
            q_sup, p_sup = questions[:n_sup], programs[:n_sup]
            pg_rows = fused_tf_loss(pg, self.pg_spec, q_sup, p_sup,
                                    dropout_masks=masks.get("pg_sup"))
            qr_rows = fused_tf_loss(qr, self.qr_spec, p_sup, q_sup,
                                    dropout_masks=masks.get("qr_sup"))
            pg_loss_sup, qr_loss_sup = (mean_over(rows.sum(), sup_count)
                                        for rows in (pg_rows, qr_rows))
            sums["program_generation_gt"] = pg_rows.detach().double().sum()
            sums["question_reconstruction_gt"] = qr_rows.detach().double().sum()
        if self._C.OBJECTIVE == "baseline":
            return pg_loss_sup + qr_loss_sup, sums

        elbo = zero
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
            elbo_each, elbo_sums = elbo_rows(logprobs_generation, logprobs_reconstruction, reward,
                                             baseline, self._C.BETA)
            elbo = mean_over(elbo_each.sum(), unsup_count)
            sums.update(elbo_sums)
        return -elbo + self._C.ALPHA * (qr_loss_sup + pg_loss_sup), sums

    def logs_of_sums(self, sums: Dict[str, torch.Tensor], batch: Dict[str, Any],
                     baseline: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
        r"""(new baseline, logs) from this batch's :data:`QC_SUMS`
        (:func:`global_means`). OBJECTIVE ``baseline`` sums no centered
        reward, so its baseline holds."""
        new_baseline, means = global_means(self._parallel, sums, QC_SUMS, batch, self.data_size,
                                           baseline, self._C.DELTA)
        logs = {"loss": {key: means[key] for key in SUP_LOGS}}
        if self._C.OBJECTIVE == "ours":
            logs["elbo"] = {key: means[key] for key in ELBO_LOGS}
        return new_baseline, logs

    def _do_iteration(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        n_unsup = batch["question"].shape[0] - batch[COUNT_KEY]
        masks = self.draw_dropout_masks(batch)
        z = None
        if self._C.OBJECTIVE == "ours" and n_unsup > 0:
            z = self.sample_programs(batch["question"][batch[COUNT_KEY]:], masks["pg_unsup"])
        total, sums = self.question_coding_sums(self._live, batch, z, self._baseline, masks)
        self._apply_gradients(total, average=False)
        self._baseline, logs = self.logs_of_sums(sums, batch, self._baseline)
        return logs

    def model_specs(self) -> Dict[str, Any]:
        return {"program_generator": self.pg_spec, "question_reconstructor": self.qr_spec}

    def after_validation(self, val_metrics: Dict[str, Any], iteration=None) -> None:
        val_metrics["metric"] = val_metrics["program_generator"]["sequence_accuracy"]
        super().after_validation(val_metrics, iteration)

    @property
    def prior_params(self) -> Dict[str, Any]:
        return self._prior_params
