"""The port's data-parallel question_coding and joint_training
(``probnmn_tpu_torch/parallel/mesh.py``, piece (b)) and the evaluate CLI over
ranks (piece (c)) on the CPU: two gloo ranks, each a spawned process, against
the JAX package on ``auto_mesh(2, B)`` (conftest's 8 CPU devices) or its
loss composition over the whole batch, and against the port in one process.

- The sorted batch over ranks: each rank's block sorted supervised-first,
  its own count and the global batch's, the blocks together the global batch.
- Each metric's counters, summed over halves and restored, give the whole.
- question_coding, OBJECTIVE ``baseline``: three steps at 2 ranks against
  the JAX trainer on the mesh and the port at one rank (losses within 1e-5;
  ROADMAP.md's trainer-parity rule; both ranks' parameters bit for bit).
- ``question_coding_objective`` and ``joint_training_objective`` at a
  handed-in z a row over 2 ranks against the JAX compositions of
  test_torch_port_question_coding.py and test_torch_port_joint_training.py
  over the whole batch: a batch whose ranks hold different supervised
  counts (the mean of the ranks' means misses the global mean), with token
  soups and an all-pad z in both ranks' blocks, and (question_coding) one
  whose rank 0 holds only supervised rows and rank 1 only unsupervised
  ones.
- Three steps of each phase at 2 ranks against one rank, z a function of
  the row's question; one step on the split batch; the baseline equal on
  both ranks bit for bit.
- Both evaluators at 2 ranks against one rank and JAX's mesh evaluators.
- ``train --device cpu --num-devices 2`` for both phases (one checkpoint a
  save, by rank 0, with the shared baseline, resumed by one rank), the
  launcher's one supervision subset, and ``evaluate --num-devices 2``
  against one rank for question_coding and module_training.

Rank-side code is this file's top-level functions and imports no JAX (the
spawned ranks import this module); JAX is imported inside the fixtures and
tests.
"""
import os

import numpy as np
import pytest
import torch

from probnmn_tpu_torch import evaluate, interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import JointTrainingDataset, QuestionCodingDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator
from probnmn_tpu_torch.data.readers import SharedFeatures
from probnmn_tpu_torch.evaluators.joint_training_evaluator import JointTrainingEvaluator
from probnmn_tpu_torch.evaluators.question_coding_evaluator import QuestionCodingEvaluator
from probnmn_tpu_torch.ops.kernels.seq2seq_train import fused_tf_loss
from probnmn_tpu_torch.parallel import mesh
from probnmn_tpu_torch.training._trainer import copy_into, tree_leaves, tree_map
from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer
from probnmn_tpu_torch.training.question_coding_trainer import (
    COUNT_KEY,
    GLOBAL_COUNT_KEY,
    QuestionCodingTrainer,
)
from probnmn_tpu_torch.utils import metrics
from probnmn_tpu_torch.utils.checkpointing import load_objects, save_objects
from probnmn_tpu_torch.utils.observability import RecordingWriter

STEPS = 3
RANKS = 2
LAUNCH_TIMEOUT = 150.0
LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5
GRAD_FLOOR = 1e-5
# JAX's fused_tf_loss, which the JAX compositions run in interpret mode,
# ties the seq2seq hidden size to the input size.
TIED = ["PROGRAM_GENERATOR.HIDDEN_SIZE", 16, "QUESTION_RECONSTRUCTOR.HIDDEN_SIZE", 16]
# The handed-in batches of 16 rows (8 a rank) over the train split's first
# 32 rows, in order: "unequal" holds rows 0-15, rank 0 five supervised rows
# and rank 1 two; "split" rows 16-31, rank 0 all supervised, rank 1 none.
# z of an unsupervised row is a token soup, all pad or a valid template.
SUPERVISED = {"unequal": (0, 1, 2, 3, 4, 8, 9), "split": tuple(range(16, 24))}
SOUP_ROWS = (5, 10, 25)
PAD_ROWS = (6, 11, 27)
OBJECTIVE_BATCH = 16


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return np.asarray(tree)


def _flat(tree, prefix=""):
    r"""{key path: numpy array} of a nested dict/list of tensors or arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy().copy()}
    return {prefix: np.asarray(tree)}


def _grads(params):
    return tree_map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), params)


class RowDataset:
    r"""A dataset whose batches carry each row's index under ``row``, with
    the supervision list given."""

    def __init__(self, dataset, supervision):
        self._dataset = dataset
        self._supervision = np.asarray(supervision, np.int64)

    def __len__(self):
        return len(self._dataset)

    def get_batch(self, indices):
        batch = self._dataset.get_batch(indices)
        batch["supervision"] = self._supervision[indices]
        batch["row"] = np.asarray(indices, np.int64)
        return batch

    def get_supervision_list(self):
        return self._supervision


class InOrder:
    r"""A sampler whose every epoch is ``order``."""

    def __init__(self, order):
        self._order = np.asarray(order)

    def epoch(self):
        return self._order


def _handed_batch(row_set, kind, parallel=None):
    r"""The rank's block of the handed-in batch ``kind``, sorted
    supervised-first, as the trainers' iterator gives it."""
    start = 0 if kind == "unequal" else OBJECTIVE_BATCH
    iterator = BatchIterator(row_set, InOrder(np.arange(start, start + OBJECTIVE_BATCH)),
                             OBJECTIVE_BATCH, device="cpu", sort_descending_by="supervision",
                             **mesh.shard_of(parallel))
    return next(iter(iterator))


def z_of_questions(questions, table):
    r"""A program a row, a function of the row's question alone."""
    q = questions.numpy()
    keys = (q * np.arange(1, q.shape[1] + 1)).sum(1) % len(table)
    return torch.from_numpy(table[keys])


def _patch_sampler(trainer, table):
    trainer.sample_programs = lambda questions, dropout_masks=None: z_of_questions(
        questions, table)


def _objective(trainer, batch, z_rows):
    r"""The objective at z of the batch's unsupervised rows (from
    ``z_rows``, by row index): (total, new baseline, logs, gradient tree)."""
    n_sup = batch[COUNT_KEY]
    z = (torch.from_numpy(z_rows[batch["row"][n_sup:].numpy()])
         if n_sup < len(batch["row"]) else None)
    objective = (trainer.question_coding_objective if isinstance(trainer, QuestionCodingTrainer)
                 else trainer.joint_training_objective)
    for leaf in tree_leaves(trainer.params):
        leaf.grad = None
    total, new_baseline, logs = objective(trainer.params, batch, z, torch.tensor(0.25))
    if total.requires_grad:
        total.backward()
    return dict(total=float(total.detach()), baseline=float(new_baseline),
                logs=_host_logs(logs), grads=_tree_numpy(_grads(trainer.params)),
                rows=batch["row"].numpy(), n_sup=n_sup, n_sup_global=batch.get(GLOBAL_COUNT_KEY))


def _host_logs(logs):
    return {group: {k: float(v) for k, v in values.items()} for group, values in logs.items()}


def _steps(trainer, params_key=None):
    r"""``STEPS`` steps: logs, baselines, gradients and the parameters after
    the first step and at the end."""
    logs, baselines, grads, first = [], [], [], None
    for iteration in range(STEPS):
        logs.append(trainer.step(iteration))
        baselines.append(float(trainer.baseline))
        grads.append(_flat(_grads(trainer.params)))
        if iteration == 0:
            first = _flat(trainer.params)
    return dict(logs=logs, baselines=baselines, grads=grads, first=first,
                params=_flat(trainer.params))


def _split_step(trainer, row_set, table):
    r"""One step on the handed-in "split" batch."""
    _patch_sampler(trainer, table)
    start = OBJECTIVE_BATCH
    trainer._batches = iter(BatchIterator(
        row_set, InOrder(np.arange(start, start + OBJECTIVE_BATCH)), OBJECTIVE_BATCH,
        device="cpu", sort_descending_by="supervision", **mesh.shard_of(trainer.parallel)))
    logs = trainer.step(0)
    return dict(logs=logs, baseline=float(trainer.baseline), params=_flat(trainer.params),
                grads=_flat(_grads(trainer.params)))


# ------------------------------------------------------------------ rank-side ----------
def _qc_runs(parallel, f):
    r"""What both the ranks and one process run of question_coding:
    OBJECTIVE baseline's evaluator and steps; OBJECTIVE ours' objective on
    both handed-in batches, its steps and a step on the split batch."""
    common = dict(device=parallel.device if parallel else "cpu", parallel=parallel,
                  dataset=f["train_set"])

    def trainer_of(config, name, writer=None):
        run_dir = os.path.join(f["run_dir"], f"{name}_{parallel.rank if parallel else 'one'}")
        trainer = QuestionCodingTrainer(config, run_dir, writer=writer or RecordingWriter(),
                                        **common)
        for model in ("program_generator", "question_reconstructor"):
            copy_into(trainer.params[model], f["init"][model])
        return trainer

    out = {}
    writer = RecordingWriter()
    trainer = trainer_of(f["baseline"], "baseline", writer)
    out["supervision"] = trainer._batch_source._dataset.get_supervision_list()
    out["val"] = QuestionCodingEvaluator(f["baseline"], trainer, dataset=f["val_set"]).evaluate(
        num_batches=2)
    out["baseline_steps"] = _steps(trainer)
    out["baseline_scalars"] = writer.scalars

    # The objective steps nothing, so the same trainer then takes the steps.
    trainer = trainer_of(f["ours"], "ours")
    out["objective"] = {}
    for kind in SUPERVISED:
        batch = _handed_batch(f["row_set"], kind, parallel)
        out["objective"][kind] = _objective(trainer, batch, f["z_rows"])
        n_sup = batch[COUNT_KEY]
        pg = trainer.params["program_generator"]
        with torch.no_grad():
            rows = fused_tf_loss(pg, trainer.pg_spec, batch["question"][:n_sup],
                                 batch["program"][:n_sup])
        out["objective"][kind]["pg_sup_rows"] = rows.numpy()

    _patch_sampler(trainer, f["z_table"])
    out["ours_steps"] = _steps(trainer)
    out["split_step"] = _split_step(trainer_of(f["ours"], "split"), f["row_set"], f["z_table"])
    return out


def _jt_runs(parallel, f):
    r"""What both the ranks and one process run of joint_training: the
    objective of both OBJECTIVEs on the "unequal" batch, the evaluator,
    OBJECTIVE ours' steps and a step on the split batch."""
    common = dict(device=parallel.device if parallel else "cpu", parallel=parallel)

    def trainer_of(config, name):
        run_dir = os.path.join(f["run_dir"], f"jt_{name}_{parallel.rank if parallel else 'one'}")
        return JointTrainingTrainer(config, run_dir, writer=RecordingWriter(),
                                    dataset=f["train_set"], **common)

    out = {"objective": {}}
    for objective in ("baseline", "ours"):
        # OBJECTIVE ours' trainer then evaluates and takes the steps.
        trainer = trainer_of(f[objective], objective)
        batch = _handed_batch(f["row_set"], "unequal", parallel)
        out["objective"][objective] = _objective(trainer, batch, f["z_rows"])
    out["val"] = JointTrainingEvaluator(f["ours"], trainer, dataset=f["val_set"]).evaluate(
        num_batches=2)
    _patch_sampler(trainer, f["z_table"])
    out["ours_steps"] = _steps(trainer)
    out["split_step"] = _split_step(trainer_of(f["ours"], "split"), f["row_set"], f["z_table"])
    features = f["train_set"]._features.features
    out["shared"] = isinstance(features, SharedFeatures) and features.tensor.is_shared()
    return out


def _qc_rank(parallel, f):
    return _qc_runs(parallel, f)


def _jt_rank(parallel, f):
    return _jt_runs(parallel, f)


def _launch(fn, run_dir, *args):
    return mesh.launch(fn, RANKS, "cpu", run_dir, args=args, timeout=LAUNCH_TIMEOUT,
                       collective_timeout=LAUNCH_TIMEOUT)


# ------------------------------------------------------------------ fixtures -----------
def _templates(vocab, n_rows, width):
    r"""The fixture's valid program templates, cycled over ``n_rows`` rows."""
    from tests.clevr_fixtures import PROGRAM_TEMPLATES

    z = np.zeros((n_rows, width), np.int64)
    for i in range(n_rows):
        ids = [vocab.get_token_index(t, "programs")
               for t in PROGRAM_TEMPLATES[i % len(PROGRAM_TEMPLATES)]]
        z[i, :len(ids)] = ids
    return z


def _z_rows(vocab, n_rows, width, seed):
    r"""A program for each row of the train split: a valid template, except
    the token soups of ``SOUP_ROWS`` and the all-pad rows of ``PAD_ROWS``."""
    z = _templates(vocab, n_rows, width)
    rs = np.random.RandomState(seed)
    for i in SOUP_ROWS:
        z[i] = rs.randint(1, vocab.get_vocab_size("programs"), width)
    z[list(PAD_ROWS)] = 0
    return z


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    r"""Fixture data; the generator, reconstructor, NMN and prior saved as
    the JAX package's checkpoints and as the port's; configs of both phases
    and OBJECTIVEs; the handed-in batches and programs."""
    import jax

    from probnmn_tpu.models import nmn as jnmn
    from probnmn_tpu.models import program_generator as jprogram_generator
    from probnmn_tpu.models import question_reconstructor as jquestion_reconstructor
    from probnmn_tpu.models.program_prior import init_program_prior_params
    from probnmn_tpu.training.program_prior_trainer import make_prior_spec as jax_make_prior_spec
    from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
    from tests.clevr_fixtures import PROGRAM_TEMPLATES, build_fixture_data, make_fixture_config

    root = str(tmp_path_factory.mktemp("mesh_semi"))
    jvocab = build_fixture_data(root)
    base = make_fixture_config(root, "joint_training", TIED)
    specs = {"program_generator": jprogram_generator.make_spec(jvocab, base),
             "question_reconstructor": jquestion_reconstructor.make_spec(jvocab, base),
             "nmn": jnmn.make_spec(jvocab, base), "program_prior": jax_make_prior_spec(base, jvocab)}
    keys = jax.random.split(jax.random.PRNGKey(22), 4)
    jparams = {"program_generator": jprogram_generator.init_params(keys[0],
                                                                    specs["program_generator"]),
               "question_reconstructor": jquestion_reconstructor.init_params(
                   keys[1], specs["question_reconstructor"]),
               "nmn": jnmn.init_nmn_params(keys[2], specs["nmn"]),
               "program_prior": init_program_prior_params(keys[3], specs["program_prior"])}
    jax_save_objects(base.CHECKPOINTS.QUESTION_CODING,
                     {k: jparams[k] for k in ("program_generator", "question_reconstructor")})
    jax_save_objects(base.CHECKPOINTS.MODULE_TRAINING, {"nmn": jparams["nmn"]})
    jax_save_objects(base.CHECKPOINTS.PROGRAM_PRIOR, {"program_prior": jparams["program_prior"]})
    numpy_params = jax.tree_util.tree_map(np.asarray, jparams)

    path = os.path.join(root, "base.yml")
    base.dump(path)
    from probnmn_tpu_torch.data.vocabulary import Vocabulary
    from probnmn_tpu_torch.models import nmn

    port_nmn_spec = nmn.make_spec(Vocabulary.from_files(base.DATA.VOCABULARY), Config(path))
    port = {name: os.path.join(root, f"{name}_port.ckpt")
            for name in ("question_coding", "module_training", "program_prior")}
    save_objects(port["question_coding"], {
        "program_generator": interop.program_generator_from_jax(
            numpy_params["program_generator"]),
        "question_reconstructor": interop.question_reconstructor_from_jax(
            numpy_params["question_reconstructor"])})
    save_objects(port["module_training"],
                 {"nmn": interop.nmn_from_jax(numpy_params["nmn"], port_nmn_spec)})
    save_objects(port["program_prior"], {"program_prior": interop.program_prior_from_jax(
        numpy_params["program_prior"])})
    overrides = ["CHECKPOINTS.QUESTION_CODING", port["question_coding"],
                 "CHECKPOINTS.MODULE_TRAINING", port["module_training"],
                 "CHECKPOINTS.PROGRAM_PRIOR", port["program_prior"]]

    def configs(phase, objective, *extra):
        jax_config = make_fixture_config(root, phase, TIED + ["OBJECTIVE", objective, *extra])
        cfg_path = os.path.join(root, f"{phase}_{objective}.yml")
        jax_config.dump(cfg_path)
        return jax_config, Config(cfg_path, overrides), cfg_path

    n_rows, width = 40, 10
    z_rows = _z_rows(jvocab, n_rows, width, seed=5)
    # z by question: the templates, a soup and an all-pad row.
    z_table = np.concatenate([_templates(jvocab, len(PROGRAM_TEMPLATES), width),
                              z_rows[[SOUP_ROWS[0], PAD_ROWS[0]]]])
    supervision = np.zeros(n_rows, np.int64)
    for rows in SUPERVISED.values():
        supervision[list(rows)] = 1
    return dict(root=root, configs=configs, overrides=overrides, port=port, jparams=jparams,
                numpy_params=numpy_params, specs=specs, z_rows=z_rows, z_table=z_table,
                supervision=supervision, jvocab=jvocab, port_nmn_spec=port_nmn_spec)


def _qc_inputs(fx, run_dir, init, jax_configs=None):
    _, baseline, _ = fx["configs"]("question_coding", "baseline")
    _, ours, _ = fx["configs"]("question_coding", "ours")
    train_set, val_set = train.launcher_datasets("question_coding", ours, False)
    row_set = RowDataset(QuestionCodingDataset(ours.DATA.TRAIN_TOKENS), fx["supervision"])
    return dict(baseline=baseline, ours=ours, train_set=train_set, val_set=val_set,
                row_set=row_set, z_rows=fx["z_rows"], z_table=fx["z_table"], init=init,
                run_dir=run_dir)


@pytest.fixture(scope="module")
def qc(fx, tmp_path_factory):
    r"""question_coding: the JAX trainer on a 2-device mesh (OBJECTIVE
    baseline: evaluator, then three steps), the port at one rank and at
    two, from the JAX trainer's initial parameters."""
    import jax

    from probnmn_tpu.evaluators.question_coding_evaluator import (
        QuestionCodingEvaluator as JaxQuestionCodingEvaluator,
    )
    from probnmn_tpu.training.question_coding_trainer import (
        QuestionCodingTrainer as JaxQuestionCodingTrainer,
    )

    jax_config, _, _ = fx["configs"]("question_coding", "baseline")
    np.random.seed(jax_config.RANDOM_SEED)
    jax_trainer = JaxQuestionCodingTrainer(jax_config, str(tmp_path_factory.mktemp("jax_qc")),
                                           num_devices=RANKS)
    assert dict(jax_trainer.mesh.shape) == {"data": RANKS, "model": 1}
    jp = jax.tree_util.tree_map(np.asarray, jax_trainer.params)
    init = {"program_generator": interop.program_generator_from_jax(jp["program_generator"]),
            "question_reconstructor": interop.question_reconstructor_from_jax(
                jp["question_reconstructor"])}
    jax_val = JaxQuestionCodingEvaluator(jax_config, jax_trainer).evaluate(num_batches=2)
    jax_logs = []
    for iteration in range(STEPS):
        jax_logs.append(jax.tree_util.tree_map(
            float, jax_trainer._do_iteration(next(jax_trainer._batches))))
        jax_trainer._iteration = iteration
    jax_params = jax.tree_util.tree_map(np.asarray, jax_trainer.params)
    jax_params = _flat({"program_generator": interop.program_generator_from_jax(
        jax_params["program_generator"]), "question_reconstructor":
        interop.question_reconstructor_from_jax(jax_params["question_reconstructor"])})

    f = _qc_inputs(fx, str(tmp_path_factory.mktemp("qc_runs")), init)
    one = _qc_runs(None, f)
    ranks = _launch(_qc_rank, str(tmp_path_factory.mktemp("qc_ranks")), f)
    return dict(f=f, jax_val=jax_val, jax_logs=jax_logs, jax_params=jax_params, one=one,
                ranks=ranks, lr=f["ours"].OPTIM.LR_INITIAL)


@pytest.fixture(scope="module")
def jt(fx, tmp_path_factory):
    r"""joint_training: JAX's evaluator on a 2-device mesh; the port at one
    rank and at two from the same checkpoints, the features of the train
    split in shared memory."""
    from probnmn_tpu.evaluators.joint_training_evaluator import (
        JointTrainingEvaluator as JaxJointTrainingEvaluator,
    )
    from probnmn_tpu.training import joint_training_trainer as jax_jt_module

    jax_config, ours, _ = fx["configs"]("joint_training", "ours")
    _, baseline, _ = fx["configs"]("joint_training", "baseline")
    np.random.seed(jax_config.RANDOM_SEED)
    jax_trainer = jax_jt_module.JointTrainingTrainer(
        jax_config, str(tmp_path_factory.mktemp("jax_jt")), num_devices=RANKS)
    assert dict(jax_trainer.mesh.shape) == {"data": RANKS, "model": 1}
    jax_val = JaxJointTrainingEvaluator(jax_config, jax_trainer).evaluate(num_batches=2)

    train_set, val_set = train.launcher_datasets("joint_training", ours, False)
    row_set = RowDataset(JointTrainingDataset(ours.DATA.TRAIN_TOKENS, ours.DATA.TRAIN_FEATURES),
                         fx["supervision"])
    f = dict(ours=ours, baseline=baseline, train_set=train_set, val_set=val_set, row_set=row_set,
             z_rows=fx["z_rows"], z_table=fx["z_table"],
             run_dir=str(tmp_path_factory.mktemp("jt_runs")))
    one = _jt_runs(None, f)
    ranks = _launch(_jt_rank, str(tmp_path_factory.mktemp("jt_ranks")), f)
    return dict(f=f, jax_config=jax_config, jax_val=jax_val, one=one, ranks=ranks,
                lr=ours.OPTIM.LR_INITIAL)


def _parity(got, want, grads, lr, atol=PARAM_ATOL, share=0.5):
    r"""ROADMAP.md's trainer-parity rule: within ``atol`` where every step's
    |g| exceeds the floor, elsewhere within 2 lr a step; the first part must
    cover ``share`` of the parameters."""
    assert sorted(got) == sorted(want)
    compared = total = 0
    for key, w in want.items():
        smooth = np.min([np.abs(g[key]) for g in grads], axis=0) > GRAD_FLOOR
        np.testing.assert_allclose(got[key][smooth], w[smooth], atol=atol, rtol=0, err_msg=key)
        np.testing.assert_allclose(got[key], w, atol=2 * lr * len(grads), rtol=0, err_msg=key)
        compared += int(smooth.sum())
        total += w.size
    assert compared > share * total


def _logs_close(got, want, atol=LOSS_ATOL, rtol=0.0):
    assert sorted(got) == sorted(want)
    for group, values in want.items():
        assert sorted(got[group]) == sorted(values), group
        for key, value in values.items():
            np.testing.assert_allclose(got[group][key], value, atol=atol, rtol=rtol,
                                       err_msg=f"{group}/{key}")


def _grads_close(got, want, tol=1e-5):
    r"""The ranks' summed gradient against one rank's, leaf by leaf, within
    ``tol`` * max(1, max|g|)."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=tol * max(1.0, float(np.abs(w).max())),
                                   rtol=0, err_msg=key)


def _ranks_equal(ranks, key="params"):
    r"""Every rank holds the same parameters, bit for bit."""
    for name, value in ranks[0][key].items():
        np.testing.assert_array_equal(ranks[1][key][name], value, err_msg=name)


def _summed(trees):
    if isinstance(trees[0], dict):
        return {k: _summed([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_summed([t[i] for t in trees]) for i in range(len(trees[0]))]
    return sum(trees)


# ------------------------------------------------------------------ (1) data, metrics --
@pytest.mark.parametrize("world", [2, 4])
def test_sorted_batches_over_ranks_carry_the_global_count(fx, world):
    path = fx["configs"]("question_coding", "ours")[1].DATA.TRAIN_TOKENS
    dataset = RowDataset(QuestionCodingDataset(path), fx["supervision"])
    from probnmn_tpu_torch.data.samplers import SupervisionWeightedRandomSampler

    def iterator(**shard):
        return iter(BatchIterator(dataset, SupervisionWeightedRandomSampler(
            fx["supervision"], seed=3), 8, device="cpu", sort_descending_by="supervision",
            **shard))

    whole = iterator()
    ranks = [iterator(rank=r, world_size=world) for r in range(world)]
    for _ in range(7):  # crosses an epoch boundary
        want = next(whole)
        parts = [next(it) for it in ranks]
        assert GLOBAL_COUNT_KEY not in want
        for part in parts:
            sup = part["supervision"].numpy()
            assert len(sup) == 8 // world and (np.diff(sup) <= 0).all()
            assert part[COUNT_KEY] == int(sup.sum())
            assert part[GLOBAL_COUNT_KEY] == want[COUNT_KEY]
        rows = np.concatenate([p["row"].numpy() for p in parts])
        assert sorted(rows) == sorted(want["row"].numpy())
    # A transform that changes the sort key over ranks cannot keep the count.
    flip = lambda batch: dict(batch, supervision=1 - batch["supervision"])  # noqa: E731
    bad = iter(BatchIterator(dataset, InOrder(np.arange(16)), 8, device="cpu",
                             sort_descending_by="supervision", transform=flip, rank=0,
                             world_size=world))
    with pytest.raises(ValueError, match="transform changed 'supervision'"):
        next(bad)


def _metric_cases():
    rs = np.random.RandomState(7)
    pred = rs.randint(0, 6, (12, 7))
    gold = np.where(rs.rand(12, 7) < 0.5, pred, rs.randint(0, 6, (12, 7)))
    mask = (gold != 0).astype(np.int64)
    return {
        "bleu": (metrics.BleuScore, (pred, gold)),
        "sequence_accuracy": (metrics.SequenceAccuracy, (pred[:, None], gold, mask)),
        "unigram_recall": (metrics.UnigramRecall, (pred[:, None], gold, mask)),
        "boolean_accuracy": (metrics.BooleanAccuracy, (pred[:, 0], gold[:, 0])),
        "average": (metrics.Average, (float(pred.mean()),)),
    }


@pytest.mark.parametrize("name", sorted(_metric_cases()))
def test_metric_counters_summed_over_halves_give_the_whole(name):
    cls, args = _metric_cases()[name]
    whole, halves, restored = cls(), [cls(), cls()], cls()
    if name == "average":  # per-batch means of equal shards
        for value in (1.5, 2.5, 4.0, 0.5):
            whole((value + value + 1.0) / 2)
        for half, shift in zip(halves, (0.0, 1.0)):
            for value in (1.5, 2.5, 4.0, 0.5):
                half(value + shift)
        sums = [a + b for a, b in zip(halves[0].counters(), halves[1].counters())]
        restored.restore(sums)
        # The ranks' counters sum to n per-batch means over 2n batches.
        assert restored.get_metric() == pytest.approx(whole.get_metric(), abs=1e-12)
        return
    whole(*args)
    for half, part in zip(halves, (slice(0, 5), slice(5, None))):
        half(*[a[part] for a in args])
    sums = [a + b for a, b in zip(halves[0].counters(), halves[1].counters())]
    restored.restore(sums)
    assert restored.counters() == pytest.approx(whole.counters(), abs=1e-12)
    assert restored.get_metric() == pytest.approx(whole.get_metric(), abs=1e-12)


# ------------------------------------------------------------------ (2) question_coding
def test_qc_ranks_hold_the_launchers_supervision_subset(qc, fx):
    r"""The launcher drew the subset once, from ``RANDOM_SEED``, as one
    process draws it, and every rank holds it."""
    config = qc["f"]["ours"]
    np.random.seed(config.RANDOM_SEED)
    want = QuestionCodingDataset(config.DATA.TRAIN_TOKENS, num_supervision=config.SUPERVISION,
                                 supervision_question_max_length=
                                 config.SUPERVISION_QUESTION_MAX_LENGTH).get_supervision_list()
    assert want.sum() == config.SUPERVISION
    for rank in qc["ranks"]:
        np.testing.assert_array_equal(rank["supervision"], want)
    np.testing.assert_array_equal(qc["one"]["supervision"], want)


def test_qc_baseline_steps_at_two_ranks_match_the_jax_mesh(qc):
    rank0, rank1 = qc["ranks"]
    for got, want in zip(rank0["baseline_steps"]["logs"], qc["jax_logs"]):
        _logs_close(got, want)
    assert rank1["baseline_steps"]["logs"] == rank0["baseline_steps"]["logs"]
    _parity(rank0["baseline_steps"]["params"], qc["jax_params"], rank0["baseline_steps"]["grads"],
            qc["lr"])


def test_qc_baseline_steps_at_two_ranks_match_one_rank(qc):
    rank0, rank1 = qc["ranks"]
    got, want = rank0["baseline_steps"], qc["one"]["baseline_steps"]
    for g, w in zip(got["logs"], want["logs"]):
        _logs_close(g, w, rtol=2e-4)
    _parity(got["params"], want["params"], got["grads"], qc["lr"])
    _ranks_equal([r["baseline_steps"] for r in qc["ranks"]])
    # Rank 0 alone writes scalars.
    assert [tag for tag, _, _ in rank0["baseline_scalars"]] == [
        "train/loss/question_reconstruction_gt", "train/loss/program_generation_gt"] * STEPS
    assert rank1["baseline_scalars"] == []


def _jax_qc_objective(fx, qc, kind):
    r"""The JAX composition over the whole handed-in batch ``kind``."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_port_question_coding import _jax_objective, _jax_specs

    f = qc["f"]
    trainer = QuestionCodingTrainer(f["ours"], str(fx["root"]), device="cpu",
                                    writer=RecordingWriter(), dataset=f["train_set"])
    batch = f["row_set"].get_batch(np.arange(OBJECTIVE_BATCH) + (
        0 if kind == "unequal" else OBJECTIVE_BATCH))
    z_full = np.where(batch["supervision"][:, None] == 1, 0, fx["z_rows"][batch["row"]])
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree_numpy(f["init"]))
    return _jax_objective(jparams, *_jax_specs(trainer), fx["jparams"]["program_prior"],
                          fx["specs"]["program_prior"], batch, z_full, jnp.float32(0.25),
                          f["ours"])


@pytest.mark.parametrize("kind", sorted(SUPERVISED))
def test_qc_objective_at_two_ranks_matches_the_jax_composition(qc, fx, kind):
    from tests.test_torch_port_question_coding import _assert_trees_close

    (want_total, (want_baseline, want_logs)), want_grads = _jax_qc_objective(fx, qc, kind)
    parts = [rank["objective"][kind] for rank in qc["ranks"]]
    sup_rows = [sum(int(r in SUPERVISED[kind]) for r in part["rows"]) for part in parts]
    assert [p["n_sup"] for p in parts] == sup_rows
    assert all(p["n_sup_global"] == len(SUPERVISED[kind]) for p in parts)
    if kind == "split":
        assert sup_rows == [8, 0]
    else:
        assert sup_rows == [5, 2]
    # The ranks' totals are shares of the global total; the baseline and
    # the logs are the global batch's on both ranks.
    np.testing.assert_allclose(sum(p["total"] for p in parts), float(want_total), atol=1e-4,
                               rtol=1e-6)
    assert parts[0]["baseline"] == parts[1]["baseline"]
    np.testing.assert_allclose(parts[0]["baseline"], float(want_baseline), atol=1e-5)
    assert parts[0]["baseline"] != 0.25
    assert parts[0]["logs"] == parts[1]["logs"]
    _logs_close(parts[0]["logs"], jax_tree_floats(want_logs))
    _assert_trees_close(_summed([p["grads"] for p in parts]), want_grads, 1e-5, scale=True)
    # One process on the whole batch gives the same.
    one = qc["one"]["objective"][kind]
    np.testing.assert_allclose(one["total"], float(want_total), atol=1e-4, rtol=1e-6)
    _logs_close(one["logs"], parts[0]["logs"])


def jax_tree_floats(tree):
    return {group: {k: float(v) for k, v in values.items()} for group, values in tree.items()}


def test_qc_mean_of_the_ranks_means_is_not_the_global_mean(qc):
    r"""With 5 and 2 supervised rows, averaging the ranks' own means misses
    the global mean that both ranks log: the test tells the two apart."""
    parts = [rank["objective"]["unequal"] for rank in qc["ranks"]]
    rows = np.concatenate([p["pg_sup_rows"] for p in parts])
    assert [len(p["pg_sup_rows"]) for p in parts] == [5, 2]
    logged = parts[0]["logs"]["loss"]["program_generation_gt"]
    np.testing.assert_allclose(logged, rows.mean(), atol=LOSS_ATOL, rtol=0)
    mean_of_means = np.mean([p["pg_sup_rows"].mean() for p in parts])
    assert abs(mean_of_means - logged) > 10 * LOSS_ATOL


def test_qc_ours_steps_at_two_ranks_match_one_rank(qc):
    got, want = qc["ranks"][0]["ours_steps"], qc["one"]["ours_steps"]
    for g, w in zip(got["logs"], want["logs"]):
        _logs_close(g, w, rtol=2e-4)
        assert sorted(g) == ["elbo", "loss"]
    assert qc["ranks"][1]["ours_steps"]["baselines"] == got["baselines"]  # bit for bit
    np.testing.assert_allclose(got["baselines"], want["baselines"], atol=1e-5, rtol=0)
    assert got["baselines"][-1] != 0.0
    _grads_close(got["grads"][0], want["grads"][0])
    _parity(got["params"], want["params"], got["grads"], qc["lr"])
    _ranks_equal([r["ours_steps"] for r in qc["ranks"]])


def test_qc_step_with_one_rank_all_supervised_matches_one_rank(qc):
    r"""Rank 0's block holds only supervised rows, rank 1's only
    unsupervised ones: rank 0 runs no K1, REINFORCE or prior pass and still
    joins both all-reduces; the step matches one rank."""
    got, want = qc["ranks"][0]["split_step"], qc["one"]["split_step"]
    _logs_close(got["logs"], want["logs"], rtol=2e-4)
    assert got["baseline"] == qc["ranks"][1]["split_step"]["baseline"]
    np.testing.assert_allclose(got["baseline"], want["baseline"], atol=1e-5, rtol=0)
    _grads_close(got["grads"], want["grads"])
    _parity(got["params"], want["params"], [got["grads"]], qc["lr"])
    _ranks_equal([r["split_step"] for r in qc["ranks"]])


def test_qc_evaluator_at_two_ranks(qc):
    for rank in qc["ranks"]:
        got = rank["val"]
        assert sorted(got) == sorted(qc["jax_val"])
        for model, values in qc["jax_val"].items():
            assert sorted(got[model]) == sorted(values) == [
                "BLEU", "perplexity", "sequence_accuracy", "word_error_rate"]
            for key, value in values.items():
                np.testing.assert_allclose(got[model][key], value, rtol=1e-5, atol=1e-7,
                                           err_msg=f"{model}/{key}")
                np.testing.assert_allclose(got[model][key], qc["one"]["val"][model][key],
                                           rtol=1e-5, atol=1e-7, err_msg=f"{model}/{key}")


# ------------------------------------------------------------------ (3) joint_training -
@pytest.mark.parametrize("objective", ["ours", "baseline"])
def test_jt_objective_at_two_ranks_matches_the_jax_composition(jt, fx, objective):
    r"""On the "unequal" batch (5 and 2 supervised rows)."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_port_joint_training import (
        _jax_objective,
        _port_as_jax_layout,
    )
    from tests.test_torch_port_module_training import BANK_TOL

    jax_config, config, _ = fx["configs"]("joint_training", objective)
    trainer = JointTrainingTrainer(config, str(fx["root"]), device="cpu",
                                   writer=RecordingWriter(), dataset=jt["f"]["train_set"])
    batch = jt["f"]["row_set"].get_batch(np.arange(OBJECTIVE_BATCH))
    z_full = np.where(batch["supervision"][:, None] == 1, 0, fx["z_rows"][batch["row"]])
    jparams = jax.tree_util.tree_map(jnp.asarray, _port_as_jax_layout(trainer.params))
    spec = fx["specs"]
    prior = {"prior": fx["jparams"]["program_prior"], "prior_spec": spec["program_prior"]}
    pg_spec, qr_spec = spec["program_generator"], spec["question_reconstructor"]
    (want_total, (want_baseline, want_logs)), want_grads = _jax_objective(
        jparams, pg_spec, qr_spec, spec["nmn"], prior, batch, z_full, jnp.float32(0.25),
        jax_config)

    parts = [rank["objective"][objective] for rank in jt["ranks"]]
    assert all(p["n_sup_global"] == len(SUPERVISED["unequal"]) for p in parts)
    np.testing.assert_allclose(sum(p["total"] for p in parts), float(want_total), atol=1e-5,
                               rtol=1e-5)
    assert parts[0]["baseline"] == parts[1]["baseline"]
    np.testing.assert_allclose(parts[0]["baseline"], float(want_baseline), atol=1e-6, rtol=0)
    assert parts[0]["logs"] == parts[1]["logs"]
    _logs_close(parts[0]["logs"], jax_tree_floats(want_logs), rtol=1e-5)
    one = jt["one"]["objective"][objective]
    _logs_close(one["logs"], parts[0]["logs"], rtol=1e-5)
    grads = _port_as_jax_layout(_summed([p["grads"] for p in parts]))
    for name in ("program_generator", "question_reconstructor"):
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_grads[name])[0],
                                jax.tree_util.tree_leaves(grads[name])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                       rtol=0, err_msg=f"{name}{jax.tree_util.keystr(path)}")
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_grads["nmn"])[0],
                            jax.tree_util.tree_leaves(grads["nmn"])):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"nmn{jax.tree_util.keystr(path)}",
                                   **BANK_TOL)
    assert np.abs(grads["nmn"]["relate"]["conv1"]["w"]).max() > 0


def test_jt_ours_steps_at_two_ranks_match_one_rank(jt):
    got, want = jt["ranks"][0]["ours_steps"], jt["one"]["ours_steps"]
    for g, w in zip(got["logs"], want["logs"]):
        _logs_close(g, w, rtol=2e-4)
    assert jt["ranks"][1]["ours_steps"]["logs"] == got["logs"]
    assert jt["ranks"][1]["ours_steps"]["baselines"] == got["baselines"]  # bit for bit
    np.testing.assert_allclose(got["baselines"], want["baselines"], atol=1e-5, rtol=0)
    assert got["baselines"][-1] != 0.0
    _grads_close(got["grads"][0], want["grads"][0])
    # As test_torch_port_joint_training.py: after one step within 1e-6
    # wherever |g| clears the float32 noise of the NMN's plateau, after
    # three every parameter within 2 lr a step (ROADMAP.md section 3).
    lr, compared, total = jt["lr"], 0, 0
    for key, w in want["first"].items():
        smooth = np.abs(got["grads"][0][key]) > GRAD_FLOOR
        np.testing.assert_allclose(got["first"][key][smooth], w[smooth], atol=1e-6, rtol=0,
                                   err_msg=key)
        np.testing.assert_allclose(got["params"][key], want["params"][key],
                                   atol=2 * lr * STEPS, rtol=0, err_msg=key)
        compared += int(smooth.sum())
        total += w.size
    assert compared > 0.4 * total
    _ranks_equal([r["ours_steps"] for r in jt["ranks"]])


def test_jt_step_with_one_rank_all_supervised_matches_one_rank(jt):
    got, want = jt["ranks"][0]["split_step"], jt["one"]["split_step"]
    _logs_close(got["logs"], want["logs"], rtol=2e-4)
    assert got["baseline"] == jt["ranks"][1]["split_step"]["baseline"]
    np.testing.assert_allclose(got["baseline"], want["baseline"], atol=1e-5, rtol=0)
    _grads_close(got["grads"], want["grads"])
    for key, w in want["params"].items():
        smooth = np.abs(got["grads"][key]) > GRAD_FLOOR
        np.testing.assert_allclose(got["params"][key][smooth], w[smooth], atol=1e-6, rtol=0,
                                   err_msg=key)
        np.testing.assert_allclose(got["params"][key], w, atol=2 * jt["lr"], rtol=0,
                                   err_msg=key)
    _ranks_equal([r["split_step"] for r in jt["ranks"]])


def test_jt_evaluator_at_two_ranks(jt):
    for rank in jt["ranks"]:
        got = rank["val"]
        assert sorted(got) == sorted(jt["jax_val"]) == ["nmn", "program_generator",
                                                        "question_reconstructor"]
        for key, value in jt["jax_val"]["program_generator"].items():
            np.testing.assert_allclose(got["program_generator"][key], value, rtol=1e-5,
                                       atol=1e-7, err_msg=key)
        for key, value in jt["jax_val"]["nmn"].items():
            assert got["nmn"][key] == pytest.approx(value, abs=1e-12), key
            assert got["nmn"][key] == pytest.approx(jt["one"]["val"]["nmn"][key], abs=1e-12)
    assert jt["ranks"][0]["shared"] and jt["ranks"][1]["shared"]


# ------------------------------------------------------------------ (4) the CLIs -------
@pytest.mark.parametrize("phase", ["question_coding", "joint_training"])
def test_train_cli_at_two_ranks_writes_one_checkpoint_with_the_baseline(fx, tmp_path, phase):
    _, config, path = fx["configs"](phase, "ours")
    out = str(tmp_path / "two")
    train.main(train.parser.parse_args([
        "--phase", phase, "--config-yml", path, "--config-override", "OPTIM.NUM_ITERATIONS", "4",
        *fx["overrides"], "--device", "cpu", "--serialization-dir", out,
        "--checkpoint-every", "4", "--num-val-batches", "1", "--num-devices", "2"]))
    files = sorted(os.listdir(out))
    assert [f for f in files if f.endswith(".ckpt")] == ["checkpoint_3.ckpt",
                                                         "checkpoint_best.ckpt"]
    assert len([f for f in files if f.startswith("events.")]) == 1  # rank 0's scalars alone
    checkpoint = os.path.join(out, "checkpoint_3.ckpt")
    saved = load_objects(checkpoint, {"reinforce_baseline": None})[0]["reinforce_baseline"]
    assert float(saved) != 0.0 and np.isfinite(float(saved))
    cls = QuestionCodingTrainer if phase == "question_coding" else JointTrainingTrainer
    np.random.seed(config.RANDOM_SEED)
    resumed = cls(config, str(tmp_path / "resumed"), device="cpu", writer=RecordingWriter())
    resumed.load_checkpoint(checkpoint)
    assert resumed.iteration == 3 and float(resumed.baseline) == float(saved)
    logs = resumed.step()
    assert resumed.iteration == 4
    assert all(np.isfinite(v) for group in logs.values() for v in group.values())


@pytest.fixture(scope="module")
def checkpoints(fx, tmp_path_factory):
    r"""A question_coding and a module_training checkpoint of the port,
    each from two steps of the one-rank CLI."""
    from tests.clevr_fixtures import make_fixture_config

    out = {}
    for phase in ("question_coding", "module_training"):
        if phase == "question_coding":
            path = fx["configs"](phase, "ours")[2]
            extra = ["CHECKPOINTS.PROGRAM_PRIOR", fx["port"]["program_prior"]]
        else:
            path = os.path.join(fx["root"], "module_training.yml")
            make_fixture_config(fx["root"], phase, TIED).dump(path)
            extra = ["CHECKPOINTS.QUESTION_CODING", fx["port"]["question_coding"]]
        run = str(tmp_path_factory.mktemp(phase))
        train.main(train.parser.parse_args([
            "--phase", phase, "--config-yml", path, "--config-override",
            "OPTIM.NUM_ITERATIONS", "2", *extra, "--device", "cpu", "--serialization-dir", run,
            "--checkpoint-every", "2", "--num-val-batches", "1"]))
        out[phase] = (path, extra, os.path.join(run, "checkpoint_best.ckpt"), run)
    return out


@pytest.mark.parametrize("phase", ["question_coding", "module_training"])
def test_evaluate_cli_at_two_ranks_matches_one_rank(checkpoints, phase):
    path, extra, checkpoint, run = checkpoints[phase]
    before = sorted(os.listdir(run))
    argv = ["--phase", phase, "--config-yml", path, "--config-override", *extra,
            "--checkpoint-path", checkpoint, "--device", "cpu"]
    want = evaluate.main(evaluate.parser.parse_args(argv))
    got = evaluate.main(evaluate.parser.parse_args(argv + ["--num-devices", "2"]))
    assert sorted(os.listdir(run)) == before  # evaluating writes nothing
    assert sorted(got) == sorted(want)
    for model, values in want.items():
        assert sorted(got[model]) == sorted(values)
        for key, value in values.items():
            assert np.isfinite(value)
            np.testing.assert_allclose(got[model][key], value, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{model}/{key}")
