"""The model axis of the port's mesh (``probnmn_tpu_torch/parallel/mesh.py``,
piece (e)) on the CPU: four gloo ranks laid out as a (data 2 x model 2)
grid, each a spawned process, against the JAX package's trainers at
``num_devices=4, model_parallel=2`` (conftest's 8 CPU devices) and against
the port at the same data count without the model axis.

- (a) ``auto_world(num, B, 8, M)`` is ``auto_mesh(num, B, M)``'s shape.
- (b) ``model_shard_spec`` is the spec of JAX ``shard_params`` leaf by leaf
  for the NMN (CLEVR's banks of 15 / 6 / 4 / 4 / 7: split and fall-back
  leaves), generator, reconstructor and prior at M = 2 and 4.
- (c) module_training (programs handed in, token soups and an all-pad row
  in each data shard) and joint_training (OBJECTIVE ours, z a function of
  the row's question; soups and all-pad z among each data shard's
  unsupervised rows), three steps at 2 x 2 ranks against the JAX trainers:
  the logged values and the baseline within 2e-4 relative, the parameters
  by ROADMAP.md's trainer-parity rule, the evaluators' metrics.
- (d) program_prior and question_coding (OBJECTIVE ours, K1's own draws) at
  2 x 2 equal the port at 2 x 1.
- (e) Every rank's replicated leaves bit for bit equal, its split leaves
  and their Adam moments of the slice's shape, the gathered leaves equal
  on every rank, one all-gather a step; K1's draws equal within a model
  group and different across data groups.
- (f) Checkpoints with Adam state both ways between the port at 2 x 2, the
  port in one process and the JAX trainer at ``model_parallel=2``.
- (g) ``train --device cpu --num-devices 4 --model-parallel 2`` for
  module_training and joint_training, and ``--model-parallel 3`` over 4
  devices falling back to 1.

Rank-side code is this file's top-level functions and imports no JAX (the
spawned ranks import this module); JAX is imported inside the fixtures and
tests.
"""
import logging
import os

import numpy as np
import pytest
import torch

from probnmn_tpu_torch import interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import ModuleTrainingDataset
from probnmn_tpu_torch.evaluators.joint_training_evaluator import JointTrainingEvaluator
from probnmn_tpu_torch.evaluators.module_training_evaluator import ModuleTrainingEvaluator
from probnmn_tpu_torch.parallel import mesh
from probnmn_tpu_torch.training._trainer import tree_leaves, tree_like
from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer
from probnmn_tpu_torch.training.module_training_trainer import ModuleTrainingTrainer
from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer
from probnmn_tpu_torch.utils.checkpointing import save_objects
from probnmn_tpu_torch.utils.observability import RecordingWriter

STEPS = 3
DATA, MODEL = 2, 2
RANKS = DATA * MODEL
BATCH = 16
LAUNCH_TIMEOUT = 150.0
LOG_RTOL = 2e-4
GRAD_FLOOR = 1e-5
# JAX's fused_tf_loss, which scores the handed-in z in the JAX trainer, ties
# the seq2seq hidden size to the input size.
TIED = ["PROGRAM_GENERATOR.HIDDEN_SIZE", 16, "QUESTION_RECONSTRUCTOR.HIDDEN_SIZE", 16]
# module_training's handed-in programs: token soups and the all-pad row in
# both data shards' rows (0-7 and 8-15).
SOUP_ROWS = (2, 5, 10, 13)
PAD_ROWS = (6, 9)


def _flat(tree, prefix=""):
    r"""{key path: numpy array} of a nested dict/list of tensors or arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy().copy()}
    return {prefix: np.asarray(tree)}


def z_of_questions(questions, table):
    r"""A program a row, a function of the row's question alone (torch or numpy)."""
    q = np.asarray(questions)
    keys = (q * np.arange(1, q.shape[1] + 1)).sum(1) % len(table)
    return table[keys]


# ------------------------------------------------------------------ rank-side ----------
def _run_dir(f, name, parallel):
    return os.path.join(f["run_dir"], f"{name}_{parallel.rank if parallel else 'one'}")


def _full_grads(parallel, trainer):
    r"""The full gradient of every leaf, the split leaves' rows gathered
    from the model group (the grads are the ranks' reduced ones)."""
    full = trainer.full_params()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in tree_leaves(trainer.params)]
    if parallel is None or parallel.model_size == 1:
        return _flat(tree_like(trainer.params, grads))
    split = mesh.split_leaves(full, parallel.model_size)
    gathered = iter(parallel.gather_rows([g for g, s in zip(grads, split) if s],
                                         [tuple(t.shape) for t, s in
                                          zip(tree_leaves(full), split) if s]))
    return _flat(tree_like(full, [next(gathered) if s else g for g, s in zip(grads, split)]))


def _steps(parallel, trainer, record_baseline=False):
    r"""``STEPS`` steps: the logs, the all-gathers each step ran, the full
    gradients and parameters after the first step and at the end (and the
    baseline after each step)."""
    logs, gathers, grads, baselines, first = [], [], [], [], None
    for iteration in range(STEPS):
        before = parallel.gathers
        logs.append(trainer.step(iteration))
        gathers.append(parallel.gathers - before)
        grads.append(_full_grads(parallel, trainer))
        if record_baseline:
            baselines.append(float(trainer.baseline))
        if iteration == 0:
            first = _flat(trainer.full_params())
    return dict(logs=logs, gathers=gathers, grads=grads, first=first, baselines=baselines,
                params=_flat(trainer.full_params()))


def _layout(parallel, trainer):
    r"""What a rank keeps: its stored leaves, their Adam moments' shapes,
    the full leaves gathered and its bytes."""
    state = trainer._optimizer.state_dict()["state"]
    moments = {key: [tuple(state[i][key].shape) for i in range(len(tree_leaves(trainer.params)))]
               for key in ("exp_avg", "exp_avg_sq")}
    return dict(stored=_flat(trainer.params), moments=moments,
                split=mesh.split_leaves(trainer.full_params(), parallel.model_size),
                resident=trainer.resident_bytes(),
                full=_flat(trainer.full_params()))


def _mt_trainer(parallel, f, name):
    trainer = ModuleTrainingTrainer(f["mt"], _run_dir(f, name, parallel), device="cpu",
                                    writer=RecordingWriter(), dataset=f["mt_train"],
                                    parallel=parallel)
    rows = BATCH // trainer.data_size
    lo = (parallel.data_rank if parallel else 0) * rows
    mine = torch.from_numpy(f["programs"][lo:lo + rows])
    trainer.sample_programs = lambda questions: mine
    return trainer


def _resumed(parallel, f, name, path):
    r"""A fresh module_training trainer resumed from ``path``: its stored
    leaves and Adam moments (this rank's rows), step and iteration."""
    trainer = _mt_trainer(parallel, f, name)
    trainer.load_checkpoint(path)
    stored = _flat(trainer.params)
    state = trainer._optimizer.state_dict()["state"]
    return dict(stored=stored, iteration=trainer.iteration,
                mu=dict(zip(stored, (state[i]["exp_avg"].float().numpy() for i in sorted(state)))),
                steps=sorted({float(state[i]["step"]) for i in state}))


def _grid_rank(parallel, f):
    r"""module_training and joint_training at (data 2 x model 2): evaluator,
    steps, layout, K1's draws, checkpoints written and read."""
    out = {}
    # module_training: the evaluator and STEPS steps from the JAX trainer's init.
    trainer = _mt_trainer(parallel, f, "mt")
    sampler = ModuleTrainingTrainer.sample_programs
    trainer.set_params({"nmn": f["mt_init"]})
    val = ModuleTrainingEvaluator(f["mt"], trainer, dataset=f["mt_val"]).evaluate(num_batches=2)
    mt = _steps(parallel, trainer)
    mt.update(val=val, layout=_layout(parallel, trainer))
    # K1 on the same questions on every rank, from the rank's own generator.
    mt["k1"] = sampler(trainer, torch.from_numpy(f["questions"])).numpy()
    # Checkpoints: the port's (rank 0 writes full leaves and moments) and the
    # JAX package's .ckpt; then resumes from the JAX trainer's and from one
    # process's.
    trainer.after_validation({"nmn": {"answer_accuracy": 0.5}}, STEPS - 1)
    trainer.save_checkpoint_jax(os.path.join(f["run_dir"], "mt_grid_jax.ckpt"))
    full, optimizer = trainer.full_state()
    if parallel.is_writer:
        full = _flat(full)
        mt["written"] = dict(params=full, mu=dict(zip(full, (
            optimizer["state"][i]["exp_avg"].numpy() for i in sorted(optimizer["state"])))))
    mt["resumed"] = {name: _resumed(parallel, f, f"mt_resume_{name}", path)
                     for name, path in f["mt_resume"].items()}
    out["mt"] = mt

    # joint_training (OBJECTIVE ours): z by question.
    trainer = JointTrainingTrainer(f["jt"], _run_dir(f, "jt", parallel), device="cpu",
                                   writer=RecordingWriter(), dataset=f["jt_train"],
                                   parallel=parallel)
    table = torch.from_numpy(f["z_table"])
    z_rows = []

    def z_by_question(questions, dropout_masks=None):
        z = z_of_questions(questions.numpy(), table.numpy())
        z_rows.append(z)
        return torch.from_numpy(z)

    trainer.sample_programs = z_by_question
    val = JointTrainingEvaluator(f["jt"], trainer, dataset=f["jt_val"]).evaluate(num_batches=2)
    jt = _steps(parallel, trainer, record_baseline=True)
    jt.update(val=val, layout=_layout(parallel, trainer), z=z_rows)
    out["jt"] = jt
    return out


def _pp_qc_rank(parallel, f):
    r"""program_prior and question_coding (OBJECTIVE ours, K1's own draws):
    STEPS steps each from the same parameters, and what a rank keeps."""
    out = {}
    trainer = ProgramPriorTrainer(f["pp"], _run_dir(f, "pp", parallel), device="cpu",
                                  writer=RecordingWriter(), parallel=parallel)
    trainer.set_params({"program_prior": f["pp_init"]})
    out["pp"] = _steps(parallel, trainer)
    out["pp"]["resident"] = trainer.resident_bytes()
    trainer = QuestionCodingTrainer(f["qc"], _run_dir(f, "qc", parallel), device="cpu",
                                    writer=RecordingWriter(), dataset=f["qc_train"],
                                    parallel=parallel)
    trainer.set_params(f["qc_init"])
    out["qc"] = _steps(parallel, trainer, record_baseline=True)
    return out


def _launch(fn, run_dir, ranks, model_parallel, *args):
    return mesh.launch(fn, ranks, "cpu", run_dir, args=args, timeout=LAUNCH_TIMEOUT,
                       collective_timeout=LAUNCH_TIMEOUT, model_parallel=model_parallel)


# ------------------------------------------------------------------ fixtures -----------
def _programs(vocab, n_rows, width):
    from tests.clevr_fixtures import PROGRAM_TEMPLATES

    z = np.zeros((n_rows, width), np.int64)
    for i in range(n_rows):
        ids = [vocab.get_token_index(t, "programs")
               for t in PROGRAM_TEMPLATES[i % len(PROGRAM_TEMPLATES)]]
        z[i, :len(ids)] = ids
    return z


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    r"""Fixture data; the generator, reconstructor, NMN and prior saved as
    the JAX package's checkpoints and as the port's; the four phases'
    configs at batch 16; the handed-in programs and the z table."""
    import jax

    from probnmn_tpu.models import nmn as jnmn
    from probnmn_tpu.models import program_generator as jprogram_generator
    from probnmn_tpu.models import question_reconstructor as jquestion_reconstructor
    from probnmn_tpu.models.program_prior import init_program_prior_params
    from probnmn_tpu.training.program_prior_trainer import make_prior_spec as jax_make_prior_spec
    from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
    from tests.clevr_fixtures import build_fixture_data, make_fixture_config

    root = str(tmp_path_factory.mktemp("mesh_model"))
    jvocab = build_fixture_data(root, n_val=2 * BATCH)
    sizes = TIED + ["OPTIM.BATCH_SIZE", BATCH]
    base = make_fixture_config(root, "joint_training", sizes)
    specs = {"program_generator": jprogram_generator.make_spec(jvocab, base),
             "question_reconstructor": jquestion_reconstructor.make_spec(jvocab, base),
             "nmn": jnmn.make_spec(jvocab, base), "program_prior": jax_make_prior_spec(base, jvocab)}
    keys = jax.random.split(jax.random.PRNGKey(24), 4)
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

    def configs(phase, *extra):
        jax_config = make_fixture_config(root, phase, sizes + list(extra))
        cfg_path = os.path.join(root, f"{phase}.yml")
        jax_config.dump(cfg_path)
        return jax_config, Config(cfg_path, overrides), cfg_path

    programs = _programs(jvocab, BATCH, 10)
    rs = np.random.RandomState(5)
    for i in SOUP_ROWS:
        programs[i] = rs.randint(1, jvocab.get_vocab_size("programs"), programs.shape[1])
    programs[list(PAD_ROWS)] = 0
    # z by question: two templates, a token soup and an all-pad row.
    z_table = _programs(jvocab, 2, 10)
    z_table = np.concatenate([z_table, rs.randint(1, jvocab.get_vocab_size("programs"), (1, 10)),
                              np.zeros((1, 10), np.int64)])
    return dict(root=root, configs=configs, port=port, jparams=jparams,
                numpy_params=numpy_params, specs=specs, programs=programs, z_table=z_table,
                port_nmn_spec=port_nmn_spec, jvocab=jvocab)


def _jax_adam(trainer):
    return [s for s in trainer._opt_state.inner_state if hasattr(s, "mu")][0]


@pytest.fixture(scope="module")
def grid(fx, tmp_path_factory):
    r"""The JAX module_training and joint_training trainers at
    ``num_devices=4, model_parallel=2`` (evaluator, then STEPS steps), the
    port's module_training in one process (its checkpoint after one step),
    then one launch of the port at (data 2 x model 2) running both."""
    import jax
    import jax.numpy as jnp

    from probnmn_tpu.evaluators.joint_training_evaluator import (
        JointTrainingEvaluator as JaxJointTrainingEvaluator,
    )
    from probnmn_tpu.evaluators.module_training_evaluator import (
        ModuleTrainingEvaluator as JaxModuleTrainingEvaluator,
    )
    from probnmn_tpu.ops.pallas.seq2seq_train import fused_tf_loss as jax_fused_tf_loss
    from probnmn_tpu.training import joint_training_trainer as jax_jt_module
    from probnmn_tpu.training import module_training_trainer as jax_mt_module
    from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects

    run_dir = str(tmp_path_factory.mktemp("grid_runs"))
    mt_jax_config, mt_config, _ = fx["configs"]("module_training")
    jt_jax_config, jt_config, _ = fx["configs"]("joint_training", "OBJECTIVE", "ours")
    out = {"run_dir": run_dir}

    # module_training: JAX on the (2, 2) mesh at the handed-in programs.
    fixed = jnp.asarray(fx["programs"])
    original = jax_mt_module.seq2seq_forward
    jax_mt_module.seq2seq_forward = lambda *args, **kwargs: {"predictions": fixed}
    try:
        jax_mt = jax_mt_module.ModuleTrainingTrainer(
            mt_jax_config, str(tmp_path_factory.mktemp("jax_mt")), num_devices=RANKS,
            model_parallel=MODEL)
        assert dict(jax_mt.mesh.shape) == {"data": DATA, "model": MODEL}
        jax_init = jax.tree_util.tree_map(np.asarray, jax_mt.params["nmn"])
        out["mt_jax_val"] = JaxModuleTrainingEvaluator(mt_jax_config, jax_mt).evaluate(
            num_batches=2)
        out["mt_jax_logs"], first = [], None
        for iteration in range(STEPS):
            out["mt_jax_logs"].append(jax.tree_util.tree_map(
                float, jax_mt._do_iteration(next(jax_mt._batches))))
            jax_mt._iteration = iteration
            if iteration == 0:
                first = jax.tree_util.tree_map(np.asarray, jax_mt.params["nmn"])
    finally:
        jax_mt_module.seq2seq_forward = original
    spec = fx["port_nmn_spec"]
    port_tree = lambda tree: interop.nmn_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), spec)
    out["mt_jax_first"] = _flat({"nmn": port_tree(first)})
    out["mt_jax_params"] = _flat({"nmn": port_tree(jax_mt.params["nmn"])})
    adam = _jax_adam(jax_mt)
    out["mt_jax_mu"] = _flat({"nmn": port_tree(adam.mu["nmn"])})
    out["mt_jax_count"] = int(adam.count)
    out["jax_mt"], out["mt_jax_config"] = jax_mt, mt_jax_config
    mt_jax_ckpt = os.path.join(run_dir, "mt_jax_mp2.ckpt")
    jax_save_objects(mt_jax_ckpt, jax_mt._checkpointables(), STEPS - 1)

    # The port in one process: one step, then its checkpoint.
    mt_train = ModuleTrainingDataset(mt_config.DATA.TRAIN_TOKENS, mt_config.DATA.TRAIN_FEATURES,
                                     shared_features=True)
    mt_val = ModuleTrainingDataset(mt_config.DATA.VAL_TOKENS, mt_config.DATA.VAL_FEATURES,
                                   shared_features=True)
    f = dict(mt=mt_config, mt_train=mt_train, mt_val=mt_val, programs=fx["programs"],
             run_dir=run_dir, mt_init=port_tree(jax_init))
    one = _mt_trainer(None, f, "mt_one")
    one.set_params({"nmn": f["mt_init"]})
    one.step(0)
    one.after_validation({"nmn": {"answer_accuracy": 0.5}}, 0)
    one_params = _flat(one.params)
    out["mt_one"] = dict(params=one_params, mu=dict(zip(one_params, (
        s["exp_avg"].numpy() for _, s in sorted(one._optimizer.state_dict()["state"].items())))))

    # joint_training: JAX on the (2, 2) mesh at z by question; its REINFORCE
    # pass scores that z (JAX's fused_tf_loss in REINFORCE mode, interpret).
    table = jnp.asarray(fx["z_table"])
    original = jax_jt_module.seq2seq_forward

    def sampled_by_question(params, spec, source, target=None, *args, **kwargs):
        if target is not None:
            return original(params, spec, source, target, *args, **kwargs)
        weights = jnp.arange(1, source.shape[1] + 1)
        z = table[(source * weights).sum(1) % len(fx["z_table"])]
        loss = jax_fused_tf_loss(params, spec, source, z, True, jnp.float32, 4, True)
        return {"loss": loss, "predictions": z}

    jax_jt_module.seq2seq_forward = sampled_by_question
    try:
        np.random.seed(jt_jax_config.RANDOM_SEED)
        jax_jt = jax_jt_module.JointTrainingTrainer(
            jt_jax_config, str(tmp_path_factory.mktemp("jax_jt")), num_devices=RANKS,
            model_parallel=MODEL)
        assert dict(jax_jt.mesh.shape) == {"data": DATA, "model": MODEL}
        out["jt_jax_val"] = JaxJointTrainingEvaluator(jt_jax_config, jax_jt).evaluate(
            num_batches=2)
        out["jt_jax_logs"], out["jt_jax_baselines"], first = [], [], None
        for iteration in range(STEPS):
            out["jt_jax_logs"].append(jax.tree_util.tree_map(
                float, jax_jt._do_iteration(next(jax_jt._batches))))
            jax_jt._iteration = iteration
            out["jt_jax_baselines"].append(float(jax_jt._baseline))
            if iteration == 0:
                first = jax.tree_util.tree_map(np.asarray, jax_jt.params)
    finally:
        jax_jt_module.seq2seq_forward = original
    models = ("program_generator", "question_reconstructor", "nmn")
    specs = {"program_generator": None, "question_reconstructor": None, "nmn": spec}
    as_port = lambda tree: _flat({n: interop.model_from_jax(  # noqa: E731
        n, jax.tree_util.tree_map(np.asarray, tree[n]), specs[n]) for n in models})
    out["jt_jax_first"] = as_port(first)
    out["jt_jax_params"] = as_port(jax_jt.params)

    jt_train, jt_val = train.launcher_datasets("joint_training", jt_config, False)
    f.update(jt=jt_config, jt_train=jt_train, jt_val=jt_val, z_table=fx["z_table"],
             questions=jt_val.get_batch(np.arange(BATCH))["question"],
             mt_resume={"jax": mt_jax_ckpt,
                        "one": os.path.join(run_dir, "mt_one_one", "checkpoint_0.ckpt")})
    out["f"] = f
    out["ranks"] = _launch(_grid_rank, str(tmp_path_factory.mktemp("grid_ranks")), RANKS,
                           MODEL, f)
    out["lr"] = mt_config.OPTIM.LR_INITIAL
    return out


@pytest.fixture(scope="module")
def pp_qc(fx, tmp_path_factory):
    r"""program_prior and question_coding at (data 2 x model 2) and at
    (data 2 x model 1), from the same parameters."""
    from probnmn_tpu_torch.models.program_prior import init_program_prior_params
    from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec
    from probnmn_tpu_torch.data.vocabulary import Vocabulary

    _, pp_config, _ = fx["configs"]("program_prior")
    _, qc_config, _ = fx["configs"]("question_coding", "OBJECTIVE", "ours")
    qc_train, _ = train.launcher_datasets("question_coding", qc_config, False)
    vocab = Vocabulary.from_files(pp_config.DATA.VOCABULARY)
    f = dict(pp=pp_config, qc=qc_config, qc_train=qc_train,
             pp_init=init_program_prior_params(torch.Generator().manual_seed(9),
                                               make_prior_spec(pp_config, vocab)),
             qc_init={"program_generator": interop.program_generator_from_jax(
                 fx["numpy_params"]["program_generator"]),
                 "question_reconstructor": interop.question_reconstructor_from_jax(
                     fx["numpy_params"]["question_reconstructor"])})
    runs = {}
    for name, model in (("grid", MODEL), ("data", 1)):
        f["run_dir"] = str(tmp_path_factory.mktemp(f"pp_qc_{name}"))
        runs[name] = _launch(_pp_qc_rank, str(tmp_path_factory.mktemp(f"ranks_{name}")),
                             DATA * model, model, dict(f))
    return runs


def _parity(got, want, grads, lr, first=None, first_want=None, share=0.4):
    r"""ROADMAP.md's trainer-parity rule: every parameter within 2 lr a step;
    where every step's |g| clears the floor, within 2e-5 (or, given the
    first step's parameters, those within 1e-6 where the first |g| clears
    it, as the NMN's plateau needs) over at least ``share`` of them."""
    assert sorted(got) == sorted(want)
    compared = total = 0
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=2 * lr * len(grads), rtol=0, err_msg=key)
        if first is None:
            smooth = np.min([np.abs(g[key]) for g in grads], axis=0) > GRAD_FLOOR
            np.testing.assert_allclose(got[key][smooth], w[smooth], atol=2e-5, rtol=0,
                                       err_msg=key)
        else:
            smooth = np.abs(grads[0][key]) > GRAD_FLOOR
            np.testing.assert_allclose(first[key][smooth], first_want[key][smooth], atol=1e-6,
                                       rtol=0, err_msg=key)
        compared += int(smooth.sum())
        total += w.size
    assert compared > share * total


def _close(got, want, rtol=LOG_RTOL, atol=1e-6, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for key in want:
            _close(got[key], want[key], rtol, atol, f"{where}/{key}")
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=where)


# ------------------------------------------------------------------ (a) counts ---------
@pytest.mark.parametrize("batch_size", [12, 16])
@pytest.mark.parametrize("model_parallel", [0, 1, 2, 3, 4])
def test_auto_world_keeps_the_jax_mesh_grid(model_parallel, batch_size, caplog):
    import jax

    from probnmn_tpu.parallel.mesh import auto_mesh

    assert len(jax.devices()) == 8
    for num_devices in (None, 0, 1, 2, 3, 4, 6, 8):
        want = auto_mesh(num_devices, batch_size, model_parallel)
        want = (1, 1) if want is None else (want.shape["data"], want.shape["model"])
        with caplog.at_level(logging.INFO, logger="probnmn_tpu_torch.parallel.mesh"):
            caplog.clear()
            got = mesh.auto_world(num_devices, batch_size, 8, model_parallel)
        assert got == want, num_devices
        fell_back = model_parallel != 1 and got[1] != model_parallel
        assert ("does not divide" in caplog.text) == fell_back, num_devices
    # Without model_parallel the count is the data axis's, as before.
    assert mesh.auto_world(4, batch_size, 8) == auto_mesh(4, batch_size).shape["data"]


# ------------------------------------------------------------------ (b) placement ------
def _trees(mp):
    r"""The four models' port trees at CLEVR's vocabulary and small widths
    (CLEVR's banks: 15 / 6 / 4 / 4 / 7)."""
    from probnmn_tpu_torch.models import nmn, program_generator, question_reconstructor
    from probnmn_tpu_torch.models.program_prior import init_program_prior_params
    from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec
    from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary

    vocab = make_clevr_like_vocabulary()
    config = Config(None, ["NMN.MODULE_CHANNELS", 8, "NMN.CLASS_PROJECTION_CHANNELS", 16,
                           "NMN.CLASSIFIER_LINEAR_SIZE", 12, "NMN.IMAGE_FEATURE_SIZE", [12, 4, 4],
                           "PROGRAM_GENERATOR.HIDDEN_SIZE", 8, "PROGRAM_GENERATOR.INPUT_SIZE", 8,
                           "QUESTION_RECONSTRUCTOR.HIDDEN_SIZE", 8,
                           "QUESTION_RECONSTRUCTOR.INPUT_SIZE", 8,
                           "PROGRAM_PRIOR.HIDDEN_SIZE", 8, "PROGRAM_PRIOR.INPUT_SIZE", 8])
    gen = torch.Generator().manual_seed(mp)
    spec = nmn.make_spec(vocab, config)
    assert spec.bank_sizes == {"attention": 15, "query": 6, "relate": 4, "same": 4,
                               "compare": 7}
    return {"nmn": nmn.init_nmn_params(gen, spec),
            "program_generator": program_generator.init_params(
                gen, program_generator.make_spec(vocab, config)),
            "question_reconstructor": question_reconstructor.init_params(
                gen, question_reconstructor.make_spec(vocab, config)),
            "program_prior": init_program_prior_params(gen, make_prior_spec(config, vocab))}


@pytest.mark.parametrize("model_parallel", [2, 4])
@pytest.mark.parametrize("name", ["nmn", "program_generator", "question_reconstructor",
                                  "program_prior"])
def test_model_shard_spec_is_the_jax_placement(name, model_parallel):
    import jax

    from probnmn_tpu.parallel.mesh import make_mesh, shard_params

    tree = _trees(model_parallel)[name]
    placed = shard_params(make_mesh(8, model_parallel), {name: interop.model_to_jax(name, tree)})
    want = {tuple(getattr(key, "key", getattr(key, "idx", None)) for key in path):
            tuple(leaf.sharding.spec)
            for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]}
    got = {path: mesh.model_shard_spec(path, leaf, model_parallel)
           for path, leaf in mesh.tree_paths({name: tree})}
    assert got == want
    split = [path for path, spec in got.items() if spec]
    if name != "nmn":
        assert split == []  # the frozen and seq2seq models keep every leaf whole
        return
    banks = {path[1] for path in split if path[1] != "classifier"}
    # 15 and 7 never split; 6 splits at 2 and falls back at 4; 4 splits at both.
    assert banks == ({"query", "relate", "same"} if model_parallel == 2 else {"relate", "same"})
    assert {path[2] for path in split if path[1] == "classifier"} == {"proj_w", "lin1", "lin2"}


# ------------------------------------------------------------------ (c) JAX parity -----
def test_module_training_on_the_grid_matches_the_jax_trainer(grid):
    ranks = [r["mt"] for r in grid["ranks"]]
    for step, want in enumerate(grid["mt_jax_logs"]):
        for r in ranks:
            _close(r["logs"][step], want, where=f"step {step}")
        assert all(r["logs"][step] == ranks[0]["logs"][step] for r in ranks)
    assert all(log["metrics"]["average_invalid"] == len(SOUP_ROWS) for log in ranks[0]["logs"])
    # The handed-in programs leave many bank slots idle: about a third of
    # the NMN's parameters see a gradient.
    _parity(ranks[0]["params"], grid["mt_jax_params"], ranks[0]["grads"], grid["lr"],
            first=ranks[0]["first"], first_want=grid["mt_jax_first"], share=0.3)
    for r in ranks:
        for key, value in grid["mt_jax_val"]["nmn"].items():
            assert r["val"]["nmn"][key] == pytest.approx(value, abs=1e-12), key


def test_joint_training_on_the_grid_matches_the_jax_trainer(grid):
    ranks = [r["jt"] for r in grid["ranks"]]
    for step, want in enumerate(grid["jt_jax_logs"]):
        _close(ranks[0]["logs"][step], want, where=f"step {step}")
        assert all(r["logs"][step] == ranks[0]["logs"][step] for r in ranks)
    for r in ranks:  # the baseline: the same bits on every rank
        assert r["baselines"] == ranks[0]["baselines"]
    np.testing.assert_allclose(ranks[0]["baselines"], grid["jt_jax_baselines"], rtol=LOG_RTOL,
                               atol=1e-6)
    assert ranks[0]["baselines"][-1] != 0.0
    _parity(ranks[0]["params"], grid["jt_jax_params"], ranks[0]["grads"], grid["lr"],
            first=ranks[0]["first"], first_want=grid["jt_jax_first"])
    for group, values in grid["jt_jax_val"].items():
        for key, value in values.items():
            for r in ranks:
                np.testing.assert_allclose(r["val"][group][key], value, rtol=1e-5, atol=1e-7,
                                           err_msg=f"{group}/{key}")


def test_every_data_shard_scores_invalid_and_all_pad_programs(grid):
    soup = grid["f"]["z_table"][2]
    for rank in grid["ranks"]:
        z = np.concatenate(rank["jt"]["z"])
        assert (z == soup).all(1).any() and (z == 0).all(1).any()
    programs = grid["f"]["programs"]
    for lo in (0, BATCH // DATA):
        shard = set(range(lo, lo + BATCH // DATA))
        assert shard & set(SOUP_ROWS) and shard & set(PAD_ROWS)
    assert (programs[list(PAD_ROWS)] == 0).all()


# ------------------------------------------------------------------ (d) no other change
@pytest.mark.parametrize("phase", ["pp", "qc"])
def test_the_model_axis_changes_nothing_else(pp_qc, phase):
    grid_ranks = [r[phase] for r in pp_qc["grid"]]
    data_ranks = [r[phase] for r in pp_qc["data"]]
    want = data_ranks[0]
    for r in grid_ranks:
        for got_log, want_log in zip(r["logs"], want["logs"]):
            _close(got_log, want_log, where=phase)
        _parity(r["params"], want["params"], r["grads"], 0.01, share=0.5)
        if phase == "qc":
            assert r["baselines"] == grid_ranks[0]["baselines"]
            np.testing.assert_allclose(r["baselines"], want["baselines"], rtol=LOG_RTOL,
                                       atol=1e-7)
            assert want["baselines"][-1] != 0.0
    assert all(r["gathers"] == [0] * STEPS for r in grid_ranks)  # no leaf to split
    if phase == "pp":  # nothing split: each rank keeps what a rank of the data-parallel run keeps
        assert {r["resident"] for r in grid_ranks} == {data_ranks[0]["resident"]}


# ------------------------------------------------------------------ (e) replicas, seeds
def test_replicated_leaves_are_equal_and_split_leaves_are_slices(grid):
    for phase in ("mt", "jt"):
        layouts = [r[phase]["layout"] for r in grid["ranks"]]
        full = layouts[0]["full"]
        keys = list(full)
        split = dict(zip(keys, layouts[0]["split"]))
        assert any(split.values()) and not all(split.values())
        for rank, layout in enumerate(layouts):
            for key in keys:
                np.testing.assert_array_equal(layout["full"][key], full[key], err_msg=key)
                stored = layout["stored"][key]
                if not split[key]:
                    np.testing.assert_array_equal(stored, full[key], err_msg=key)
                    want_shape = full[key].shape
                else:
                    rows = full[key].shape[0] // MODEL
                    m = rank % MODEL
                    want_shape = (rows,) + full[key].shape[1:]
                    np.testing.assert_array_equal(stored, full[key][m * rows:(m + 1) * rows],
                                                  err_msg=key)
                assert stored.shape == want_shape, key
                index = keys.index(key)
                assert layout["moments"]["exp_avg"][index] == want_shape, key
                assert layout["moments"]["exp_avg_sq"][index] == want_shape, key
        # One all-gather in the model group a step.
        assert all(r[phase]["gathers"] == [1] * STEPS for r in grid["ranks"])
    # Split bytes: a rank keeps less than a data-parallel rank would.
    mt = grid["ranks"][0]["mt"]["layout"]
    whole = sum(v.size * 4 * 3 for v in mt["full"].values())
    kept = sum(v.size * 4 * 3 for v in mt["stored"].values())
    assert mt["resident"] == kept < whole


def test_k1_draws_follow_the_data_index(grid):
    draws = [r["mt"]["k1"] for r in grid["ranks"]]
    assert np.array_equal(draws[0], draws[1]) and np.array_equal(draws[2], draws[3])
    assert not np.array_equal(draws[0], draws[2])


# ------------------------------------------------------------------ (f) checkpoints ----
def test_checkpoints_pass_between_the_grid_one_process_and_jax(grid):
    import jax

    f = grid["f"]
    ranks = [r["mt"] for r in grid["ranks"]]
    written = ranks[0]["written"]
    # The grid's file resumes in one process: full leaves and moments.
    run_dir = os.path.join(f["run_dir"], "mt_0")
    one = _mt_trainer(None, f, "mt_from_grid")
    one.load_checkpoint(os.path.join(run_dir, "checkpoint_2.ckpt"))
    assert one.iteration == STEPS - 1
    for key, value in _flat(one.params).items():
        np.testing.assert_array_equal(value, written["params"][key], err_msg=key)
    state = one._optimizer.state_dict()["state"]
    for index, key in enumerate(_flat(one.params)):
        np.testing.assert_array_equal(state[index]["exp_avg"].numpy(), written["mu"][key],
                                      err_msg=key)
    # The grid's JAX .ckpt resumes in the JAX trainer at model_parallel=2.
    jax_mt = grid["jax_mt"]
    jax_mt.load_checkpoint(os.path.join(f["run_dir"], "mt_grid_jax.ckpt"))
    port = lambda tree: _flat({"nmn": interop.nmn_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), one.nmn_spec)})
    for key, value in port(jax_mt.params["nmn"]).items():
        np.testing.assert_array_equal(value, written["params"][key], err_msg=key)
    adam = _jax_adam(jax_mt)
    assert int(adam.count) == STEPS
    for key, value in port(adam.mu["nmn"]).items():
        np.testing.assert_array_equal(value, written["mu"][key], err_msg=key)
    # The JAX trainer's and one process's files resume on the grid: each
    # rank holds its rows of the leaves and moments.
    sources = {"jax": (grid["mt_jax_params"], grid["mt_jax_mu"], STEPS),
               "one": (grid["mt_one"]["params"], grid["mt_one"]["mu"], 1)}
    for name, (params, mus, steps) in sources.items():
        for rank, r in enumerate(ranks):
            resumed = r["resumed"][name]
            assert resumed["steps"] == [float(steps)]
            assert sorted(resumed["stored"]) == sorted(params)
            for key, value in resumed["stored"].items():
                rows = value.shape[0]
                m = rank % MODEL if rows != params[key].shape[0] else 0
                np.testing.assert_array_equal(value, params[key][m * rows:(m + 1) * rows],
                                              err_msg=f"{name} {key}")
                np.testing.assert_array_equal(resumed["mu"][key],
                                              mus[key][m * rows:(m + 1) * rows],
                                              err_msg=f"{name} {key}")


# ------------------------------------------------------------------ (g) the CLI --------
@pytest.mark.parametrize("phase", ["module_training", "joint_training"])
def test_train_cli_on_the_grid_writes_a_checkpoint(fx, phase, tmp_path):
    _, config, path = fx["configs"](phase, *(["OBJECTIVE", "ours"] if phase == "joint_training"
                                             else []))
    overrides = ["CHECKPOINTS.QUESTION_CODING", fx["port"]["question_coding"],
                 "CHECKPOINTS.MODULE_TRAINING", fx["port"]["module_training"],
                 "CHECKPOINTS.PROGRAM_PRIOR", fx["port"]["program_prior"],
                 "OPTIM.NUM_ITERATIONS", "2"]
    out = str(tmp_path / "grid")
    train.main(train.parser.parse_args([
        "--phase", phase, "--config-yml", path, "--config-override", *overrides,
        "--device", "cpu", "--serialization-dir", out, "--checkpoint-every", "2",
        "--num-val-batches", "1", "--num-devices", "4", "--model-parallel", "2"]))
    files = sorted(os.listdir(out))
    assert [f for f in files if f.endswith(".ckpt")] == ["checkpoint_1.ckpt",
                                                         "checkpoint_best.ckpt"]
    assert len([f for f in files if f.startswith("events.")]) == 1  # rank 0's scalars alone
    trainer = (JointTrainingTrainer if phase == "joint_training" else ModuleTrainingTrainer)(
        Config(path, overrides), str(tmp_path / "resumed"), device="cpu",
        writer=RecordingWriter())
    trainer.load_checkpoint(os.path.join(out, "checkpoint_1.ckpt"))
    assert trainer.iteration == 1
    state = trainer._optimizer.state_dict()["state"]
    assert {float(s["step"]) for s in state.values()} == {2.0}
    assert all(np.isfinite(v).all() for v in _flat(trainer.params).values())


def test_model_parallel_that_does_not_divide_falls_back_to_one(fx, caplog):
    import jax

    from probnmn_tpu.parallel.mesh import auto_mesh

    _, _, path = fx["configs"]("program_prior")
    args = train.parser.parse_args(["--phase", "program_prior", "--config-yml", path,
                                    "--device", "cpu", "--num-devices", "4",
                                    "--model-parallel", "3"])
    with caplog.at_level(logging.INFO, logger="probnmn_tpu_torch.parallel.mesh"):
        grid = train.world_of(args, Config(path))
    assert grid == (4, 1)
    assert "--model-parallel 3 does not divide 4 devices" in caplog.text
    assert len(jax.devices()) >= 4
    assert dict(auto_mesh(4, BATCH, 3).shape) == {"data": 4, "model": 1}
