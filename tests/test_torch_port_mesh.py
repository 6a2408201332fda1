"""The port's data-parallel mesh (``probnmn_tpu_torch/parallel/mesh.py``) on
the CPU: two gloo ranks, each a spawned process, against the JAX package's
trainers and evaluators on ``auto_mesh(2, B)`` (conftest's 8 CPU devices)
and against the port in one process.

- ``auto_world`` gives ``auto_mesh``'s data count for every ``--num-devices``
  and batch size.
- Three program_prior steps at 2 ranks: the logged loss within 1e-5 of the
  JAX trainer's on the mesh and within 2e-4 relative of the port's at one
  rank; the parameters by ROADMAP.md's trainer-parity rule (within 2e-5
  wherever every step's |g| exceeds 1e-5, elsewhere within 2 lr a step);
  both ranks' parameters bit for bit equal.
- Three module_training steps at 2 ranks on fixed programs (both samplers
  patched, as in test_torch_port_module_training.py; batch 16, with three
  invalid token soups and an all-pad row over both ranks): the loss within 1e-5,
  the all-reduced metrics within 1e-6, the first step's parameters within
  1e-6 where |g| exceeds 1e-5 and all within 2 lr a step, against JAX on the
  mesh and the port at one rank.
- Both evaluators at 2 ranks against one rank and JAX's mesh evaluators.
- ``train --device cpu --num-devices 2 --phase program_prior``: one
  checkpoint per save, written by rank 0, its parameters by the parity rule
  against the one-rank CLI's, resumed by a one-rank trainer.
- ``--model-parallel 2`` taken as a grid of ranks, a rank that raises, and
  the features held once in shared memory.

Rank-side code is this file's top-level functions and imports no JAX (the
spawned ranks import this module); JAX is imported inside the tests.
"""
import os
import time

import numpy as np
import pytest
import torch

from probnmn_tpu_torch import interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import ModuleTrainingDataset, ProgramPriorDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator, EpochIterator
from probnmn_tpu_torch.data.readers import SharedFeatures
from probnmn_tpu_torch.data.samplers import RandomSampler
from probnmn_tpu_torch.evaluators.module_training_evaluator import ModuleTrainingEvaluator
from probnmn_tpu_torch.evaluators.program_prior_evaluator import ProgramPriorEvaluator
from probnmn_tpu_torch.parallel import mesh
from probnmn_tpu_torch.training._trainer import copy_into, tree_map
from probnmn_tpu_torch.training.module_training_trainer import ModuleTrainingTrainer
from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
from probnmn_tpu_torch.utils.checkpointing import save_objects
from probnmn_tpu_torch.utils.observability import RecordingWriter

STEPS = 3
RANKS = 2
LAUNCH_TIMEOUT = 120.0
LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5
GRAD_FLOOR = 1e-5
# module_training's batch, and the rows of its fixed programs (rows 0-7 on
# rank 0) that are token soups, and the one all-pad row: every template
# keeps a valid row.
MT_BATCH = 16
SOUP_ROWS = (2, 5, 10)
PAD_ROW = 6


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
    return _flat(tree_map(lambda t: t.grad, params))


# ------------------------------------------------------------------ rank-side ----------
def _pp_rank(parallel, config, run_dir, init):
    writer = RecordingWriter()
    trainer = ProgramPriorTrainer(config, run_dir, device="cpu", writer=writer,
                                  parallel=parallel)
    copy_into(trainer.params["program_prior"], init)
    val = ProgramPriorEvaluator(config, trainer).evaluate(num_batches=2)
    logs, grads = [], []
    for iteration in range(STEPS):
        logs.append(trainer.step(iteration))
        grads.append(_grads(trainer.params["program_prior"]))
    return dict(val=val, logs=logs, grads=grads, scalars=writer.scalars,
                params=_flat(trainer.params["program_prior"]))


def _mt_rank(parallel, config, run_dir, init, programs, train_set, val_set):
    writer = RecordingWriter()
    trainer = ModuleTrainingTrainer(config, run_dir, device="cpu", writer=writer,
                                    dataset=train_set, parallel=parallel)
    rows = len(programs) // parallel.world_size
    mine = torch.from_numpy(programs[parallel.rank * rows:(parallel.rank + 1) * rows])
    trainer.sample_programs = lambda questions: mine
    copy_into(trainer.params["nmn"], init)
    val = ModuleTrainingEvaluator(config, trainer, dataset=val_set).evaluate(num_batches=2)
    logs, grads, first = [], [], None
    for iteration in range(STEPS):
        logs.append(trainer.step(iteration))
        grads.append(_grads(trainer.params["nmn"]))
        if iteration == 0:
            first = _flat(trainer.params["nmn"])
    # The features are one copy: rank 1 writes into them, rank 0 reads it.
    features = train_set._features.features
    shared = isinstance(features, SharedFeatures) and features.tensor.is_shared()
    parallel.barrier()
    if parallel.rank == 1:
        features.tensor.view(-1)[0] = 1234.5
    parallel.barrier()
    return dict(val=val, logs=logs, grads=grads, first=first, scalars=writer.scalars,
                params=_flat(trainer.params["nmn"]), shared=shared,
                seen=float(features.tensor.view(-1)[0]))


def _raising_rank(parallel):
    if parallel.rank == 1:
        raise ValueError("rank 1 cannot read its shard")
    parallel.barrier()


# ------------------------------------------------------------------ fixtures -----------
@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    import jax

    from probnmn_tpu.models import program_generator as jprogram_generator
    from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
    from tests.clevr_fixtures import PROGRAM_TEMPLATES, build_fixture_data, make_fixture_config

    root = str(tmp_path_factory.mktemp("mesh"))
    jvocab = build_fixture_data(root, n_val=2 * MT_BATCH)
    out = {"root": root}
    for phase in ("program_prior", "module_training"):
        jax_config = make_fixture_config(
            root, phase, ["OPTIM.BATCH_SIZE", MT_BATCH] if phase == "module_training" else [])
        path = os.path.join(root, f"{phase}.yml")
        jax_config.dump(path)
        out[phase] = {"jax_config": jax_config, "path": path}
    pg_spec = jprogram_generator.make_spec(jvocab, out["module_training"]["jax_config"])
    pg = jprogram_generator.init_params(jax.random.PRNGKey(3), pg_spec)
    jax_save_objects(os.path.join(root, "question_coding_best.ckpt"), {"program_generator": pg})
    port_qc = os.path.join(root, "question_coding_port.ckpt")
    save_objects(port_qc, {"program_generator": interop.program_generator_from_jax(
        jax.tree_util.tree_map(np.asarray, pg))})
    out["program_prior"]["config"] = Config(out["program_prior"]["path"])
    out["module_training"]["config"] = Config(out["module_training"]["path"],
                                              ["CHECKPOINTS.QUESTION_CODING", port_qc])
    batch = out["module_training"]["config"].OPTIM.BATCH_SIZE
    programs = np.zeros((batch, 10), np.int64)
    for i in range(batch):
        ids = [jvocab.get_token_index(t, "programs")
               for t in PROGRAM_TEMPLATES[i % len(PROGRAM_TEMPLATES)]]
        programs[i, :len(ids)] = ids
    # Invalid rows in both ranks' blocks: rank 0's holds two token soups and
    # the all-pad row, rank 1's one soup.
    rs = np.random.RandomState(5)
    for i in SOUP_ROWS:
        programs[i] = rs.randint(1, jvocab.get_vocab_size("programs"), programs.shape[1])
    programs[PAD_ROW] = 0
    out["programs"] = programs
    return out


def _launch(fn, run_dir, *args):
    return mesh.launch(fn, RANKS, "cpu", run_dir, args=args, timeout=LAUNCH_TIMEOUT,
                       collective_timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def pp(fx, tmp_path_factory):
    r"""program_prior: the JAX trainer on a 2-device mesh, the port at one
    rank and at two, from the same parameters; each evaluator first, then
    three steps."""
    import jax

    from probnmn_tpu.evaluators.program_prior_evaluator import (
        ProgramPriorEvaluator as JaxProgramPriorEvaluator,
    )
    from probnmn_tpu.training.program_prior_trainer import (
        ProgramPriorTrainer as JaxProgramPriorTrainer,
    )

    f = fx["program_prior"]
    np.random.seed(0)
    jax_trainer = JaxProgramPriorTrainer(f["jax_config"], str(tmp_path_factory.mktemp("jax")),
                                         num_devices=RANKS)
    assert dict(jax_trainer.mesh.shape) == {"data": RANKS, "model": 1}
    init = interop.program_prior_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_trainer.params["program_prior"]))
    jax_val = JaxProgramPriorEvaluator(f["jax_config"], jax_trainer).evaluate(num_batches=2)
    jax_losses = []
    for iteration in range(STEPS):
        jax_losses.append(float(jax_trainer._do_iteration(next(jax_trainer._batches))["loss"]))
    jax_params = _flat(interop.program_prior_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_trainer.params["program_prior"])))

    one = ProgramPriorTrainer(f["config"], str(tmp_path_factory.mktemp("one")), device="cpu",
                              writer=RecordingWriter())
    copy_into(one.params["program_prior"], init)
    one_val = ProgramPriorEvaluator(f["config"], one).evaluate(num_batches=2)
    one_losses = [one.step(iteration)["loss"] for iteration in range(STEPS)]

    ranks = _launch(_pp_rank, str(tmp_path_factory.mktemp("ranks")), f["config"],
                    str(tmp_path_factory.mktemp("pp_ranks")), init)
    return dict(jax_val=jax_val, jax_losses=jax_losses, jax_params=jax_params, one_val=one_val,
                one_losses=one_losses, one_params=_flat(one.params["program_prior"]), ranks=ranks,
                lr=f["config"].OPTIM.LR_INITIAL)


@pytest.fixture(scope="module")
def mt(fx, tmp_path_factory):
    r"""module_training at fixed programs: the JAX trainer on a 2-device
    mesh, the port at one rank and at two (the features in shared memory),
    from the same parameters; each evaluator first, then three steps."""
    import jax
    import jax.numpy as jnp

    from probnmn_tpu.evaluators.module_training_evaluator import (
        ModuleTrainingEvaluator as JaxModuleTrainingEvaluator,
    )
    from probnmn_tpu.training import module_training_trainer as jax_mt_module

    f = fx["module_training"]
    fixed = jnp.asarray(fx["programs"])
    original = jax_mt_module.seq2seq_forward
    jax_mt_module.seq2seq_forward = lambda *args, **kwargs: {"predictions": fixed}
    try:
        jax_trainer = jax_mt_module.ModuleTrainingTrainer(
            f["jax_config"], str(tmp_path_factory.mktemp("jax_mt")), num_devices=RANKS)
        assert dict(jax_trainer.mesh.shape) == {"data": RANKS, "model": 1}
        jax_init = jax_trainer.params["nmn"]
        jax_val = JaxModuleTrainingEvaluator(f["jax_config"], jax_trainer).evaluate(num_batches=2)
        jax_logs, jax_first = [], None
        for iteration in range(STEPS):
            jax_logs.append(jax.tree_util.tree_map(
                float, jax_trainer._do_iteration(next(jax_trainer._batches))))
            if iteration == 0:
                jax_first = jax_trainer.params["nmn"]
    finally:
        jax_mt_module.seq2seq_forward = original

    config = f["config"]
    one = ModuleTrainingTrainer(config, str(tmp_path_factory.mktemp("one_mt")), device="cpu",
                                writer=RecordingWriter())
    spec = one.nmn_spec

    def port_tree(tree):
        return interop.nmn_from_jax(jax.tree_util.tree_map(np.asarray, tree), spec)

    init = port_tree(jax_init)
    one.sample_programs = lambda questions: torch.from_numpy(fx["programs"])
    copy_into(one.params["nmn"], init)
    one_val = ModuleTrainingEvaluator(config, one).evaluate(num_batches=2)
    one_logs, one_first = [], None
    for iteration in range(STEPS):
        one_logs.append(one.step(iteration))
        if iteration == 0:
            one_first = _flat(one.params["nmn"])

    train_set = ModuleTrainingDataset(config.DATA.TRAIN_TOKENS, config.DATA.TRAIN_FEATURES,
                                      shared_features=True)
    val_set = ModuleTrainingDataset(config.DATA.VAL_TOKENS, config.DATA.VAL_FEATURES,
                                    shared_features=True)
    ranks = _launch(_mt_rank, str(tmp_path_factory.mktemp("mt_ranks")), config,
                    str(tmp_path_factory.mktemp("mt_rank_dir")), init, fx["programs"],
                    train_set, val_set)
    return dict(jax_val=jax_val, jax_logs=jax_logs, jax_first=_flat(port_tree(jax_first)),
                jax_params=_flat(port_tree(jax_trainer.params["nmn"])), one_val=one_val,
                one_logs=one_logs, one_first=one_first, one_params=_flat(one.params["nmn"]),
                ranks=ranks, lr=config.OPTIM.LR_INITIAL, train_set=train_set)


def _parity(got, want, grads, lr, atol=PARAM_ATOL, share=0.9):
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


# ------------------------------------------------------------------ (1) auto_world -----
@pytest.mark.parametrize("batch_size", [12, 16])
@pytest.mark.parametrize("num_devices", [None, 0, 1, 2, 3, 8])
def test_auto_world_keeps_the_jax_mesh_policy(num_devices, batch_size):
    import jax

    from probnmn_tpu.parallel.mesh import auto_mesh

    assert len(jax.devices()) == 8
    want = auto_mesh(num_devices, batch_size)
    want = 1 if want is None else want.shape["data"]
    assert mesh.auto_world(num_devices, batch_size, available=8) == want


def test_batch_iterators_give_each_rank_its_block_of_rows(fx):
    path = fx["program_prior"]["config"].DATA.TRAIN_TOKENS
    dataset = ProgramPriorDataset(path)
    for world in (2, 4):
        whole = iter(BatchIterator(dataset, RandomSampler(len(dataset), seed=3), 8, device="cpu"))
        ranks = [iter(BatchIterator(dataset, RandomSampler(len(dataset), seed=3), 8,
                                    device="cpu", rank=r, world_size=world))
                 for r in range(world)]
        for _ in range(7):  # 5 batches an epoch: crosses an epoch boundary
            parts = [next(it)["program"] for it in ranks]
            assert all(len(p) == 8 // world for p in parts)
            assert torch.equal(torch.cat(parts), next(whole)["program"])
        whole = list(EpochIterator(dataset, 8, device="cpu"))
        parts = [list(EpochIterator(dataset, 8, device="cpu", rank=r, world_size=world))
                 for r in range(world)]
        assert all(len(p) == len(whole) == 5 for p in parts)
        for index, batch in enumerate(whole):
            assert torch.equal(torch.cat([p[index]["program"] for p in parts]), batch["program"])
    with pytest.raises(ValueError, match="does not split"):
        BatchIterator(dataset, RandomSampler(len(dataset), seed=3), 8, device="cpu",
                      rank=0, world_size=3)
    seeds = {mesh.rank_seed(0, r) for r in range(8)}
    assert len(seeds) == 8 and mesh.rank_seed(0, 0) == 0
    assert mesh.rank_seed(0, 1) == mesh.rank_seed(0, 1) != mesh.rank_seed(1, 1)


# ------------------------------------------------------------------ (2) program_prior --
def test_program_prior_at_two_ranks_matches_the_jax_mesh(pp):
    rank0, rank1 = pp["ranks"]
    losses = [log["loss"] for log in rank0["logs"]]
    np.testing.assert_allclose(losses, pp["jax_losses"], atol=LOSS_ATOL, rtol=0)
    assert [log["loss"] for log in rank1["logs"]] == losses
    _parity(rank0["params"], pp["jax_params"], rank0["grads"], pp["lr"])


def test_program_prior_at_two_ranks_matches_one_rank(pp):
    rank0, rank1 = pp["ranks"]
    np.testing.assert_allclose([log["loss"] for log in rank0["logs"]], pp["one_losses"],
                               rtol=2e-4)
    _parity(rank0["params"], pp["one_params"], rank0["grads"], pp["lr"])
    for key, value in rank0["params"].items():  # every rank holds the same parameters
        np.testing.assert_array_equal(rank1["params"][key], value)
    # Rank 0 alone writes scalars.
    assert [tag for tag, _, _ in rank0["scalars"]] == ["train/loss"] * STEPS
    assert rank1["scalars"] == []


def test_program_prior_evaluator_at_two_ranks(pp):
    want = pp["jax_val"]["program_prior"]["perplexity"]
    for rank in pp["ranks"]:
        got = rank["val"]["program_prior"]["perplexity"]
        assert got > 1.0
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, pp["one_val"]["program_prior"]["perplexity"], rtol=1e-5)


# ------------------------------------------------------------------ (3) module_training
def _mt_logs_close(got_logs, want_logs):
    for got, want in zip(got_logs, want_logs):
        assert sorted(got) == sorted(want) == ["loss", "metrics"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=LOSS_ATOL, rtol=0)
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for key, value in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], value, atol=1e-6, err_msg=key)


def _mt_params_close(rank0, first, params, lr):
    # Adam's first step moves a parameter by about lr * sign(g): there the
    # params agree wherever |g| clears the float32 noise of the NMN's
    # plateau; after three steps the bound is 2 lr a step (ROADMAP.md
    # section 3).
    compared = total = 0
    for key, w in first.items():
        smooth = np.abs(rank0["grads"][0][key]) > GRAD_FLOOR
        np.testing.assert_allclose(rank0["first"][key][smooth], w[smooth], atol=1e-6, rtol=0,
                                   err_msg=key)
        np.testing.assert_allclose(rank0["params"][key], params[key], atol=2 * lr * STEPS,
                                   rtol=0, err_msg=key)
        compared += int(smooth.sum())
        total += w.size
    assert compared > 0.4 * total


def test_module_training_at_two_ranks_matches_the_jax_mesh(mt):
    rank0, rank1 = mt["ranks"]
    _mt_logs_close(rank0["logs"], mt["jax_logs"])
    assert rank1["logs"] == rank0["logs"]
    assert all(log["metrics"]["average_invalid"] == len(SOUP_ROWS) for log in rank0["logs"])
    _mt_params_close(rank0, mt["jax_first"], mt["jax_params"], mt["lr"])


def test_module_training_at_two_ranks_matches_one_rank(mt):
    rank0, rank1 = mt["ranks"]
    _mt_logs_close(rank0["logs"], mt["one_logs"])
    for got, want in zip(rank0["logs"], mt["one_logs"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4)
    _mt_params_close(rank0, mt["one_first"], mt["one_params"], mt["lr"])
    for key, value in rank0["params"].items():
        np.testing.assert_array_equal(rank1["params"][key], value)
    assert [tag for tag, _, _ in rank0["scalars"]] == [
        "train/loss", "train/metrics/answer_accuracy", "train/metrics/average_invalid"] * STEPS
    assert rank1["scalars"] == []


def test_module_training_evaluator_at_two_ranks(mt):
    for rank in mt["ranks"]:
        got = rank["val"]["nmn"]
        assert sorted(got) == ["answer_accuracy", "average_invalid"]
        for key, value in mt["jax_val"]["nmn"].items():
            assert got[key] == pytest.approx(value, abs=1e-12), key
            assert got[key] == pytest.approx(mt["one_val"]["nmn"][key], abs=1e-12), key


def test_the_ranks_read_one_shared_copy_of_the_features(mt):
    r"""The launcher's features are one copy in shared memory: what rank 1
    wrote into it, rank 0 and the launcher read."""
    rank0, rank1 = mt["ranks"]
    assert rank0["shared"] and rank1["shared"]
    assert rank0["seen"] == rank1["seen"] == 1234.5
    features = mt["train_set"]._features.features
    assert float(features.tensor.view(-1)[0]) == 1234.5
    # Pickled for a spawned process it is its shared tensor, which torch
    # hands over as a handle to the same pages.
    rebuild, args = features.__reduce__()
    assert rebuild is SharedFeatures and args[0] is features.tensor and args[0].is_shared()


# ------------------------------------------------------------------ (5) the CLI --------
def _cli_args(fx, out, *extra):
    return train.parser.parse_args([
        "--phase", "program_prior", "--config-yml", fx["program_prior"]["path"],
        "--config-override", "OPTIM.NUM_ITERATIONS", "4", "--device", "cpu",
        "--serialization-dir", out, "--checkpoint-every", "4", "--num-val-batches", "1",
        *extra])


def test_train_cli_at_two_ranks_writes_one_checkpoint_and_resumes(fx, tmp_path):
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    train.main(_cli_args(fx, one))
    train.main(_cli_args(fx, two, "--num-devices", "2"))
    files = sorted(os.listdir(two))
    assert [f for f in files if f.endswith(".ckpt")] == ["checkpoint_3.ckpt",
                                                         "checkpoint_best.ckpt"]
    assert [f for f in files if not f.startswith("events.")] == [
        f for f in sorted(os.listdir(one)) if not f.startswith("events.")]
    assert len([f for f in files if f.startswith("events.")]) == 1  # rank 0's scalars alone
    config = fx["program_prior"]["config"]
    trainers = {}
    for name, path in (("one", one), ("two", two)):
        trainers[name] = ProgramPriorTrainer(config, str(tmp_path / f"resumed_{name}"),
                                             device="cpu", writer=RecordingWriter())
        trainers[name].load_checkpoint(os.path.join(path, "checkpoint_3.ckpt"))
        assert trainers[name].iteration == 3
    got = _flat(trainers["two"].params["program_prior"])
    want = _flat(trainers["one"].params["program_prior"])
    lr = config.OPTIM.LR_INITIAL
    close = 0
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=2 * lr * 4, rtol=0, err_msg=key)
        close += int((np.abs(got[key] - w) <= PARAM_ATOL).sum())
    assert close > 0.9 * sum(w.size for w in want.values())
    assert np.isfinite(trainers["two"].step()["loss"]) and trainers["two"].iteration == 4


# ------------------------------------------------------------------ (6) the model axis -
@pytest.mark.parametrize("num_devices, grid", [("2", (1, 2)), ("4", (2, 2)), ("3", (2, 1))])
def test_model_parallel_is_taken_as_a_grid_of_ranks(fx, num_devices, grid):
    r"""``--model-parallel 2`` is taken (test_torch_port_mesh_model.py trains
    on the grid): 2 devices a data index where 2 divides the count, else 1."""
    path = fx["program_prior"]["path"]
    args = train.parser.parse_args(["--phase", "program_prior", "--config-yml", path,
                                    "--device", "cpu", "--num-devices", num_devices,
                                    "--model-parallel", "2"])
    assert train.world_of(args, Config(path)) == grid


# ------------------------------------------------------------------ (7) a rank fails ---
def test_a_rank_that_raises_fails_the_launch_with_its_message(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 cannot read its shard"):
        _launch(_raising_rank, str(tmp_path))
    assert time.monotonic() - t0 < LAUNCH_TIMEOUT
    assert os.listdir(tmp_path) == []  # the rendezvous directory is gone
