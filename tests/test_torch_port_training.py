"""The port's program_prior training phase against the JAX package's, in float32
on the CPU, on the synthetic CLEVR-shaped fixture data.

From the same parameters and the same sampler seed, three steps of the port's
``ProgramPriorTrainer(device="cpu")`` give the JAX trainer's losses within
1e-5, and its parameters after them within 2e-5 wherever every step's
gradient exceeds 1e-5 in magnitude. (Adam's first steps move a parameter by
about lr * sign(g), so where |g| sits at the float32 noise floor the sign,
and with it a 0.01-sized step, may differ; elsewhere the update depends
smoothly on the gradient.) The evaluator's perplexity matches within 1e-5
relative; the optimizer, the plateau scheduler, the data path and the
checkpoints match their JAX counterparts; and the CLI runs."""
import os

import numpy as np
import pytest
import torch

import jax
import optax

from probnmn_tpu.data.datasets import ProgramPriorDataset as JaxProgramPriorDataset
from probnmn_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from probnmn_tpu.data.pipeline import EpochIterator as JaxEpochIterator
from probnmn_tpu.data.samplers import RandomSampler as JaxRandomSampler
from probnmn_tpu.evaluators.program_prior_evaluator import (
    ProgramPriorEvaluator as JaxProgramPriorEvaluator,
)
from probnmn_tpu.training.optim import ReduceLROnPlateau as JaxReduceLROnPlateau
from probnmn_tpu.training.optim import make_optimizer
from probnmn_tpu.training.program_prior_trainer import (
    ProgramPriorTrainer as JaxProgramPriorTrainer,
)
from probnmn_tpu_torch import interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import ProgramPriorDataset
from probnmn_tpu_torch.data.pipeline import BatchIterator, EpochIterator
from probnmn_tpu_torch.data.samplers import RandomSampler, SequentialSampler
from probnmn_tpu_torch.evaluators.program_prior_evaluator import ProgramPriorEvaluator
from probnmn_tpu_torch.training._trainer import copy_into
from probnmn_tpu_torch.training.optim import ClampedAdam, ReduceLROnPlateau
from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
from probnmn_tpu_torch.utils.checkpointing import CheckpointManager, load_objects
from probnmn_tpu_torch.utils.observability import RecordingWriter

from tests.clevr_fixtures import build_fixture_data, make_fixture_config

STEPS = 3
LOSS_ATOL = 1e-5
PARAM_ATOL = 2e-5
GRAD_FLOOR = 1e-5


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clevr_port"))
    build_fixture_data(root)
    jax_config = make_fixture_config(root, "program_prior")
    path = os.path.join(root, "program_prior.yml")
    jax_config.dump(path)
    return {"root": root, "jax_config": jax_config, "config_path": path,
            "config": Config(path)}


def _port_tree(jax_tree):
    return interop.program_prior_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))


def _flat(tree):
    r"""{key path: numpy array} of a nested dict/list of JAX arrays or tensors."""
    def to_np(x):
        return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return {jax.tree_util.keystr(path): to_np(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def trained(fixture, tmp_path_factory):
    r"""Both trainers from the same parameters, three steps each on the same
    batches, and both evaluators after them."""
    np.random.seed(0)
    jax_trainer = JaxProgramPriorTrainer(fixture["jax_config"],
                                         str(tmp_path_factory.mktemp("jax_run")))
    port_dir = str(tmp_path_factory.mktemp("port_run"))
    writer = RecordingWriter()
    port = ProgramPriorTrainer(fixture["config"], port_dir, device="cpu", writer=writer)
    copy_into(port.params["program_prior"], _port_tree(jax_trainer.params["program_prior"]))

    jax_losses, port_losses, grads = [], [], []
    for iteration in range(STEPS):
        logs = jax_trainer._do_iteration(next(jax_trainer._batches))
        jax_trainer._iteration = iteration
        jax_losses.append(float(logs["loss"]))
        port_losses.append(port.step(iteration)["loss"])
        grads.append(_flat(jax.tree_util.tree_map(lambda t: t.grad, port.params["program_prior"])))
    val_jax = JaxProgramPriorEvaluator(fixture["jax_config"], jax_trainer).evaluate(num_batches=2)
    evaluator = ProgramPriorEvaluator(fixture["config"], port)
    val_port = evaluator.evaluate(num_batches=2)
    return dict(jax_trainer=jax_trainer, port=port, port_dir=port_dir, writer=writer,
                jax_losses=jax_losses, port_losses=port_losses, grads=grads,
                val_jax=val_jax, val_port=val_port, evaluator=evaluator)


def test_three_steps_match_the_jax_trainer(trained):
    np.testing.assert_allclose(trained["port_losses"], trained["jax_losses"], atol=LOSS_ATOL, rtol=0)
    assert [tag for tag, _, _ in trained["writer"].scalars] == ["train/loss"] * STEPS
    want = _flat(trained["jax_trainer"].params["program_prior"])
    got = _flat(trained["port"].params["program_prior"])
    assert sorted(got) == sorted(want)
    compared = 0
    for key, w in want.items():
        smooth = np.min([np.abs(g[key]) for g in trained["grads"]], axis=0) > GRAD_FLOOR
        np.testing.assert_allclose(got[key][smooth], w[smooth], atol=PARAM_ATOL, rtol=0,
                                   err_msg=key)
        # Elsewhere the difference is bounded by the steps' size: 2 * lr per step.
        np.testing.assert_allclose(got[key], w, atol=2 * 0.01 * STEPS, rtol=0, err_msg=key)
        compared += int(smooth.sum())
    assert compared > 0.9 * sum(w.size for w in want.values())


def test_perplexity_matches_the_jax_evaluator(trained):
    got = trained["val_port"]["program_prior"]["perplexity"]
    want = trained["val_jax"]["program_prior"]["perplexity"]
    assert got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_checkpoint_resume_and_lr_schedule(trained, fixture):
    port, port_dir = trained["port"], trained["port_dir"]
    val = trained["val_port"]
    # One improvement, then four flat validations: patience 3 halves the lr
    # at the fifth; the sixth's checkpoint holds the halved lr (a checkpoint
    # is written before its validation's scheduler step, as in the JAX trainer).
    for iteration in range(4, 10):
        port.after_validation({k: dict(v) for k, v in val.items()}, iteration)
    assert port.learning_rate == pytest.approx(0.005)
    assert os.path.exists(os.path.join(port_dir, "checkpoint_9.ckpt"))
    assert os.path.exists(os.path.join(port_dir, "checkpoint_best.ckpt"))
    best, best_iteration, _ = load_objects(os.path.join(port_dir, "checkpoint_best.ckpt"),
                                           {"scheduler": None})
    assert best_iteration == 4

    resumed = ProgramPriorTrainer(fixture["config"], port_dir, device="cpu",
                                  writer=RecordingWriter())
    resumed.load_checkpoint(os.path.join(port_dir, "checkpoint_9.ckpt"))
    assert resumed.iteration == 9
    assert resumed.learning_rate == pytest.approx(0.005)
    for key, value in _flat(port.params["program_prior"]).items():
        np.testing.assert_array_equal(_flat(resumed.params["program_prior"])[key], value)
    want_state = port._optimizer.state_dict()["state"]
    got_state = resumed._optimizer.state_dict()["state"]
    assert sorted(got_state) == sorted(want_state)
    for index, state in want_state.items():
        for name, value in state.items():
            assert torch.equal(got_state[index][name], value), (index, name)
    # A resumed trainer steps on.
    assert np.isfinite(resumed.step()["loss"]) and resumed.iteration == 10


def test_checkpoint_manager_prunes_and_restores_by_name(tmp_path):
    manager = CheckpointManager(str(tmp_path), keep_recent=2)
    for iteration, metric in enumerate([0.1, 0.3, 0.2]):
        manager.step(iteration, {"model": {"w": torch.full((2,), float(iteration))}}, metric)
    files = sorted(os.listdir(tmp_path))
    assert files == ["checkpoint_1.ckpt", "checkpoint_2.ckpt", "checkpoint_best.ckpt"]
    restored, iteration, missing = load_objects(
        str(tmp_path / "checkpoint_best.ckpt"), {"model": None, "other": "template"})
    assert iteration == 1 and missing == ["other"] and restored["other"] == "template"
    assert torch.equal(restored["model"]["w"], torch.ones(2))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_clamped_adam_matches_optax(weight_decay):
    rs = np.random.RandomState(0)
    params = rs.randn(6, 5).astype(np.float32)
    grads = [rs.randn(6, 5).astype(np.float32) * 4.0 for _ in range(3)]
    grads[0][0, :3] = [12.0, -7.5, 5.0]  # beyond the +-5 clamp
    tx = make_optimizer(0.01, weight_decay)
    jp = jax.numpy.asarray(params)
    state = tx.init(jp)
    grads[2][:] = 0.0  # a step without a gradient: optax steps on zeros
    p = torch.from_numpy(params.copy()).requires_grad_(True)
    opt = ClampedAdam([p], 0.01, weight_decay)
    for index, g in enumerate(grads):
        updates, state = tx.update(jax.numpy.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        if index < 2:
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    opt.set_learning_rate(0.002)
    assert opt.get_learning_rate() == pytest.approx(0.002)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_clamped_adam_bfloat16_moment_matches_optax(weight_decay):
    r"""``mu_dtype="bfloat16"`` against optax's ``scale_by_adam(mu_dtype=
    bfloat16)`` over 50 steps of gradients beyond +-5: the stored first
    moment bit for bit, the parameters within 1e-6."""
    rs = np.random.RandomState(1)
    shapes = [(6, 5), (7,), (3, 4, 2)]
    params = [rs.randn(*shape).astype(np.float32) for shape in shapes]
    tx = make_optimizer(0.01, weight_decay, "bfloat16")
    jp = [jax.numpy.asarray(a) for a in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(a.copy()).requires_grad_(True) for a in params]
    opt = ClampedAdam(tp, 0.01, weight_decay, mu_dtype="bfloat16")
    for step in range(50):
        grads = [(rs.randn(*shape) * 4.0).astype(np.float32) for shape in shapes]
        grads[0][0, :3] = [12.0, -7.5, 5.0]
        updates, state = tx.update([jax.numpy.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        adam = [s for s in state.inner_state if hasattr(s, "mu")][0]
        moments = opt.state_dict()["state"]
        for i, (p, j) in enumerate(zip(tp, jp)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=1e-6, rtol=0)
            mu = moments[i]["exp_avg"]
            assert mu.dtype == torch.bfloat16 and adam.mu[i].dtype == jax.numpy.bfloat16
            np.testing.assert_array_equal(mu.view(torch.int16).numpy(),
                                          np.asarray(adam.mu[i]).view(np.int16))
            np.testing.assert_array_equal(moments[i]["exp_avg_sq"].numpy(), np.asarray(adam.nu[i]))
        assert float(moments[0]["step"]) == int(adam.count) == step + 1
    # A state_dict round trip keeps the moment in bfloat16.
    again = ClampedAdam(tp, 0.01, weight_decay, mu_dtype="bfloat16")
    again.load_state_dict(opt.state_dict())
    assert again.state_dict()["state"][0]["exp_avg"].dtype == torch.bfloat16


def test_trainer_refuses_bfloat16_adam_moment(fixture, tmp_path):
    r"""Once refused, now trained: the program_prior trainer with
    ``OPTIM.ADAM_MU_DTYPE bfloat16`` against the JAX trainer with the same
    setting over three steps: the losses within the float32 trainer's
    tolerance; the parameters within it plus what a bfloat16 moment adds.
    The two runs' gradients differ by float32 rounding, and where a float32
    moment lies at a bfloat16 rounding boundary that difference moves the
    stored moment (and the rounded product b1 * mu) by one bfloat16 ulp,
    2**-8 of its size: up to about 2 * lr * 2**-8 on a parameter each step.
    The first moment is stored in bfloat16, within 1% of optax's."""
    overrides = ["OPTIM.ADAM_MU_DTYPE", "bfloat16"]
    config = Config(fixture["config_path"], overrides)
    jax_config = make_fixture_config(fixture["root"], "program_prior", overrides)
    np.random.seed(0)
    jax_trainer = JaxProgramPriorTrainer(jax_config, str(tmp_path / "jax"))
    port = ProgramPriorTrainer(config, str(tmp_path / "port"), device="cpu",
                               writer=RecordingWriter())
    copy_into(port.params["program_prior"], _port_tree(jax_trainer.params["program_prior"]))
    jax_losses, port_losses, grads = [], [], []
    for iteration in range(STEPS):
        jax_losses.append(float(jax_trainer._do_iteration(next(jax_trainer._batches))["loss"]))
        port_losses.append(port.step(iteration)["loss"])
        grads.append(_flat(jax.tree_util.tree_map(lambda t: t.grad, port.params["program_prior"])))
    np.testing.assert_allclose(port_losses, jax_losses, atol=LOSS_ATOL, rtol=0)
    want = _flat(jax_trainer.params["program_prior"])
    got = _flat(port.params["program_prior"])
    for key, w in want.items():
        smooth = np.min([np.abs(g[key]) for g in grads], axis=0) > GRAD_FLOOR
        np.testing.assert_allclose(got[key][smooth], w[smooth], rtol=0, err_msg=key,
                                   atol=PARAM_ATOL + STEPS * 2 * 0.01 * 2 ** -8)
        np.testing.assert_allclose(got[key], w, atol=2 * 0.01 * STEPS, rtol=0, err_msg=key)
    moments = port._optimizer.state_dict()["state"]
    assert all(m["exp_avg"].dtype == torch.bfloat16 for m in moments.values())
    adam = [s for s in jax_trainer._opt_state.inner_state if hasattr(s, "mu")][0]
    assert all(m.dtype == jax.numpy.bfloat16
               for m in jax.tree_util.tree_leaves(adam.mu["program_prior"]))
    port_mu = _flat(interop._tree_like(port.params["program_prior"], [
        moments[i]["exp_avg"].float() for i in range(len(moments))]))
    for key, m in _flat(_port_tree(adam.mu["program_prior"])).items():
        np.testing.assert_allclose(port_mu[key], m, atol=0.01 * np.abs(m).max() + 1e-6, rtol=0,
                                   err_msg=key)
    # The port's own checkpoint keeps the moment in bfloat16, bit for bit.
    port._checkpoint_manager.step(STEPS - 1, port._checkpointables())
    resumed = ProgramPriorTrainer(config, str(tmp_path / "resumed"), device="cpu",
                                  writer=RecordingWriter())
    resumed.load_checkpoint(str(tmp_path / "port" / f"checkpoint_{STEPS - 1}.ckpt"))
    for index, state in resumed._optimizer.state_dict()["state"].items():
        assert state["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(state["exp_avg"], moments[index]["exp_avg"])


def test_token_ids_outside_the_vocabulary_are_refused(fixture, tmp_path):
    programs = ProgramPriorDataset(fixture["jax_config"].DATA.TRAIN_TOKENS).get_batch(
        np.arange(8))["program"]
    programs[5, 0] = 10_000
    bad = ProgramPriorDataset.from_programs(programs)
    with pytest.raises(ValueError, match="program 5"):
        ProgramPriorTrainer(fixture["config"], str(tmp_path), device="cpu",
                            writer=RecordingWriter(), dataset=bad)
    programs[5, 0] = -1
    with pytest.raises(ValueError, match="outside"):
        ProgramPriorDataset.from_programs(programs, split="val").check_tokens(10_001)


def test_plateau_scheduler_matches_jax_with_negative_metrics():
    metrics = [-0.5, -0.6, -0.4995, -0.4996, -0.3, -0.3, -0.3, -0.3, -0.3, 0.2, 0.2, 0.2, 0.2,
               0.2, 0.2001, 0.2003, 0.1, 0.1, 0.1]
    port, ref = ReduceLROnPlateau(0.01, 0.5, 2), JaxReduceLROnPlateau(0.01, 0.5, 2)
    lrs = []
    for m in metrics:
        lrs.append(port.step(m))
        assert lrs[-1] == ref.step(m)
        assert port.state_dict() == ref.state_dict()
    assert len(set(lrs)) > 2  # the lr was cut more than once
    restored = ReduceLROnPlateau(1.0, 0.1, 9)
    restored.load_state_dict(port.state_dict())
    assert restored.state_dict() == port.state_dict()


def test_data_path_matches_jax(fixture):
    path = fixture["jax_config"].DATA.TRAIN_TOKENS
    port_set, jax_set = ProgramPriorDataset(path), JaxProgramPriorDataset(path)
    assert len(port_set) == len(jax_set) == 40 and port_set.split == "train"
    port_batches = iter(BatchIterator(port_set, RandomSampler(len(port_set), seed=3), 8,
                                      device="cpu"))
    jax_batches = iter(JaxBatchIterator(jax_set, JaxRandomSampler(len(jax_set), seed=3), 8,
                                        device_put=False))
    for _ in range(7):  # 5 batches an epoch: crosses an epoch boundary
        got, want = next(port_batches), next(jax_batches)
        assert isinstance(got["program"], torch.Tensor)
        np.testing.assert_array_equal(got["program"].numpy(), want["program"])
    memory = ProgramPriorDataset.from_programs(port_set.get_batch(np.arange(20))["program"])
    got = [b["program"].numpy() for b in EpochIterator(memory, 8, device="cpu")]
    want = [b["program"] for b in JaxEpochIterator(
        JaxProgramPriorDataset(path), 8, device_put=False)][:2]
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.array_equal(SequentialSampler(5).epoch(), np.arange(5))


def test_train_cli_runs_on_the_cpu(fixture, tmp_path):
    out = str(tmp_path / "cli_run")
    args = train.parser.parse_args([
        "--phase", "program_prior", "--config-yml", fixture["config_path"],
        "--config-override", "OPTIM.NUM_ITERATIONS", "2",
        "--device", "cpu", "--serialization-dir", out,
        "--checkpoint-every", "2", "--num-val-batches", "1",
    ])
    train.main(args)
    assert sorted(os.listdir(out))[:3] == ["checkpoint_1.ckpt", "checkpoint_best.ckpt",
                                           "config.yml"]
    assert Config(os.path.join(out, "config.yml")).OPTIM.NUM_ITERATIONS == 2
