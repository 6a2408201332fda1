"""The port's joint_training phase against the JAX package's, in float32 on the CPU.

At the small NMN spec of tests/test_torch_port_module_training.py (C = 8 on
6 x 6) over PROGRAM_CASES (every module kind, invalid paths) and an all-pad
row:

- K6's plain version, the CPU path of both of its modes, against JAX
  ``_execute_bwd_pallas(..., interpret=True)`` in replay mode (no residuals),
  at test_nmn_pallas.py's tolerances (d_stem 2e-5 abs / 1e-4 rel, banks
  5e-5 abs / 1e-3 rel);
- ``execute_programs_diff`` with the replay selected, by ``replay=True`` and
  by ``PROBNMN_NMN_REPLAY_BWD=1``: every gradient routed as autograd through
  the plain machine routes it, equal to the no-replay call's, and its forward
  through K2's wrapper, not K5's.

On tests/clevr_fixtures.py, with the generator, reconstructor, NMN and prior
saved both as the JAX package's checkpoints and as the port's:
``JointTrainingDataset`` against JAX's (train and test splits);
``joint_training_objective`` at a shared z against a JAX composition of
``seq2seq_forward``, ``fused_tf_loss`` (REINFORCE mode, interpret),
``nmn_forward``, ``program_prior_forward``, ``joint_training_reward`` and
``elbo_with_reinforce`` for both OBJECTIVEs and both empty subsets (total
and logs within 1e-5, baseline within 1e-6, NMN gradients within 5e-5 /
1e-3, seq2seq leaves within 5e-6 of their scale); three trainer steps
against the JAX trainer with both samplers replaced by fixed programs; the
evaluator in both decode modes against the JAX evaluator; resume; each
frozen model read from a JAX ``.ckpt`` and a reference ``.pth``; the CLI
with ``--device cpu``."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.data.datasets import JointTrainingDataset as JaxJointTrainingDataset
from probnmn_tpu.data.pipeline import image_to_nhwc as jax_image_to_nhwc
from probnmn_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from probnmn_tpu.evaluators.joint_training_evaluator import (
    JointTrainingEvaluator as JaxJointTrainingEvaluator,
)
from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.models import program_generator as jprogram_generator
from probnmn_tpu.models import question_reconstructor as jquestion_reconstructor
from probnmn_tpu.models import seq2seq as jseq2seq
from probnmn_tpu.models.program_prior import init_program_prior_params, program_prior_forward
from probnmn_tpu.modules import elbo as jelbo
from probnmn_tpu.ops.pallas import nmn_interpreter as jni
from probnmn_tpu.ops.pallas.seq2seq_train import fused_tf_loss as jax_fused_tf_loss
from probnmn_tpu.training import joint_training_trainer as jax_jt_module
from probnmn_tpu.training.program_prior_trainer import make_prior_spec as jax_make_prior_spec
from probnmn_tpu.utils import torch_interop as jax_torch_interop
from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
from probnmn_tpu_torch import interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import JointTrainingDataset
from probnmn_tpu_torch.evaluators.joint_training_evaluator import JointTrainingEvaluator
from probnmn_tpu_torch.ops.kernels import nmn_interpreter as ni
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    DIFF_BANKS,
    build_banks,
    build_tables,
    execute_programs_diff,
    execute_programs_kernel,
    execute_programs_plain,
    interpreter_grads_kernel,
)
from probnmn_tpu_torch.training._trainer import copy_into
from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer
from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY
from probnmn_tpu_torch.utils.checkpointing import save_objects
from probnmn_tpu_torch.utils.observability import RecordingWriter

from tests import ref_checkpoints
from tests.clevr_fixtures import PROGRAM_TEMPLATES, build_fixture_data, make_fixture_config
from tests.test_nmn import EXPECTED_INVALID
from tests.test_torch_port_module_training import (  # noqa: F401 (small is a fixture)
    BANK_TOL,
    STEM_TOL,
    _jax_banks_as_port,
    _to_numpy,
    small,
)

LOG_TOL = 1e-5
SEQ_GRAD_TOL = 5e-6
# JAX's fused_tf_loss, which gives the REINFORCE-mode loss at z on the JAX
# side, ties the seq2seq hidden size to the input size.
TIED = ["PROGRAM_GENERATOR.HIDDEN_SIZE", 16, "QUESTION_RECONSTRUCTOR.HIDDEN_SIZE", 16]


# ------------------------------------------------------------------ K6's replay mode --
def test_plain_backward_matches_jax_replay_mode(small):
    s = small
    stem = torch.from_numpy(np.asarray(s["jstem"]))
    programs = torch.from_numpy(s["programs"])
    g_final = np.random.RandomState(4).randn(*stem.shape).astype(np.float32)
    _, jinvalid = jni.execute_programs_pallas(s["jbanks"], s["jtables"], None, s["jstem"],
                                              jnp.asarray(s["programs"]), interpret=True)
    jd_banks, jd_stem = jni._execute_bwd_pallas(
        s["jbanks"], s["jtables"], s["jstem"], jnp.asarray(s["programs"]), jinvalid,
        jnp.asarray(g_final), interpret=True)
    _, invalid = execute_programs_kernel(s["banks"], s["tables"], s["spec"], stem, programs)
    np.testing.assert_array_equal(invalid.numpy(), np.asarray(jinvalid))
    before = (interpreter_grads_kernel.launches, interpreter_grads_kernel.replay_launches)
    d_banks, d_stem = interpreter_grads_kernel(s["banks"], s["tables"], s["spec"], stem, programs,
                                               invalid, torch.from_numpy(g_final))
    assert (interpreter_grads_kernel.launches,
            interpreter_grads_kernel.replay_launches) == before  # no kernel on the CPU
    np.testing.assert_allclose(d_stem.numpy(), np.asarray(jd_stem), **STEM_TOL)
    assert (d_stem.numpy()[np.asarray(EXPECTED_INVALID + [0]) == 1] == 0).all()
    want = _jax_banks_as_port(jd_banks, s["spec"].module_channels)
    for key in DIFF_BANKS:
        np.testing.assert_allclose(d_banks[key].numpy(), want[key], err_msg=key, **BANK_TOL)
        assert np.abs(want[key]).max() > 0, key  # every bank takes a gradient here
    with pytest.raises(ValueError, match="both"):
        interpreter_grads_kernel(s["banks"], s["tables"], s["spec"], stem, programs, invalid,
                                 torch.from_numpy(g_final), otraj=torch.zeros(1))


@pytest.mark.parametrize("select", ["argument", "environment"])
def test_replay_mode_routes_every_gradient(small, monkeypatch, select):
    r"""With the replay selected the forward goes through K2's wrapper (no
    residuals) and the backward through K6's without them; the gradients
    equal the no-replay call's, and autograd's through the plain machine."""
    s = small
    programs = torch.from_numpy(s["programs"])
    g = torch.from_numpy(np.random.RandomState(5).randn(len(s["programs"]), 6, 6, 8)
                         .astype(np.float32))
    calls = []

    def recording(name, fn, residuals_at=None):
        def wrapper(*args, **kwargs):
            calls.append(name if residuals_at is None
                         else (name, args[residuals_at] is not None))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ni, "execute_programs_kernel", recording("K2", ni.execute_programs_kernel))
    monkeypatch.setattr(ni, "execute_programs_train_kernel",
                        recording("K5", ni.execute_programs_train_kernel))
    monkeypatch.setattr(ni, "interpreter_grads_kernel",
                        recording("K6", ni.interpreter_grads_kernel, residuals_at=7))
    if select == "environment":
        monkeypatch.setenv("PROBNMN_NMN_REPLAY_BWD", "1")
        replay = None
    else:
        monkeypatch.delenv("PROBNMN_NMN_REPLAY_BWD", raising=False)
        replay = True

    def grads(forward):
        params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), s["params"])
        stem = torch.from_numpy(np.asarray(s["jstem"])).requires_grad_(True)
        final, _ = forward(build_banks(params, s["spec"], torch.float32), build_tables(s["spec"]),
                           s["spec"], stem, programs)
        (final * g).sum().backward()
        leaves = [p.grad for p in jax.tree_util.tree_leaves(
            {k: params[k] for k in ("attention", "query", "relate", "same", "compare")})]
        return [stem.grad] + leaves

    got = grads(lambda *args: execute_programs_diff(*args, replay=replay))
    assert calls == ["K2", ("K6", False)]
    calls.clear()
    no_replay = grads(lambda *args: execute_programs_diff(*args, replay=False))
    assert calls == ["K5", ("K6", True)]
    for a, b in zip(got, no_replay):
        assert torch.equal(a, b)
    for a, b in zip(got, grads(execute_programs_plain)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ the phase --------
@pytest.fixture(scope="module")
def jt(tmp_path_factory):
    r"""Fixture data; the generator, reconstructor, NMN and prior saved as the
    JAX package's msgpack checkpoints (for the JAX trainer) and as the
    port's; one fixed (B, 10) array of valid programs for both samplers."""
    root = str(tmp_path_factory.mktemp("jt_port"))
    jvocab = build_fixture_data(root)
    jax_config = make_fixture_config(root, "joint_training", TIED)
    pg_spec = jprogram_generator.make_spec(jvocab, jax_config)
    qr_spec = jquestion_reconstructor.make_spec(jvocab, jax_config)
    nmn_spec = jnmn.make_spec(jvocab, jax_config)
    prior_spec = jax_make_prior_spec(jax_config, jvocab)
    keys = jax.random.split(jax.random.PRNGKey(21), 4)
    pg = jprogram_generator.init_params(keys[0], pg_spec)
    qr = jquestion_reconstructor.init_params(keys[1], qr_spec)
    nmn_params = jnmn.init_nmn_params(keys[2], nmn_spec)
    prior = init_program_prior_params(keys[3], prior_spec)
    jax_save_objects(jax_config.CHECKPOINTS.QUESTION_CODING,
                     {"program_generator": pg, "question_reconstructor": qr})
    jax_save_objects(jax_config.CHECKPOINTS.MODULE_TRAINING, {"nmn": nmn_params})
    jax_save_objects(jax_config.CHECKPOINTS.PROGRAM_PRIOR, {"program_prior": prior})
    path = os.path.join(root, "joint_training.yml")
    jax_config.dump(path)

    from probnmn_tpu_torch.data.vocabulary import Vocabulary
    from probnmn_tpu_torch.models import nmn

    port_nmn_spec = nmn.make_spec(Vocabulary.from_files(jax_config.DATA.VOCABULARY),
                                  Config(path))
    port = {name: os.path.join(root, f"{name}_port.ckpt")
            for name in ("question_coding", "module_training", "program_prior")}
    save_objects(port["question_coding"], {
        "program_generator": interop.program_generator_from_jax(_to_numpy(pg)),
        "question_reconstructor": interop.question_reconstructor_from_jax(_to_numpy(qr))})
    save_objects(port["module_training"],
                 {"nmn": interop.nmn_from_jax(_to_numpy(nmn_params), port_nmn_spec)})
    save_objects(port["program_prior"],
                 {"program_prior": interop.program_prior_from_jax(_to_numpy(prior))})
    overrides = ["CHECKPOINTS.QUESTION_CODING", port["question_coding"],
                 "CHECKPOINTS.MODULE_TRAINING", port["module_training"],
                 "CHECKPOINTS.PROGRAM_PRIOR", port["program_prior"]]

    def configs(objective):
        jax_cfg = make_fixture_config(root, "joint_training", TIED + ["OBJECTIVE", objective])
        cfg_path = os.path.join(root, f"joint_training_{objective}.yml")
        jax_cfg.dump(cfg_path)
        return jax_cfg, Config(cfg_path, overrides), cfg_path

    programs = np.zeros((jax_config.OPTIM.BATCH_SIZE, 10), np.int64)
    for i in range(len(programs)):
        ids = [jvocab.get_token_index(t, "programs")
               for t in PROGRAM_TEMPLATES[i % len(PROGRAM_TEMPLATES)]]
        programs[i, :len(ids)] = ids
    return dict(root=root, configs=configs, overrides=overrides, port=port, prior=prior,
                prior_spec=prior_spec, programs=programs, pg=pg, qr=qr, nmn=nmn_params,
                specs={"program_generator": pg_spec, "question_reconstructor": qr_spec,
                       "nmn": nmn_spec, "program_prior": prior_spec}, jvocab=jvocab)


def _port_trainer(config, directory, **kwargs):
    np.random.seed(config.RANDOM_SEED)  # the supervision subset, as the CLI seeds it
    return JointTrainingTrainer(config, directory, device="cpu", writer=RecordingWriter(),
                                **kwargs)


def _jax_specs(trainer):
    def convert(spec):
        return jseq2seq.Seq2SeqSpec(**{f: getattr(spec, f) for f in spec.__dataclass_fields__})

    return convert(trainer.pg_spec), convert(trainer.qr_spec)


def _port_as_jax_layout(tree):
    r"""A port param (or gradient) tree as numpy, the NMN stem's OIHW convs
    in JAX's HWIO layout."""
    out = _to_numpy(tree)
    if "nmn" in out:
        for name in ("w1", "w2"):
            out["nmn"]["stem"][name] = out["nmn"]["stem"][name].transpose(2, 3, 1, 0)
    return out


def _jax_objective(jparams, pg_spec, qr_spec, nmn_spec, jt, batch, z_full, baseline, c):
    r"""The JAX trainer's loss function (its full-batch path: supervision
    masks over the whole batch), z given: PG's REINFORCE-mode loss at z
    through interpret-mode ``fused_tf_loss``, the teacher-forced passes
    through ``seq2seq_forward``, the NMN through ``nmn_forward``."""
    q, prog = jnp.asarray(batch["question"]), jnp.asarray(batch["program"])
    sup = jnp.asarray(batch["supervision"]).astype(jnp.float32)
    unsup = 1.0 - sup
    z = jnp.asarray(z_full)
    image = jax_image_to_nhwc(jnp.asarray(batch["image"]))
    answer = jnp.asarray(batch["answer"])

    def tf_loss(p, spec, src, tgt):
        return jseq2seq.seq2seq_forward(p, spec, src, tgt, jseq2seq.GREEDY)["loss"]

    def loss_fn(p):
        pg_loss = jax_fused_tf_loss(p["program_generator"], pg_spec, q, z, True, jnp.float32, 4,
                                    True)
        nmn_out = jnmn.nmn_forward(p["nmn"], nmn_spec, image, z, answer)
        nmn_loss = jelbo.masked_mean(nmn_out["loss"], unsup)
        logprobs_answering = -nmn_out["loss"]
        if c.OBJECTIVE == "baseline":
            term, new_baseline = jelbo.reinforce(pg_loss, logprobs_answering, baseline, c.DELTA,
                                                 mask=unsup)
            elbo_value = jelbo.masked_mean(term, unsup)
            logs = {"loss": {"nmn": nmn_loss},
                    "elbo": {"elbo": elbo_value,
                             "reinforce_reward": jelbo.masked_mean(logprobs_answering, unsup)}}
            return c.GAMMA * nmn_loss - elbo_value, (new_baseline, logs)
        rec = -tf_loss(p["question_reconstructor"], qr_spec, z, q)
        log_prior = -program_prior_forward(jt["prior"], jt["prior_spec"], z,
                                           jax.random.PRNGKey(0))["loss"]
        reward = jelbo.joint_training_reward(rec, -pg_loss, log_prior, logprobs_answering,
                                             c.BETA, c.GAMMA)
        diagnostics, new_baseline = jelbo.elbo_with_reinforce(
            -pg_loss, rec, reward, baseline, c.BETA, c.DELTA, mask=unsup)
        elbo_value = diagnostics.pop("elbo")
        diagnostics.pop("elbo_per_example")
        pg_sup = jelbo.masked_mean(tf_loss(p["program_generator"], pg_spec, q, prog), sup)
        qr_sup = jelbo.masked_mean(tf_loss(p["question_reconstructor"], qr_spec, prog, q), sup)
        logs = {"loss": {"nmn": nmn_loss, "question_reconstruction_gt": qr_sup,
                         "program_generation_gt": pg_sup},
                "elbo": dict(diagnostics, elbo=elbo_value)}
        return c.GAMMA * nmn_loss - elbo_value + c.ALPHA * (pg_sup + qr_sup), (new_baseline, logs)

    return jax.value_and_grad(loss_fn, has_aux=True)(jparams)


@pytest.mark.parametrize("objective, subsets", [
    ("ours", "mixed"), ("baseline", "mixed"), ("ours", "all_supervised"),
    ("ours", "none_supervised"),
])
def test_objective_at_a_shared_z_matches_the_jax_composition(jt, tmp_path, objective, subsets):
    jax_config, config, _ = jt["configs"](objective)
    trainer = _port_trainer(config, str(tmp_path))
    batch = dict(next(trainer._batches))
    size = config.OPTIM.BATCH_SIZE
    if subsets != "mixed":
        n_sup = size if subsets == "all_supervised" else 0
        batch["supervision"] = torch.full((size,), int(n_sup > 0), dtype=torch.int64)
        batch[COUNT_KEY] = n_sup
    n_sup = batch[COUNT_KEY]
    if subsets == "mixed":
        assert 0 < n_sup < size
    z_full = jt["programs"].copy()
    z_full[:n_sup] = 0
    z_full[-1] = 0  # an all-pad program: valid, the stem features pass through
    z = torch.from_numpy(z_full[n_sup:]) if n_sup < size else None
    baseline = torch.tensor(0.25)
    params = trainer.params
    total, new_baseline, logs = trainer.joint_training_objective(params, batch, z, baseline)
    if total.requires_grad:
        total.backward()

    jparams = jax.tree_util.tree_map(jnp.asarray, _port_as_jax_layout(params))
    np_batch = {k: v.numpy() for k, v in batch.items() if not k.startswith("_")}
    (want_total, (want_baseline, want_logs)), want_grads = _jax_objective(
        jparams, *_jax_specs(trainer), jnmn.make_spec(JaxVocabulary.from_files(
            jax_config.DATA.VOCABULARY), jax_config), jt, np_batch, z_full, jnp.float32(0.25),
        jax_config)
    np.testing.assert_allclose(float(total.detach()), float(want_total), atol=LOG_TOL,
                               rtol=LOG_TOL)
    np.testing.assert_allclose(float(new_baseline), float(want_baseline), atol=1e-6, rtol=0)
    assert (float(new_baseline) == 0.25) == (subsets == "all_supervised")
    assert sorted(logs) == sorted(want_logs)
    for group, values in want_logs.items():
        assert sorted(logs[group]) == sorted(values), group
        for key, value in values.items():
            np.testing.assert_allclose(float(logs[group][key]), float(value), atol=LOG_TOL,
                                       rtol=LOG_TOL, err_msg=f"{group}/{key}")
    grads = jax.tree_util.tree_map(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t), params)
    grads = _port_as_jax_layout(grads)
    for name in ("program_generator", "question_reconstructor"):
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_grads[name])[0],
                                jax.tree_util.tree_leaves(grads[name])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, atol=SEQ_GRAD_TOL * max(1.0, float(np.abs(w).max())),
                                       rtol=0, err_msg=f"{name}{jax.tree_util.keystr(path)}")
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_grads["nmn"])[0],
                            jax.tree_util.tree_leaves(grads["nmn"])):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"nmn{jax.tree_util.keystr(path)}",
                                   **BANK_TOL)
    if subsets != "all_supervised":
        assert np.abs(grads["nmn"]["relate"]["conv1"]["w"]).max() > 0


@pytest.fixture(scope="module")
def runs(jt, tmp_path_factory):
    r"""The JAX and the port trainer from the same params and sampler seed,
    three steps each on the same batches at the same programs. The JAX
    trainer's free-running generator call returns the REINFORCE-mode loss
    at the fixed programs (what ``test_reinforce_mode_is_the_free_running_loss_at_z``
    shows its sampler would give had it drawn them); its other calls pass
    through."""
    jax_config, config, _ = jt["configs"]("ours")
    fixed = jt["programs"]
    original = jax_jt_module.seq2seq_forward

    def sampled_at_fixed(params, spec, source, target=None, *args, **kwargs):
        if target is not None:
            return original(params, spec, source, target, *args, **kwargs)
        z = jnp.asarray(fixed[-source.shape[0]:])
        loss = jax_fused_tf_loss(params, spec, source, z, True, jnp.float32, 4, True)
        return {"loss": loss, "predictions": z}

    jax_jt_module.seq2seq_forward = sampled_at_fixed
    try:
        np.random.seed(config.RANDOM_SEED)
        jax_trainer = jax_jt_module.JointTrainingTrainer(
            jax_config, str(tmp_path_factory.mktemp("jax_jt")))
        port = _port_trainer(config, str(tmp_path_factory.mktemp("port_jt")))
        port.sample_programs = lambda questions: torch.from_numpy(fixed[-len(questions):])
        jax_logs, port_logs, baselines, grads, first_params = [], [], [], [], None
        for iteration in range(3):
            jax_logs.append(jax.tree_util.tree_map(float, jax_trainer._do_iteration(
                next(jax_trainer._batches))))
            jax_trainer._iteration = iteration
            port_logs.append(port.step(iteration))
            baselines.append((float(port.baseline), float(jax_trainer._baseline)))
            grads.append(_port_as_jax_layout(jax.tree_util.tree_map(lambda t: t.grad,
                                                                    port.params)))
            if iteration == 0:
                first_params = (_port_as_jax_layout(port.params),
                                jax.tree_util.tree_map(np.asarray, jax_trainer.params))
    finally:
        jax_jt_module.seq2seq_forward = original
    return dict(jax_config=jax_config, config=config, jax_trainer=jax_trainer, port=port,
                jax_logs=jax_logs, port_logs=port_logs, baselines=baselines, grads=grads,
                first_params=first_params)


def test_three_steps_match_the_jax_trainer(runs):
    for got, want in zip(runs["port_logs"], runs["jax_logs"]):
        assert sorted(got) == sorted(want) == ["elbo", "loss"]
        for group, values in want.items():
            assert sorted(got[group]) == sorted(values), group
            for key, value in values.items():
                np.testing.assert_allclose(got[group][key], value, atol=LOG_TOL, rtol=0,
                                           err_msg=f"{group}/{key}")
    for got, want in runs["baselines"]:
        assert got == pytest.approx(want, abs=1e-6)
    assert runs["baselines"][-1][0] != 0.0
    # As tests/test_torch_port_module_training.py: after one step the params
    # agree within 1e-6 wherever |g| clears the float32 noise of the
    # plateau (Adam's first step is about lr * sign(g)); after three steps
    # every param within 2 lr a step (ROADMAP.md section 3).
    lr, steps, compared, total = runs["config"].OPTIM.LR_INITIAL, 3, 0, 0
    first_got, first_want = (jax.tree_util.tree_leaves(t) for t in runs["first_params"])
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, runs["jax_trainer"].params))[0]
    got = jax.tree_util.tree_leaves(_port_as_jax_layout(runs["port"].params))
    first_grads = jax.tree_util.tree_leaves(runs["grads"][0])
    assert len(got) == len(want) == len(first_got) == len(first_grads)
    for index, ((path, w), g) in enumerate(zip(want, got)):
        key = jax.tree_util.keystr(path)
        smooth = np.abs(first_grads[index]) > 1e-5
        np.testing.assert_allclose(first_got[index][smooth], first_want[index][smooth], atol=1e-6,
                                   rtol=0, err_msg=key)
        np.testing.assert_allclose(g, w, atol=2 * lr * steps, rtol=0, err_msg=key)
        compared += int(smooth.sum())
        total += w.size
    assert compared > 0.4 * total


def _copy_jax_params(port, jax_trainer):
    jp = jax.tree_util.tree_map(np.asarray, jax_trainer.params)
    copy_into(port.params["program_generator"],
              interop.program_generator_from_jax(jp["program_generator"]))
    copy_into(port.params["question_reconstructor"],
              interop.question_reconstructor_from_jax(jp["question_reconstructor"]))
    copy_into(port.params["nmn"], interop.nmn_from_jax(jp["nmn"], port.nmn_spec))


@pytest.mark.parametrize("decode", ["tf_greedy", "free_greedy"])
def test_evaluator_matches_the_jax_evaluator(runs, decode):
    port, jax_trainer = runs["port"], runs["jax_trainer"]
    _copy_jax_params(port, jax_trainer)
    want = JaxJointTrainingEvaluator(runs["jax_config"], jax_trainer,
                                     program_decode=decode).evaluate(num_batches=2)
    before = execute_programs_kernel.launches
    got = JointTrainingEvaluator(runs["config"], port, program_decode=decode).evaluate(
        num_batches=2)
    assert execute_programs_kernel.launches == before  # the plain K2 on the CPU
    assert sorted(got) == sorted(want) == ["nmn", "program_generator", "question_reconstructor"]
    assert got["question_reconstructor"] == want["question_reconstructor"] == {}
    assert sorted(got["program_generator"]) == sorted(want["program_generator"]) == [
        "BLEU", "perplexity", "sequence_accuracy", "word_error_rate"]
    for key, value in want["program_generator"].items():
        np.testing.assert_allclose(got["program_generator"][key], value, rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    assert sorted(got["nmn"]) == sorted(want["nmn"]) == ["answer_accuracy", "average_invalid"]
    for key, value in want["nmn"].items():
        assert got["nmn"][key] == pytest.approx(value, abs=1e-12), key
    port.after_validation(got, 2)
    assert port.learning_rate == pytest.approx(runs["config"].OPTIM.LR_INITIAL)
    with pytest.raises(ValueError, match="program_decode"):
        JointTrainingEvaluator(runs["config"], port, program_decode="beam")


def test_checkpoint_resumes_params_and_baseline(runs, tmp_path):
    port = runs["port"]
    port._checkpoint_manager.serialization_dir = tmp_path
    port.after_validation({"program_generator": {}, "question_reconstructor": {},
                           "nmn": {"answer_accuracy": 0.5, "average_invalid": 0.0}}, 7)
    resumed = _port_trainer(runs["config"], str(tmp_path))
    resumed.load_checkpoint(str(tmp_path / "checkpoint_7.ckpt"))
    assert resumed.iteration == 7
    assert torch.equal(resumed.baseline, port.baseline) and float(port.baseline) != 0.0
    for a, b in zip(jax.tree_util.tree_leaves(_to_numpy(resumed.params)),
                    jax.tree_util.tree_leaves(_to_numpy(port.params))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("checkpoint", ["PROGRAM_PRIOR", "QUESTION_CODING", "MODULE_TRAINING"])
def test_trainer_refuses_jax_and_reference_checkpoints(jt, tmp_path, checkpoint):
    r"""Each frozen or starting model loads from the JAX package's ``.ckpt``
    equal to the JAX params, and from a reference ``.pth`` equal to the JAX
    package's port of it."""
    jax_config, _, path = jt["configs"]("ours")
    names = {"PROGRAM_PRIOR": ["program_prior"],
             "QUESTION_CODING": ["program_generator", "question_reconstructor"],
             "MODULE_TRAINING": ["nmn"]}[checkpoint]
    specs = {name: jt["specs"][name] for name in names}
    states = {
        "program_prior": lambda s: ref_checkpoints.make_prior_state(
            s.vocab_size, s.input_size, s.hidden_size, s.num_layers, 1),
        "program_generator": lambda s: ref_checkpoints.make_seq2seq_state(
            s.source_vocab_size, s.target_vocab_size, s.input_size, s.hidden_size,
            s.num_layers, 2),
        "question_reconstructor": lambda s: ref_checkpoints.make_seq2seq_state(
            s.source_vocab_size, s.target_vocab_size, s.input_size, s.hidden_size,
            s.num_layers, 3),
        "nmn": lambda s: ref_checkpoints.make_nmn_state(jt["jvocab"], s, 4),
    }
    pth = str(tmp_path / "model.pth")
    ref_checkpoints.save_reference_pth(pth, {name: states[name](specs[name]) for name in names})
    ported = jax_torch_interop.load_reference_checkpoint(pth, specs, jt["jvocab"])
    jax_params = {"program_prior": jt["prior"], "program_generator": jt["pg"],
                  "question_reconstructor": jt["qr"], "nmn": jt["nmn"]}
    for source, want in ((getattr(jax_config.CHECKPOINTS, checkpoint), jax_params),
                         (pth, ported)):
        overrides = list(jt["overrides"])
        overrides[overrides.index(f"CHECKPOINTS.{checkpoint}") + 1] = source
        trainer = _port_trainer(Config(path, overrides), str(tmp_path))
        for name in names:
            got = trainer.prior_params if name == "program_prior" else trainer.params[name]
            expected = _to_numpy(want[name])
            if name == "nmn":
                expected = _to_numpy(interop.nmn_from_jax(expected, trainer.nmn_spec))
            got = _to_numpy(got)
            assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(np.shape, got))
                    == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.shape, expected)))
            for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(expected)):
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_dataset_matches_jax(jt):
    jax_config, _, _ = jt["configs"]("ours")
    data = jax_config.DATA
    indices = np.array([13, 3, 3, 15, 0, 12, 9, 5])  # the test split has 16 rows
    for tokens, features, keys in (
        (data.TRAIN_TOKENS, data.TRAIN_FEATURES,
         ["answer", "image", "program", "question", "supervision"]),
        (data.TEST_TOKENS, data.TEST_FEATURES, ["image", "question", "question_index"]),
    ):
        np.random.seed(0)
        port_set = JointTrainingDataset(tokens, features, 12, 10)
        np.random.seed(0)
        jax_set = JaxJointTrainingDataset(tokens, features, 12, 10)
        np.random.seed(0)
        stream_set = JointTrainingDataset(tokens, features, 12, 10, in_memory=False)
        assert port_set.split == jax_set.split and len(port_set) == len(jax_set)
        np.testing.assert_array_equal(port_set.get_supervision_list(),
                                      jax_set.get_supervision_list())
        want = jax_set.get_batch(indices)
        for dataset in (port_set, stream_set):
            got = dataset.get_batch(indices)
            assert sorted(got) == sorted(want) == keys
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert port_set.split == "test" and port_set.get_supervision_list().sum() == len(port_set)
    np.random.seed(0)
    train_set = JointTrainingDataset(data.TRAIN_TOKENS, data.TRAIN_FEATURES, 12, 10)
    assert train_set.get_supervision_list().sum() == 12
    np.random.seed(0)
    arrays = JointTrainingDataset.from_arrays(
        train_set._programs, train_set._questions, train_set._answers, train_set._image_indices,
        train_set._features.features, num_supervision=12, supervision_question_max_length=10)
    for key, value in arrays.get_batch(indices).items():
        np.testing.assert_array_equal(value, train_set.get_batch(indices)[key], err_msg=key)
    with pytest.raises(ValueError, match="val program 0"):
        JointTrainingDataset.from_arrays(train_set._programs + 100, train_set._questions,
                                         train_set._answers, train_set._image_indices,
                                         train_set._features.features,
                                         split="val").check_tokens(50, 50)


@pytest.mark.parametrize("objective", ["ours", "baseline"])
def test_train_cli_runs_joint_training_on_the_cpu(jt, tmp_path, objective):
    _, _, config_path = jt["configs"](objective)
    out = str(tmp_path / "cli_jt")
    args = train.parser.parse_args([
        "--phase", "joint_training", "--config-yml", config_path,
        "--config-override", "OPTIM.NUM_ITERATIONS", "2", *jt["overrides"],
        "--device", "cpu", "--serialization-dir", out,
        "--checkpoint-every", "2", "--num-val-batches", "1",
    ])
    train.main(args)
    assert sorted(os.listdir(out))[:3] == ["checkpoint_1.ckpt", "checkpoint_best.ckpt",
                                           "config.yml"]
