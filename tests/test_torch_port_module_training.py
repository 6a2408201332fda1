"""The port's module_training phase against the JAX package's, in float32 on the CPU.

At the small spec of test_nmn_pallas.py (C = 8 on 6 x 6, 12 feature channels)
over PROGRAM_CASES (every module kind and invalid paths) plus an all-pad row:

- K5's plain version (``execute_programs_train_kernel`` on CPU tensors)
  against JAX ``_execute_train_fwd_pallas(..., interpret=True)``: flags
  equal, final within 1e-5, and the residuals ``otraj`` / ``atraj`` (the same
  layout) within 1e-5 on every step a valid row ran;
- K6's plain version against JAX ``_execute_bwd_pallas(..., interpret=True,
  otraj=..., atraj=...)`` under the same numpy-seeded cotangent, and the port's
  ``nmn_forward_fast`` gradients against ``jax.grad`` of JAX
  ``nmn_forward_fast(..., interpret=True)`` and, on random token soups, of
  the XLA machine ``nmn_forward``. The loss agrees within 1e-5 relative; the
  leaves within test_nmn_pallas.py's tolerances (d_stem 2e-5 abs / 1e-4 rel,
  banks 5e-5 abs / 1e-3 rel), which are absolute on the leaves that sit on
  the random-init plateau near 1e-5 (ROADMAP.md section 3).

On tests/clevr_fixtures.py: three ``ModuleTrainingTrainer`` steps against the
JAX trainer with both samplers replaced by one fixed array of valid programs
(losses within 1e-5, params within the Adam bound of ROADMAP.md section 3);
the evaluator in both decode modes against the JAX evaluator; the streaming
features reader against the in-memory one; the data path and
``BooleanAccuracy`` against JAX; the CLI with ``--device cpu``, with and
without ``--streaming-features``."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.data.datasets import ModuleTrainingDataset as JaxModuleTrainingDataset
from probnmn_tpu.data.pipeline import image_to_nhwc
from probnmn_tpu.data.vocabulary import SPECIAL_TOKENS as J_SPECIAL_TOKENS
from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu.evaluators.module_training_evaluator import (
    ModuleTrainingEvaluator as JaxModuleTrainingEvaluator,
)
from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.models import program_generator as jprogram_generator
from probnmn_tpu.ops.pallas import nmn_interpreter as jni
from probnmn_tpu.training import module_training_trainer as jax_mt_module
from probnmn_tpu.utils import metrics as jmetrics
from probnmn_tpu.utils import torch_interop as jax_torch_interop
from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
from probnmn_tpu_torch import interop, train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import ModuleTrainingDataset
from probnmn_tpu_torch.data.readers import ClevrImageFeaturesReader
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.evaluators.module_training_evaluator import ModuleTrainingEvaluator
from probnmn_tpu_torch.models import nmn
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    COMPARE,
    DIFF_BANKS,
    RELATE,
    build_banks,
    build_tables,
    execute_programs_diff,
    execute_programs_kernel,
    execute_programs_plain,
    execute_programs_train_kernel,
    interpreter_grads_kernel,
    interpreter_grads_on_branch,
    interpreter_grads_plain,
    workspace_errors,
)
from probnmn_tpu_torch.training._trainer import copy_into
from probnmn_tpu_torch.training.module_training_trainer import (
    ModuleTrainingTrainer,
    load_frozen_generator,
)
from probnmn_tpu_torch.utils import metrics
from probnmn_tpu_torch.utils.checkpointing import save_objects
from probnmn_tpu_torch.utils.observability import RecordingWriter

from tests import ref_checkpoints
from tests.clevr_fixtures import (
    PROGRAM_TEMPLATES,
    build_fixture_data,
    make_fixture_config,
)
from tests.test_nmn import EXPECTED_INVALID, PROGRAM_CASES, PROGRAM_TOKENS, _programs

ATOL = 1e-5
STEM_TOL = dict(atol=2e-5, rtol=1e-4)
BANK_TOL = dict(atol=5e-5, rtol=1e-3)
TOKENS = {
    "questions": J_SPECIAL_TOKENS + ["w"],
    "programs": PROGRAM_TOKENS,
    "answers": [f"a{i}" for i in range(5)] + ["@@UNKNOWN@@"],
}
SMALL = dict(feature_channels=12, height=6, width=6, module_channels=8,
             class_projection_channels=16, classifier_linear_size=10)


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda t: t.detach().numpy().copy() if isinstance(t, torch.Tensor) else np.array(t), tree)


@pytest.fixture(scope="module")
def small():
    jvocab = JVocabulary(TOKENS)
    jspec = jnmn.make_spec(jvocab)
    spec = nmn.make_spec(Vocabulary(TOKENS))
    for k, v in SMALL.items():
        setattr(jspec, k, v)
        setattr(spec, k, v)
    jparams = jnmn.init_nmn_params(jax.random.PRNGKey(0), jspec)
    params = interop.nmn_from_jax(_to_numpy(jparams), spec)
    programs = np.concatenate([_programs(jvocab, PROGRAM_CASES),
                               np.zeros((1, 8), np.int64)])  # an all-pad row
    rs = np.random.RandomState(0)
    feats = rs.randn(len(programs), 6, 6, 12).astype(np.float32)
    jstem = jnmn.apply_stem(jparams["stem"], jnp.asarray(feats))
    jbanks, jtables = jni.build_kernel_tables(jparams, jspec, dtype=jnp.float32)
    return dict(jvocab=jvocab, jspec=jspec, spec=spec, jparams=jparams, params=params,
                programs=programs, feats=feats, jstem=jstem, jbanks=jbanks, jtables=jtables,
                banks=build_banks(params, spec, torch.float32), tables=build_tables(spec))


def _executed(s):
    r"""(valid rows, first step of each row, kind of each (row, reversed step))."""
    rev = s["programs"][:, ::-1]
    start = np.where((rev != 0).any(1), np.argmax(rev != 0, axis=1), rev.shape[1])
    kinds = s["spec"].token_kind[rev]
    valid = np.asarray(EXPECTED_INVALID + [0]) == 0
    return valid, start, kinds


def _jax_banks_as_port(d, C):
    r"""The JAX kernel's bank gradients in the port's bank layout."""
    d = {k: np.asarray(v) for k, v in d.items()}
    return {
        "w3": d["w3"].reshape(d["w3"].shape[0], 9, C, C), "b3": d["b3"][:, 0, :C],
        "w1": d["w1"][:, :, 0], "b1": d["b1"][:, 0, 0],
        "same_wf": d["same_wf"][:, :, 0], "same_wa": d["same_wa"][:, 0],
        "same_b": d["same_b"][:, 0, 0], "wcmp": d["wcmp"], "bcmp": d["bcmp"][:, 0, :C],
    }


def test_training_forward_plain_matches_jax(small):
    s = small
    stem = torch.from_numpy(np.asarray(s["jstem"]))
    programs = torch.from_numpy(s["programs"])
    before = execute_programs_train_kernel.launches
    final, invalid, otraj, atraj = execute_programs_train_kernel(
        s["banks"], s["tables"], s["spec"], stem, programs)
    assert execute_programs_train_kernel.launches == before  # no kernel on the CPU
    jfinal, jinvalid, jotraj, jatraj = jni._execute_train_fwd_pallas(
        s["jbanks"], s["jtables"], s["jstem"], jnp.asarray(s["programs"]), interpret=True)
    np.testing.assert_array_equal(invalid.numpy(), np.asarray(jinvalid))
    np.testing.assert_array_equal(invalid.numpy().astype(int), EXPECTED_INVALID + [0])
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=ATOL)
    # K5's final and flags are K2's.
    k2_final, k2_invalid = execute_programs_plain(s["banks"], s["tables"], s["spec"], stem, programs)
    assert torch.equal(final, k2_final) and torch.equal(invalid, k2_invalid)
    assert otraj.shape == np.asarray(jotraj).shape and atraj.shape == np.asarray(jatraj).shape
    valid, start, kinds = _executed(s)
    two_conv = np.isin(kinds, [nmn.ATTENTION, nmn.QUERY, nmn.COMPARE])
    checked = 0
    for b in np.flatnonzero(valid):
        for t in range(start[b], s["programs"].shape[1]):
            np.testing.assert_allclose(otraj[b, t].numpy(), np.asarray(jotraj)[b, t], atol=ATOL)
            if two_conv[b, t]:
                np.testing.assert_allclose(atraj[b, t].numpy(), np.asarray(jatraj)[b, t], atol=ATOL)
                checked += 1
    assert checked >= 8


def test_backward_plain_matches_jax(small):
    s = small
    stem = torch.from_numpy(np.asarray(s["jstem"]))
    programs = torch.from_numpy(s["programs"])
    g_final = np.random.RandomState(3).randn(*stem.shape).astype(np.float32)
    final, invalid, otraj, atraj = jni._execute_train_fwd_pallas(
        s["jbanks"], s["jtables"], s["jstem"], jnp.asarray(s["programs"]), interpret=True)
    jd_banks, jd_stem = jni._execute_bwd_pallas(
        s["jbanks"], s["jtables"], s["jstem"], jnp.asarray(s["programs"]), invalid,
        jnp.asarray(g_final), interpret=True, otraj=otraj, atraj=atraj)
    before = interpreter_grads_kernel.launches
    fwd = execute_programs_train_kernel(s["banks"], s["tables"], s["spec"], stem, programs)
    d_banks, d_stem = interpreter_grads_kernel(
        s["banks"], s["tables"], s["spec"], stem, programs, fwd[1], torch.from_numpy(g_final),
        fwd[2], fwd[3])
    assert interpreter_grads_kernel.launches == before
    np.testing.assert_allclose(d_stem.numpy(), np.asarray(jd_stem), **STEM_TOL)
    assert (d_stem.numpy()[np.asarray(EXPECTED_INVALID + [0]) == 1] == 0).all()
    want = _jax_banks_as_port(jd_banks, s["spec"].module_channels)
    assert sorted(d_banks) == sorted(DIFF_BANKS)
    for key in DIFF_BANKS:
        assert d_banks[key].shape == s["banks"][key].shape, key
        np.testing.assert_allclose(d_banks[key].numpy(), want[key], err_msg=key, **BANK_TOL)
        assert np.abs(want[key]).max() > 0, key  # every bank takes a gradient here
    # The plain version is autograd through the plain forward.
    again, d_stem2 = interpreter_grads_plain(s["banks"], s["tables"], s["spec"], stem, programs,
                                             torch.from_numpy(g_final))
    assert torch.equal(d_stem, d_stem2)


def test_branch_reference_matches_float64_autograd_and_jax(small):
    r"""K6's float32 reference on the card, the float64 gradient of the
    branch K5 and K6 took (interpreter_grads_on_branch): with float64's own
    decisions it is autograd through the plain machine in float64; with
    the float32 forward's residuals as the decisions it stays within float32
    rounding of it and of the JAX backward; a residual whose ReLU side is
    far from its tie is reported as a fault."""
    s = small
    stem = torch.from_numpy(np.asarray(s["jstem"]))
    programs = torch.from_numpy(s["programs"])
    g = torch.from_numpy(np.random.RandomState(5).randn(*stem.shape).astype(np.float32))
    _, invalid, otraj, atraj = execute_programs_train_kernel(s["banks"], s["tables"], s["spec"],
                                                             stem, programs)
    banks64 = {k: v.double() for k, v in s["banks"].items()}
    want_banks, want_stem = interpreter_grads_plain(banks64, s["tables"], s["spec"], stem.double(),
                                                    programs, g.double())
    assert want_stem.dtype == torch.float64
    own_banks, own_stem, own_final, report = interpreter_grads_on_branch(
        s["banks"], s["tables"], s["spec"], stem, programs, g, invalid)
    want_final, _ = execute_programs_plain(banks64, s["tables"], s["spec"], stem.double(),
                                           programs)
    np.testing.assert_allclose(own_final.numpy(), want_final.numpy(), atol=1e-12, rtol=0)
    assert report == {"taken": 0, "gap": 0.0, "far": 0, "far_gap": 0.0, "entries": 0, "rows": 0}
    for name, got, want in [("stem", own_stem, want_stem)] + [
            (k, own_banks[k], want_banks[k]) for k in DIFF_BANKS]:
        assert float(want.abs().max()) > 0, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12, rtol=1e-9, err_msg=name)
    got_banks, got_stem, _, report = interpreter_grads_on_branch(
        s["banks"], s["tables"], s["spec"], stem, programs, g, invalid, otraj, atraj)
    assert report["far"] == 0 and report["entries"] == 0 and report["rows"] == 0, report
    for name, got, want in [("stem", got_stem, want_stem)] + [
            (k, got_banks[k], want_banks[k]) for k in DIFF_BANKS]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, err_msg=name,
                                   atol=1e-6 * max(1.0, float(want.abs().max())))
    jfinal, jinvalid, jotraj, jatraj = jni._execute_train_fwd_pallas(
        s["jbanks"], s["jtables"], s["jstem"], jnp.asarray(s["programs"]), interpret=True)
    jd_banks, jd_stem = jni._execute_bwd_pallas(
        s["jbanks"], s["jtables"], s["jstem"], jnp.asarray(s["programs"]), jinvalid,
        jnp.asarray(g.numpy()), interpret=True, otraj=jotraj, atraj=jatraj)
    np.testing.assert_allclose(got_stem.numpy(), np.asarray(jd_stem), **STEM_TOL)
    want = _jax_banks_as_port(jd_banks, s["spec"].module_channels)
    for key in DIFF_BANKS:
        np.testing.assert_allclose(got_banks[key].numpy(), want[key], err_msg=key, **BANK_TOL)
    # A ReLU side far from its tie is a fault, not a tie broken by rounding.
    wrong = atraj.clone()
    b, t, layer, *rest = (wrong > 0.1 * float(wrong.max())).nonzero()[0].tolist()
    wrong[(b, t, layer, *rest)] *= -1
    *_, report = interpreter_grads_on_branch(s["banks"], s["tables"], s["spec"], stem, programs,
                                             g, invalid, otraj, wrong)
    assert report["far"] == 1 and report["far_gap"] > 1e-3, report


def _grads_close(got, want, tree_tol=BANK_TOL):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_got) == len(flat_want)
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path),
                                   **tree_tol)


def _port_grads(s, programs, feats, answers, reduce):
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), s["params"])
    features = torch.from_numpy(feats).requires_grad_(True)
    out = nmn.nmn_forward_fast(params, s["spec"], features, torch.from_numpy(programs),
                               torch.from_numpy(answers))
    loss = reduce(out["loss"])
    loss.backward()
    grads = jax.tree_util.tree_map(lambda t: t.grad.numpy(), params)
    # The stem's convs are OIHW in the port, HWIO in JAX.
    for name in ("w1", "w2"):
        grads["stem"][name] = grads["stem"][name].transpose(2, 3, 1, 0)
    return float(loss), grads, features.grad.numpy(), out


def test_nmn_forward_fast_gradients_match_jax(small):
    s = small
    rs = np.random.RandomState(7)
    answers = rs.randint(0, s["spec"].num_answers, (len(s["programs"]),))
    before = (execute_programs_train_kernel.launches, interpreter_grads_kernel.launches)

    def loss_fast(p, f):
        return jnmn.nmn_forward_fast(p, s["jspec"], f, jnp.asarray(s["programs"]),
                                     jnp.asarray(answers), interpret=True)["loss"].mean()

    want_loss, (want, want_f) = jax.value_and_grad(loss_fast, argnums=(0, 1))(
        s["jparams"], jnp.asarray(s["feats"]))
    loss, grads, grad_f, out = _port_grads(s, s["programs"], s["feats"], answers, torch.mean)
    assert (execute_programs_train_kernel.launches, interpreter_grads_kernel.launches) == before
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    np.testing.assert_array_equal(out["invalid"].numpy().astype(int), EXPECTED_INVALID + [0])
    np.testing.assert_allclose(grad_f, np.asarray(want_f), **STEM_TOL)
    _grads_close(grads, want)
    # The differentiable interpreter's forward is the inference forward.
    ref = nmn.nmn_forward(s["params"], s["spec"], torch.from_numpy(s["feats"]),
                          torch.from_numpy(s["programs"]), torch.from_numpy(answers))
    np.testing.assert_array_equal(out["predictions"].numpy(), ref["predictions"].numpy())
    np.testing.assert_allclose(out["loss"].detach().numpy(), ref["loss"].numpy(), atol=ATOL)


def test_gradient_fuzz_against_the_xla_machine(small):
    r"""Random token soups (B = 16, T = 9): valid and invalid mixes, as
    test_nmn_pallas.py's fuzz, held to ``jax.grad`` of JAX ``nmn_forward``."""
    s = small
    rs = np.random.RandomState(11)
    programs = rs.randint(0, s["jvocab"].get_vocab_size("programs"), (16, 9)).astype(np.int64)
    programs[0] = 0
    feats = rs.randn(16, 6, 6, 12).astype(np.float32)
    answers = rs.randint(0, s["spec"].num_answers, (16,))

    def loss_ref(p):
        return jnmn.nmn_forward(p, s["jspec"], jnp.asarray(feats), jnp.asarray(programs),
                                jnp.asarray(answers))["loss"].sum()

    want = jax.grad(loss_ref)(s["jparams"])
    _, grads, _, out = _port_grads(s, programs, feats, answers, torch.sum)
    assert 0 < int(out["invalid"].sum()) < 16
    _grads_close(grads, want)


def test_differentiable_interpreter_routes_every_gradient(small):
    r"""Through ``execute_programs_diff`` the params get what autograd through
    the plain machine gives them."""
    s = small
    programs = torch.from_numpy(s["programs"])
    g = torch.from_numpy(np.random.RandomState(5).randn(len(s["programs"]), 6, 6, 8)
                         .astype(np.float32))

    def grads(forward):
        params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), s["params"])
        stem = torch.from_numpy(np.asarray(s["jstem"])).requires_grad_(True)
        final, _ = forward(build_banks(params, s["spec"], torch.float32), build_tables(s["spec"]),
                           s["spec"], stem, programs)
        (final * g).sum().backward()
        leaves = [p.grad for p in jax.tree_util.tree_leaves(
            {k: params[k] for k in ("attention", "query", "relate", "same", "compare")})]
        return [stem.grad] + leaves

    for got, want in zip(grads(execute_programs_diff), grads(execute_programs_plain)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def _conv_weight(w3_slot):
    r"""A (9, C_in, C_out) bank slot as torch's (C_out, C_in, 3, 3) conv weight."""
    c = w3_slot.shape[-1]
    return w3_slot.reshape(3, 3, c, c).permute(3, 2, 0, 1)


def _sweep_workspace(s):
    r"""The workspace K6's sweep writes for one relate step and one compare
    step, built with torch's conv2d and autograd instead: each conv's (input,
    g_z, slot, dilation) in the sweep's order (a chain's last layer first,
    then compare's two projection halves), a trailing unwritten entry, and the
    weight gradients autograd gives the bank slots."""
    spec, banks, tables = s["spec"], s["banks"], s["tables"]
    h, w, c = spec.height, spec.width, spec.module_channels
    s3, sc = banks["w3"].shape[0], banks["wcmp"].shape[0]
    kinds = tables["kind"].tolist()
    relate, compare = kinds.index(RELATE), kinds.index(COMPARE)
    gen = torch.Generator().manual_seed(21)
    w3 = banks["w3"].detach().clone().requires_grad_(True)
    wc = banks["wcmp"].detach().clone().requires_grad_(True)

    def conv_chain(a, slots, dilations):
        inps, zs = [], []
        for slot, d in zip(slots, dilations):
            inps.append(a)
            z = torch.nn.functional.conv2d(a.permute(2, 0, 1)[None], _conv_weight(w3[slot]),
                                           banks["b3"][slot], padding=d, dilation=d)[0]
            z = z.permute(1, 2, 0)
            z.retain_grad()
            zs.append(z)
            a = torch.relu(z)
        return a, inps, zs

    entries, loss = [], 0.0
    a0 = torch.rand(h, w, c, generator=gen)
    rel_slots = tables["slot3"][relate].tolist()
    last, inps, zs = conv_chain(a0, rel_slots, (1, 2, 4, 8, 1))
    loss = loss + (last * torch.randn(h, w, c, generator=gen)).sum()
    rel = [(inps[l], zs[l], rel_slots[l], (1, 2, 4, 8, 1)[l]) for l in reversed(range(5))]
    out, saved = torch.randn(h, w, c, generator=gen), torch.randn(h, w, c, generator=gen)
    cs = int(tables["cmp_slot"][compare])
    pre = torch.cat([out, saved], -1) @ wc[cs] + banks["bcmp"][cs]
    pre.retain_grad()
    cmp_slots = tables["slot3"][compare, :2].tolist()
    last, inps, zs = conv_chain(torch.relu(pre), cmp_slots, (1, 1))
    loss = loss + (last * torch.randn(h, w, c, generator=gen)).sum()
    loss.backward()
    entries = rel + [(inps[1], zs[1], cmp_slots[1], 1), (inps[0], zs[0], cmp_slots[0], 1),
                     (out, pre, s3 + 2 * cs, 0), (saved, pre, s3 + 2 * cs + 1, 0)]
    stack = lambda xs: torch.stack([x.detach().reshape(h * w, c) for x in xs])  # noqa: E731
    return {
        "inp": torch.cat([stack([e[0] for e in entries]), torch.zeros(1, h * w, c)]),
        "g": torch.cat([stack([e[1].grad for e in entries]), torch.zeros(1, h * w, c)]),
        "tag": torch.tensor([e[2] for e in entries] + [s3 + 2 * sc], dtype=torch.int32),
        "dil": torch.tensor([e[3] for e in entries] + [0], dtype=torch.int32),
        "dw3": w3.grad.clone(), "dwc": wc.grad.reshape(sc, 2, c, c).clone(),
    }


def test_workspace_errors_hold_the_sweep_to_torch_conv(small):
    r"""``workspace_errors``, which holds K6's weight-gradient kernel and its
    conv input gradients to float64 sums over the sweep's own workspace on the
    card, reads the workspace's taps, dilations and chain order as torch's
    conv2d and autograd do; a dropped tap or a wrong g_z stands out by orders
    of magnitude."""
    s = small
    ws = _sweep_workspace(s)
    errs = workspace_errors(ws, s["banks"], s["tables"], s["spec"])
    assert (errs["entries"], errs["chained"]) == (9, 6)
    assert errs["weight_grad"] <= 1e-6 and errs["input_grad"] <= 1e-6, errs
    slot = int(ws["tag"][0])  # relate's last conv, at dilation 1
    bad = dict(ws, dw3=ws["dw3"].clone())
    bad["dw3"][slot, 5] = 0  # one tap of one slot dropped
    assert workspace_errors(bad, s["banks"], s["tables"], s["spec"])["weight_grad"] > 1e-2
    bad = dict(ws, g=ws["g"].clone())
    bad["g"][6] = bad["g"][6].roll(1, 0)  # compare's first conv: g_z off by a pixel
    assert workspace_errors(bad, s["banks"], s["tables"], s["spec"])["input_grad"] > 1e-2


# ------------------------------------------------------------------ the phase --------
@pytest.fixture(scope="module")
def mt(tmp_path_factory):
    r"""Fixture data, and one frozen ProgramGenerator saved twice: as the JAX
    package's msgpack checkpoint (for the JAX trainer and evaluator) and as
    the port's (for the port's)."""
    root = str(tmp_path_factory.mktemp("mt_port"))
    jvocab = build_fixture_data(root)
    jax_config = make_fixture_config(root, "module_training")
    pg_spec = jprogram_generator.make_spec(jvocab, jax_config)
    pg = jprogram_generator.init_params(jax.random.PRNGKey(3), pg_spec)
    jax_save_objects(os.path.join(root, "question_coding_best.ckpt"), {"program_generator": pg})
    port_qc = os.path.join(root, "question_coding_port.ckpt")
    save_objects(port_qc, {"program_generator": interop.program_generator_from_jax(_to_numpy(pg))})
    path = os.path.join(root, "module_training.yml")
    jax_config.dump(path)
    config = Config(path, ["CHECKPOINTS.QUESTION_CODING", port_qc])
    # One fixed batch of valid programs that both trainers run.
    programs = np.zeros((config.OPTIM.BATCH_SIZE, 10), np.int64)
    for i in range(len(programs)):
        ids = [jvocab.get_token_index(t, "programs")
               for t in PROGRAM_TEMPLATES[i % len(PROGRAM_TEMPLATES)]]
        programs[i, :len(ids)] = ids
    return dict(root=root, jax_config=jax_config, config=config, path=path, port_qc=port_qc,
                pg=pg, programs=programs)


@pytest.fixture(scope="module")
def runs(mt, tmp_path_factory):
    r"""The JAX and the port trainer from the same params, three steps each
    on the same batches at the same programs."""
    fixed = jnp.asarray(mt["programs"])
    original = jax_mt_module.seq2seq_forward
    jax_mt_module.seq2seq_forward = lambda *args, **kwargs: {"predictions": fixed}
    try:
        jax_trainer = jax_mt_module.ModuleTrainingTrainer(
            mt["jax_config"], str(tmp_path_factory.mktemp("jax_mt")))
        port = ModuleTrainingTrainer(mt["config"], str(tmp_path_factory.mktemp("port_mt")),
                                     device="cpu", writer=RecordingWriter())
        port.sample_programs = lambda questions: torch.from_numpy(mt["programs"])
        copy_into(port.params["nmn"], interop.nmn_from_jax(
            _to_numpy(jax_trainer.params["nmn"]), port.nmn_spec))
        jax_logs, port_logs, grads = [], [], []
        for iteration in range(3):
            batch = next(jax_trainer._batches)
            if iteration == 0:  # the JAX trainer's gradient of its first step
                first_grads = jax.grad(lambda p: jnmn.nmn_forward(
                    p, jax_trainer.nmn_spec, image_to_nhwc(batch["image"]), fixed,
                    batch["answer"])["loss"].mean())(jax_trainer.params["nmn"])
            jax_logs.append(jax.tree_util.tree_map(float, jax_trainer._do_iteration(batch)))
            jax_trainer._iteration = iteration
            port_logs.append(port.step(iteration))
            if iteration == 0:
                first_params = [_to_numpy(port.params["nmn"]),
                                _to_numpy(jax_trainer.params["nmn"])]
                for name in ("w1", "w2"):
                    first_params[0]["stem"][name] = first_params[0]["stem"][name].transpose(2, 3, 1, 0)
            grads.append(jax.tree_util.tree_map(lambda t: t.grad.numpy().copy(),
                                                port.params["nmn"]))
    finally:
        jax_mt_module.seq2seq_forward = original
    return dict(jax_trainer=jax_trainer, port=port, jax_logs=jax_logs, port_logs=port_logs,
                grads=grads, first_grads=first_grads, first_params=first_params)


def test_three_steps_match_the_jax_trainer(mt, runs):
    for got, want in zip(runs["port_logs"], runs["jax_logs"]):
        assert sorted(got) == sorted(want) == ["loss", "metrics"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL, rtol=0)
        for key, value in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], value, atol=1e-6, err_msg=key)
    assert all(log["metrics"]["average_invalid"] == 0.0 for log in runs["port_logs"])
    port = runs["port"]
    want = _to_numpy(runs["jax_trainer"].params["nmn"])
    got = _to_numpy(port.params["nmn"])
    grads = runs["grads"]
    for name in ("w1", "w2"):  # compare the stem in JAX's HWIO layout
        got["stem"][name] = got["stem"][name].transpose(2, 3, 1, 0)
        for g in grads:
            g["stem"][name] = g["stem"][name].transpose(2, 3, 1, 0)
    _grads_close(grads[0], runs["first_grads"])
    # Adam moves a parameter by about lr * sign(g) on its first step: there
    # the params agree wherever |g| clears the float32 noise of the plateau.
    # Later steps divide by sqrt(v), which turns float32 noise in a gradient
    # near the plateau into a sizeable part of lr: there the bound is 2 lr a
    # step (ROADMAP.md section 3).
    lr, steps, compared, total = mt["config"].OPTIM.LR_INITIAL, 3, 0, 0
    first_got = jax.tree_util.tree_leaves(runs["first_params"][0])
    first_want = jax.tree_util.tree_leaves(runs["first_params"][1])
    for index, ((path, w), g) in enumerate(zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                               jax.tree_util.tree_leaves(got))):
        key = jax.tree_util.keystr(path)
        smooth = np.abs(jax.tree_util.tree_leaves(grads[0])[index]) > 1e-5
        np.testing.assert_allclose(first_got[index][smooth], first_want[index][smooth], atol=1e-6,
                                   rtol=0, err_msg=key)
        np.testing.assert_allclose(g, w, atol=2 * lr * steps, rtol=0, err_msg=key)
        compared += int(smooth.sum())
        total += w.size
    assert compared > 0.4 * total


@pytest.mark.parametrize("decode", ["tf_greedy", "free_greedy"])
def test_evaluator_matches_the_jax_evaluator(mt, runs, decode):
    port = runs["port"]
    want = JaxModuleTrainingEvaluator(mt["jax_config"], runs["jax_trainer"],
                                      program_decode=decode).evaluate(num_batches=2)
    before = execute_programs_kernel.launches
    got = ModuleTrainingEvaluator(mt["config"], port, program_decode=decode).evaluate(num_batches=2)
    assert execute_programs_kernel.launches == before  # the plain K2 on the CPU
    assert sorted(got) == sorted(want) == ["nmn"]
    assert sorted(got["nmn"]) == sorted(want["nmn"]) == ["answer_accuracy", "average_invalid"]
    for key, value in want["nmn"].items():
        assert got["nmn"][key] == pytest.approx(value, abs=1e-12), key
    port.after_validation(got, 2)
    assert port.learning_rate == pytest.approx(mt["config"].OPTIM.LR_INITIAL)
    with pytest.raises(ValueError, match="program_decode"):
        ModuleTrainingEvaluator(mt["config"], port, program_decode="beam")


def test_checkpoint_resumes_and_generator_must_be_the_ports(mt, runs, tmp_path):
    port = runs["port"]
    port._checkpoint_manager.serialization_dir = tmp_path
    port.after_validation({"nmn": {"answer_accuracy": 0.5, "average_invalid": 0.0}}, 7)
    resumed = ModuleTrainingTrainer(mt["config"], str(tmp_path), device="cpu",
                                    writer=RecordingWriter())
    resumed.load_checkpoint(str(tmp_path / "checkpoint_7.ckpt"))
    assert resumed.iteration == 7
    for a, b in zip(jax.tree_util.tree_leaves(_to_numpy(resumed.params)),
                    jax.tree_util.tree_leaves(_to_numpy(port.params))):
        np.testing.assert_array_equal(a, b)
    spec = resumed.pg_spec
    params = load_frozen_generator(mt["port_qc"], spec, torch.device("cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(_to_numpy(params)),
                    jax.tree_util.tree_leaves(_to_numpy(interop.program_generator_from_jax(
                        _to_numpy(mt["pg"]))))):
        np.testing.assert_array_equal(a, b)
    # The JAX package's .ckpt gives the same params; a reference .pth its
    # JAX port's.
    params = load_frozen_generator(os.path.join(mt["root"], "question_coding_best.ckpt"), spec,
                                   torch.device("cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(_to_numpy(params)),
                    jax.tree_util.tree_leaves(_to_numpy(mt["pg"]))):
        np.testing.assert_array_equal(a, b)
    pg_spec = jprogram_generator.make_spec(JVocabulary.from_files(
        mt["jax_config"].DATA.VOCABULARY), mt["jax_config"])
    pth = str(tmp_path / "x.pth")
    ref_checkpoints.save_reference_pth(pth, {"program_generator": ref_checkpoints.make_seq2seq_state(
        pg_spec.source_vocab_size, pg_spec.target_vocab_size, pg_spec.input_size,
        pg_spec.hidden_size, pg_spec.num_layers, 7)})
    params = load_frozen_generator(pth, spec, torch.device("cpu"))
    ported = jax_torch_interop.load_reference_checkpoint(pth, {"program_generator": pg_spec}, None)
    for a, b in zip(jax.tree_util.tree_leaves(_to_numpy(params)),
                    jax.tree_util.tree_leaves(_to_numpy(ported["program_generator"]))):
        np.testing.assert_array_equal(a, b)


def test_data_path_matches_jax(mt):
    config = mt["jax_config"]
    port_set = ModuleTrainingDataset(config.DATA.TRAIN_TOKENS, config.DATA.TRAIN_FEATURES)
    stream_set = ModuleTrainingDataset(config.DATA.TRAIN_TOKENS, config.DATA.TRAIN_FEATURES,
                                       in_memory=False)
    jax_set = JaxModuleTrainingDataset(config.DATA.TRAIN_TOKENS, config.DATA.TRAIN_FEATURES)
    assert len(port_set) == len(jax_set) == 40 and port_set.split == "train"
    # Unsorted indices whose images repeat and come out of order.
    indices = np.array([17, 3, 3, 39, 0, 22, 17, 5])
    want = jax_set.get_batch(indices)
    for dataset in (port_set, stream_set):
        got = dataset.get_batch(indices)
        assert sorted(got) == sorted(want) == ["answer", "image", "program", "question"]
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    reader = ClevrImageFeaturesReader(config.DATA.TRAIN_FEATURES, in_memory=False)
    memory = ClevrImageFeaturesReader(config.DATA.TRAIN_FEATURES)
    for index in ([4, 1, 1, 5, 0, 4], 2, np.array([3])):
        np.testing.assert_array_equal(reader[index], memory[index])
    assert len(reader) == len(memory) == 6 and reader.split == "train"
    features = memory[np.arange(6)]
    arrays = ModuleTrainingDataset.from_arrays(port_set._programs, port_set._questions,
                                               port_set._answers, port_set._image_indices,
                                               features)
    for key, value in arrays.get_batch(indices).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    with pytest.raises(ValueError, match="val program 0"):
        ModuleTrainingDataset.from_arrays(port_set._programs + 100, port_set._questions,
                                          port_set._answers, port_set._image_indices, features,
                                          split="val").check_tokens(50, 50)
    rs = np.random.RandomState(0)
    pred, gold = rs.randint(0, 3, 10), rs.randint(0, 3, 10)
    got, jgot = metrics.BooleanAccuracy(), jmetrics.BooleanAccuracy()
    got(pred, gold)
    jgot(pred, gold)
    assert got.get_metric() == jgot.get_metric()


@pytest.mark.parametrize("streaming", [False, True])
def test_train_cli_runs_module_training_on_the_cpu(mt, tmp_path, streaming):
    out = str(tmp_path / "cli_mt")
    args = train.parser.parse_args([
        "--phase", "module_training", "--config-yml", mt["path"],
        "--config-override", "OPTIM.NUM_ITERATIONS", "2",
        "CHECKPOINTS.QUESTION_CODING", mt["port_qc"],
        "--device", "cpu", "--serialization-dir", out,
        "--checkpoint-every", "2", "--num-val-batches", "1",
    ] + (["--streaming-features"] if streaming else []))
    assert args.streaming_features == streaming
    train.main(args)
    assert sorted(os.listdir(out))[:3] == ["checkpoint_1.ckpt", "checkpoint_best.ckpt",
                                           "config.yml"]
