"""The port's NMN against the JAX package's, in float32 on the CPU, at the
small spec of test_nmn_pallas.py over PROGRAM_CASES (every module kind,
invalid programs, an all-pad row): the same token -> bank-slot assignment and
kernel tables, the same invalid flags as the JAX register machine and the
interpret-mode Pallas interpreter, outputs within 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.data.vocabulary import SPECIAL_TOKENS as J_SPECIAL_TOKENS
from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.ops.pallas.nmn_interpreter import (
    build_kernel_tables,
    build_tables as jax_build_tables,
    execute_programs_pallas,
)
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models import nmn
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    build_banks,
    build_tables,
    execute_programs_kernel,
    execute_programs_plain,
)
from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary

from tests.test_nmn import EXPECTED_INVALID, PROGRAM_CASES, PROGRAM_TOKENS, _programs

ATOL = 1e-5
TOKENS = {
    "questions": J_SPECIAL_TOKENS + ["w"],
    "programs": PROGRAM_TOKENS,
    "answers": [f"a{i}" for i in range(5)] + ["@@UNKNOWN@@"],
}
SMALL = dict(feature_channels=12, height=6, width=6, module_channels=8,
             class_projection_channels=16, classifier_linear_size=10)


@pytest.fixture(scope="module")
def setup():
    jvocab = JVocabulary(TOKENS)
    jspec = jnmn.make_spec(jvocab)
    spec = nmn.make_spec(Vocabulary(TOKENS))
    for k, v in SMALL.items():
        setattr(jspec, k, v)
        setattr(spec, k, v)
    jparams = jnmn.init_nmn_params(jax.random.PRNGKey(0), jspec)
    params = interop.nmn_from_jax(jax.tree_util.tree_map(np.asarray, jparams), spec)
    programs = _programs(jvocab, PROGRAM_CASES)
    rs = np.random.RandomState(0)
    feats = rs.randn(len(PROGRAM_CASES), 6, 6, 12).astype(np.float32)
    return dict(jspec=jspec, spec=spec, jparams=jparams, params=params,
                programs=programs, feats=feats)


@pytest.mark.parametrize("vocab_kind", ["small", "clevr"])
def test_spec_and_kernel_tables_equal_jax(vocab_kind):
    if vocab_kind == "small":
        jvocab, vocab = JVocabulary(TOKENS), Vocabulary(TOKENS)
    else:
        from probnmn_tpu.utils.clevr import make_clevr_like_vocabulary as jax_clevr_vocab

        jvocab, vocab = jax_clevr_vocab(), make_clevr_like_vocabulary()
    jspec, spec = jnmn.make_spec(jvocab), nmn.make_spec(vocab)
    np.testing.assert_array_equal(spec.token_kind, jspec.token_kind)
    np.testing.assert_array_equal(spec.token_bank, jspec.token_bank)
    assert spec.bank_sizes == jspec.bank_sizes
    assert spec.unk_answer_index == jspec.unk_answer_index
    want = jax_build_tables(jspec)
    got = build_tables(spec)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def _stem(s):
    jstem = jnmn.apply_stem(s["jparams"]["stem"], jnp.asarray(s["feats"]))
    stem = nmn.apply_stem(s["params"]["stem"], torch.from_numpy(s["feats"]))
    np.testing.assert_allclose(stem.numpy(), np.asarray(jstem), atol=ATOL)
    return jstem, stem


def test_plain_machine_matches_jax_machine_and_pallas_interpreter(setup):
    s = setup
    jstem, stem = _stem(s)
    ref_out, ref_invalid = jnmn.execute_programs(
        s["jparams"], s["jspec"], jstem, jnp.asarray(s["programs"]))
    banks, tables = build_kernel_tables(s["jparams"], s["jspec"], dtype=jnp.float32)
    pal_out, pal_invalid = execute_programs_pallas(
        banks, tables, s["jspec"], jstem, jnp.asarray(s["programs"]), interpret=True)
    out, invalid = nmn.execute_programs(
        s["params"], s["spec"], stem, torch.from_numpy(s["programs"]))
    np.testing.assert_array_equal(invalid.numpy(), np.asarray(ref_invalid))
    np.testing.assert_array_equal(invalid.numpy(), np.asarray(pal_invalid))
    np.testing.assert_array_equal(invalid.numpy().astype(int), EXPECTED_INVALID)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal_out), atol=ATOL)


def test_kernel_wrapper_runs_the_plain_version_on_cpu(setup):
    s = setup
    _, stem = _stem(s)
    banks = build_banks(s["params"], s["spec"], torch.float32)
    tables = build_tables(s["spec"])
    programs = torch.from_numpy(s["programs"])
    before = execute_programs_kernel.launches
    out_k, inv_k = execute_programs_kernel(banks, tables, s["spec"], stem, programs)
    out_p, inv_p = execute_programs_plain(banks, tables, s["spec"], stem, programs)
    assert execute_programs_kernel.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(inv_k.numpy(), inv_p.numpy())
    np.testing.assert_array_equal(out_k.numpy(), out_p.numpy())


def test_nmn_forward_matches_jax(setup):
    s = setup
    rs = np.random.RandomState(1)
    answers = rs.randint(0, s["spec"].num_answers, (len(PROGRAM_CASES),))
    want = jnmn.nmn_forward(s["jparams"], s["jspec"], jnp.asarray(s["feats"]),
                            jnp.asarray(s["programs"]), jnp.asarray(answers))
    for forward in (
        lambda f, p, a: nmn.nmn_forward(s["params"], s["spec"], f, p, a),
        nmn.make_fast_inference_fn(s["params"], s["spec"]),
    ):
        got = forward(torch.from_numpy(s["feats"]), torch.from_numpy(s["programs"]),
                      torch.from_numpy(answers))
        np.testing.assert_array_equal(got["invalid"].numpy(), np.asarray(want["invalid"]))
        np.testing.assert_array_equal(got["predictions"].numpy(),
                                      np.asarray(want["predictions"]))
        np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=ATOL)
        np.testing.assert_allclose(got["answer_logits"].numpy(),
                                   np.asarray(want["answer_logits"]), atol=ATOL)


def test_nmn_forward_without_answers_matches_jax(setup):
    s = setup
    want = jnmn.nmn_forward(s["jparams"], s["jspec"], jnp.asarray(s["feats"]),
                            jnp.asarray(s["programs"]))
    got = nmn.nmn_forward(s["params"], s["spec"], torch.from_numpy(s["feats"]),
                          torch.from_numpy(s["programs"]))
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), atol=ATOL)
    invalid = got["invalid"].numpy()
    assert (got["predictions"].numpy()[invalid] == s["spec"].unk_answer_index).all()
    np.testing.assert_allclose(got["loss"].numpy()[invalid], nmn.INVALID_LOSS)


def test_bfloat16_plain_machine_keeps_flags_and_stays_close(setup):
    s = setup
    _, stem = _stem(s)
    tables = build_tables(s["spec"])
    programs = torch.from_numpy(s["programs"])
    out32, inv32 = execute_programs_plain(
        build_banks(s["params"], s["spec"], torch.float32), tables, s["spec"], stem, programs)
    out16, inv16 = execute_programs_plain(
        build_banks(s["params"], s["spec"], torch.bfloat16), tables, s["spec"],
        stem.to(torch.bfloat16), programs)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_array_equal(inv16.numpy(), inv32.numpy())
    scale = float(out32.abs().max())
    assert float((out16.float() - out32).abs().max()) <= 2e-2 * scale
