"""The interpreter kernels' plan (``interpreter_plan``: each program's 3x3
convs and the longest-first order in which the persistent K2, K5 and K6 take
the examples) against the JAX package, in float32 on the CPU: the conv count
of each row equals a replay of the tag machine over the JAX package's
``build_tables`` on CLEVR-like programs with token soups, a program without a
scene and an all-pad row; the order is a stable permutation, longest first;
and the plain interpreter run in that order and scattered back equals the
interpret-mode Pallas interpreter in batch order (within 1e-5)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.ops.pallas.nmn_interpreter import (
    build_kernel_tables,
    build_tables as jax_build_tables,
    execute_programs_pallas,
)
from probnmn_tpu.utils.clevr import make_clevr_like_vocabulary as jax_clevr_vocab
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.models import nmn
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    build_banks,
    build_tables,
    execute_programs_kernel,
    interpreter_plan,
    interpreter_plan_plain,
)
from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary, sample_clevr_like_programs

ATOL = 1e-5
SMALL = dict(feature_channels=12, height=6, width=6, module_channels=8,
             class_projection_channels=16, classifier_linear_size=10)
# Module kinds of the JAX package (probnmn_tpu/models/nmn.py).
NOP, SCENE, AND, OR, ATTENTION, QUERY, RELATE, SAME, COMPARE = range(9)


@pytest.fixture(scope="module")
def clevr():
    jvocab, vocab = jax_clevr_vocab(), make_clevr_like_vocabulary()
    jspec, spec = jnmn.make_spec(jvocab), nmn.make_spec(vocab)
    for k, v in SMALL.items():
        setattr(jspec, k, v)
        setattr(spec, k, v)
    return dict(vocab=vocab, jspec=jspec, spec=spec,
                jtables={k: np.asarray(v) for k, v in jax_build_tables(jspec).items()})


def _batch(vocab, n, seed):
    r"""``n`` CLEVR-like programs; the last four rows are token soups (mostly
    invalid), then a program with no scene (invalid) and an all-pad row."""
    programs = sample_clevr_like_programs(vocab, n, seed=seed)
    rs = np.random.RandomState(seed + 100)
    n_tokens = len(vocab.get_index_to_token_vocabulary("programs"))
    programs[-4:] = rs.randint(0, n_tokens, (4, programs.shape[1]))
    programs[-2, :] = 0
    programs[-2, :2] = [vocab.get_token_index("count", "programs"),
                        vocab.get_token_index("filter_color[red]", "programs")]
    programs[-1] = 0
    return programs


def _replay_convs(jtables, programs):
    r"""The 3x3 convs each row runs: the tag machine over the JAX tables, from
    the first non-pad token of the reversed program to the first invalid op."""
    kind, chain, head = jtables["kind"], jtables["chain_len"], jtables["head_slot"]
    counts = []
    for row in programs:
        out_tag, saved_tag, n = 2, 0, 0
        rev = row[::-1]
        for tok in rev[np.argmax(rev != 0):] if (rev != 0).any() else []:
            k = kind[tok]
            if k == SCENE:
                out_tag, saved_tag = 1, out_tag
            elif k in (AND, OR):
                if saved_tag == 0:
                    break
                out_tag = 1 if out_tag == 1 and saved_tag == 1 else 2
            elif k in (ATTENTION, QUERY, RELATE):
                if out_tag != 1:
                    break
                n += chain[tok]
                out_tag = 1 if head[tok] >= 0 else 2
            elif k == COMPARE:
                if out_tag != 2 or saved_tag != 2:
                    break
                n += chain[tok]
            elif k == SAME:
                if out_tag != 1:
                    break
        counts.append(n)
    return np.array(counts)


@pytest.mark.parametrize("n, seed", [(16, 0), (64, 1), (256, 2)])
def test_plan_counts_the_convs_of_the_jax_tag_machine(clevr, n, seed):
    programs = _batch(clevr["vocab"], n, seed)
    convs, _ = interpreter_plan(build_tables(clevr["spec"]), torch.from_numpy(programs))
    want = _replay_convs(clevr["jtables"], programs)
    assert convs.dtype == torch.int32
    np.testing.assert_array_equal(convs.numpy(), want)
    assert want[-1] == 0 and want[:-6].min() > 0  # the all-pad row; every CLEVR program runs


@pytest.mark.parametrize("n, seed", [(16, 3), (64, 4), (256, 5)])
def test_plan_order_is_a_stable_permutation_longest_first(clevr, n, seed):
    programs = _batch(clevr["vocab"], n, seed)
    tables = build_tables(clevr["spec"])
    convs, order = interpreter_plan(tables, torch.from_numpy(programs))
    assert order.dtype == torch.int32
    order, convs = order.long().numpy(), convs.long().numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    ranked = convs[order]
    assert (np.diff(ranked) <= 0).all()
    ties = np.diff(ranked) == 0
    assert (np.diff(order)[ties] > 0).all()  # equal counts keep batch order
    assert ranked[0] == convs.max()
    # The wrapper on CPU tensors is the plain version itself.
    again = interpreter_plan_plain(tables, torch.from_numpy(programs))
    np.testing.assert_array_equal(again[1].long().numpy(), order)


@pytest.mark.parametrize("seed", [6, 7])
def test_plain_interpreter_in_plan_order_matches_jax_in_batch_order(clevr, seed):
    spec, jspec = clevr["spec"], clevr["jspec"]
    programs = _batch(clevr["vocab"], 12, seed)
    jparams = jnmn.init_nmn_params(jax.random.PRNGKey(seed), jspec)
    params = interop.nmn_from_jax(jax.tree_util.tree_map(np.asarray, jparams), spec)
    feats = np.random.RandomState(seed).randn(len(programs), 6, 6, 12).astype(np.float32)
    jstem = jnmn.apply_stem(jparams["stem"], jnp.asarray(feats))
    jbanks, jtables = build_kernel_tables(jparams, jspec, dtype=jnp.float32)
    want_out, want_invalid = execute_programs_pallas(
        jbanks, jtables, jspec, jstem, jnp.asarray(programs), interpret=True)

    stem = nmn.apply_stem(params["stem"], torch.from_numpy(feats))
    banks, tables = build_banks(params, spec, torch.float32), build_tables(spec)
    progs = torch.from_numpy(programs)
    _, order = interpreter_plan(tables, progs)
    order = order.long()
    out_sorted, invalid_sorted = execute_programs_kernel(banks, tables, spec, stem[order],
                                                         progs[order])
    out = torch.empty_like(out_sorted)
    invalid = torch.empty_like(invalid_sorted)
    out[order], invalid[order] = out_sorted, invalid_sorted
    np.testing.assert_array_equal(invalid.numpy(), np.asarray(want_invalid))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    assert int(invalid.sum()) >= 1 and not bool(invalid[-1])  # the no-scene row; all pad is valid
