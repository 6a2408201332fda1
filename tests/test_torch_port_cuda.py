"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. These need a CUDA device and skip without one; on a GPU
machine run them with ``python -m pytest --noconftest tests/test_torch_port_cuda.py``
(the JAX-free port needs none of tests/conftest.py). chip_smoke.py holds the
kernels to the same versions at full width."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from probnmn_tpu_torch.models import nmn, program_generator, program_prior
from probnmn_tpu_torch.models.seq2seq import Seq2SeqSpec, _encode, init_seq2seq_params
from probnmn_tpu_torch.models.nmn import cast_params
from probnmn_tpu_torch.ops.kernels.gemm import (
    gemm_cuda, gemm_launches, gemm_plan, gemm_plan_cuda, gemm_record, gemm_records,
)
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    DIFF_BANKS, build_banks, build_tables, execute_programs_diff, execute_programs_kernel,
    execute_programs_plain, execute_programs_train_kernel, interpreter_grads_kernel,
    interpreter_grads_on_branch, interpreter_grads_plain, interpreter_grads_plain_by_row,
    interpreter_plan,
    interpreter_plan_plain, weight_grad_kernel, weight_grad_plain, weight_grad_plan,
    workspace_errors,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
    decoder_plan, decoder_plan_twin, encoder_plan, fused_sampling_forward, philox_gumbel,
    sampling_encode, sampling_forward_with_noise,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    fused_lm_loss, fused_tf_loss, lm_backward_cuda, lm_forward_cuda, lm_grads_plain, lm_loss_plain,
    pack_lm_weights, pack_tf_weights, param_leaves, params_from_leaves, tf_backward_cuda,
    tf_forward_cuda, tf_grads_plain, tf_loss_plain, tf_param_leaves, tf_params_from_leaves,
    tf_sweep_plan,
)
from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary, sample_clevr_like_programs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches(fn, names=("lstm_fwd_sweep", "lstm_fwd_step", "lstm_bwd_sweep", "lstm_bwd_step")):
    r"""Launches of each named kernel in one call of ``fn`` under the profiler,
    with the card idle for 20 ms after the trace starts and before it stops
    (without that gap the profiler can lose a trace's first kernels; see
    chip_smoke.py's ``profiled``). A template kernel's name carries its
    arguments: ``lstm_fwd_sweep<3>``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    counts = dict.fromkeys(names, 0)
    for event in prof.key_averages():
        for name in names:
            if f"{name}(" in event.key or f"{name}<" in event.key:
                counts[name] += event.count
    return counts


def test_sampling_kernel_matches_plain_version(cuda):
    vocab = make_clevr_like_vocabulary()
    spec = program_generator.make_spec(vocab)
    spec = dataclasses.replace(spec, input_size=64, hidden_size=128)
    gen = torch.Generator().manual_seed(0)
    params = cast_params(program_generator.init_params(gen, spec), torch.float32, cuda)
    rs = np.random.RandomState(0)
    src = rs.randint(4, spec.source_vocab_size, (9, 20)) * (np.arange(20) < rs.randint(1, 21, (9, 1)))
    src[0] = 0
    src = torch.from_numpy(src).to(cuda)
    noise = torch.from_numpy(philox_gumbel(7, spec.max_decoding_steps, 9, spec.target_vocab_size)).to(cuda)
    got = fused_sampling_forward(params, spec, src, noise=noise, compute_dtype=torch.float32)
    want = sampling_forward_with_noise(params, spec, src, noise)
    torch.testing.assert_close(got["predictions"], want["predictions"], rtol=0, atol=0)
    torch.testing.assert_close(got["logprobs"], want["logprobs"], rtol=0, atol=1e-4)
    torch.testing.assert_close(got["loss"], want["loss"], rtol=0, atol=1e-4)
    philox = fused_sampling_forward(params, spec, src, seed=7, compute_dtype=torch.float32)
    torch.testing.assert_close(philox["predictions"], want["predictions"], rtol=0, atol=0)


# Which of a K1 encoder layer's matrices stay in shared memory at D = H, as
# the header comment of csrc/seq2seq_decode.cu states: (W_hh, W_ih).
K1_RESIDENT = {
    (128, torch.bfloat16): (1, 1), (128, torch.float32): (1, 1),
    (256, torch.bfloat16): (1, 1), (256, torch.float32): (1, 0),
    (512, torch.bfloat16): (1, 0), (512, torch.float32): (0, 0),
}


def _k1_batches(rs, vocab_size, length=45):
    r"""Batches of 37 and 256 rows, each with a full-length, an all-pad and a
    one-token row among random lengths, and the three as batches of one."""
    def batch(n):
        src = rs.randint(4, vocab_size, (n, length))
        src = src * (np.arange(length)[None, :] < rs.randint(1, length + 1, (n, 1)))
        src[0] = rs.randint(4, vocab_size, length)
        src[1] = 0
        src[2, 1:] = 0
        return src
    full = batch(3)
    return [batch(37), batch(256), full[0:1], full[1:2], full[2:3]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [128, 256, 512])
def test_encoder_sweep_and_k1_match_plain_versions(cuda, hidden, dtype):
    r"""K1's encoder sweeps against the plain encoder (float32 within 1e-5 of
    max(1, max|x|), bfloat16 within 2e-2 of max|x|), and K1 against its plain
    version on explicit noise (float32: >= 99% identical rows, logprobs
    within 1e-4 there; bfloat16: >= 95% identical tokens), at D = H."""
    vocab = make_clevr_like_vocabulary()
    spec = dataclasses.replace(program_generator.make_spec(vocab), input_size=hidden,
                               hidden_size=hidden)
    params = cast_params(program_generator.init_params(torch.Generator().manual_seed(hidden), spec),
                         torch.float32, cuda)
    plans = [encoder_plan(256, hidden, hidden, dtype), encoder_plan(1, hidden, hidden, dtype)]
    for plan in plans:
        assert (plan["w_hh_resident"], plan["w_ih_resident"]) == K1_RESIDENT[hidden, dtype], plan
        assert plan["units"] * plan["cluster"] == hidden and plan["units"] <= 32
    rs = np.random.RandomState(hidden)
    T, V = spec.max_decoding_steps, spec.target_vocab_size
    for src_np in _k1_batches(rs, spec.source_vocab_size):
        src = torch.from_numpy(src_np).to(cuda)
        out, final = sampling_encode(params, spec, src, compute_dtype=dtype)
        want_out, _, want_final, _ = _encode(params, spec, src, dtype)
        assert out.dtype == dtype and final.dtype == torch.float32
        for got, want in ((out.float(), want_out), (final, want_final)):
            scale = float(want.abs().max())
            tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
            assert float((got - want).abs().max()) <= tol, (src_np.shape, scale)
        noise = torch.from_numpy(rs.gumbel(size=(T, src.shape[0], V)).astype(np.float32)).to(cuda)
        got = fused_sampling_forward(params, spec, src, noise=noise, compute_dtype=dtype)
        want = sampling_forward_with_noise(params, spec, src, noise, compute_dtype=dtype)
        same = (got["predictions"] == want["predictions"]).all(dim=1)
        if dtype == torch.float32:
            assert float(same.float().mean()) >= 0.99
            assert float((got["logprobs"] - want["logprobs"])[same].abs().max()) <= 1e-4
        else:
            assert float((got["predictions"] == want["predictions"]).float().mean()) >= 0.95
        assert torch.isfinite(got["loss"]).all()


def _k1_against_plain(params, spec, src, dtype, rs):
    r"""K1 against its plain version on explicit noise: float32 >= 99%
    identical rows with logprobs within 1e-4 there, bfloat16 >= 95%
    identical tokens, finite losses."""
    T, V = spec.max_decoding_steps, spec.target_vocab_size
    noise = torch.from_numpy(rs.gumbel(size=(T, src.shape[0], V)).astype(np.float32)).to(src.device)
    got = fused_sampling_forward(params, spec, src, noise=noise, compute_dtype=dtype)
    want = sampling_forward_with_noise(params, spec, src, noise, compute_dtype=dtype)
    same = (got["predictions"] == want["predictions"]).all(dim=1)
    if dtype == torch.float32:
        assert float(same.float().mean()) >= 0.99
        assert float((got["logprobs"] - want["logprobs"])[same].abs().max()) <= 1e-4
    else:
        assert float((got["predictions"] == want["predictions"]).float().mean()) >= 0.95
    assert torch.isfinite(got["loss"]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [128, 256, 512])
def test_decoder_plan_matches_its_twin(cuda, hidden, dtype):
    r"""The decoder's plan on the card against its Python twin, given the
    card's two fits, at B = 1, 37, 256 and a batch that needs waves."""
    for batch in (1, 37, 256, 4000):
        plan = decoder_plan(batch, 45, hidden, hidden, 44, dtype)
        twin = decoder_plan_twin(batch, 45, hidden, hidden, 44, dtype, plan["fit_full_smem"],
                                 plan["fit"])
        assert {k: plan[k] for k in plan if k != "registers"} == \
            {k: twin[k] for k in twin if k != "r_max"}, (batch, plan, twin)
        assert plan["registers"] <= 255


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [128, 256, 512])
def test_k1_decoder_runs_in_waves(cuda, hidden, dtype):
    r"""K1 against its plain version at a batch one wave of the decoder's
    clusters cannot hold (the plan's most rows a cluster times the clusters
    that fit, plus 5), at D = H."""
    vocab = make_clevr_like_vocabulary()
    spec = dataclasses.replace(program_generator.make_spec(vocab), input_size=hidden,
                               hidden_size=hidden)
    params = cast_params(program_generator.init_params(torch.Generator().manual_seed(7), spec),
                         torch.float32, cuda)
    widest = decoder_plan(100000, 45, hidden, hidden, spec.target_vocab_size, dtype)
    batch = widest["rows"] * widest["fit"] + 5
    plan = decoder_plan(batch, 45, hidden, hidden, spec.target_vocab_size, dtype)
    assert plan["clusters"] > plan["fit"], plan
    rs = np.random.RandomState(hidden + 1)
    src = rs.randint(4, spec.source_vocab_size, (batch, 45))
    src = src * (np.arange(45)[None, :] < rs.randint(1, 46, (batch, 1)))
    src[1] = 0
    _k1_against_plain(params, spec, torch.from_numpy(src).to(cuda), dtype, rs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [128, 256])
def test_k1_decoder_at_odd_input_and_vocabulary_sizes(cuda, hidden, dtype):
    r"""K1 against its plain version with an odd embedding width (67) and an
    odd program vocabulary (45), at B = 37 and 1."""
    vocab = make_clevr_like_vocabulary()
    spec = dataclasses.replace(program_generator.make_spec(vocab), input_size=67,
                               hidden_size=hidden, target_vocab_size=45)
    params = cast_params(program_generator.init_params(torch.Generator().manual_seed(5), spec),
                         torch.float32, cuda)
    rs = np.random.RandomState(hidden)
    for src in _k1_batches(rs, spec.source_vocab_size)[0::2]:
        _k1_against_plain(params, spec, torch.from_numpy(src).to(cuda), dtype, rs)


def test_k1_is_one_sweep_a_layer_and_one_decoder_launch(cuda):
    r"""Under the profiler K1 is one encoder sweep a layer (three here) and one
    decoder launch, with the sweeps' counter one a call."""
    vocab = make_clevr_like_vocabulary()
    spec = dataclasses.replace(program_generator.make_spec(vocab), num_layers=3)
    params = cast_params(program_generator.init_params(torch.Generator().manual_seed(3), spec),
                         torch.float32, cuda)
    src = torch.from_numpy(_k1_batches(np.random.RandomState(3), spec.source_vocab_size)[0]).to(cuda)
    before = (sampling_encode.launches, fused_sampling_forward.launches)
    counts = _launches(lambda: fused_sampling_forward(params, spec, src, seed=5),
                       names=("k1_encoder_sweep", "seq2seq_sample_kernel"))
    assert counts == {"k1_encoder_sweep": 3, "seq2seq_sample_kernel": 1}, counts
    assert (sampling_encode.launches, fused_sampling_forward.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    out, final = sampling_encode(params, spec, src, compute_dtype=torch.float32)
    want_out, _, want_final, _ = _encode(params, spec, src)
    assert float((out - want_out).abs().max()) <= 1e-5
    assert float((final - want_final).abs().max()) <= 1e-5


def test_interpreter_kernel_matches_plain_version(cuda):
    vocab = make_clevr_like_vocabulary()
    spec = nmn.make_spec(vocab)
    spec.feature_channels, spec.height, spec.width = 16, 6, 6
    gen = torch.Generator().manual_seed(1)
    params = cast_params(nmn.init_nmn_params(gen, spec), torch.float32, cuda)
    programs = sample_clevr_like_programs(vocab, 12, seed=2)
    programs[-1] = 0
    programs[-2, :] = 0
    programs[-2, 0] = vocab.get_token_index("intersect", "programs")
    programs = torch.from_numpy(programs).to(cuda)
    feats = torch.randn(12, 6, 6, 16, generator=gen).to(cuda)
    tables = build_tables(spec, cuda)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        stem = nmn.apply_stem(cast_params(params["stem"], dtype), feats.to(dtype)).contiguous()
        banks = build_banks(params, spec, dtype)
        before = execute_programs_kernel.launches
        out_k, inv_k = execute_programs_kernel(banks, tables, spec, stem, programs)
        out_p, inv_p = execute_programs_plain(banks, tables, spec, stem, programs)
        assert execute_programs_kernel.launches == before + 1
        assert torch.equal(inv_k, inv_p)
        assert bool(inv_k[-2]) and not bool(inv_k[-1]) and not bool(inv_k[:-2].any())
        scale = max(1.0, float(out_p.float().abs().max()))
        assert float((out_k.float() - out_p.float()).abs().max()) <= tol * scale
    # bfloat16 runs only on the tensor cores: C = 128 and H * W <= 256, else it raises.
    with pytest.raises(ValueError):
        execute_programs_kernel(banks, tables, spec, stem.new_zeros(12, 17, 16, stem.shape[-1]),
                                programs)


def _clevr_batch(vocab, n, seed):
    r"""``n`` CLEVR-like programs with token soups, a program with no scene and
    an all-pad row at the end, as chip_smoke.py's batches."""
    programs = sample_clevr_like_programs(vocab, n, seed=seed)
    rs = np.random.RandomState(seed + 1)
    programs[-8:] = rs.randint(0, len(vocab.get_index_to_token_vocabulary("programs")),
                               (8, programs.shape[1]))
    programs[-2, :] = 0
    programs[-2, :2] = [vocab.get_token_index("count", "programs"),
                        vocab.get_token_index("filter_color[red]", "programs")]
    programs[-1] = 0
    return programs


@pytest.mark.parametrize("batch", [1, 37, 256, 300])
def test_plan_kernel_matches_plain_version(cuda, batch):
    vocab = make_clevr_like_vocabulary()
    spec = nmn.make_spec(vocab)
    programs = torch.from_numpy(_clevr_batch(vocab, max(batch, 10), seed=batch)[-batch:])
    tables = build_tables(spec)
    before = interpreter_plan.launches
    convs, order = interpreter_plan(build_tables(spec, cuda), programs.to(cuda))
    assert interpreter_plan.launches == before + 1
    want_convs, want_order = interpreter_plan_plain(tables, programs)
    assert torch.equal(convs.cpu(), want_convs) and torch.equal(order.cpu(), want_order)


@pytest.mark.parametrize("hw", [(14, 14), (16, 16)])
def test_forward_core_matches_plain_version_at_full_width(cuda, hw):
    r"""K2 and K5 in bfloat16 at C = 128 on 14 x 14 (196 pixels: four 64-row
    tiles, the last ragged) and 16 x 16 (256: the most the wgmma core takes,
    two ring stages) against the plain version, on CLEVR programs with the
    35-conv program of chip_smoke.py's timed batch, token soups, a program
    with no scene and an all-pad row; K5 equal to K2 bit for bit."""
    vocab = make_clevr_like_vocabulary()
    spec = nmn.make_spec(vocab)
    spec.feature_channels, (spec.height, spec.width) = 32, hw
    tables = build_tables(spec, cuda)
    timed = torch.from_numpy(sample_clevr_like_programs(vocab, 256, seed=1))
    convs, order = interpreter_plan_plain(build_tables(spec), timed)
    assert int(convs.max()) == 35
    programs = _clevr_batch(vocab, 40, seed=9)
    programs[0] = timed[int(order[0])].numpy()
    programs = torch.from_numpy(programs).to(cuda)
    gen = torch.Generator().manual_seed(11)
    params = cast_params(nmn.init_nmn_params(gen, spec), torch.float32, cuda)
    feats = torch.randn(40, *hw, 32, generator=gen).to(cuda, torch.bfloat16)
    stem = nmn.apply_stem(cast_params(params["stem"], torch.bfloat16), feats).contiguous()
    banks = build_banks(params, spec, torch.bfloat16)
    out_k, inv_k = execute_programs_kernel(banks, tables, spec, stem, programs)
    final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
    out_p, inv_p, otraj_p, atraj_p = execute_programs_plain(banks, tables, spec, stem, programs,
                                                            record=True)
    assert torch.equal(final, out_k) and torch.equal(invalid, inv_k)
    assert torch.equal(inv_k, inv_p) and bool(inv_k[-2]) and not bool(inv_k[-1])
    assert not bool(inv_k[:-8].any())
    scale = float(out_p.float().abs().max())
    assert float((out_k.float() - out_p.float()).abs().max()) <= 2e-2 * scale
    # K5's residuals at the two-conv steps of the valid rows, against the plain version's.
    ran = atraj_p.flatten(2).abs().amax(2) > 0
    ran[inv_p] = False
    for got, want in ((atraj, atraj_p), (otraj, otraj_p)):
        err = float((got.float() - want.float()).abs().flatten(2).amax(2)[ran].max())
        assert err <= 2e-2 * float(want.float().abs().max()), err


# K6 against autograd through the plain machine: float32 within 1e-4 of
# each leaf's scale; bfloat16 within 1e-1 of it. The plain version rounds
# every gradient to bfloat16 where its forward rounds a value; the kernel
# rounds only g_z and the heads' g, as the JAX kernel does; the two differ
# by several percent of a leaf's scale at random init. The tensor-core
# pieces are held tightly besides: K6's weight-gradient kernel and conv input
# gradients within WS_TOL of float64 sums over the operands it wrote to its
# workspace (relative to the sum of |products|; chip_smoke.py phase 8 says
# what it measured).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-1}
WS_TOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_match_plain_versions(cuda, dtype):
    vocab = make_clevr_like_vocabulary()
    spec = nmn.make_spec(vocab)
    spec.feature_channels, spec.height, spec.width = 16, 6, 6
    gen = torch.Generator().manual_seed(3)
    params = cast_params(nmn.init_nmn_params(gen, spec), torch.float32, cuda)
    programs = sample_clevr_like_programs(vocab, 12, seed=4)
    programs[-1] = 0
    programs[-2, :] = 0
    programs[-2, 0] = vocab.get_token_index("intersect", "programs")
    programs = torch.from_numpy(programs).to(cuda)
    feats = torch.randn(12, 6, 6, 16, generator=gen).to(cuda)
    tables = build_tables(spec, cuda)
    stem = nmn.apply_stem(cast_params(params["stem"], dtype), feats.to(dtype)).contiguous()
    banks = build_banks(params, spec, dtype)

    before = (execute_programs_train_kernel.launches, interpreter_grads_kernel.launches)
    final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
    out2, inv2 = execute_programs_kernel(banks, tables, spec, stem, programs)
    assert torch.equal(final, out2) and torch.equal(invalid, inv2)  # K5 is K2, bit for bit
    want, want_inv = execute_programs_plain(banks, tables, spec, stem, programs)
    assert torch.equal(invalid, want_inv)
    assert bool(invalid[-2]) and not bool(invalid[-1]) and not bool(invalid[:-2].any())
    scale = max(1.0, float(want.float().abs().max()))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((final.float() - want.float()).abs().max()) <= tol * scale

    # A cotangent that final's dtype holds exactly, as autograd hands it over.
    g = torch.randn(final.shape, generator=gen).to(cuda).to(dtype).float()
    ws = {}
    d_banks, d_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                               otraj, atraj, workspace=ws)
    tight = workspace_errors(ws, banks, tables, spec)
    assert tight["chained"] > 0 and tight["weight_grad"] <= WS_TOL, tight
    assert tight["input_grad"] <= WS_TOL, tight
    again = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g, otraj, atraj)
    assert torch.equal(d_stem, again[1])  # no float atomics: the same bits every time
    assert all(torch.equal(d_banks[k], again[0][k]) for k in DIFF_BANKS)
    assert (execute_programs_train_kernel.launches, interpreter_grads_kernel.launches) == (
        before[0] + 1, before[1] + 2)
    assert float(d_stem[-2].float().abs().max()) == 0.0  # invalid: zero gradient
    w_banks, w_stem = interpreter_grads_plain(banks, tables, spec, stem, programs, g)
    for name, got, want in [("stem", d_stem, w_stem)] + [(k, d_banks[k], w_banks[k])
                                                          for k in DIFF_BANKS]:
        assert got.dtype == want.dtype and got.shape == want.shape, name
        err = float((got.float() - want.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * max(1.0, float(want.float().abs().max())), (name, err)

    # Through autograd: K5 forward, K6 backward, once each.
    leaves = {k: banks[k].detach().clone().requires_grad_(True) for k in DIFF_BANKS}
    stem_leaf = stem.detach().clone().requires_grad_(True)
    final_d, _ = execute_programs_diff(dict(banks, **leaves), tables, spec, stem_leaf, programs)
    (final_d.float() * g).sum().backward()
    assert torch.equal(stem_leaf.grad, d_stem)
    assert all(torch.equal(leaves[k].grad, d_banks[k]) for k in DIFF_BANKS)
    assert (execute_programs_train_kernel.launches, interpreter_grads_kernel.launches) == (
        before[0] + 2, before[1] + 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_backward_matches_no_replay_bit_for_bit(cuda, dtype):
    r"""K6 in replay mode (no residuals) against K6 over K5's residuals: the
    same dx, bank gradients and workspace entries, bit for bit, and the plain
    version within GRAD_TOL. 300 examples outnumber the replay grid at this
    size, so blocks take several examples each."""
    vocab = make_clevr_like_vocabulary()
    spec = nmn.make_spec(vocab)
    spec.feature_channels, spec.height, spec.width = 16, 6, 6
    gen = torch.Generator().manual_seed(7)
    params = cast_params(nmn.init_nmn_params(gen, spec), torch.float32, cuda)
    programs = sample_clevr_like_programs(vocab, 300, seed=8)
    programs[-1] = 0
    programs[-2, :] = 0
    programs[-2, 0] = vocab.get_token_index("intersect", "programs")
    programs = torch.from_numpy(programs).to(cuda)
    feats = torch.randn(300, 6, 6, 16, generator=gen).to(cuda)
    tables = build_tables(spec, cuda)
    stem = nmn.apply_stem(cast_params(params["stem"], dtype), feats.to(dtype)).contiguous()
    banks = build_banks(params, spec, dtype)
    final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
    g = torch.randn(final.shape, generator=gen).to(cuda).to(dtype).float()
    ws, ws_replay = {}, {}
    d_banks, d_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                               otraj, atraj, workspace=ws)
    before = (interpreter_grads_kernel.launches, interpreter_grads_kernel.replay_launches)
    r_banks, r_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                               workspace=ws_replay)
    assert (interpreter_grads_kernel.launches, interpreter_grads_kernel.replay_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(d_stem, r_stem)
    assert all(torch.equal(d_banks[k], r_banks[k]) for k in DIFF_BANKS)
    assert all(torch.equal(ws[k], ws_replay[k]) for k in ("inp", "g", "tag", "dil", "dw3", "dwc"))
    again = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g)
    assert torch.equal(r_stem, again[1]) and all(torch.equal(r_banks[k], again[0][k])
                                                 for k in DIFF_BANKS)
    w_banks, w_stem = interpreter_grads_plain(banks, tables, spec, stem, programs, g)
    for name, got, want in [("stem", r_stem, w_stem)] + [(k, r_banks[k], w_banks[k])
                                                          for k in DIFF_BANKS]:
        err = float((got.float() - want.float()).abs().max())
        assert err <= GRAD_TOL[dtype] * max(1.0, float(want.float().abs().max())), (name, err)

    # Through autograd with the replay selected: K2 forward, K6 replay backward.
    leaves = {k: banks[k].detach().clone().requires_grad_(True) for k in DIFF_BANKS}
    stem_leaf = stem.detach().clone().requires_grad_(True)
    counts = (execute_programs_kernel.launches, execute_programs_train_kernel.launches,
              interpreter_grads_kernel.replay_launches)
    final_d, _ = execute_programs_diff(dict(banks, **leaves), tables, spec, stem_leaf, programs,
                                       replay=True)
    assert torch.equal(final_d, final)  # K2's output is K5's
    (final_d.float() * g).sum().backward()
    assert torch.equal(stem_leaf.grad, d_stem)
    assert all(torch.equal(leaves[k].grad, d_banks[k]) for k in DIFF_BANKS)
    assert (execute_programs_kernel.launches, execute_programs_train_kernel.launches,
            interpreter_grads_kernel.replay_launches) == (counts[0] + 1, counts[1], counts[2] + 1)


@pytest.mark.parametrize("dtype, hw", [(torch.bfloat16, (6, 6)), (torch.bfloat16, (14, 14)),
                                       (torch.bfloat16, (16, 14)), (torch.float32, (6, 6)),
                                       (torch.float32, (14, 14))])
def test_weight_grad_kernel_matches_plain_version(cuda, dtype, hw):
    r"""K6's weight-gradient stage alone on skewed tags (one target with 150
    entries over several chunks, targets with one, targets with none,
    unwritten entries between) at C = 128: within WS_TOL of the plain
    version (relative to the sum of |products|), empty targets exactly 0,
    the same bits twice, one launch counted a call. bf16 runs TMA and wgmma
    (up to 224 pixels: 16 x 14 fills the last K step), float32 the SIMT
    FMAs."""
    h, w = hw
    s3, sc, c = 9, 2, 128
    n_targets = s3 + 2 * sc
    rs = np.random.RandomState(h * w)
    tags = np.array([3] * 150 + [0, 7, s3, s3 + 3] + list(rs.randint(0, 3, 40)) + [n_targets] * 9,
                    np.int32)
    rs.shuffle(tags)
    dil = np.where(tags < s3, rs.choice([1, 2, 4, 8], tags.size), 0).astype(np.int32)
    tag, dil = torch.from_numpy(tags).to(cuda), torch.from_numpy(dil).to(cuda)
    inp = torch.randn(tags.size, h * w, c, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    g = torch.randn(tags.size, h * w, c, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    assert int(weight_grad_plan(tag, n_targets)["target_chunks"][3]) > 1
    before = weight_grad_kernel.launches
    got = weight_grad_kernel(inp, g, tag, dil, s3, sc, h, w)
    again = weight_grad_kernel(inp, g, tag, dil, s3, sc, h, w)
    assert weight_grad_kernel.launches == before + 2
    want = weight_grad_plain(inp, g, tag, dil, s3, sc, h, w)
    scale = weight_grad_plain(inp.abs(), g.abs(), tag, dil, s3, sc, h, w)
    for a, b, ref, top in zip(got, again, want, scale):  # dw3, then dwc: per (target, tap)
        assert torch.equal(a, b)
        err = (a - ref).flatten(0, 1).flatten(1).abs().amax(1)
        top = top.flatten(0, 1).flatten(1).amax(1)
        assert float((err / top.clamp_min(1e-30)).max()) <= WS_TOL
        assert not a.flatten(0, 1)[top == 0].any()  # no products there: exactly 0


@pytest.mark.parametrize("sizes", [
    dict(vocab_size=20, input_size=16, hidden_size=12, num_layers=1, batch=9, length=7),
    dict(vocab_size=44, input_size=64, hidden_size=96, num_layers=2, batch=37, length=26),
    # Shapes the forward sweep's plan must handle: one row; one-token programs
    # and rows padded to nothing; 300 rows (the plan holds them at once); the
    # shipped width at its batch, and at a batch whose clusters run in waves.
    dict(vocab_size=20, input_size=16, hidden_size=12, num_layers=2, batch=1, length=7),
    dict(vocab_size=44, input_size=64, hidden_size=96, num_layers=2, batch=20, length=1,
         pad_rows=12),
    dict(vocab_size=44, input_size=64, hidden_size=96, num_layers=2, batch=300, length=26),
    dict(vocab_size=44, input_size=256, hidden_size=256, num_layers=2, batch=256, length=26),
    dict(vocab_size=44, input_size=256, hidden_size=256, num_layers=2, batch=800, length=10),
])
def test_lm_kernels_match_plain_versions(cuda, sizes):
    sizes = dict(sizes)
    batch, length = sizes.pop("batch"), sizes.pop("length")
    pad_rows = sizes.pop("pad_rows", 0)
    spec = program_prior.ProgramPriorSpec(**sizes)
    gen = torch.Generator().manual_seed(3)
    params = program_prior.init_program_prior_params(gen, spec)
    params = {"embedding": params["embedding"].to(cuda), "projection": params["projection"].to(cuda),
              "encoder": [{k: v.to(cuda) for k, v in layer.items()} for layer in params["encoder"]]}
    rs = np.random.RandomState(4)
    tok = rs.randint(4, spec.vocab_size, (batch, length))
    tok *= np.arange(length)[None, :] < rs.randint(1, max(length, 2), (batch, 1))
    tok[0] = rs.randint(4, spec.vocab_size, (length,))
    tok[1:2] = 0
    if pad_rows:
        tok[-pad_rows:] = 0
    tok = torch.from_numpy(tok).to(cuda)
    dloss = torch.from_numpy(rs.rand(batch).astype(np.float32) + 0.5).to(cuda)
    packed = pack_lm_weights(params)
    L, steps = spec.num_layers, length + 1
    plan = tf_sweep_plan(batch, spec.hidden_size, forward=True)
    if batch == 800:  # more forward sweep clusters than the card runs at once
        assert plan["clusters"] > plan["fit"], plan
    elif batch >= 256:
        assert plan["clusters"] <= plan["fit"], plan

    before = (lm_forward_cuda.launches, lm_backward_cuda.launches)
    loss = lm_forward_cuda(packed, spec, tok)
    torch.testing.assert_close(loss, lm_loss_plain(params, spec, tok), rtol=0, atol=1e-5)
    got = lm_backward_cuda(packed, spec, tok, dloss)
    want = lm_grads_plain(params, spec, tok, dloss)
    for g, w in zip(param_leaves(got), param_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
    again = lm_backward_cuda(packed, spec, tok, dloss)
    for a, b in zip(param_leaves(got), param_leaves(again)):
        assert torch.equal(a, b)  # no float atomics: the same bits every time
    assert torch.equal(loss, lm_forward_cuda(packed, spec, tok))
    assert (lm_forward_cuda.launches, lm_backward_cuda.launches) == (before[0] + 2, before[1] + 2)
    # Each layer's recurrence is one sweep, in K3f and in K3b's replay alike.
    assert _launches(lambda: lm_forward_cuda(packed, spec, tok)) == {
        "lstm_fwd_sweep": L, "lstm_fwd_step": 0, "lstm_bwd_sweep": 0, "lstm_bwd_step": 0}
    assert _launches(lambda: lm_backward_cuda(packed, spec, tok, dloss)) == {
        "lstm_fwd_sweep": L, "lstm_fwd_step": 0, "lstm_bwd_sweep": 0, "lstm_bwd_step": L * steps}

    # Through autograd: K3f forward, K3b backward, once each.
    before = (lm_forward_cuda.launches, lm_backward_cuda.launches)
    leaves = [p.detach().clone().requires_grad_(True) for p in param_leaves(params)]
    out = fused_lm_loss(params_from_leaves(leaves), spec, tok)
    (out * dloss).sum().backward()
    for leaf, w in zip(leaves, param_leaves(want)):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
    assert (lm_forward_cuda.launches, lm_backward_cuda.launches) == (before[0] + 1, before[1] + 1)


def _tf_tokens(rs, batch, length, vocab, end_index=3):
    r"""Right-padded rows with a full-length row and an all-pad row."""
    tok = rs.randint(4, vocab, (batch, length))
    tok *= np.arange(length)[None, :] < rs.randint(1, length + 1, (batch, 1))
    tok[0] = rs.randint(4, vocab, (length,))
    tok[1:2] = 0
    return tok


@pytest.mark.parametrize("sizes", [
    dict(source_vocab_size=20, target_vocab_size=15, input_size=16, hidden_size=12, num_layers=1,
         batch=9, ls=7, lt=5),
    dict(source_vocab_size=92, target_vocab_size=44, input_size=64, hidden_size=96, num_layers=2,
         batch=37, ls=45, lt=26),
    # The shipped width at a batch that needs more reverse sweep clusters than
    # fit at once (the forward sweep's plan holds it at once).
    dict(source_vocab_size=92, target_vocab_size=44, input_size=256, hidden_size=256,
         num_layers=2, batch=300, ls=45, lt=26),
    # One row; a source of one step (its token or none, plus @end@) with rows
    # padded to nothing on both sides; a question_coding pass at shipped width.
    dict(source_vocab_size=20, target_vocab_size=15, input_size=16, hidden_size=12, num_layers=2,
         batch=1, ls=7, lt=5),
    dict(source_vocab_size=92, target_vocab_size=44, input_size=64, hidden_size=96, num_layers=2,
         batch=37, ls=1, lt=26, pad_rows=9),
    dict(source_vocab_size=92, target_vocab_size=44, input_size=256, hidden_size=256,
         num_layers=2, batch=128, ls=45, lt=26),
])
@pytest.mark.parametrize("reinforce_norm", [False, True])
def test_tf_kernels_match_plain_versions(cuda, sizes, reinforce_norm):
    sizes = dict(sizes)
    batch, ls, lt = sizes.pop("batch"), sizes.pop("ls"), sizes.pop("lt")
    pad_rows = sizes.pop("pad_rows", 0)
    spec = Seq2SeqSpec(**sizes)
    params = init_seq2seq_params(torch.Generator().manual_seed(5), spec)
    params = tf_params_from_leaves([p.to(cuda) for p in tf_param_leaves(params)])
    rs = np.random.RandomState(6)
    src = _tf_tokens(rs, batch, ls, spec.source_vocab_size)
    tgt = _tf_tokens(rs, batch, lt, spec.target_vocab_size)
    if reinforce_norm:  # a trimmed z: @end@ kept after the last token of some rows
        ends = rs.rand(batch) < 0.5
        lens = (tgt != 0).sum(1)
        for b in np.flatnonzero(ends & (lens < lt)):
            tgt[b, lens[b]] = spec.end_index
        tgt[2:3] = 0  # @end@ came first: trimmed to all pad
    if pad_rows:
        src[-pad_rows:] = 0
        tgt[-pad_rows:] = 0
    src, tgt = torch.from_numpy(src).to(cuda), torch.from_numpy(tgt).to(cuda)
    dloss = torch.from_numpy(rs.rand(batch).astype(np.float32) + 0.5).to(cuda)
    packed = pack_tf_weights(params, spec)

    if batch == 300:  # more reverse sweep clusters than the card runs at once
        plan = tf_sweep_plan(batch, spec.hidden_size)
        assert plan["clusters"] > plan["fit"], plan
        plan = tf_sweep_plan(batch, spec.hidden_size, forward=True)
        assert plan["clusters"] <= plan["fit"], plan
    before = (tf_forward_cuda.launches, tf_backward_cuda.launches)
    lean = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm)
    loss, residuals = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True)
    assert torch.equal(lean, loss) and residuals.nbytes > 0
    want_loss = tf_loss_plain(params, spec, src, tgt, reinforce_norm)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-5)
    got = tf_backward_cuda(residuals, dloss)
    assert residuals.nbytes == 0  # consumed
    with pytest.raises(RuntimeError, match="already consumed"):
        tf_backward_cuda(residuals, dloss)
    want = tf_grads_plain(params, spec, src, tgt, dloss, reinforce_norm)
    for g, w in zip(tf_param_leaves(got), tf_param_leaves(want)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
    # No float atomics: K4f + K4b run again give the same bits.
    loss_again, residuals = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True)
    again = tf_backward_cuda(residuals, dloss)
    assert torch.equal(loss, loss_again)
    for a, b in zip(tf_param_leaves(got), tf_param_leaves(again)):
        assert torch.equal(a, b)
    assert (tf_forward_cuda.launches, tf_backward_cuda.launches) == (before[0] + 3, before[1] + 2)
    # The encoder: one forward sweep a layer (lean or keeping) and one reverse
    # sweep a layer; the decoder: a step launch each way a step.
    steps = lt + (0 if reinforce_norm else 1)
    L = spec.num_layers
    assert _launches(lambda: tf_forward_cuda(packed, spec, src, tgt, reinforce_norm)) == {
        "lstm_fwd_sweep": L, "lstm_fwd_step": steps, "lstm_bwd_sweep": 0, "lstm_bwd_step": 0}
    _, residuals = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True)
    assert _launches(lambda: tf_backward_cuda(residuals, dloss)) == {
        "lstm_fwd_sweep": 0, "lstm_fwd_step": 0, "lstm_bwd_sweep": L, "lstm_bwd_step": steps}
    before = (tf_forward_cuda.launches, tf_backward_cuda.launches)

    # Through autograd: K4f keeping its residuals, K4b from them, once each.
    leaves = [p.detach().clone().requires_grad_(True) for p in tf_param_leaves(params)]
    out = fused_tf_loss(tf_params_from_leaves(leaves), spec, src, tgt, reinforce_norm)
    total = (out * dloss).sum()
    total.backward(retain_graph=True)
    for leaf, w in zip(leaves, tf_param_leaves(want)):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
    with pytest.raises(RuntimeError, match="second time"):
        total.backward()
    assert (tf_forward_cuda.launches, tf_backward_cuda.launches) == (before[0] + 1, before[1] + 1)


def test_forward_takes_the_per_step_route_above_a_cluster(cuda):
    r"""Above H = 256 no cluster holds a layer: K3f, K3b's replay and K4f
    under ``torch.no_grad()`` run the recurrence one ``lstm_fwd_step`` launch
    a step, chosen by the shape before any launch, and still match their
    plain versions."""
    L, length = 2, 6
    spec = program_prior.ProgramPriorSpec(vocab_size=20, input_size=16, hidden_size=264,
                                          num_layers=L)
    params = program_prior.init_program_prior_params(torch.Generator().manual_seed(8), spec)
    params = params_from_leaves([p.to(cuda) for p in param_leaves(params)])
    rs = np.random.RandomState(8)
    tok = torch.from_numpy(_tf_tokens(rs, 5, length, spec.vocab_size)).to(cuda)
    dloss = torch.from_numpy(rs.rand(5).astype(np.float32) + 0.5).to(cuda)
    packed = pack_lm_weights(params)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tf_sweep_plan(5, 264, forward=True)
    counts = _launches(lambda: lm_forward_cuda(packed, spec, tok))
    assert counts == {"lstm_fwd_sweep": 0, "lstm_fwd_step": L * (length + 1), "lstm_bwd_sweep": 0,
                      "lstm_bwd_step": 0}, counts
    counts = _launches(lambda: lm_backward_cuda(packed, spec, tok, dloss))
    assert counts == {"lstm_fwd_sweep": 0, "lstm_fwd_step": L * (length + 1), "lstm_bwd_sweep": 0,
                      "lstm_bwd_step": L * (length + 1)}, counts
    torch.testing.assert_close(lm_forward_cuda(packed, spec, tok), lm_loss_plain(params, spec, tok),
                               rtol=0, atol=1e-5)
    want = lm_grads_plain(params, spec, tok, dloss)
    for g, w in zip(param_leaves(lm_backward_cuda(packed, spec, tok, dloss)), param_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))

    tf_spec = Seq2SeqSpec(source_vocab_size=20, target_vocab_size=15, input_size=16,
                          hidden_size=264, num_layers=L)
    tf_params = init_seq2seq_params(torch.Generator().manual_seed(9), tf_spec)
    tf_params = tf_params_from_leaves([p.to(cuda) for p in tf_param_leaves(tf_params)])
    src = torch.from_numpy(_tf_tokens(rs, 4, 6, tf_spec.source_vocab_size)).to(cuda)
    tgt = torch.from_numpy(_tf_tokens(rs, 4, 5, tf_spec.target_vocab_size)).to(cuda)
    with torch.no_grad():
        got = {}
        counts = _launches(lambda: got.update(loss=fused_tf_loss(tf_params, tf_spec, src, tgt)))
    assert counts == {"lstm_fwd_sweep": 0, "lstm_fwd_step": L * 7 + 6, "lstm_bwd_sweep": 0,
                      "lstm_bwd_step": 0}, counts
    torch.testing.assert_close(got["loss"], tf_loss_plain(tf_params, tf_spec, src, tgt), rtol=0,
                               atol=1e-5)


def test_tf_backward_refuses_a_layer_no_cluster_holds(cuda):
    r"""Above H = 256 no cluster holds the encoder's reverse sweep: K4b
    refuses with cudaErrorInvalidValue and the wrapper raises."""
    spec = Seq2SeqSpec(source_vocab_size=20, target_vocab_size=15, input_size=16, hidden_size=264,
                       num_layers=1)
    params = init_seq2seq_params(torch.Generator().manual_seed(7), spec)
    params = tf_params_from_leaves([p.to(cuda) for p in tf_param_leaves(params)])
    rs = np.random.RandomState(7)
    src = torch.from_numpy(_tf_tokens(rs, 4, 6, spec.source_vocab_size)).to(cuda)
    tgt = torch.from_numpy(_tf_tokens(rs, 4, 5, spec.target_vocab_size)).to(cuda)
    _, residuals = tf_forward_cuda(pack_tf_weights(params, spec), spec, src, tgt, keep=True)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        tf_backward_cuda(residuals, torch.ones(4, device=cuda))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tf_sweep_plan(4, 264)
    assert tf_sweep_plan(4, 256)["cluster"] == 8


def test_phase8_float32_k6_input(cuda, tmp_path):
    r"""chip_smoke.py phase 8's float32 K6 check on the input that once failed
    it: every draw of phase 8 one draw of (256, 46, 256) later from its
    generator, whose state before the feature draw tools/k6_flips.py wrote
    to tests/data. Against autograd through the batched plain machine, K6's
    w3 and b3 stand off (5.20e-3 against a limit of 4.57e-3 on w3): in row
    104, the ReLU input of relate's last conv at one element lies within
    float32 rounding of 0 (5.4e-8 in float64 from K5's own input), and the
    batched plain forward puts it at 0, on the other side of K5's, which
    flips that element's gradient (tools/k6_flips.py). Held to the plain
    version run alone on that row (interpreter_grads_plain_by_row), every
    leaf is within 1e-4 of its scale, as chip_smoke.py holds it."""
    from tools.k6_flips import STATE, phase8_input

    spec, tables, banks, stem, programs, g = phase8_input(
        np, torch, cuda, make_clevr_like_vocabulary(), torch.from_numpy(np.load(STATE)),
        str(tmp_path))
    final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
    d_banks, d_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                               otraj, atraj)
    w_banks, w_stem, alone = interpreter_grads_plain_by_row(banks, tables, spec, stem, programs, g,
                                                            d_stem, GRAD_TOL[torch.float32])
    assert 104 in alone, alone
    for name, got, want in [("stem", d_stem, w_stem)] + [(k, d_banks[k], w_banks[k])
                                                          for k in DIFF_BANKS]:
        err = float((got - want).abs().max())
        assert err <= GRAD_TOL[torch.float32] * max(1.0, float(want.abs().max())), (name, err)


def test_phase8_float32_k6_input_on_the_float64_branch(cuda, tmp_path):
    r"""The same input held as chip_smoke.py now holds float32 K6: against
    the float64 gradient of the branch K5 and K6 took
    (interpreter_grads_on_branch), which reads relate's last ReLU side
    from where K6 passed a gradient (row 104's tie lies there). No
    decision is off float64's by more than BRANCH_TOL of its scale; every
    workspace entry is where the sweep puts it; K5's final and every K6
    leaf are within 1e-4 of their scale."""
    from tools.k6_flips import STATE, phase8_input

    spec, tables, banks, stem, programs, g = phase8_input(
        np, torch, cuda, make_clevr_like_vocabulary(), torch.from_numpy(np.load(STATE)),
        str(tmp_path))
    final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
    ws = {}
    d_banks, d_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                               otraj, atraj, workspace=ws)
    w_banks, w_stem, w_final, report = interpreter_grads_on_branch(
        banks, tables, spec, stem, programs, g, invalid, otraj, atraj, ws)
    assert report["far"] == 0 and report["entries"] == 0 and report["rows"] == 0, report
    assert float((final.double() - w_final).abs().max()) <= 1e-4 * max(
        1.0, float(w_final.abs().max()))
    for name, got, want in [("stem", d_stem, w_stem)] + [(k, d_banks[k], w_banks[k])
                                                          for k in DIFF_BANKS]:
        err = float((got.double() - want).abs().max())
        assert err <= GRAD_TOL[torch.float32] * max(1.0, float(want.abs().max())), (name, err)


# GEMM shapes: M, N, K off the tile multiples; one element; a K that the
# split cuts into 128- and 512-deep chunks; the decoder's per-step product
# (B x 2H x 4H) and a weight gradient over T*B rows at shipped width.
GEMM_SHAPES = [(1, 1, 1), (37, 45, 19), (130, 70, 33), (5, 300, 7), (200, 130, 1000),
               (128, 512, 1024), (1024, 256, 3456)]


def _gemm_operand(rs, rows, cols, transposed, offset, device):
    r"""A (rows, cols) float32 view whose contiguous axis is the other one
    when ``transposed``, starting ``offset`` floats into its storage."""
    shape = (cols, rows) if transposed else (rows, cols)
    flat = torch.from_numpy(rs.randn(offset + shape[0] * shape[1]).astype(np.float32)).to(device)
    x = flat[offset:].view(shape)
    return x.t() if transposed else x


@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("pattern", ["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("epilogue", ["plain", "bias", "accumulate", "unaligned"])
def test_gemm_matches_float64(cuda, shape, pattern, epilogue):
    r"""Every stride pattern (A with m or k contiguous, B with n or k
    contiguous), with a bias, accumulating into C, or from operands that
    start one float past a 16-byte boundary (the 4-byte copies), split and
    not: within 1e-5 of the sum of |products| of float64 torch.matmul, and
    the same bits on a second run."""
    M, N, K = shape
    rs = np.random.RandomState(M * 7 + N * 3 + K)
    offset = 1 if epilogue == "unaligned" else 0
    a = _gemm_operand(rs, M, K, pattern[0] == "t", offset, cuda)
    b = _gemm_operand(rs, K, N, pattern[1] == "t", offset, cuda)
    bias = torch.randn(N, device=cuda) if epilogue == "bias" else None
    c0 = torch.randn(M, N, device=cuda) if epilogue == "accumulate" else None
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    if bias is not None:
        want, scale = want + bias.double(), scale + bias.double().abs()
    if c0 is not None:
        want, scale = want + c0.double(), scale + c0.double().abs()
    for split in (False, True):
        runs = []
        for _ in range(2):
            out = c0.clone() if c0 is not None else None
            runs.append(gemm_cuda(a, b, bias=bias, out=out, accumulate=c0 is not None,
                                  split=split))
        torch.cuda.synchronize()
        err = (runs[0].double() - want).abs()
        assert bool((err <= 1e-5 * scale + 1e-30).all()), (split, float(err.max()))
        assert torch.equal(runs[0], runs[1]), split


def test_gemm_plan_and_launches_match_the_python_twin(cuda):
    r"""The C library's plan equals :func:`gemm_plan` on every shape and
    stride pattern of GEMM_SHAPES, split and not; the launch count and the
    recorder see each call once, with the plan's splits and tile."""
    for M, N, K in GEMM_SHAPES:
        for a_strides in ((K, 1), (1, M)):
            for b_strides in ((N, 1), (1, K)):
                for split in (False, True):
                    assert gemm_plan_cuda(M, N, K, a_strides, b_strides, split) == gemm_plan(
                        M, N, K, a_strides, b_strides, split)
    a = torch.randn(128, 1024, device=cuda)
    b = torch.randn(1024, 512, device=cuda)
    gemm_launches(reset=True)
    gemm_record(True)
    gemm_cuda(a, b, split=True)
    gemm_cuda(a, b)
    gemm_record(False)
    gemm_cuda(a, b)
    records = gemm_records()
    assert gemm_launches() == 3 and len(records) == 2
    for record, split in zip(records, (True, False)):
        plan = gemm_plan(128, 512, 1024, (1024, 1), (512, 1), split)
        assert (record["M"], record["N"], record["K"]) == (128, 512, 1024)
        assert (record["splits"], (record["tile_m"], record["tile_n"])) == (
            plan["splits"], plan["tile"])


def test_phase13_bucket_check_at_four_rows(cuda):
    r"""chip_smoke.py phase 13 (a) at B = 4 alone, at full width: K1 (the
    decoder's cluster plan leaves most CTAs without a row) and K2 (its
    persistent grid has one block an example) against their plain versions
    in both dtypes, at phases 2 and 3's tolerances."""
    import chip_smoke

    vocab = make_clevr_like_vocabulary()
    pg_spec, nmn_spec = program_generator.make_spec(vocab), nmn.make_spec(vocab)
    gen = torch.Generator().manual_seed(13)
    pg = cast_params(program_generator.init_params(gen, pg_spec), torch.float32, cuda)
    nmn_params = cast_params(nmn.init_nmn_params(gen, nmn_spec), torch.float32, cuda)
    k1, k2 = chip_smoke.bucket_against_plain(np, torch, cuda, 4, pg, pg_spec, nmn_params,
                                             nmn_spec, vocab, seed=1300)
    assert set(k1) == set(k2) == {"float32", "bfloat16"}


def test_phase17_float32_check_over_two_shards(cuda):
    r"""chip_smoke.py phase 17's float32 check at 64 rows alone, at full
    width: greedy and sampling engines over two shards (one a card, or both
    on card 0 on a one-card machine) give one card's answers, answers that
    follow the image; the greedy one's dispatcher answers 256 requests as
    one card's ``predict``; and K1 at a row base draws the rows of the full
    batch's Philox stream."""
    import chip_smoke

    (vocab, pg_spec, nmn_spec, scripted, soft, nmn_params, questions, images,
     seed) = chip_smoke.cards_inputs(np, torch, 64)
    requests = chip_smoke.cards_requests(np, vocab, images, 256)
    out = chip_smoke.cards_float32_check(np, torch, vocab, pg_spec, nmn_spec, scripted, soft,
                                         nmn_params, questions, images, seed,
                                         share=torch.cuda.device_count() < 2, requests=requests)
    assert set(out) == {"greedy", "sampling"}
    rows = chip_smoke.k1_row_base_check(np, torch, cast_params(soft, torch.float32, cuda),
                                        pg_spec, torch.from_numpy(questions).to(cuda), seed)
    assert set(rows) == {"0", "32"}

# ------------------------------------------------------------------ inter-layer dropout
DROPOUT_NAMES = ("lstm_fwd_sweep", "lstm_bwd_sweep", "dropout_rows", "k1_dropout")


@pytest.mark.parametrize("num_layers", [2, 3])
def test_masked_lm_kernels_match_plain_versions(cuda, num_layers):
    r"""K3f and K3b with the LM's dropout masks against the plain versions
    under the same masks (phase 6's tolerances): one ``dropout_rows`` launch
    a layer below the top in K3f, and in K3b as many for the replay and as
    many for the gradient; none without masks."""
    spec = program_prior.ProgramPriorSpec(vocab_size=44, input_size=64, hidden_size=96,
                                          num_layers=num_layers, dropout=0.3)
    params = program_prior.init_program_prior_params(torch.Generator().manual_seed(7), spec)
    params = params_from_leaves([p.to(cuda) for p in param_leaves(params)])
    rs = np.random.RandomState(8)
    tok = rs.randint(4, spec.vocab_size, (37, 26))
    tok *= np.arange(26)[None, :] < rs.randint(1, 26, (37, 1))
    tok[1] = 0
    tok = torch.from_numpy(tok).to(cuda)
    masks = program_prior.lm_dropout_masks(torch.Generator(device=cuda).manual_seed(9), spec, tok)
    assert masks.shape == (num_layers - 1, 37, 28, 96) and masks.is_cuda
    dloss = torch.from_numpy(rs.rand(37).astype(np.float32) + 0.5).to(cuda)
    packed = pack_lm_weights(params)
    loss = lm_forward_cuda(packed, spec, tok, masks)
    torch.testing.assert_close(loss, lm_loss_plain(params, spec, tok, masks), rtol=0, atol=1e-5)
    assert float((loss - lm_forward_cuda(packed, spec, tok)).abs().max()) > 1e-3
    want = lm_grads_plain(params, spec, tok, dloss, masks)
    for g, w in zip(param_leaves(lm_backward_cuda(packed, spec, tok, dloss, masks)),
                    param_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
    below = num_layers - 1
    assert _launches(lambda: lm_forward_cuda(packed, spec, tok, masks), DROPOUT_NAMES) == {
        "lstm_fwd_sweep": num_layers, "lstm_bwd_sweep": 0, "dropout_rows": below, "k1_dropout": 0}
    assert _launches(lambda: lm_backward_cuda(packed, spec, tok, dloss, masks),
                     DROPOUT_NAMES)["dropout_rows"] == 2 * below
    assert _launches(lambda: lm_forward_cuda(packed, spec, tok), DROPOUT_NAMES)["dropout_rows"] == 0
    leaves = [p.detach().clone().requires_grad_(True) for p in param_leaves(params)]
    (fused_lm_loss(params_from_leaves(leaves), spec, tok, masks) * dloss).sum().backward()
    for leaf, w in zip(leaves, param_leaves(want)):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))


@pytest.mark.parametrize("reinforce_norm", [False, True])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_masked_tf_kernels_match_plain_versions(cuda, num_layers, reinforce_norm):
    r"""K4f (lean and keeping its residuals) and K4b with the encoder's
    dropout masks against the plain versions under the same masks (phase
    7's tolerances), through autograd too; one ``dropout_rows`` launch a
    layer below the top each way."""
    spec = Seq2SeqSpec(source_vocab_size=92, target_vocab_size=44, input_size=64,
                       hidden_size=96, num_layers=num_layers, dropout=0.2)
    params = init_seq2seq_params(torch.Generator().manual_seed(10), spec)
    params = tf_params_from_leaves([p.to(cuda) for p in tf_param_leaves(params)])
    rs = np.random.RandomState(11)
    src = torch.from_numpy(_tf_tokens(rs, 37, 45, spec.source_vocab_size)).to(cuda)
    tgt = torch.from_numpy(_tf_tokens(rs, 37, 26, spec.target_vocab_size)).to(cuda)
    from probnmn_tpu_torch.models.seq2seq import encoder_dropout_masks

    masks = encoder_dropout_masks(torch.Generator(device=cuda).manual_seed(12), spec, src)
    dloss = torch.from_numpy(rs.rand(37).astype(np.float32) + 0.5).to(cuda)
    packed = pack_tf_weights(params, spec)
    lean = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, dropout_masks=masks)
    loss, residuals = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True,
                                      dropout_masks=masks)
    assert torch.equal(lean, loss)
    torch.testing.assert_close(loss, tf_loss_plain(params, spec, src, tgt, reinforce_norm, masks),
                               rtol=0, atol=1e-5)
    want = tf_grads_plain(params, spec, src, tgt, dloss, reinforce_norm, masks)
    for g, w in zip(tf_param_leaves(tf_backward_cuda(residuals, dloss)), tf_param_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
    below = num_layers - 1
    assert _launches(lambda: tf_forward_cuda(packed, spec, src, tgt, reinforce_norm,
                                             dropout_masks=masks),
                     DROPOUT_NAMES)["dropout_rows"] == below
    _, residuals = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True,
                                   dropout_masks=masks)
    assert _launches(lambda: tf_backward_cuda(residuals, dloss),
                     DROPOUT_NAMES)["dropout_rows"] == below
    leaves = [p.detach().clone().requires_grad_(True) for p in tf_param_leaves(params)]
    out = fused_tf_loss(tf_params_from_leaves(leaves), spec, src, tgt, reinforce_norm, masks)
    (out * dloss).sum().backward()
    for leaf, w in zip(leaves, tf_param_leaves(want)):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_k1_matches_plain_version(cuda, dtype):
    r"""K1's encoder with dropout masks (one ``k1_dropout`` launch a layer
    below the top) against the plain encoder under the same masks, and K1
    against its plain version (phase 2's tolerances), at the shipped width."""
    from probnmn_tpu_torch.models.seq2seq import encoder_dropout_masks

    vocab = make_clevr_like_vocabulary()
    spec = dataclasses.replace(program_generator.make_spec(vocab), dropout=0.2, num_layers=3)
    params = cast_params(program_generator.init_params(torch.Generator().manual_seed(13), spec),
                         torch.float32, cuda)
    rs = np.random.RandomState(14)
    src = torch.from_numpy(_tf_tokens(rs, 64, 45, spec.source_vocab_size)).to(cuda)
    masks = encoder_dropout_masks(torch.Generator(device=cuda).manual_seed(15), spec, src)
    out, final = sampling_encode(params, spec, src, compute_dtype=dtype, dropout_masks=masks)
    want_out, _, want_final, _ = _encode(params, spec, src, dtype, masks)
    plain_out = _encode(params, spec, src, dtype)[0]
    assert float((want_out - plain_out).abs().max()) > 1e-3  # the masks matter
    for got, want in ((out.float(), want_out), (final, want_final)):
        scale = float(want.abs().max())
        tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
        assert float((got - want).abs().max()) <= tol
    assert _launches(lambda: sampling_encode(params, spec, src, compute_dtype=dtype,
                                             dropout_masks=masks), DROPOUT_NAMES)["k1_dropout"] == 2
    assert _launches(lambda: sampling_encode(params, spec, src, compute_dtype=dtype),
                     DROPOUT_NAMES)["k1_dropout"] == 0
    T, V = spec.max_decoding_steps, spec.target_vocab_size
    noise = torch.from_numpy(rs.gumbel(size=(T, 64, V)).astype(np.float32)).to(cuda)
    got = fused_sampling_forward(params, spec, src, noise=noise, compute_dtype=dtype,
                                 dropout_masks=masks)
    want = sampling_forward_with_noise(params, spec, src, noise, compute_dtype=dtype,
                                       dropout_masks=masks)
    same = (got["predictions"] == want["predictions"]).all(dim=1)
    if dtype == torch.float32:
        assert float(same.float().mean()) >= 0.99
        assert float((got["logprobs"] - want["logprobs"])[same].abs().max()) <= 1e-4
    else:
        assert float((got["predictions"] == want["predictions"]).float().mean()) >= 0.95
    with pytest.raises(ValueError, match="dropout masks"):
        sampling_encode(params, spec, src, compute_dtype=dtype, dropout_masks=masks[:, :, :10])


def _pp_rank_on_card(parallel, config, run_dir, dataset, init):
    r"""A rank of the two-card test below: three program_prior steps."""
    from probnmn_tpu_torch.training._trainer import copy_into, tree_leaves, tree_map
    from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = ProgramPriorTrainer(config, run_dir, device=parallel.device,
                                  writer=RecordingWriter(), dataset=dataset, parallel=parallel)
    copy_into(trainer.params["program_prior"], tree_map(lambda t: t.to(parallel.device), init))
    logs = [trainer.step(i) for i in range(3)]
    flat = torch.cat([p.detach().reshape(-1) for p in tree_leaves(trainer.params["program_prior"])])
    return {"logs": logs, "params": flat.cpu(), "device": str(parallel.device)}


def test_program_prior_at_two_ranks_on_two_cards(cuda, tmp_path):
    r"""The program_prior trainer at two ranks over NCCL, one card a rank,
    against one rank on the card: three steps' losses within 2e-4
    relative, the parameters where every step's |g| > 1e-5 within 1% of lr
    a step (a tenth of them at least) and all within 2 lr a step, both
    ranks' parameters equal."""
    import os

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import ProgramPriorDataset
    from probnmn_tpu_torch.parallel import mesh
    from probnmn_tpu_torch.training._trainer import copy_into, tree_leaves, tree_map
    from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    vocab = make_clevr_like_vocabulary()
    vocab.save_to_files(str(tmp_path / "vocab"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = Config(os.path.join(repo, "configs", "program_prior.yml"),
                    ["DATA.VOCABULARY", str(tmp_path / "vocab"), "OPTIM.BATCH_SIZE", 64])
    dataset = ProgramPriorDataset.from_programs(sample_clevr_like_programs(vocab, 512, seed=7))
    one = ProgramPriorTrainer(config, str(tmp_path / "one"), device=cuda,
                              writer=RecordingWriter(), dataset=dataset)
    params = one.params["program_prior"]
    init = tree_map(lambda t: t.detach().cpu().clone(), params)
    losses, smooth = [], None
    for i in range(3):
        losses.append(one.step(i)["loss"])
        big = torch.cat([p.grad.reshape(-1).abs() > 1e-5 for p in tree_leaves(params)])
        smooth = big if smooth is None else smooth & big
    want = torch.cat([p.detach().reshape(-1) for p in tree_leaves(params)]).cpu()
    ranks = mesh.launch(_pp_rank_on_card, 2, "cuda", str(tmp_path), timeout=300,
                        collective_timeout=120,
                        args=(config, str(tmp_path / "ranks"), dataset, init))
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:1"]
    np.testing.assert_allclose([log["loss"] for log in ranks[0]["logs"]], losses, rtol=2e-4)
    assert ranks[1]["logs"] == ranks[0]["logs"]
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    lr = config.OPTIM.LR_INITIAL
    got = ranks[0]["params"]
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    diff = (got - want).abs()
    worst = torch.topk(diff, 3).indices.tolist()
    where = [(i, float(got[i]), float(want[i]), bool(smooth[i])) for i in worst]
    assert float(diff[smooth.cpu()].max()) <= 1e-2 * lr * 3, where
    assert float(diff.max()) <= 2 * lr * 3, where
    assert float(smooth.float().mean()) > 0.1  # 0.22 of the LM's at this width
