"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. These need a CUDA device and skip without one; on a GPU
machine run them with ``python -m pytest --noconftest tests/test_torch_port_cuda.py``
(the JAX-free port needs none of tests/conftest.py). chip_smoke.py holds the
kernels to the same versions at full width."""
import dataclasses

import numpy as np
import pytest
import torch

from probnmn_tpu_torch.models import nmn, program_generator, program_prior
from probnmn_tpu_torch.models.nmn import cast_params
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    build_banks, build_tables, execute_programs_kernel, execute_programs_plain,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
    fused_sampling_forward, philox_gumbel, sampling_forward_with_noise,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    fused_lm_loss, lm_backward_cuda, lm_forward_cuda, lm_grads_plain, lm_loss_plain,
    pack_lm_weights, param_leaves, params_from_leaves,
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
    # bfloat16 runs only on the tensor cores, which read the transposed banks.
    plain_banks = {k: v for k, v in banks.items() if k not in ("w3t", "wcmpt")}
    with pytest.raises(ValueError):
        execute_programs_kernel(plain_banks, tables, spec, stem, programs)


@pytest.mark.parametrize("sizes", [
    dict(vocab_size=20, input_size=16, hidden_size=12, num_layers=1, batch=9, length=7),
    dict(vocab_size=44, input_size=64, hidden_size=96, num_layers=2, batch=37, length=26),
])
def test_lm_kernels_match_plain_versions(cuda, sizes):
    sizes = dict(sizes)
    batch, length = sizes.pop("batch"), sizes.pop("length")
    spec = program_prior.ProgramPriorSpec(**sizes)
    gen = torch.Generator().manual_seed(3)
    params = program_prior.init_program_prior_params(gen, spec)
    params = {"embedding": params["embedding"].to(cuda), "projection": params["projection"].to(cuda),
              "encoder": [{k: v.to(cuda) for k, v in layer.items()} for layer in params["encoder"]]}
    rs = np.random.RandomState(4)
    tok = rs.randint(4, spec.vocab_size, (batch, length))
    tok *= np.arange(length)[None, :] < rs.randint(1, length, (batch, 1))
    tok[0] = rs.randint(4, spec.vocab_size, (length,))
    tok[1] = 0
    tok = torch.from_numpy(tok).to(cuda)
    dloss = torch.from_numpy(rs.rand(batch).astype(np.float32) + 0.5).to(cuda)
    packed = pack_lm_weights(params)

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
    assert (lm_forward_cuda.launches, lm_backward_cuda.launches) == (before[0] + 1, before[1] + 2)

    # Through autograd: K3f forward, K3b backward, once each.
    leaves = [p.detach().clone().requires_grad_(True) for p in param_leaves(params)]
    out = fused_lm_loss(params_from_leaves(leaves), spec, tok)
    (out * dloss).sum().backward()
    for leaf, w in zip(leaves, param_leaves(want)):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=1e-4 * max(1.0, float(w.abs().max())))
    assert (lm_forward_cuda.launches, lm_backward_cuda.launches) == (before[0] + 2, before[1] + 3)
