"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. These need a CUDA device and skip without one; on a GPU
machine run them with ``python -m pytest --noconftest tests/test_torch_port_cuda.py``
(the JAX-free port needs none of tests/conftest.py). chip_smoke.py holds the
kernels to the same versions at full width."""
import dataclasses

import numpy as np
import pytest
import torch

from probnmn_tpu_torch.models import nmn, program_generator
from probnmn_tpu_torch.models.nmn import cast_params
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    build_banks, build_tables, execute_programs_kernel, execute_programs_plain,
)
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
    fused_sampling_forward, philox_gumbel, sampling_forward_with_noise,
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
