"""The training kernels' GEMM (``probnmn_tpu_torch/csrc/gemm.cu``) on the CPU:
its launch plan's Python twin at every call site of K3f/K3b and K4f/K4b at
the shipped widths, the twin's constants against the CUDA source's, and the
plain version (what ``gemm_cuda`` runs on CPU tensors) against float64 and
against JAX's ``jnp.dot``, the product the Pallas kernels compute inside.
The kernel itself runs only on the card: ``tests/test_torch_port_cuda.py``
holds it to float64 there and its plan to this twin. The call sites come
from ``tools/gemm_ab.py::step_classes``, which times the same shapes on the
card."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probnmn_tpu_torch.ops.kernels import gemm
from tools.gemm_ab import step_classes

CSRC = Path(gemm.__file__).resolve().parents[2] / "csrc"


# Every GEMM shape of a question_coding step (passes of half a batch, and of
# a whole one as joint_training runs them) and of a program_prior step at
# the shipped widths, with the strides and scratch K3/K4 pass.
CLASSES = sorted({key for rows in (128, 256) for counts in step_classes(rows).values()
                  for key in counts})


@pytest.mark.parametrize("key", CLASSES, ids=[
    f"{M}x{N}x{K}-{'t' if sa[0] == 1 else 'n'}{'n' if sb[1] == 1 else 't'}"
    for M, N, K, sa, sb, _, _ in CLASSES])
def test_every_call_site_gets_a_plan_that_covers_it(key):
    M, N, K, a_strides, b_strides, split, _ = key
    plan = gemm.gemm_plan(M, N, K, a_strides, b_strides, split)
    bm, bn = plan["tile"]
    assert (bm, bn) in ((64, 64), (128, 64), (128, 128)) and plan["depth"] in (16, 32)
    gx, gy, gz = plan["grid"]
    assert gx * bn >= N > (gx - 1) * bn and gy * bm >= M > (gy - 1) * bm
    assert gz == plan["splits"] and plan["splits"] * plan["k_chunk"] >= K
    assert (plan["splits"] - 1) * plan["k_chunk"] < K
    assert plan["smem"] <= gemm.TWO_BLOCK_SMEM  # two blocks an SM
    # The transposed operands (dpre^T, dlogits^T) land [k][x]; the rest [x][k].
    assert plan["a_k_contiguous"] == (a_strides[1] == 1)
    assert plan["b_k_contiguous"] == (b_strides[0] == 1)
    if split:  # every split GEMM at these widths has a long K and is split
        assert plan["splits"] > 1 and plan["k_chunk"] == gemm.gemm_chunk(K)
        assert gemm.gemm_partial_floats(M, N, K) == plan["splits"] * M * N
    else:
        assert plan["splits"] == 1
    if (N, K) == (512, 1024) and M <= 256:  # the decoder's serial chain: the grid covers the card
        assert gx * gy * gz >= 128


def test_the_plan_does_not_read_the_device(monkeypatch):
    r"""Neither the twin nor gemm.cu asks the device anything: the plan is a
    function of the shape and the strides."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("get_device_properties", "device_count", "is_available", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    plans = [gemm.gemm_plan(*key[:6]) for key in CLASSES]
    assert plans == [gemm.gemm_plan(*key[:6]) for key in CLASSES]
    source = (CSRC / "gemm.cu").read_text()
    for query in ("multiProcessorCount", "cudaGetDeviceProperties", "cudaDeviceGetAttribute",
                  "cudaOccupancy"):
        assert query not in source, query


@pytest.mark.parametrize("K", [1, 16, 129, 1024, 2048, 2049, 3456, 5888, 6912])
def test_split_sizes_depend_on_K_alone(K):
    r"""For one K, every shape and stride pattern that splits cuts K into
    the same chunks, and the partial buffer follows from them."""
    chunks, splits = set(), set()
    for M in (1, 44, 128, 1024, 5888):
        for N in (1, 44, 256, 512, 1024):
            for a_strides in ((K, 1), (1, M)):
                for b_strides in ((N, 1), (1, K)):
                    plan = gemm.gemm_plan(M, N, K, a_strides, b_strides, split=True)
                    chunks.add(plan["k_chunk"])
                    splits.add(plan["splits"])
                    assert gemm.gemm_partial_floats(M, N, K) == (
                        plan["splits"] * M * N if plan["splits"] > 1 else 0)
    assert len(chunks) == 1 and len(splits) == 1
    chunk = gemm.gemm_chunk(K)
    assert chunks == {chunk if K > chunk else K}
    assert splits == {-(-K // chunk) if K > chunk else 1}


def test_splits_never_fall_as_K_grows():
    r"""A caller sizes its split-K scratch for its longest contraction (T*B
    rows) and runs shorter ones through it ((T - 1) * B rows for d W_hh):
    the number of splits, and so the scratch, never falls as K grows. A plan
    whose splits fell past a chunk boundary (16 splits at K = 2048, 5 at
    2049) overran that scratch on the card."""
    splits = [gemm.gemm_plan(128, 1024, K, (1, 128), (1024, 1), split=True)["splits"]
              for K in range(1, 20000)]
    assert all(a <= b for a, b in zip(splits, splits[1:]))
    for K in range(1, 20000, 7):
        chunk = gemm.gemm_chunk(K)
        assert chunk % 4 == 0 and chunk <= gemm.LONG_CHUNK
        assert gemm.gemm_partial_floats(1024, 256, K) <= gemm.gemm_partial_floats(1024, 256, K + 1)


def test_the_twin_has_the_constants_of_the_cuda_source():
    source = (CSRC / "gemm.cu").read_text()

    def constant(name):
        return int(re.search(rf"\b{name} = (\d+)", source).group(1))

    assert constant("kThreads") == gemm.THREADS
    assert constant("kFillCtas") == gemm.FILL_CTAS
    assert constant("kTwoBlockSmem") == gemm.TWO_BLOCK_SMEM
    assert (constant("kShortK"), constant("kShortChunk"), constant("kSplits"),
            constant("kLongChunk")) == (gemm.SHORT_K, gemm.SHORT_CHUNK, gemm.SPLITS,
                                        gemm.LONG_CHUNK)
    assert "return bk == 16 ? 4 : 3;" in source and "return bk + 4;" in source
    assert [gemm.stages_for(d) for d in (16, 32)] == [4, 3]
    # train_common.cuh's old tiled kernel is gone; every product goes through gemm.cu.
    common = (CSRC / "train_common.cuh").read_text()
    assert "gemm_kernel" not in common and "#include \"gemm.cuh\"" in common


def _operands(rs, M, N, K, pattern):
    a = rs.randn(K, M).astype(np.float32).T if pattern[0] == "t" else rs.randn(M, K).astype(
        np.float32)
    b = rs.randn(N, K).astype(np.float32).T if pattern[1] == "t" else rs.randn(K, N).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("pattern", ["nn", "nt", "tn", "tt"])
@pytest.mark.parametrize("epilogue", ["plain", "bias", "accumulate"])
def test_gemm_on_cpu_tensors_is_the_plain_version(pattern, epilogue):
    r"""``gemm_cuda`` on CPU tensors (transposed views as they are) runs
    ``gemm_plain``: within float32 rounding of float64, with the bias added
    or C accumulated."""
    rs = np.random.RandomState(len(pattern) + len(epilogue))
    M, N, K = 37, 45, 130
    a, b = _operands(rs, M, N, K, pattern)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert (ta.stride(0) == 1) == (pattern[0] == "t") and (tb.stride(1) == 1) == (pattern[1] == "n")
    want = a.astype(np.float64) @ b.astype(np.float64)
    bias = out = None
    if epilogue == "bias":
        bias = torch.from_numpy(rs.randn(N).astype(np.float32))
        want = want + bias.numpy()
    if epilogue == "accumulate":
        out = torch.from_numpy(rs.randn(M, N).astype(np.float32))
        want = want + out.numpy()
    got = gemm.gemm_cuda(ta, tb, bias=bias, out=out, accumulate=out is not None, split=True)
    if out is not None:
        assert got is out
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_gemm_plain_equals_jax_dot():
    r"""The plain version against ``jnp.dot`` at float32 with HIGHEST
    precision (what the Pallas bodies compute off the TPU), on a decoder
    step's product at small width."""
    rs = np.random.RandomState(5)
    a = rs.randn(24, 64).astype(np.float32)
    w = rs.randn(64, 32).astype(np.float32)
    bias = rs.randn(32).astype(np.float32)
    want = np.asarray(jnp.dot(a, w, precision="highest") + bias)
    got = gemm.gemm_plain(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_gemm_refuses_what_the_kernel_does_not_take():
    a, b = torch.randn(4, 5), torch.randn(5, 6)
    with pytest.raises(ValueError):
        gemm.gemm_cuda(a, torch.randn(4, 6))
    with pytest.raises(ValueError):
        gemm.gemm_cuda(a.double(), b.double())
    with pytest.raises(ValueError):
        gemm.gemm_cuda(a, b, bias=torch.randn(5))
    with pytest.raises(ValueError):
        gemm.gemm_cuda(a, b, out=torch.zeros(6, 4).t())
    with pytest.raises(ValueError):
        gemm.gemm_cuda(a, b, accumulate=True)
