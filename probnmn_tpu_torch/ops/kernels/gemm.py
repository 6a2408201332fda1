r"""
The training kernels' float32 GEMM (``probnmn_tpu_torch/csrc/gemm.cu``) on
its own: ``C (+)= A B (+ bias)`` with A and B read through their strides, so
that a transposed view needs no copy.

K3f/K3b and K4f/K4b launch it from their C code for every product inside
them (the ``jnp.dot`` calls inside the Pallas bodies of
``probnmn_tpu/ops/pallas/seq2seq_train.py``). This module gives it a Python
entry (:func:`gemm_cuda`, for the card tests and ``chip_smoke.py``), its
plain version (:func:`gemm_plain`), a twin of its launch plan
(:func:`gemm_plan`: the tile, the split of K and the grid, from the shape
and the strides alone), the count of its launches (:func:`gemm_launches`,
every launch, from this entry or from inside K3/K4) and a recorder of the
shapes it is launched at (:func:`gemm_record`, :func:`gemm_records`).

CPU tensors run the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from probnmn_tpu_torch.ops.kernels import _build

# The plan's constants, as gemm.cu has them.
THREADS = 256
FILL_CTAS = 128          # the largest tile whose grid has this many blocks
TWO_BLOCK_SMEM = 115712  # bytes a block may take for two to share an SM
SHORT_K, SHORT_CHUNK, SPLITS, LONG_CHUNK = 1024, 128, 16, 512

RECORD_FIELDS = ("M", "N", "K", "sam", "sak", "sbk", "sbn", "splits", "bias", "accumulate",
                 "tile_m", "tile_n")


def gemm_chunk(K: int) -> int:
    r"""K per split, a function of K alone: 128 up to K = 1024, then 16
    chunks (multiples of 4) up to K = 8192, then 512; the number of splits
    never falls as K grows."""
    if K <= SHORT_K:
        return SHORT_CHUNK
    if K > LONG_CHUNK * SPLITS:
        return LONG_CHUNK
    return 4 * -(-K // (4 * SPLITS))


def stages_for(depth: int) -> int:
    return 4 if depth == 16 else 3


def _operand_floats(extent: int, k_contiguous: bool, depth: int) -> int:
    r"""Shared floats of one operand: its ring (rows of depth + 4 floats
    when k-contiguous), and the [k][x] slice a k-contiguous operand is
    transposed into."""
    if k_contiguous:
        return stages_for(depth) * extent * (depth + 4) + depth * extent
    return stages_for(depth) * depth * extent


def _smem(bm: int, bn: int, a_kc: bool, b_kc: bool, depth: int) -> int:
    return 4 * (_operand_floats(bm, a_kc, depth) + _operand_floats(bn, b_kc, depth))


def _tiles(M: int, N: int, bm: int, bn: int, splits: int) -> int:
    return -(-M // bm) * -(-N // bn) * splits


def gemm_plan(M: int, N: int, K: int, a_strides: Tuple[int, int], b_strides: Tuple[int, int],
              split: bool = False) -> Dict[str, object]:
    r"""The launch plan ``gemm.cu::make_plan`` makes for an (M, K) A with
    strides ``a_strides = (sam, sak)`` and a (K, N) B with ``b_strides =
    (sbk, sbn)``; ``split``: the caller passes scratch, so a long K may be
    split. Each operand lands [x][k] (and is transposed to [k][x] before the
    products) unless only its outer axis is contiguous. The tile is the
    largest of 128 x 128, 128 x 64 and 64 x 64 whose grid has FILL_CTAS
    blocks (64 x 64 otherwise); a stage is 32 deep unless two blocks of
    that depth would not share an SM, then 16."""
    sam, sak = a_strides
    sbk, sbn = b_strides
    a_kc = not (sam == 1 and sak != 1)
    b_kc = not (sbn == 1 and sbk != 1)
    splits, k_chunk = 1, K
    chunk = gemm_chunk(K)
    if split and K > chunk:
        splits, k_chunk = -(-K // chunk), chunk
    bm = bn = 64
    if _tiles(M, N, 128, 128, splits) >= FILL_CTAS:
        bm = bn = 128
    elif _tiles(M, N, 128, 64, splits) >= FILL_CTAS:
        bm = 128
    depth = 32 if _smem(bm, bn, a_kc, b_kc, 32) <= TWO_BLOCK_SMEM else 16
    return {
        "tile": (bm, bn), "splits": splits, "k_chunk": k_chunk,
        "grid": (-(-N // bn), -(-M // bm), splits),
        "a_k_contiguous": a_kc, "b_k_contiguous": b_kc,
        "smem": _smem(bm, bn, a_kc, b_kc, depth), "depth": depth,
    }


def gemm_partial_floats(M: int, N: int, K: int) -> int:
    r"""Floats of scratch a split GEMM needs (0 when K is not split)."""
    chunk = gemm_chunk(K)
    return -(-K // chunk) * M * N if K > chunk else 0


def gemm_plan_cuda(M: int, N: int, K: int, a_strides, b_strides, split: bool = False):
    r"""The plan as the C library makes it (same keys as :func:`gemm_plan`)."""
    out = (ctypes.c_int * 11)()
    code = _build.library().probnmn_gemm_plan(M, N, K, *a_strides, *b_strides, int(split), out)
    _build.check(code, "GEMM plan")
    v = list(out)
    return {"tile": (v[0], v[1]), "splits": v[2], "k_chunk": v[3], "grid": tuple(v[4:7]),
            "a_k_contiguous": bool(v[7]), "b_k_contiguous": bool(v[8]), "smem": v[9],
            "depth": v[10]}


def gemm_plain(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None, accumulate: bool = False) -> torch.Tensor:
    r"""The plain version: ``a @ b (+ bias)``, written into (or, with
    ``accumulate``, added to) ``out`` when given."""
    c = torch.matmul(a, b)
    if bias is not None:
        c = c + bias
    if out is None:
        return c
    if accumulate:
        out += c
    else:
        out.copy_(c)
    return out


def _check(a: torch.Tensor, b: torch.Tensor, bias, out, accumulate: bool):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want (M, K) and (K, N), got {tuple(a.shape)} and {tuple(b.shape)}")
    M, N = a.shape[0], b.shape[1]
    tensors = [a, b] + [t for t in (bias, out) if t is not None]
    for t in tensors:
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"want float32 tensors on {a.device}, got {t.dtype} on {t.device}")
    if bias is not None and (tuple(bias.shape) != (N,) or bias.stride(0) != 1):
        raise ValueError(f"bias must be a contiguous ({N},), got {tuple(bias.shape)}")
    if out is not None and (tuple(out.shape) != (M, N) or (N > 1 and out.stride(1) != 1)):
        raise ValueError(f"out must be ({M}, {N}) with unit column stride, got "
                         f"{tuple(out.shape)} strides {out.stride()}")
    if accumulate and out is None:
        raise ValueError("accumulate needs out")


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None, accumulate: bool = False,
              split: bool = False) -> torch.Tensor:
    r"""``a @ b (+ bias)`` into ``out`` (allocated when None; added to it with
    ``accumulate``) by the GEMM kernel, a and b read through their strides.
    ``split`` lets a long K be split (scratch from the caching allocator).
    CPU tensors take :func:`gemm_plain`."""
    _check(a, b, bias, out, accumulate)
    if a.device.type == "cpu":
        return gemm_plain(a, b, bias, out, accumulate)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_cuda: unsupported device {a.device}")
    M, K = a.shape
    N = b.shape[1]
    if out is None:
        out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    partial = None
    if split:
        n = _build.library().probnmn_gemm_partial_floats(M, N, K)
        partial = torch.empty(max(n, 1), dtype=torch.float32, device=a.device)
    code = _build.library().probnmn_gemm(
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0), b.stride(1),
        out.data_ptr(), out.stride(0), M, N, K,
        bias.data_ptr() if bias is not None else None, int(accumulate),
        partial.data_ptr() if partial is not None else None,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(code, "GEMM kernel")
    return out


def gemm_launches(reset: bool = False) -> int:
    r"""GEMM launches (this entry's and K3/K4's) since the library was loaded
    or the last reset; ``reset`` sets the count to 0 after reading it."""
    return int(_build.library().probnmn_gemm_launches(int(reset)))


def gemm_record(on: bool) -> None:
    r"""Start (forgetting earlier records) or stop noting each launch's shape."""
    _build.library().probnmn_gemm_record(int(on))


def gemm_records() -> List[Dict[str, int]]:
    r"""The launches noted since :func:`gemm_record` was turned on, in order,
    each as ``RECORD_FIELDS``: the shape, A's and B's strides, the splits of
    K, whether a bias was added or C accumulated, and the tile's rows and
    columns."""
    lib = _build.library()
    n = lib.probnmn_gemm_records(None, 0)
    buf = (ctypes.c_longlong * (max(n, 1) * len(RECORD_FIELDS)))()
    lib.probnmn_gemm_records(buf, n)
    values = list(buf)
    return [dict(zip(RECORD_FIELDS, values[i * len(RECORD_FIELDS):(i + 1) * len(RECORD_FIELDS)]))
            for i in range(n)]


def gemm_work(M: int, N: int, K: int, bias: bool, accumulate: bool) -> Tuple[float, float]:
    r"""FLOPs and bytes of one GEMM: each input read once, the result written
    once (and read once when accumulated)."""
    nbytes = 4 * (M * K + K * N + M * N * (2 if accumulate else 1) + (N if bias else 0))
    return 2.0 * M * N * K, float(nbytes)

