r"""
Build and load the port's CUDA kernels.

Every ``probnmn_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, one ``nvcc`` per source started
together, then one link. The library is keyed by a hash of the sources and
flags and kept under ``build/torch_kernels/`` beside the package (git
ignores it), so a second process reuses it.

Each C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# What the last build (or load) did: seconds spent and the compiler's output,
# including ``-Xptxas -v``'s registers, shared memory and spills per kernel.
BUILD_INFO: Dict[str, object] = {"seconds": 0.0, "log": "", "path": None}

_VOID_P = ctypes.c_void_p
_VOID_P_ARRAY = ctypes.POINTER(ctypes.c_void_p)
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# The inter-layer dropout of K1's, K3's and K4's encoders: keep mask (L-1, B,
# steps, H) uint8 or NULL, its steps, its scale 1 / (1 - p).
_DROPOUT = [_VOID_P, _INT, _FLOAT]


def _nvcc() -> str:
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    r"""Compile every source (in parallel) and link one library; a no-op when a
    library for these sources and flags already exists."""
    digest = _digest()
    lib_path = BUILD_DIR / f"libprobnmn_kernels_{digest}.so"
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path))
        return lib_path
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp_{digest}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp_lib = work / lib_path.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *[str(o) for _, o, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    log = "\n".join(logs)
    (BUILD_DIR / f"build_{digest}.log").write_text(log)
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, log=log, path=str(lib_path)
    )
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    r"""The loaded kernel library (built at first use) with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    lib.probnmn_k1_encode.restype = _INT
    lib.probnmn_k1_encode.argtypes = [
        _INT,                                   # dtype: 0 float32, 1 bfloat16
        _VOID_P, _INT, _INT,                    # src (B, L) int32, B, L
        _VOID_P,                                # source embedding
        _VOID_P, _VOID_P, _VOID_P,              # encoder w_ih^T (flat), w_hh^T, bias
        _VOID_P, _VOID_P, _VOID_P,              # outputs (B, L+1, H), the layers below (or NULL), final h (B, H)
        _VOID_P, _FLOAT,                        # dropout keep mask (layers-1, B, L+1, H) u8 or NULL, scale
        _INT, _INT, _INT,                       # D, H, layers
        _INT, _INT,                             # pad, end
        _VOID_P,                                # stream
    ]
    lib.probnmn_k1_encoder_plan.restype = _INT
    lib.probnmn_k1_encoder_plan.argtypes = [_INT] * 4 + [ctypes.POINTER(_INT)]  # dtype, B, in, H; out[12]
    lib.probnmn_k1_decoder_plan.restype = _INT
    lib.probnmn_k1_decoder_plan.argtypes = [_INT] * 6 + [ctypes.POINTER(_INT)]  # dtype, B, L, D, H, V; out[15]
    lib.probnmn_k1_decode.restype = _INT
    lib.probnmn_k1_decode.argtypes = [
        _INT,                                   # dtype: 0 float32, 1 bfloat16
        _VOID_P, _INT, _INT,                    # src (B, L) int32, B, L
        _VOID_P, _INT, ctypes.c_uint64,         # noise (T, B, stride) f32 or NULL, stride, seed
        _INT,                                   # row_base: the Philox row of row 0
        _VOID_P,                                # target embedding
        _VOID_P, _VOID_P, _VOID_P,              # decoder w_ih^T, w_hh^T, bias
        _VOID_P, _VOID_P,                       # projection w^T, bias
        _VOID_P, _VOID_P,                       # encoder outputs (B, L+1, H), final h (B, H) f32
        _VOID_P, _VOID_P, _VOID_P,              # predictions, loss, logprobs
        _INT, _INT, _INT, _INT,                 # D, H, target vocab, steps
        _INT, _INT, _INT, _INT,                 # pad, unk, start, end
        _VOID_P,                                # stream
    ]
    nmn_operands = [
        _INT,                                   # dtype
        _VOID_P, _INT, _INT,                    # programs (B, T) int32, B, T
        _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,  # kind, slot3, head, cmp, same tables
        _VOID_P,                                # stem features (B, H, W, C)
        _VOID_P, _VOID_P,                       # w3, b3
        _VOID_P, _VOID_P,                       # w1, b1
        _VOID_P, _VOID_P, _VOID_P,              # same_wf, same_wa, same_b
        _VOID_P, _VOID_P,                       # wcmp, bcmp
        _INT, _INT,                             # S3, Sc: slots of w3 and wcmp
        _VOID_P, _VOID_P,                       # order (B,) int32, example counter (1,) int32
    ]
    lib.probnmn_nmn_plan.restype = _INT
    lib.probnmn_nmn_plan.argtypes = [
        _VOID_P, _INT, _INT,                    # programs (B, T) int32, B, T
        _VOID_P, _VOID_P,                       # kind, head tables
        _VOID_P, _VOID_P,                       # convs (B,) int32, stream
    ]
    lib.probnmn_nmn_interpret.restype = _INT
    lib.probnmn_nmn_interpret.argtypes = nmn_operands + [
        _VOID_P, _VOID_P, _VOID_P,              # out, saved scratch, invalid
        _VOID_P, _VOID_P,                       # otraj, atraj (K5) or NULL (K2)
        _INT, _INT, _INT,                       # H, W, C
        _VOID_P,                                # stream
    ]
    lib.probnmn_nmn_interpret_grid.restype = _INT
    lib.probnmn_nmn_interpret_grid.argtypes = [_INT] * 5 + [ctypes.POINTER(_INT)]  # dtype, B, H, W, C; stages
    lib.probnmn_nmn_backward.restype = _INT
    lib.probnmn_nmn_backward_grid.restype = _INT
    lib.probnmn_nmn_backward_grid.argtypes = [_INT] * 5  # dtype, B, H, W, C
    lib.probnmn_nmn_backward.argtypes = nmn_operands + [
        _VOID_P, _VOID_P, _VOID_P, _VOID_P,     # invalid, g_final, otraj, atraj (or NULL)
        _VOID_P, _INT,                          # replay: traj (G, T, 3, HW, C) or NULL; grid G
        _VOID_P, _VOID_P,                       # scratch (G, 4, HW, C) f32, acts (G, 6, HW, C)
        _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,  # entries: inp, g, tag, dilation; bases
        _VOID_P,                                # partials (B, R) f32
        _INT, _INT,                             # S1, Ss
        _VOID_P,                                # dx (B, HW, C) f32
        _INT, _INT, _INT,                       # H, W, C
        _VOID_P,                                # stream
    ]
    lib.probnmn_nmn_partial_floats.restype = _INT
    lib.probnmn_nmn_partial_floats.argtypes = [_INT] * 5  # S3, S1, Ss, Sc, C
    lib.probnmn_nmn_weight_grad.restype = _INT
    lib.probnmn_nmn_weight_grad.argtypes = [
        _INT,                                   # dtype
        _VOID_P, _VOID_P, _VOID_P, _INT,        # entries: inp, g, dilation; their number E
        _VOID_P,                                # order (E,) int32
        _VOID_P, _VOID_P, _VOID_P, _VOID_P, _INT,  # chunks: target, first, count, slot; J
        _VOID_P, _VOID_P,                       # per target: chunks, first partial slot
        _INT, _INT,                             # S3, Sc
        _VOID_P, _VOID_P, _VOID_P,              # dw3 (S3, 9, C, C), dwc (Sc, 2, C, C), partials f32
        _INT, _INT, _INT,                       # H, W, C
        _VOID_P,                                # stream
    ]
    lib.probnmn_nmn_sum_rows.restype = _INT
    lib.probnmn_nmn_sum_rows.argtypes = [_VOID_P, _INT, _INT, _VOID_P, _VOID_P]
    lib.probnmn_lm_workspace_floats.restype = ctypes.c_longlong
    lib.probnmn_lm_workspace_floats.argtypes = [_INT] * 7  # B, Lt, D, H, layers, V, backward
    lm_weights = [
        _VOID_P, _INT, _INT,                    # tokens (B, Lt) int32, B, Lt
        _VOID_P, _VOID_P,                       # embedding (V, D), projection (D, H)
        _VOID_P, _VOID_P, _VOID_P,              # w_ih (flat), w_hh (L, 4H, H), bias (L, 4H)
    ]
    lm_sizes = [_INT] * 7 + [_VOID_P]           # V, D, H, layers, pad, start, end; stream
    lib.probnmn_lm_forward.restype = _INT
    lib.probnmn_lm_forward.argtypes = lm_weights + [
        _VOID_P, _VOID_P,                       # workspace, loss (B,)
    ] + _DROPOUT + lm_sizes
    lib.probnmn_lm_backward.restype = _INT
    lib.probnmn_lm_backward.argtypes = lm_weights + [
        _VOID_P, _VOID_P,                       # dloss (B,), workspace
        _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,  # d_emb, d_proj, d_wih, d_whh, d_bias
    ] + _DROPOUT + lm_sizes
    _LL = ctypes.c_longlong
    lib.probnmn_gemm.restype = _INT
    lib.probnmn_gemm.argtypes = [
        _VOID_P, _LL, _LL,                      # A, its strides (m, k)
        _VOID_P, _LL, _LL,                      # B, its strides (k, n)
        _VOID_P, _LL,                           # C, its leading dimension
        _INT, _INT, _INT,                       # M, N, K
        _VOID_P, _INT,                          # bias (N,) or NULL, accumulate
        _VOID_P, _VOID_P,                       # split-K scratch or NULL, stream
    ]
    lib.probnmn_gemm_partial_floats.restype = _LL
    lib.probnmn_gemm_partial_floats.argtypes = [_INT] * 3  # M, N, K
    lib.probnmn_gemm_plan.restype = _INT
    lib.probnmn_gemm_plan.argtypes = [      # M, N, K, A's and B's strides, split; out[11]
        _INT, _INT, _INT, _LL, _LL, _LL, _LL, _INT, ctypes.POINTER(_INT)]
    lib.probnmn_gemm_launches.restype = _LL
    lib.probnmn_gemm_launches.argtypes = [_INT]  # reset
    lib.probnmn_gemm_record.restype = None
    lib.probnmn_gemm_record.argtypes = [_INT]   # on
    lib.probnmn_gemm_records.restype = _INT
    lib.probnmn_gemm_records.argtypes = [ctypes.POINTER(_LL), _INT]  # out, max records
    tf_dims = [_INT] * 9                       # B, Ls, Lt, D, H, L, Vs, Vt, reinforce
    lib.probnmn_tf_workspace_floats.restype = ctypes.c_longlong
    lib.probnmn_tf_workspace_floats.argtypes = tf_dims + [_INT]  # keep
    lib.probnmn_tf_scratch_floats.restype = ctypes.c_longlong
    lib.probnmn_tf_scratch_floats.argtypes = tf_dims
    lib.probnmn_tf_sweep_plan.restype = _INT
    lib.probnmn_tf_sweep_plan.argtypes = [_INT, _INT, _INT, ctypes.POINTER(_INT)]  # B, H, forward, out[8]
    lib.probnmn_tf_decoder_plan.restype = _INT
    lib.probnmn_tf_decoder_plan.argtypes = [_INT] * 4 + [ctypes.POINTER(_INT)]  # B, Ls, H, forward; out[8]
    tf_sizes = [_INT] * 9 + [_VOID_P]           # D, H, layers, Vs, Vt, reinforce, pad, start, end; stream
    lib.probnmn_tf_forward.restype = _INT
    lib.probnmn_tf_forward.argtypes = [
        _VOID_P, _VOID_P, _INT, _INT, _INT,     # src (B, Ls), tgt (B, Lt) int32, B, Ls, Lt
        _VOID_P_ARRAY,                          # the ten packed weights
        _VOID_P, _VOID_P, _INT,                 # workspace, loss (B,), keep
    ] + _DROPOUT + tf_sizes
    lib.probnmn_tf_backward.restype = _INT
    lib.probnmn_tf_backward.argtypes = [
        _INT, _INT, _INT,                       # B, Ls, Lt
        _VOID_P_ARRAY,                          # the ten packed weights
        _VOID_P, _VOID_P, _VOID_P,              # dloss (B,), K4f's residuals, scratch
        _VOID_P_ARRAY,                          # the ten gradients
    ] + _DROPOUT + tf_sizes
    return lib


def pointers(tensors) -> ctypes.Array:
    r"""A C array of the tensors' device pointers (for a ``void**`` argument)."""
    return (_VOID_P * len(tensors))(*[t.data_ptr() for t in tensors])


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
