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
    lib.probnmn_seq2seq_sample.restype = _INT
    lib.probnmn_seq2seq_sample.argtypes = [
        _INT,                                   # dtype: 0 float32, 1 bfloat16
        _VOID_P, _INT, _INT,                    # src (B, L) int32, B, L
        _VOID_P, _INT, ctypes.c_uint64,         # noise (T, B, stride) f32 or NULL, stride, seed
        _VOID_P, _VOID_P,                       # source / target embeddings
        _VOID_P, _VOID_P, _VOID_P,              # encoder w_ih^T (flat), w_hh^T, bias
        _VOID_P, _VOID_P, _VOID_P,              # decoder w_ih^T, w_hh^T, bias
        _VOID_P, _VOID_P,                       # projection w^T, bias
        _VOID_P,                                # encoder-output scratch (B, L+1, H)
        _VOID_P, _VOID_P, _VOID_P,              # predictions, loss, logprobs
        _INT, _INT, _INT, _INT, _INT,           # D, H, layers, target vocab, steps
        _INT, _INT, _INT, _INT,                 # pad, unk, start, end
        _VOID_P,                                # stream
    ]
    lib.probnmn_nmn_interpret.restype = _INT
    lib.probnmn_nmn_interpret.argtypes = [
        _INT,                                   # dtype
        _VOID_P, _INT, _INT,                    # programs (B, T) int32, B, T
        _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,  # kind, slot3, head, cmp, same tables
        _VOID_P,                                # stem features (B, H, W, C)
        _VOID_P, _VOID_P, _VOID_P,              # w3, w3t (or NULL), b3
        _VOID_P, _VOID_P,                       # w1, b1
        _VOID_P, _VOID_P, _VOID_P,              # same_wf, same_wa, same_b
        _VOID_P, _VOID_P, _VOID_P,              # wcmp, wcmpt (or NULL), bcmp
        _VOID_P, _VOID_P, _VOID_P,              # out, saved scratch, invalid
        _INT, _INT, _INT,                       # H, W, C
        _VOID_P,                                # stream
    ]
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
    ] + lm_sizes
    lib.probnmn_lm_backward.restype = _INT
    lib.probnmn_lm_backward.argtypes = lm_weights + [
        _VOID_P, _VOID_P,                       # dloss (B,), workspace
        _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,  # d_emb, d_proj, d_wih, d_whh, d_bias
    ] + lm_sizes
    lib.probnmn_tf_workspace_floats.restype = ctypes.c_longlong
    lib.probnmn_tf_workspace_floats.argtypes = [_INT] * 10  # B, Ls, Lt, D, H, L, Vs, Vt, reinforce, backward
    tf_inputs = [
        _VOID_P, _VOID_P, _INT, _INT, _INT,     # src (B, Ls), tgt (B, Lt) int32, B, Ls, Lt
        _VOID_P_ARRAY,                          # the ten packed weights
    ]
    tf_sizes = [_INT] * 9 + [_VOID_P]           # D, H, layers, Vs, Vt, reinforce, pad, start, end; stream
    lib.probnmn_tf_forward.restype = _INT
    lib.probnmn_tf_forward.argtypes = tf_inputs + [
        _VOID_P, _VOID_P,                       # workspace, loss (B,)
    ] + tf_sizes
    lib.probnmn_tf_backward.restype = _INT
    lib.probnmn_tf_backward.argtypes = tf_inputs + [
        _VOID_P, _VOID_P,                       # dloss (B,), workspace
        _VOID_P_ARRAY,                          # the ten gradients
    ] + tf_sizes
    return lib


def pointers(tensors) -> ctypes.Array:
    r"""A C array of the tensors' device pointers (for a ``void**`` argument)."""
    return (_VOID_P * len(tensors))(*[t.data_ptr() for t in tensors])


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
