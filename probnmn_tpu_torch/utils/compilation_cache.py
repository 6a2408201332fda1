r"""
The kernels' build cache (counterpart of
``probnmn_tpu/utils/compilation_cache.py``, which roots JAX's persistent XLA
cache). The port compiles its CUDA kernels with ``nvcc`` at first use, about
a minute on the H100's machine (``ops/kernels/_build.py``), and keeps the
library under a directory keyed by a hash of the sources and flags; this
module moves that directory, so that later processes (the CLIs'
``--compilation-cache-dir``, ``InferenceEngine(compilation_cache_dir=...)``)
load the library instead of building it again.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from probnmn_tpu_torch.ops.kernels import _build

_DEFAULT_DIR = os.path.join("~", ".cache", "probnmn_tpu_torch", "kernels")


def resolve_cache_dir(cache_dir: Optional[str] = None) -> str:
    r"""The directory ``cache_dir`` names, resolved as the JAX package
    resolves its cache: the argument itself, else ``$PROBNMN_COMPILATION_CACHE``,
    else ``~/.cache/probnmn_tpu_torch/kernels``; ``"auto"`` is no argument."""
    if cache_dir == "auto":
        cache_dir = None
    cache_dir = cache_dir or os.environ.get("PROBNMN_COMPILATION_CACHE") or _DEFAULT_DIR
    return os.path.abspath(os.path.expanduser(cache_dir))


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    r"""Root the kernels' build cache at :func:`resolve_cache_dir`'s
    directory (created if missing) and return it. The library is looked up
    and built there from then on; a process that has already loaded it keeps
    the one it loaded."""
    path = resolve_cache_dir(cache_dir)
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    return path
