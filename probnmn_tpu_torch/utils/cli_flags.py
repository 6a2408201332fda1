r"""
The flags the JAX package's CLIs share, as the port's CLIs take them:
``--gpu-ids`` is ignored and ``--cpu-workers`` accepted and unused, as there;
``--compilation-cache-dir`` roots the kernels' build cache
(``utils/compilation_cache.py``); ``--num-devices`` and ``--model-parallel``
take 1, since the data-parallel mesh is not ported (ROADMAP.md queue 1
item 5).
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional

MESH = "ROADMAP.md queue 1 item 5, the mesh"


def add_shared_flags(parser: argparse.ArgumentParser, *, gpu_ids: bool = True,
                     model_parallel: bool = False, num_devices_default: Optional[int] = 1,
                     cache_default: Optional[str] = "") -> None:
    if gpu_ids:
        parser.add_argument("--gpu-ids", nargs="+", type=int, default=[0],
                            help="Ignored, as in the JAX CLIs (the device is --device).")
        parser.add_argument("--cpu-workers", type=int, default=0,
                            help="Accepted and unused, as in the JAX CLIs.")
    parser.add_argument("--num-devices", type=int, default=num_devices_default,
                        help=f"Devices: 1 (the data-parallel mesh is {MESH}, not ported yet).")
    if model_parallel:
        parser.add_argument("--model-parallel", type=int, default=1,
                            help=f"Devices a data shard: 1 ({MESH}, not ported yet).")
    parser.add_argument(
        "--compilation-cache-dir", default=cache_default,
        help="Root the CUDA kernels' build cache here ('auto': $PROBNMN_COMPILATION_CACHE or "
        "~/.cache/probnmn_tpu_torch/kernels), so that later runs load the built kernels.")


def apply_shared_flags(args: argparse.Namespace) -> Optional[str]:
    r"""Refuse a mesh; root the build cache where ``--compilation-cache-dir``
    says. Returns the cache directory, or None."""
    for flag in ("num_devices", "model_parallel"):
        value = getattr(args, flag, None)
        if value not in (None, 1):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {value}: only one device is ported; the "
                f"data-parallel mesh is {MESH}")
    if not getattr(args, "compilation_cache_dir", None):
        return None
    from probnmn_tpu_torch.utils.compilation_cache import enable_compilation_cache

    path = enable_compilation_cache(args.compilation_cache_dir)
    logging.getLogger(__name__).info("Kernel build cache: %s", path)
    return path
