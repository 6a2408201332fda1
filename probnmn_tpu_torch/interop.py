r"""
Carry weights across from the JAX package: its parameter pytrees, as numpy
arrays, become the port's parameter dicts of tensors.

This is the one place where layouts change. The port keeps the JAX package's
layout everywhere (torch-style (out, in) matrices, per-slot HWIO module
banks, the classifier's NHWC flatten) except the NMN stem's two 3x3 convs,
which run ``F.conv2d`` and so take OIHW weights: HWIO -> OIHW here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def program_generator_from_jax(params_np: Any, device="cpu") -> dict:
    r"""ProgramGenerator params: same layout, as float32 tensors on ``device``."""
    return _tree_to_torch(params_np, device)


def program_prior_from_jax(params_np: Any, device="cpu") -> dict:
    r"""ProgramPrior params (``embedding`` (V, D), ``encoder`` as a list of
    ``{w_ih, w_hh, b_ih, b_hh}``, ``projection`` (D, H)): same layout, as
    float32 tensors on ``device``."""
    return _tree_to_torch(params_np, device)


_BANK_OF_CLASS = {
    "attention": "conv1", "query": "conv1", "relate": "conv1", "same": "conv",
    "compare": "conv1",
}


def nmn_from_jax(params_np: Any, spec, device="cpu") -> dict:
    r"""NMN params: same layout except the stem convs, HWIO -> OIHW. Both
    packages assign tokens to bank slots in the same ``make_spec`` order; the
    bank sizes are checked against ``spec``."""
    params = _tree_to_torch(params_np, device)
    for cls, conv in _BANK_OF_CLASS.items():
        slots = params[cls][conv]["w"].shape[0]
        if slots != spec.bank_sizes[cls]:
            raise ValueError(f"{cls} bank has {slots} slots, spec wants {spec.bank_sizes[cls]}")
    stem = params["stem"]
    for name in ("w1", "w2"):
        stem[name] = stem[name].permute(3, 2, 0, 1).contiguous()
    return params
