r"""
Convolutions for the Neural Module Network (counterpart of
``probnmn_tpu/ops/gconv.py``).

Activations are NHWC at every public function, as in the JAX package, so the
two can be compared on the same arrays. Shared-weight 3x3 convs (the stem)
take torch's OIHW weights and run ``F.conv2d``; module banks keep the JAX
package's per-slot layout ``(n, 3, 3, C_in, C_out)`` and are applied per
example ("gathered") as a tap-major im2col product, which is the plain
version the interpreter kernel is held against.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def kaiming_normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    r"""torch ``kaiming_normal_`` (fan_in, relu gain): std = sqrt(2 / fan_in)."""
    return torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    r"""Shared-weight 3x3 same conv. x: NHWC; w: OIHW (C_out, C_in, 3, 3)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=dilation, dilation=dilation)
    return out.permute(0, 2, 3, 1)


def conv1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r"""Shared-weight 1x1 conv as a matmul. x: NHWC; w: (C_in, C_out)."""
    return x @ w + b


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    r"""2x2/stride-2 max pool, NHWC (torch ``MaxPool2d(2)``; floors odd dims)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def extract_patches(x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    r"""3x3 same-padded (dilated) patches of NHWC x -> (B, H*W, 9*C), tap-major:
    feature ``(ky*3 + kx)*C + c`` is channel c at tap (ky, kx)."""
    batch, h, w, c = x.shape
    d = dilation
    padded = F.pad(x, (0, 0, d, d, d, d))
    taps = [
        padded[:, ky * d: ky * d + h, kx * d: kx * d + w, :]
        for ky in range(3)
        for kx in range(3)
    ]
    return torch.stack(taps, dim=3).reshape(batch, h * w, 9 * c)


def gathered_conv3x3(
    x: torch.Tensor, bank: Dict[str, torch.Tensor], idx: torch.Tensor, dilation: int = 1
) -> torch.Tensor:
    r"""Per-example 3x3 conv: example b uses bank slot idx[b].

    x: (B, H, W, C_in); bank["w"]: (n, 3, 3, C_in, C_out) or (n, 9, C_in, C_out);
    bank["b"]: (n, C_out); idx: (B,) int.
    """
    batch, h, w, c = x.shape
    weights = bank["w"][idx].reshape(batch, 9 * c, -1)
    out = torch.bmm(extract_patches(x, dilation), weights) + bank["b"][idx][:, None, :]
    return out.reshape(batch, h, w, -1)


def gathered_conv1x1(
    x: torch.Tensor, bank: Dict[str, torch.Tensor], idx: torch.Tensor
) -> torch.Tensor:
    r"""Per-example 1x1 conv. x: (B, H, W, C_in); bank["w"]: (n, C_in, C_out)."""
    batch, h, w, c = x.shape
    out = torch.bmm(x.reshape(batch, h * w, c), bank["w"][idx]) + bank["b"][idx][:, None, :]
    return out.reshape(batch, h, w, -1)
