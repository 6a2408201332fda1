r"""
Feature layout helpers for the serving path.

Image features arrive NCHW from the H5 files (reference layout
(N, 1024, 14, 14)); the port's NMN functions take NHWC, like the JAX
package's, so the two can be compared on the same arrays.
"""
from __future__ import annotations

import torch


def image_to_nhwc(image: torch.Tensor) -> torch.Tensor:
    r"""NCHW -> NHWC (a view; callers that need contiguity copy)."""
    return image.permute(0, 2, 3, 1)
