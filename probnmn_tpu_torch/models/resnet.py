r"""
ResNet-101 stage-3 feature extractor (inference only), the counterpart of
``probnmn_tpu/models/resnet.py``: the reference's extractor
(``scripts/preprocess/extract_features.py:98-105``: torchvision ``resnet101``
with ``layer4``, ``avgpool`` and ``fc`` cut off), i.e. the (1024, 14, 14)
stage-3 output for 224 x 224 images.

- **Module.** :class:`ResNet101Stage3`: the stem (7x7/2 pad 3, frozen batch
  norm, ReLU, maxpool 3x3/2 pad 1), then 3 + 4 + 23 bottlenecks with the
  stride on conv2 (torchvision v1.5, as in the JAX code). Batch norm is frozen
  and folded as scale and shift (``y = gamma * (x - mean) / sqrt(var + eps) +
  beta``); each conv's buffers hold its weight times the scale, per output
  channel, and the shift as its bias, so a conv and its norm are one
  ``F.conv2d``.
- **Padding.** Every 3x3 conv pads 1 pixel on each side, torchvision's
  padding, so the two stride-2 3x3 convs (``layer2.0.conv2``: 56 -> 28,
  ``layer3.0.conv2``: 28 -> 14) see the reference's windows. This is the one
  deliberate difference from the JAX extractor, whose
  ``_conv_bn(..., padding="SAME")`` (``probnmn_tpu/models/resnet.py:70-83``)
  pads those two convs (0, 1) on an even input.
- **Layout.** Activations are contiguous NCHW tensors, and the output is (B,
  1024, 14, 14), the reference H5 layout. cuDNN's IEEE float32 convs on the
  H100 are NCHW kernels: in ``channels_last`` memory each conv is wrapped in
  two transposes, 10.7 of 66.5 ms a batch of 128 (``tools/extract_layout.py``).
- **Precision.** The convs run in IEEE float32: cuDNN's float32 precision is
  scoped around the forward (:func:`ieee_float32_convs`), leaving every other
  flag of the caller as it is. PyTorch's default lets cuDNN use TF32, which
  would leave the reference's float32 features by about 1e-3.
- **Weights.** :func:`params_from_torch_state_dict` reads a torchvision
  ``resnet101`` state dict (ImageNet weights; nothing is downloaded);
  :func:`init_resnet101_stage3_params` draws random ones from an explicit
  ``torch.Generator`` (the port cannot redraw JAX's threefry keys);
  :func:`synthetic_torchvision_state_dict` makes a torchvision-keyed state
  dict whose activations stay O(1-10) through the 30 blocks, for tests.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5

# (blocks, mid_channels, out_channels, stride) per stage; stage-3 cut (no layer4).
STAGES = [
    (3, 64, 256, 1),    # layer1
    (4, 128, 512, 2),   # layer2
    (23, 256, 1024, 2), # layer3
]
# torchvision resnet101's layer4, present in its state dict and ignored here.
LAYER4 = (3, 512, 2048, 2)

# Image preprocessing constants: the reference's third std value is 0.224, not
# ImageNet's 0.225 (reference extract_features.py:66-71), kept for parity.
IMAGE_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGE_STD = np.array([0.229, 0.224, 0.224], np.float32)
IMAGE_SIZE = 224
FEATURE_CHANNELS = 1024


def ieee_float32_convs():
    r"""``torch.backends.cudnn.flags`` with float32 convs in IEEE float32
    (``fp32_precision="ieee"`` where this torch has it, ``allow_tf32=False``
    either way) and every other flag as the caller has set it."""
    cudnn = torch.backends.cudnn
    kwargs = {}
    for name in inspect.signature(cudnn.flags).parameters:
        if name == "allow_tf32":
            kwargs[name] = False
        elif name == "fp32_precision":
            kwargs[name] = "ieee"
        elif hasattr(cudnn, name):
            kwargs[name] = getattr(cudnn, name)
    return cudnn.flags(**kwargs)


class ConvBN(nn.Module):
    r"""A bias-free conv and the frozen batch norm after it, as one conv:
    the weight times the norm's scale, the norm's shift as the bias."""

    def __init__(self, p: Mapping[str, Any], stride: int = 1, padding: int = 0):
        super().__init__()
        scale = torch.as_tensor(p["bn"]["scale"], dtype=torch.float32)
        weight = torch.as_tensor(p["w"], dtype=torch.float32) * scale.view(-1, 1, 1, 1)
        self.register_buffer("weight", weight.contiguous())
        self.register_buffer("bias", torch.as_tensor(p["bn"]["shift"], dtype=torch.float32).clone())
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class Bottleneck(nn.Module):
    def __init__(self, block: Mapping[str, Any], stride: int):
        super().__init__()
        self.conv1 = ConvBN(block["conv1"])
        self.conv2 = ConvBN(block["conv2"], stride, padding=1)
        self.conv3 = ConvBN(block["conv3"])
        self.downsample = ConvBN(block["downsample"], stride) if "downsample" in block else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x).relu_()
        out = self.conv2(out).relu_()
        out = self.conv3(out)
        identity = x if self.downsample is None else self.downsample(x)
        return out.add_(identity).relu_()


class ResNet101Stage3(nn.Module):
    r"""The stage-3 extractor over the port's params (OIHW conv weights,
    folded batch norm): (B, 3, 224, 224) normalized images -> (B, 1024, 14,
    14). ``launches`` counts forwards on a CUDA tensor."""

    launches = 0

    def __init__(self, params: Mapping[str, Any]):
        super().__init__()
        self.stem = ConvBN(params["conv1"], stride=2, padding=3)
        self.layers = nn.Sequential(*[
            nn.Sequential(*[Bottleneck(block, stride if i == 0 else 1)
                            for i, block in enumerate(stage)])
            for stage, (_, _, _, stride) in zip(params["layers"], STAGES)
        ])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.contiguous()
        with torch.inference_mode(), ieee_float32_convs():
            x = self.stem(x).relu_()
            x = F.max_pool2d(x, 3, 2, 1)
            x = self.layers(x)
        if x.is_cuda:
            ResNet101Stage3.launches += 1
        return x


# ------------------------------------------------------------------ parameters -----
def _conv_init(generator: torch.Generator, shape) -> torch.Tensor:
    fan_in = shape[1] * shape[2] * shape[3]
    return torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5


def _bn_init(channels: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(channels), "shift": torch.zeros(channels)}


def init_resnet101_stage3_params(generator: torch.Generator) -> Dict[str, Any]:
    r"""Random extractor params in the JAX init's scheme (He-normal convs,
    identity batch norm), drawn from ``generator``; conv weights OIHW."""
    params: Dict[str, Any] = {
        "conv1": {"w": _conv_init(generator, (64, 3, 7, 7)), "bn": _bn_init(64)},
        "layers": [],
    }
    in_ch = 64
    for blocks, mid, out, _ in STAGES:
        stage: List[Dict[str, Any]] = []
        for i in range(blocks):
            block = {
                "conv1": {"w": _conv_init(generator, (mid, in_ch, 1, 1)), "bn": _bn_init(mid)},
                "conv2": {"w": _conv_init(generator, (mid, mid, 3, 3)), "bn": _bn_init(mid)},
                "conv3": {"w": _conv_init(generator, (out, mid, 1, 1)), "bn": _bn_init(out)},
            }
            if i == 0:
                block["downsample"] = {"w": _conv_init(generator, (out, in_ch, 1, 1)),
                                       "bn": _bn_init(out)}
            stage.append(block)
            in_ch = out
        params["layers"].append(stage)
    return params


def _fold_bn(state: Mapping[str, np.ndarray], prefix: str) -> Dict[str, torch.Tensor]:
    gamma = np.asarray(state[f"{prefix}.weight"])
    beta = np.asarray(state[f"{prefix}.bias"])
    mean = np.asarray(state[f"{prefix}.running_mean"])
    var = np.asarray(state[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    return {
        "scale": torch.from_numpy(np.asarray(scale, np.float32)),
        "shift": torch.from_numpy(np.asarray(beta - mean * scale, np.float32)),
    }


def _port_conv(state: Mapping[str, np.ndarray], conv_key: str, bn_key: str) -> Dict[str, Any]:
    return {
        "w": torch.from_numpy(np.asarray(state[f"{conv_key}.weight"], np.float32)),  # OIHW
        "bn": _fold_bn(state, bn_key),
    }


def params_from_torch_state_dict(state: Mapping[str, Any]) -> Dict[str, Any]:
    r"""Port a torchvision ``resnet101`` state dict (tensors or ndarrays);
    ``layer4.*``, ``fc.*`` and ``num_batches_tracked`` are not read."""
    state = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
             for k, v in state.items()
             if not k.startswith(("layer4.", "fc.")) and not k.endswith("num_batches_tracked")}
    params: Dict[str, Any] = {"conv1": _port_conv(state, "conv1", "bn1"), "layers": []}
    for stage_index, (blocks, _, _, _) in enumerate(STAGES, start=1):
        stage = []
        for i in range(blocks):
            prefix = f"layer{stage_index}.{i}"
            block = {
                "conv1": _port_conv(state, f"{prefix}.conv1", f"{prefix}.bn1"),
                "conv2": _port_conv(state, f"{prefix}.conv2", f"{prefix}.bn2"),
                "conv3": _port_conv(state, f"{prefix}.conv3", f"{prefix}.bn3"),
            }
            if f"{prefix}.downsample.0.weight" in state:
                block["downsample"] = _port_conv(
                    state, f"{prefix}.downsample.0", f"{prefix}.downsample.1")
            stage.append(block)
        params["layers"].append(stage)
    return params


def synthetic_torchvision_state_dict(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    r"""A state dict with every key and shape of torchvision's ``resnet101``
    (``layer4``, ``fc`` and each ``num_batches_tracked`` included), drawn from
    ``generator``: He-normal convs and batch norm statistics near identity,
    with each block's last gamma small, as in trained ResNets, so that
    activations stay O(1-10) through the 30 blocks of stage 3 (JAX's identity
    batch norm lets them grow to ~1e6)."""
    state: Dict[str, torch.Tensor] = {}

    def uniform(n, low, high):
        return low + (high - low) * torch.rand(n, generator=generator)

    def conv(key, shape):
        state[f"{key}.weight"] = _conv_init(generator, shape)

    def bn(key, channels, gamma=(0.5, 1.0)):
        state[f"{key}.weight"] = uniform(channels, *gamma)
        state[f"{key}.bias"] = 0.1 * torch.randn(channels, generator=generator)
        state[f"{key}.running_mean"] = 0.1 * torch.randn(channels, generator=generator)
        state[f"{key}.running_var"] = uniform(channels, 0.5, 1.5)
        state[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    conv("conv1", (64, 3, 7, 7))
    bn("bn1", 64)
    in_ch = 64
    for stage_index, (blocks, mid, out, _) in enumerate(STAGES + [LAYER4], start=1):
        for i in range(blocks):
            prefix = f"layer{stage_index}.{i}"
            conv(f"{prefix}.conv1", (mid, in_ch, 1, 1))
            bn(f"{prefix}.bn1", mid)
            conv(f"{prefix}.conv2", (mid, mid, 3, 3))
            bn(f"{prefix}.bn2", mid)
            conv(f"{prefix}.conv3", (out, mid, 1, 1))
            bn(f"{prefix}.bn3", out, gamma=(0.05, 0.25))
            if i == 0:
                conv(f"{prefix}.downsample.0", (out, in_ch, 1, 1))
                bn(f"{prefix}.downsample.1", out)
            in_ch = out
    state["fc.weight"] = 0.01 * torch.randn(1000, in_ch, generator=generator)
    state["fc.bias"] = torch.zeros(1000)
    return state
