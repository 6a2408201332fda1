#!/usr/bin/env python3
r"""
How far the JAX package's ResNet-101 stage-3 extractor stands from the
reference's padding, on the CPU in float32. JAX's ``resnet101_stage3`` pads
its two stride-2 3x3 convs (0, 1) (``_conv_bn(..., padding="SAME")``, on an
even input); the reference's torchvision ``resnet101`` and the port
(``probnmn_tpu_torch/models/resnet.py``) pad (1, 1). For JAX's own random
init (``PRNGKey(0)``) and for a synthesized torchvision state dict (seed 0),
on 2 random uint8 images of SIZE x SIZE, prints max |f| and, relative to it,
the port against a JAX forward built from JAX's own ``_conv_bn`` with (1, 1)
at those two convs, and JAX's ``resnet101_stage3`` against the port:

    JAX_PLATFORMS=cpu python tools/jax_resnet_padding.py [SIZE]   # default 224
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(size):
    import jax
    import numpy as np
    import torch

    from probnmn_tpu.models import resnet as jresnet
    from probnmn_tpu_torch import interop
    from probnmn_tpu_torch.models import resnet
    from probnmn_tpu_torch.preprocess.extract_features import normalize_images
    from tests.test_torch_port_resnet import _jax_reference_forward, _nchw, _nhwc

    images = np.random.RandomState(1).randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    x = normalize_images(torch.from_numpy(images))
    state = resnet.synthetic_torchvision_state_dict(torch.Generator().manual_seed(0))
    for name, jparams in (
        ("JAX init, PRNGKey(0)", jresnet.init_resnet101_stage3_params(jax.random.PRNGKey(0))),
        ("synthesized state dict, seed 0",
         jresnet.params_from_torch_state_dict({k: v.numpy() for k, v in state.items()})),
    ):
        port = resnet.ResNet101Stage3(interop.resnet_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams)))(x).numpy()
        padded = _nchw(_jax_reference_forward(jparams, _nhwc(x.numpy())))
        own = _nchw(jresnet.resnet101_stage3(jparams, _nhwc(x.numpy())))
        scale = float(np.abs(padded).max())
        print(f"{name}, 2 x {size} x {size}: max |f| {scale:.6g}; the port against JAX with "
              f"(1, 1) padding {np.abs(port - padded).max() / scale:.3e} of it; JAX's "
              f"resnet101_stage3 against the port {np.abs(own - port).max() / scale:.3e}",
              flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 224)
