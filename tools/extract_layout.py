#!/usr/bin/env python3
r"""
Where the ResNet-101 stage-3 extractor's time goes on one GPU, and what its
memory layout costs: a batch of 128 random uint8 224 x 224 images through

- the module as it ships (``models/resnet.py``: NCHW, batch norm folded into
  each conv's weight and bias),
- the same module with its conv weights in ``channels_last`` memory (cuDNN
  then runs every conv, and the activations follow, in that layout),
- ``chip_smoke.plain_extract`` (batch norm unfolded, out of place),

each timed by CUDA events (``cudnn.benchmark`` off, then on), held to the
module's features, and traced once under ``torch.profiler`` with its largest
kernels printed. Weights from ``synthetic_torchvision_state_dict`` (seed 14,
as ``chip_smoke.py`` phase 14). Run on a GPU from the root of the repository:

    python3 tools/extract_layout.py
"""
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    import chip_smoke as cs
    from probnmn_tpu_torch.models import resnet
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.preprocess.extract_features import normalize_images

    if not torch.cuda.is_available():
        print("extract_layout: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    gen = torch.Generator().manual_seed(14)
    params = resnet.params_from_torch_state_dict(resnet.synthetic_torchvision_state_dict(gen))
    nchw = resnet.ResNet101Stage3(params).cuda()
    channels_last = copy.deepcopy(nchw)
    for conv in channels_last.modules():
        if isinstance(conv, resnet.ConvBN):
            conv.weight = conv.weight.contiguous(memory_format=torch.channels_last)
    params_dev = cast_params(params, torch.float32, torch.device("cuda"))
    x = torch.randint(0, 256, (cs.EXTRACT_BATCH, 224, 224, 3), generator=gen,
                      dtype=torch.uint8).cuda()

    def plain():
        with torch.no_grad(), resnet.ieee_float32_convs():
            return cs.plain_extract(torch, F, params_dev, normalize_images(x))

    variants = (("nchw (shipped)", lambda: nchw(normalize_images(x))),
                ("channels_last", lambda: channels_last(normalize_images(x))),
                ("plain", plain))
    reference = variants[0][1]()
    scale = float(reference.abs().max())
    for name, fn in variants:
        err = float((fn() - reference).abs().max())
        ms = [cs.cuda_ms(torch, fn, iters=10) for _ in range(2)]
        torch.backends.cudnn.benchmark = True
        ms_benchmark = cs.cuda_ms(torch, fn, iters=10, warmup=3)
        torch.backends.cudnn.benchmark = False
        prof, wall_ms = cs.profiled(torch, fn)
        rows = []
        for event in prof.key_averages():
            us = getattr(event, "self_device_time_total", 0.0)
            if event.device_type == DeviceType.CUDA and us > 0:
                rows.append((us, event.count, event.key))
        rows.sort(reverse=True)
        print(f"== {name}: {ms[0]:.3f} / {ms[1]:.3f} ms a batch of {cs.EXTRACT_BATCH} "
              f"(cudnn.benchmark on: {ms_benchmark:.3f}); max |err| against the shipped "
              f"module {err:.3e} (max |f| {scale:.4f}); traced: busy "
              f"{sum(r[0] for r in rows) / 1e3:.2f} ms, host clock {wall_ms:.2f} ms", flush=True)
        for us, count, key in rows[:12]:
            print(f"   {us / 1e3:8.3f} ms x{count:<4d} {key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
