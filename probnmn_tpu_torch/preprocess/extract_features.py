r"""
Extract ResNet-101 stage-3 features from CLEVR images into an H5 file
(counterpart of ``scripts/preprocess/extract_features.py``; reference
``scripts/preprocess/extract_features.py``): images sorted by filename,
resized to 224 x 224, normalized with the reference's constants (its blue
std 0.224 included), features stored as float32 (N, 1024, 14, 14) with attr
``split``.

    python -m probnmn_tpu_torch.preprocess.extract_features -i data/images/train \
        -o data/clevr_train_features.h5 -s train --weights-pth resnet101.pth

The extractor is ``models/resnet.py::ResNet101Stage3`` (cuDNN convs in IEEE
float32, torchvision's padding) on ``--device`` (``cuda`` by default). A batch
goes up as uint8 and is normalized on the device; the last batch runs at its
own size. ImageNet weights come from a torchvision ``resnet101`` state dict
(``--weights-pth``; nothing is downloaded); without one the extractor is
randomly initialized and a loud warning is logged: parity with the
reference's features needs the torchvision weights. Reading images needs PIL,
writing the file ``h5py``.
"""
import argparse
import glob
import logging
import os

import numpy as np
import torch

from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.models import resnet

parser = argparse.ArgumentParser(description="Extract CLEVR image features (PyTorch port).")
parser.add_argument("-i", "--image-dir", default="data/images/train")
parser.add_argument("-o", "--output-h5path", default="data/clevr_train_features.h5")
parser.add_argument("-s", "--split", default="train", choices=["train", "val", "test"])
parser.add_argument("-b", "--batch-size", type=int, default=128)
parser.add_argument("--gpu-ids", nargs="+", type=int, default=[0],
                    help="Ignored, as in the JAX script: --device picks the device.")
parser.add_argument("--cpu-workers", type=int, default=0,
                    help="Ignored, as in the JAX script: images are read in this process.")
parser.add_argument(
    "--weights-pth", default="",
    help="Path to a torchvision resnet101 state_dict (.pth) for ImageNet weights.",
)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")


def load_image(path: str) -> np.ndarray:
    r"""The image at ``path`` as RGB, resized bilinearly to 224 x 224: uint8
    (224, 224, 3)."""
    from PIL import Image

    image = Image.open(path).convert("RGB")
    image = image.resize((resnet.IMAGE_SIZE, resnet.IMAGE_SIZE), Image.BILINEAR)
    return np.array(image, np.uint8)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    r"""uint8 (N, H, W, 3) -> contiguous float32 (N, 3, H, W), as ``(x / 255
    - mean) / std``: the operations of the JAX script's ``load_image``, in
    its order."""
    mean = torch.from_numpy(resnet.IMAGE_MEAN).to(images.device)
    std = torch.from_numpy(resnet.IMAGE_STD).to(images.device)
    x = (images.to(torch.float32) / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


def extract_features(model: resnet.ResNet101Stage3, images_uint8, batch_size: int = 128,
                     device="cuda") -> np.ndarray:
    r"""Features of ``images_uint8`` (N, 224, 224, 3) uint8, ``batch_size``
    images a forward, the last batch at its own size: float32 (N, 1024, 14,
    14) on the host. ``model`` is moved to ``device``."""
    device = resolve_device(device)
    images = torch.as_tensor(images_uint8)
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be uint8 (N, H, W, 3), got {images.dtype} "
                         f"{tuple(images.shape)}")
    model.to(device)
    out = None
    for start in range(0, len(images), batch_size):
        batch = images[start:start + batch_size].to(device)
        features = model(normalize_images(batch))
        if out is None:
            out = np.empty((len(images),) + tuple(features.shape[1:]), np.float32)
        out[start:start + len(batch)] = features.contiguous().cpu().numpy()
    if out is None:
        raise ValueError("no images")
    return out


def main(args):
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger(__name__)
    device = resolve_device(args.device)
    image_paths = sorted(glob.glob(os.path.join(args.image_dir, "*.png")))
    logger.info("Found %d images", len(image_paths))
    if args.weights_pth:
        params = resnet.params_from_torch_state_dict(
            torch.load(args.weights_pth, map_location="cpu"))
        logger.info("Loaded ImageNet weights from %s", args.weights_pth)
    else:
        params = resnet.init_resnet101_stage3_params(torch.Generator().manual_seed(0))
        logger.warning(
            "NO --weights-pth GIVEN: extracting with RANDOM weights. Feature "
            "parity with the reference requires torchvision resnet101 weights."
        )
    model = resnet.ResNet101Stage3(params)

    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is needed to write the features H5 file") from e
    with h5py.File(args.output_h5path, "w") as output_h5:
        output_h5.attrs["split"] = args.split
        features = output_h5.create_dataset(
            "features",
            (len(image_paths), resnet.FEATURE_CHANNELS, resnet.IMAGE_SIZE // 16,
             resnet.IMAGE_SIZE // 16),
            dtype="float32",
        )
        for start in range(0, len(image_paths), args.batch_size):
            batch_paths = image_paths[start:start + args.batch_size]
            batch = np.stack([load_image(p) for p in batch_paths])
            features[start:start + len(batch_paths)] = extract_features(
                model, batch, len(batch_paths), device)
            logger.info("%d / %d images", start + len(batch_paths), len(image_paths))
    logger.info("Wrote features to %s", args.output_h5path)


if __name__ == "__main__":
    main(parser.parse_args())
