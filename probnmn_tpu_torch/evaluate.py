r"""
Evaluation CLI of the PyTorch port (counterpart of ``scripts/evaluate.py``;
reference ``scripts/evaluate.py``): build the phase's trainer (for the models
and the checkpoint load) and evaluator through :func:`train.build`, load the
checkpoint (the port's, the JAX package's ``.ckpt`` or the reference's
``.pth``), evaluate the val split and log every metric.

    python -m probnmn_tpu_torch.evaluate --phase module_training \
        --config-yml checkpoints/mt/config.yml \
        --checkpoint-path checkpoints/mt/checkpoint_best.ckpt

``--device`` is ``cuda`` (the default) or ``cpu``. ``--num-val-batches``
evaluates that many batches instead of the whole split. Scalars go to an
in-memory writer, so evaluating writes nothing beside the checkpoint. The
JAX CLI's ``--gpu-ids``, ``--compilation-cache-dir``, ``--cpu-workers`` and
``--num-devices`` are not ported.
"""
import argparse
import logging
import os

import numpy as np

from probnmn_tpu_torch import train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.utils.observability import RecordingWriter

parser = argparse.ArgumentParser(
    description="Evaluate a checkpoint of a particular phase (PyTorch/CUDA).")
parser.add_argument("--phase", required=True, choices=train.PHASES)
parser.add_argument("--config-yml", required=True, help="Path to a config file.")
parser.add_argument(
    "--config-override",
    nargs="*",
    default=[],
    help="A sequence of key-value pairs overriding the config.",
)
parser.add_argument(
    "--checkpoint-path", required=True,
    help="A checkpoint of the phase: the port's, the JAX package's .ckpt or the reference's "
    ".pth, told apart by content.")
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
parser.add_argument(
    "--streaming-features",
    action="store_true",
    help="Stream image features from the H5 file instead of loading it into host memory "
    "(module_training, joint_training).",
)
parser.add_argument("--num-val-batches", type=int, default=None,
                    help="Batches to evaluate (default: the whole val split).")


def main(args):
    r"""Returns the evaluator's metrics."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger(__name__)
    config = Config(args.config_yml, args.config_override)
    if args.phase != config.PHASE:
        raise ValueError(
            f"Provided `--phase` as {args.phase}, expected config PHASE to match, "
            f"found {config.PHASE}"
        )
    print(config)
    # The supervision subset of the train set the trainer builds depends on
    # this global seed (reference train.py:104-110).
    np.random.seed(config.RANDOM_SEED)

    serialization_dir = os.path.dirname(os.path.abspath(args.checkpoint_path))
    trainer, evaluator = train.build(args.phase, config, serialization_dir, args.device,
                                     in_memory_features=not args.streaming_features,
                                     writer=RecordingWriter())
    trainer.load_checkpoint(args.checkpoint_path)

    val_metrics = evaluator.evaluate(num_batches=args.num_val_batches)
    for model_name, metrics in val_metrics.items():
        if not isinstance(metrics, dict):
            continue
        for metric_name, value in metrics.items():
            logger.info("%s %s: %s", model_name, metric_name, value)
    return val_metrics


if __name__ == "__main__":
    main(parser.parse_args())
