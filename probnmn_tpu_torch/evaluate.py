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
JAX CLI's other flags: ``--gpu-ids`` is ignored, ``--cpu-workers`` accepted
and unused and ``--compilation-cache-dir`` roots the kernels' build cache
(``utils/cli_flags.py``). A config with ``DROPOUT > 0`` evaluates as the
JAX evaluators do: without dropout.

``--num-devices N`` evaluates over N ranks (``parallel/mesh.py``), launched
as ``train.fit`` launches them: the datasets built once
(``train.launcher_datasets``), each rank loads the checkpoint and evaluates
its rows of every global batch, the metrics' counters are summed over the
ranks, and rank 0 logs and returns the metrics.
"""
import argparse
import logging
import os

import numpy as np

from probnmn_tpu_torch import train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.utils.cli_flags import add_shared_flags, apply_shared_flags
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
add_shared_flags(parser)


def main(args):
    r"""Returns the evaluator's metrics (rank 0's, over several ranks)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    apply_shared_flags(args)
    config = Config(args.config_yml, args.config_override)
    if args.phase != config.PHASE:
        raise ValueError(
            f"Provided `--phase` as {args.phase}, expected config PHASE to match, "
            f"found {config.PHASE}"
        )
    print(config)
    world, _ = train.world_of(args, config)  # evaluate takes no --model-parallel
    if world == 1:
        return _evaluate(None, args, config)
    train_dataset, val_dataset = train.launcher_datasets(args.phase, config,
                                                         args.streaming_features)
    serialization_dir = os.path.dirname(os.path.abspath(args.checkpoint_path))
    return train.launch_ranks(_evaluate_rank, args, world, serialization_dir,
                              (args, config, train_dataset, val_dataset))[0]


def _evaluate_rank(parallel, args, config, train_dataset, val_dataset):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    apply_shared_flags(args)  # the build cache's root, in this process too
    return _evaluate(parallel, args, config, train_dataset, val_dataset)


def _evaluate(parallel, args, config, train_dataset=None, val_dataset=None):
    # The supervision subset of the train set the trainer builds depends on
    # this global seed (reference train.py:104-110).
    np.random.seed(config.RANDOM_SEED)
    serialization_dir = os.path.dirname(os.path.abspath(args.checkpoint_path))
    trainer, evaluator = train.build(args.phase, config, serialization_dir,
                                     args.device if parallel is None else parallel.device,
                                     in_memory_features=not args.streaming_features,
                                     writer=RecordingWriter(), train_dataset=train_dataset,
                                     val_dataset=val_dataset, parallel=parallel)
    trainer.load_checkpoint(args.checkpoint_path)

    val_metrics = evaluator.evaluate(num_batches=args.num_val_batches)
    if not trainer.is_writer:
        return None
    logger = logging.getLogger(__name__)
    for model_name, metrics in val_metrics.items():
        if not isinstance(metrics, dict):
            continue
        for metric_name, value in metrics.items():
            logger.info("%s %s: %s", model_name, metric_name, value)
    return val_metrics


if __name__ == "__main__":
    main(parser.parse_args())
