r"""
Training CLI of the PyTorch port (counterpart of ``scripts/train.py``; reference
``scripts/train.py``): the same arguments where they apply, the same phase
dispatch and the same loop: ``trainer.step()`` every iteration, evaluate and
``after_validation`` every ``--checkpoint-every`` iterations.

    python -m probnmn_tpu_torch.train --phase program_prior \
        --config-yml configs/program_prior.yml --serialization-dir checkpoints/prior

``--device`` is ``cuda`` (the default) or ``cpu``. All four phases are
ported. ``--streaming-features`` reads image features from their H5 file per
batch instead of loading the file into host memory (the phases that read
features). In ``joint_training``, ``PROBNMN_NMN_REPLAY_BWD=1`` trains the NMN
without K5's stored residuals (K2 forward, K6's replay-mode backward).
"""
import argparse
import logging
import os

import numpy as np
from tqdm import tqdm

from probnmn_tpu_torch.config import Config

PHASES = ["program_prior", "question_coding", "module_training", "joint_training"]

parser = argparse.ArgumentParser(description="Train a specified phase of ProbNMN (PyTorch/CUDA).")
parser.add_argument("--phase", required=True, choices=PHASES)
parser.add_argument("--config-yml", required=True, help="Path to a config file.")
parser.add_argument(
    "--config-override",
    nargs="*",
    default=[],
    help="A sequence of key-value pairs overriding the config.",
)
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
parser.add_argument(
    "--streaming-features",
    action="store_true",
    help="Stream image features from the H5 file instead of loading it into host memory "
    "(module_training, joint_training).",
)
parser.add_argument("--serialization-dir", default="checkpoints/experiment")
parser.add_argument("--checkpoint-every", type=int, default=500)
parser.add_argument("--start-from-checkpoint", default="")
parser.add_argument("--num-val-batches", type=int, default=256)


def build(phase: str, config: Config, serialization_dir: str, device: str,
          in_memory_features: bool = True, writer=None, train_dataset=None, val_dataset=None):
    r"""(trainer, evaluator) of ``phase``. ``writer`` is the trainer's scalar
    writer (None: tensorboardX over ``serialization_dir``); ``train_dataset``
    and ``val_dataset`` are the phase's datasets (None: read from the H5 files
    that ``config.DATA`` names)."""
    data = dict(writer=writer, dataset=train_dataset)
    if phase == "joint_training":
        from probnmn_tpu_torch.evaluators.joint_training_evaluator import JointTrainingEvaluator
        from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer

        trainer = JointTrainingTrainer(config, serialization_dir, device=device,
                                       in_memory_features=in_memory_features, **data)
        return trainer, JointTrainingEvaluator(config, trainer, dataset=val_dataset,
                                               in_memory_features=in_memory_features)
    if phase == "module_training":
        from probnmn_tpu_torch.evaluators.module_training_evaluator import (
            ModuleTrainingEvaluator,
        )
        from probnmn_tpu_torch.training.module_training_trainer import ModuleTrainingTrainer

        trainer = ModuleTrainingTrainer(config, serialization_dir, device=device,
                                        in_memory_features=in_memory_features, **data)
        return trainer, ModuleTrainingEvaluator(config, trainer, dataset=val_dataset,
                                                in_memory_features=in_memory_features)
    if phase == "question_coding":
        from probnmn_tpu_torch.evaluators.question_coding_evaluator import (
            QuestionCodingEvaluator,
        )
        from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer

        trainer = QuestionCodingTrainer(config, serialization_dir, device=device, **data)
        return trainer, QuestionCodingEvaluator(config, trainer, dataset=val_dataset)
    from probnmn_tpu_torch.evaluators.program_prior_evaluator import ProgramPriorEvaluator
    from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer

    trainer = ProgramPriorTrainer(config, serialization_dir, device=device, **data)
    return trainer, ProgramPriorEvaluator(config, trainer, dataset=val_dataset)


def main(args):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    config = Config(args.config_yml, args.config_override)
    if args.phase != config.PHASE:
        raise ValueError(
            f"Provided `--phase` as {args.phase}, expected config PHASE to match, "
            f"found {config.PHASE}"
        )
    print(config)

    os.makedirs(args.serialization_dir, exist_ok=True)
    config.dump(os.path.join(args.serialization_dir, "config.yml"))

    # The supervision subset selection depends on this global seed
    # (reference train.py:104-110).
    np.random.seed(config.RANDOM_SEED)

    trainer, evaluator = build(args.phase, config, args.serialization_dir, args.device,
                               in_memory_features=not args.streaming_features)
    if args.start_from_checkpoint:
        trainer.load_checkpoint(args.start_from_checkpoint)

    start_iteration = trainer.iteration + 1
    for iteration in tqdm(range(start_iteration, config.OPTIM.NUM_ITERATIONS), desc="training"):
        trainer.step(iteration)
        if (iteration + 1) % args.checkpoint_every == 0:
            val_metrics = evaluator.evaluate(num_batches=args.num_val_batches)
            trainer.after_validation(val_metrics, iteration)


if __name__ == "__main__":
    main(parser.parse_args())
