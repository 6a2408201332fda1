r"""
Training CLI of the PyTorch port (counterpart of ``scripts/train.py``; reference
``scripts/train.py``): the same arguments where they apply, the same phase
dispatch and the same loop: ``trainer.step()`` every iteration, evaluate and
``after_validation`` every ``--checkpoint-every`` iterations.

    python -m probnmn_tpu_torch.train --phase program_prior \
        --config-yml configs/program_prior.yml --serialization-dir checkpoints/prior

``--device`` is ``cuda`` (the default) or ``cpu``. All four phases are
ported. ``--start-from-checkpoint`` and the ``CHECKPOINTS.*`` of the later
phases take a checkpoint of the port, of the JAX package (its ``.ckpt``) or
of the reference (its ``.pth``). ``--streaming-features`` reads image features from their H5 file per
batch instead of loading the file into host memory (the phases that read
features). In ``joint_training``, ``PROBNMN_NMN_REPLAY_BWD=1`` trains the NMN
without K5's stored residuals (K2 forward, K6's replay-mode backward).
``--profile-dir DIR`` traces ``--profile-steps`` steps, from the third step of
the run on (the first ones build the kernels and fill the caches), with
``torch.profiler`` into a Chrome trace in DIR, each step a named range
``train_step_<iteration>``. The JAX CLI's other flags: ``--gpu-ids`` is
ignored, ``--cpu-workers`` accepted and unused, ``--compilation-cache-dir``
roots the kernels' build cache, and ``--model-parallel`` takes 1
(``utils/cli_flags.py``).

``--num-devices N`` trains any of the four phases data-parallel
(``parallel/mesh.py``), as the JAX CLI's mesh does: N ranks, ``auto_mesh``'s
count (0 is every card; the count drops to the largest that divides
``OPTIM.BATCH_SIZE``), one process a card over NCCL on ``cuda`` and CPU
processes over gloo with ``--device cpu``. The launcher builds the kernels
once and the datasets once (:func:`launcher_datasets`: question_coding's and
joint_training's supervision subset is drawn there, so every rank holds the
same one; module_training's and joint_training's in-memory features go into
shared host memory); each rank trains on its rows of every global batch
with one gradient all-reduce a step (and, in question_coding and
joint_training, one all-reduce of the logged sums), and rank 0 alone
writes checkpoints, scalars and the ``--profile-dir`` trace.
"""
import argparse
import logging
import os

import numpy as np
from tqdm import tqdm

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.parallel import mesh
from probnmn_tpu_torch.utils.cli_flags import add_shared_flags, apply_shared_flags
from probnmn_tpu_torch.utils.observability import annotate, profile_trace

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
parser.add_argument(
    "--start-from-checkpoint",
    default="",
    help="Resume from a checkpoint of this phase: the port's, the JAX package's .ckpt (params, "
    "Adam state, scheduler, baseline, iteration) or the reference's .pth (weights only), "
    "told apart by content.",
)
parser.add_argument("--num-val-batches", type=int, default=256)
parser.add_argument(
    "--profile-dir",
    default="",
    help="Trace --profile-steps training steps (from the third on) with torch.profiler into a "
    "Chrome trace in this directory; open it in Perfetto.",
)
parser.add_argument("--profile-steps", type=int, default=5,
                    help="Steps to trace when --profile-dir is set.")
add_shared_flags(parser, model_parallel=True)


def build(phase: str, config: Config, serialization_dir: str, device: str,
          in_memory_features: bool = True, writer=None, train_dataset=None, val_dataset=None,
          parallel=None):
    r"""(trainer, evaluator) of ``phase``. ``writer`` is the trainer's scalar
    writer (None: tensorboardX over ``serialization_dir``); ``train_dataset``
    and ``val_dataset`` are the phase's datasets (None: read from the H5 files
    that ``config.DATA`` names); ``parallel`` makes the trainer a rank of a
    data-parallel run."""
    data = dict(writer=writer, dataset=train_dataset, parallel=parallel)
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
    r"""Returns what :func:`fit` returns."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    apply_shared_flags(args)
    config = Config(args.config_yml, args.config_override)
    if args.phase != config.PHASE:
        raise ValueError(
            f"Provided `--phase` as {args.phase}, expected config PHASE to match, "
            f"found {config.PHASE}"
        )
    print(config)

    os.makedirs(args.serialization_dir, exist_ok=True)
    config.dump(os.path.join(args.serialization_dir, "config.yml"))
    return fit(args, config)


def world_of(args, config: Config) -> int:
    r"""The ranks that ``--num-devices`` gives ``config`` on ``--device``."""
    device_type = resolve_device(args.device).type
    return mesh.auto_world(args.num_devices, config.OPTIM.BATCH_SIZE,
                           mesh.available_devices(device_type, args.num_devices))


def launcher_datasets(phase: str, config: Config, streaming: bool, train_dataset=None,
                      val_dataset=None):
    r"""(train, val) datasets of ``phase`` built once in the launcher of
    several ranks, where the caller gave none: question_coding's and
    joint_training's train set draws its supervision subset here, from the
    global numpy seed set to ``RANDOM_SEED`` as one process sets it, so every
    rank holds the same subset; module_training's and joint_training's
    in-memory features are read once into shared host memory. program_prior
    returns what it was given."""
    from probnmn_tpu_torch.data import datasets

    np.random.seed(config.RANDOM_SEED)
    d, in_memory = config.DATA, not streaming
    supervision = dict(num_supervision=config.SUPERVISION,
                       supervision_question_max_length=config.SUPERVISION_QUESTION_MAX_LENGTH)
    if phase == "question_coding":
        if train_dataset is None:
            train_dataset = datasets.QuestionCodingDataset(d.TRAIN_TOKENS, **supervision)
        if val_dataset is None:
            val_dataset = datasets.QuestionCodingDataset(d.VAL_TOKENS)
    elif phase == "joint_training":
        features = dict(in_memory=in_memory, shared_features=in_memory)
        if train_dataset is None:
            train_dataset = datasets.JointTrainingDataset(d.TRAIN_TOKENS, d.TRAIN_FEATURES,
                                                          **supervision, **features)
        if val_dataset is None:
            val_dataset = datasets.JointTrainingDataset(d.VAL_TOKENS, d.VAL_FEATURES, **features)
    elif phase == "module_training" and in_memory:
        if train_dataset is None:
            train_dataset = datasets.ModuleTrainingDataset(d.TRAIN_TOKENS, d.TRAIN_FEATURES,
                                                           shared_features=True)
        if val_dataset is None:
            val_dataset = datasets.ModuleTrainingDataset(d.VAL_TOKENS, d.VAL_FEATURES,
                                                         shared_features=True)
    return train_dataset, val_dataset


def launch_ranks(fn, args, world: int, run_dir: str, rank_args: tuple):
    r"""``fn(parallel, *rank_args)`` on ``world`` ranks on ``--device``, the
    kernels built once here first on ``cuda`` (so that the ranks load the
    library and no rank runs nvcc); each rank's results, by rank."""
    device_type = resolve_device(args.device).type
    if device_type == "cuda":
        from probnmn_tpu_torch.ops.kernels import _build

        _build.build()
    return mesh.launch(fn, world, device_type, run_dir, args=rank_args)


def fit(args, config: Config, train_dataset=None, val_dataset=None, writer=None):
    r"""Train ``config``'s phase from the CLI's parsed ``args``: in this
    process, or with ``--num-devices`` above 1 over that many ranks through
    :func:`parallel.mesh.launch`. ``train_dataset`` and ``val_dataset``
    stand in for the H5 files (None: read them); ``writer`` is rank 0's
    scalar writer (None: tensorboardX), which must pickle where there are
    several ranks. Returns rank 0's ``writer`` once trained."""
    world = world_of(args, config)
    if world == 1:
        return _train(None, args, config, train_dataset, val_dataset, writer)
    logging.getLogger(__name__).info("Training %s over %d ranks on %s", args.phase, world,
                                     args.device)
    train_dataset, val_dataset = launcher_datasets(args.phase, config, args.streaming_features,
                                                   train_dataset, val_dataset)
    return launch_ranks(_train_rank, args, world, args.serialization_dir,
                        (args, config, train_dataset, val_dataset, writer))[0]


def _train_rank(parallel, args, config, train_dataset, val_dataset, writer):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    apply_shared_flags(args)  # the build cache's root, in this process too
    return _train(parallel, args, config, train_dataset, val_dataset, writer)


def _train(parallel, args, config, train_dataset, val_dataset, writer):
    # The supervision subset selection depends on this global seed
    # (reference train.py:104-110).
    np.random.seed(config.RANDOM_SEED)
    device = parallel.device if parallel is not None else args.device
    given = dict(writer=writer, train_dataset=train_dataset, val_dataset=val_dataset,
                 parallel=parallel)
    trainer, evaluator = build(args.phase, config, args.serialization_dir, device,
                               in_memory_features=not args.streaming_features,
                               **{k: v for k, v in given.items() if v is not None})
    if args.start_from_checkpoint:
        trainer.load_checkpoint(args.start_from_checkpoint)

    # Rank 0 alone traces and shows progress.
    run(trainer, evaluator, config.OPTIM.NUM_ITERATIONS, args.checkpoint_every,
        args.num_val_batches, args.profile_dir if trainer.is_writer else "", args.profile_steps,
        progress=trainer.is_writer)
    trainer.close_writer()
    return writer if trainer.is_writer else None


def run(trainer, evaluator, num_iterations: int, checkpoint_every: int = 500,
        num_val_batches: int = 256, profile_dir: str = "", profile_steps: int = 5,
        progress: bool = True) -> None:
    r"""The training loop from ``trainer.iteration + 1`` up to
    ``num_iterations``: a step an iteration, evaluation and
    ``after_validation`` every ``checkpoint_every`` iterations. With
    ``profile_dir``, steps [start + 2, start + 2 + ``profile_steps``) run
    under :func:`profile_trace`, each a range ``train_step_<iteration>``
    (the JAX CLI's window: the first steps build the kernels)."""
    start_iteration = trainer.iteration + 1
    window = (range(start_iteration + 2, start_iteration + 2 + profile_steps)
              if profile_dir else range(0))
    profiling = None
    for iteration in tqdm(range(start_iteration, num_iterations), desc="training",
                          disable=not progress):
        if window and iteration == window.start:
            profiling = profile_trace(profile_dir)
            profiling.__enter__()
        if profiling is not None:
            with annotate(f"train_step_{iteration}"):
                trainer.step(iteration)
        else:
            trainer.step(iteration)
        if profiling is not None and iteration == window.stop - 1:
            profiling.__exit__(None, None, None)
            profiling = None
        if (iteration + 1) % checkpoint_every == 0:
            val_metrics = evaluator.evaluate(num_batches=num_val_batches)
            trainer.after_validation(val_metrics, iteration)
    if profiling is not None:
        profiling.__exit__(None, None, None)


if __name__ == "__main__":
    main(parser.parse_args())
