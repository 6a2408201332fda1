#!/usr/bin/env python3
r"""
The train CLI's data-parallel path (what ``python -m probnmn_tpu_torch.train
--num-devices N --model-parallel M`` runs after reading its H5 files: the
launcher's datasets, ``train.launch_ranks``, each rank ``train.build`` and
``train.run``) at 1, 2 and 4 ranks on the cards of this machine, each world
at every model axis M of ``--model-parallel`` that divides it, on mini-CLEVR
data made in memory (``data/mini_clevr.py``, the arrays ``mini_clevr_run``
trains on) at production geometry:

    python3 tools/mesh_train_times.py [--worlds 1 2 4] [--model-parallel 1 2 4] \
        [--steps 300] [--out build/mesh_times.json]

For each case (program_prior at batch 256; module_training at batch 128 on
mini-CLEVR's 16-channel features; module_training on 512 random images of
the shipped (1024, 14, 14) features, whose host gather sets the step's
clock; question_coding and joint_training, OBJECTIVE ours, at batch 256,
joint on mini-CLEVR's 16-channel features) and each world size: ``--steps`` steps through the CLI's loop with
rank 0's ``--profile-dir`` trace of 5 steps, the rolling step time and
examples/s rank 0's trainer logs at its last 50-step mark
(``train/step_time_ms``, ``train/examples_per_sec``, ``train/prefetch_wait_ms``)
and the device's idle share over the traced steps (1 - the union of the
kernels' and copies' intervals over the span of the ``train_step_*``
ranges), and rank 0's resident bytes of parameters and Adam moments
(``trainer.resident_bytes``, all models and the NMN's) and its peak
allocated device memory over the run. The frozen models (module_training's generator; the prior of
question_coding and joint_training, joint's generator, reconstructor and
NMN) are random. The features go to the ranks as one copy in shared
memory, and the supervision subsets are drawn once, as ``train.fit``'s
launcher draws them. Prints one JSON line and
writes it to ``--out``, beside the card's name and power limit.
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from probnmn_tpu_torch import mini_clevr_run, train  # noqa: E402
from probnmn_tpu_torch.config import Config  # noqa: E402
from probnmn_tpu_torch.data import mini_clevr  # noqa: E402
from probnmn_tpu_torch.data.datasets import (  # noqa: E402
    JointTrainingDataset,
    ModuleTrainingDataset,
)
from probnmn_tpu_torch.data.readers import SharedFeatures  # noqa: E402
from probnmn_tpu_torch.models import (  # noqa: E402
    nmn,
    program_generator,
    question_reconstructor,
)
from probnmn_tpu_torch.models.program_prior import init_program_prior_params  # noqa: E402
from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec  # noqa: E402
from probnmn_tpu_torch.utils.checkpointing import save_objects  # noqa: E402
from probnmn_tpu_torch.utils.observability import RecordingWriter  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
parser.add_argument("--model-parallel", type=int, nargs="+", default=[1],
                    help="Model-axis sizes; each world runs at each one that divides it.")
parser.add_argument("--steps", type=int, default=300)
parser.add_argument("--cases", nargs="+",
                    default=["program_prior", "module_training", "module_training_1024",
                             "question_coding", "joint_training"])
parser.add_argument("--train-images", type=int, default=3000)
parser.add_argument("--device", default="cuda")
parser.add_argument("--mini-clevr-args", default="",
                    help="mini_clevr_run flags for the configs, e.g. '--geometry tiny "
                    "--max-batch 16' to rehearse on the CPU.")
parser.add_argument("--out", default="build/mesh_times.json")


def idle_share(trace_path):
    r"""(idle share, busy ms, span ms, steps) over the ``train_step_*``
    ranges of a Chrome trace: busy is the union of the device's kernel,
    copy and set intervals."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if str(e.get("name", "")).startswith("train_step_")
             and e.get("ph") == "X"]
    if not steps:
        return None
    start = min(e["ts"] for e in steps)
    end = max(e["ts"] + e["dur"] for e in steps)
    spans = sorted((max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e.get("ph") == "X" and e["ts"] < end and e["ts"] + e["dur"] > start)
    busy, cursor = 0.0, start
    for a, b in spans:
        a = max(a, cursor)
        if b > a:
            busy += b - a
            cursor = b
    span = end - start
    return {"idle_share": 1 - busy / span, "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "traced_steps": len({e["name"] for e in steps})}


def case_data(case, splits, supervision):
    r"""(phase, config overrides, train set, val set) of a case."""
    phase = case if case != "module_training_1024" else "module_training"
    if phase in ("program_prior", "question_coding"):
        np.random.seed(0)  # the supervision subset, drawn once
        return phase, [], mini_clevr.phase_dataset(splits["train"], phase, supervision), \
            mini_clevr.phase_dataset(splits["val"], phase)
    if phase == "joint_training":
        features = SharedFeatures.from_array(splits["train"].features)
        np.random.seed(0)
        sets = [JointTrainingDataset.from_arrays(
            split.programs, split.questions, split.answers, split.image_indices,
            features if split.split == "train" else split.features, split=split.split,
            num_supervision=supervision, supervision_question_max_length=40)
            for split in (splits["train"], splits["val"])]
        return phase, [], sets[0], sets[1]
    train_split, val_split = splits["train"], splits["val"]
    if case == "module_training_1024":
        images = 512
        features = SharedFeatures.from_array(np.random.default_rng(7).standard_normal(
            (images, 1024, 14, 14), dtype=np.float32))
        rs = np.random.RandomState(8)
        index = {s: rs.randint(0, images, len(sp.questions)) for s, sp in splits.items()}
        overrides = ["NMN.IMAGE_FEATURE_SIZE", [1024, 14, 14]]
    else:
        features = SharedFeatures.from_array(train_split.features)
        index = {"train": train_split.image_indices, "val": None}
        overrides = []
    sets = []
    for split in (train_split, val_split):
        feats = features if index[split.split] is not None else split.features
        indices = index[split.split] if index[split.split] is not None else split.image_indices
        sets.append(ModuleTrainingDataset.from_arrays(split.programs, split.questions,
                                                      split.answers, indices, feats,
                                                      split=split.split))
    return phase, overrides, sets[0], sets[1]


def train_rank(parallel, cli, config, train_set, val_set, writer):
    r"""One rank of the CLI's path (``train._train``), which also returns
    rank 0's resident parameter and moment bytes and peak device memory."""
    device = parallel.device if parallel is not None else torch.device(cli.device)
    np.random.seed(config.RANDOM_SEED)
    trainer, evaluator = train.build(cli.phase, config, cli.serialization_dir, device,
                                     writer=writer, train_dataset=train_set,
                                     val_dataset=val_set, parallel=parallel)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    train.run(trainer, evaluator, config.OPTIM.NUM_ITERATIONS, cli.checkpoint_every,
              cli.num_val_batches, cli.profile_dir if trainer.is_writer else "",
              cli.profile_steps, progress=False)
    if not trainer.is_writer:
        return None
    return {"writer": writer, "resident_mb": trainer.resident_bytes() / 1e6,
            "nmn_resident_mb": (trainer.resident_bytes(["nmn"]) / 1e6
                                if "nmn" in trainer.params else None),
            "peak_allocated_mib": (torch.cuda.max_memory_allocated(device) / 2 ** 20
                                   if device.type == "cuda" else None)}


def run_grid(cli, config, train_set, val_set):
    r"""Rank 0's :func:`train_rank` result over the grid ``cli`` asks for."""
    data, model = train.world_of(cli, config)
    if data * model == 1:
        return train_rank(None, cli, config, train_set, val_set, RecordingWriter()), (1, 1)
    train_set, val_set = train.launcher_datasets(cli.phase, config, False, train_set, val_set)
    return train.launch_ranks(train_rank, cli, data * model, cli.serialization_dir,
                              (cli, config, train_set, val_set, RecordingWriter()),
                              model_parallel=model)[0], (data, model)


def frozen_checkpoints(vocab, config, work):
    r"""Random frozen models of the later phases, saved as the port's
    checkpoints in ``work``; the config overrides that name them."""
    gen = torch.Generator().manual_seed(0)
    paths = {name: os.path.join(work, f"{name}.ckpt")
             for name in ("PROGRAM_PRIOR", "QUESTION_CODING", "MODULE_TRAINING")}
    if not os.path.exists(paths["PROGRAM_PRIOR"]):
        save_objects(paths["PROGRAM_PRIOR"], {"program_prior": init_program_prior_params(
            gen, make_prior_spec(config, vocab))})
        save_objects(paths["QUESTION_CODING"], {
            "program_generator": program_generator.init_params(
                gen, program_generator.make_spec(vocab, config)),
            "question_reconstructor": question_reconstructor.init_params(
                gen, question_reconstructor.make_spec(vocab, config))})
        save_objects(paths["MODULE_TRAINING"], {"nmn": nmn.init_nmn_params(
            gen, nmn.make_spec(vocab, config))})
    return [item for name, path in paths.items() for item in (f"CHECKPOINTS.{name}", path)]


def main():
    args = parser.parse_args()
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines() if args.device == "cuda" else ["cpu"])
    print(f"[mesh-times] {smi}; torch {torch.__version__}; {torch.cuda.device_count()} cards",
          flush=True)
    work = tempfile.mkdtemp(prefix="mesh_times_", dir=os.path.join(REPO, "build"))
    t0 = time.perf_counter()
    vocab, splits = mini_clevr.make_mini_clevr(args.train_images, 750, 1, seed=0)
    splits.pop("test")
    root = os.path.join(work, "data")
    vocab.save_to_files(os.path.join(root, "vocab"))
    print(f"[mesh-times] mini-CLEVR: {len(splits['train'].questions)} train questions over "
          f"{args.train_images} images in {time.perf_counter() - t0:.1f} s", flush=True)
    mc_args = mini_clevr_run.parser.parse_args(["--root", root, "--runs", work,
                                                *args.mini_clevr_args.split()])
    results = {"device": smi, "torch": torch.__version__, "steps": args.steps, "cases": {}}
    for case in args.cases:
        phase, overrides, train_set, val_set = case_data(case, splits, mc_args.supervision)
        yml = os.path.join(work, f"{case}.yml")
        base = mini_clevr_run.phase_config(mc_args, phase, args.steps)
        base.dump(yml)
        config = Config(yml, [*frozen_checkpoints(vocab, base, work), *overrides])
        config.dump(yml)
        for world, mp in [(w, m) for w in args.worlds for m in args.model_parallel
                          if w % m == 0]:
            run_dir = os.path.join(work, f"{case}_{world}_{mp}")
            trace_dir = os.path.join(run_dir, "trace")
            cli = train.parser.parse_args([
                "--phase", phase, "--config-yml", yml, "--device", args.device,
                "--serialization-dir", run_dir, "--checkpoint-every", str(10 ** 9),
                "--num-devices", str(world), "--model-parallel", str(mp),
                "--profile-dir", trace_dir])
            os.makedirs(run_dir, exist_ok=True)
            t1 = time.perf_counter()
            rank0, grid = run_grid(cli, config, train_set, val_set)
            wall = time.perf_counter() - t1
            last = {}
            for tag, value, step in rank0.pop("writer").scalars:
                if tag.startswith("train/") and tag[6:] in ("step_time_ms", "examples_per_sec",
                                                            "prefetch_wait_ms", "h2d_dispatch_ms"):
                    last[tag[6:]] = (value, step)
            traces = glob.glob(os.path.join(trace_dir, "*.json"))
            entry = {k: v for k, (v, _) in last.items()}
            entry.update(at_step=max((s for _, s in last.values()), default=None),
                         batch=config.OPTIM.BATCH_SIZE, grid=list(grid),
                         rows_a_rank=config.OPTIM.BATCH_SIZE // grid[0], wall_s=wall,
                         traces=len(traces), trace=idle_share(traces[0]) if traces else None,
                         **rank0)
            results["cases"].setdefault(case, {})[f"{grid[0]}x{grid[1]}"] = entry
            print(f"[mesh-times] {case} at data {grid[0]} x model {grid[1]}: "
                  f"{json.dumps(entry)}", flush=True)
    print(json.dumps(results), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
