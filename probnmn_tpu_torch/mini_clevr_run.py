r"""
Mini-CLEVR convergence run of the PyTorch port (counterpart of
``scripts/run_mini_clevr.py``): outcome-level proof that the four chained
training phases (reference ``docs/probnmn/usage/training.rst:35-42``) learn,
not just that each step's gradients are right.

    python -m probnmn_tpu_torch.mini_clevr_run --seed 0 --train-images 15000 \
        --val-images 750 --questions-per-image 2 --supervision 1000 \
        --iters 2000 8000 4000 3000 --hparam ALPHA 500.0 \
        --resume-split-phase module_training

It builds the synthetic task in memory (:mod:`probnmn_tpu_torch.data.mini_clevr`)
and trains program_prior -> question_coding -> module_training ->
joint_training in this process, each phase through :func:`train.build` and
the train CLI's loop (``trainer.step``; every ``--checkpoint-every``
iterations ``evaluator.evaluate(--num-val-batches)`` and
``after_validation``), at the production model sizes (256-d/2-layer LSTMs,
128-channel modules on 14 x 14) with the JAX script's per-phase settings
and bars. Each phase reads the earlier phases' ``checkpoint_best.ckpt``
through ``CHECKPOINTS.*``; its best checkpoint is then evaluated by a fresh
trainer on the whole val split (module_training and joint_training also
with free-running greedy decode, under ``nmn_free_greedy``).

Where it differs from the JAX script: no H5 files (the splits stay in
memory; the vocabulary is written to ``--root``) and an in-memory scalar
writer instead of tensorboardX. As there, ``--phases`` trains a subset: a
phase left out whose best checkpoint is in ``--runs`` (from an earlier
invocation, possibly over other data sizes) is re-evaluated into the
report, and ``--resume-split-phase`` trains one phase in two legs, the
second resumed from the half-way checkpoint.

The report: a Markdown table (``--report``) and a JSON file
(``--report-json``) with each phase's best metrics against its bar, train
seconds and steps/s, every val trajectory as ``[iteration, value]`` pairs
under the writer's ``val/metrics/<model>/<metric>`` tags, and the device
(on ``cuda`` with the ``nvidia-smi`` name and power limit).
"""
import argparse
import json
import logging
import math
import os
import subprocess
import sys
import time

import numpy as np

from probnmn_tpu_torch import train
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data import mini_clevr
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary
from probnmn_tpu_torch.utils.observability import RecordingWriter

logger = logging.getLogger(__name__)

parser = argparse.ArgumentParser(description="Mini-CLEVR 4-phase convergence run (PyTorch/CUDA).")
parser.add_argument("--root", default="build/mini_clevr/data",
                    help="Where the vocabulary is written (the splits stay in memory).")
parser.add_argument("--runs", default="build/mini_clevr/runs",
                    help="Serialization dirs of the four phases.")
parser.add_argument("--report", default="build/mini_clevr/report.md",
                    help="Markdown report path ('' to skip writing).")
parser.add_argument("--report-json", default="build/mini_clevr/report.json",
                    help="JSON report path ('' to skip writing).")
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
parser.add_argument("--train-images", type=int, default=3000)
parser.add_argument("--val-images", type=int, default=750)
parser.add_argument("--questions-per-image", type=int, default=2)
parser.add_argument("--supervision", type=int, default=1000)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--iters", type=int, nargs=4, metavar=("PRIOR", "QC", "MT", "JT"),
                    default=[2000, 8000, 6000, 3000], help="NUM_ITERATIONS per phase.")
parser.add_argument("--checkpoint-every", type=int, default=250)
parser.add_argument("--num-val-batches", type=int, default=6)
parser.add_argument("--phases", nargs="*", default=[],
                    help="Subset of phases to train (default: all four; 'none' trains "
                    "nothing). Earlier phases' checkpoints must already exist in --runs.")
parser.add_argument("--assert-thresholds", action="store_true",
                    help="Exit nonzero unless every phase clears its bar.")
parser.add_argument("--resume-split-phase", default="",
                    help="Train this phase in two legs, each with a trainer of its own: "
                    "first to about half its iterations, then the rest resumed from the "
                    "half-way periodic checkpoint (models, optimizer, scheduler, "
                    "REINFORCE baseline, iteration).")
parser.add_argument("--geometry", choices=["production", "small", "tiny"],
                    default="production",
                    help="Model geometry: production (256-d/2-layer LSTMs, 128-channel "
                    "modules), small (128-d/1-layer, 64-channel), tiny (32-d/1-layer, "
                    "16-channel).")
parser.add_argument("--grid", type=int, default=14,
                    help="Feature-grid side (14 = production CLEVR geometry).")
parser.add_argument("--hparam", nargs=2, action="append", default=[],
                    metavar=("KEY", "VALUE"),
                    help="Extra dotted config override applied to every phase, after the "
                    "per-phase table (e.g. --hparam ALPHA 500).")
parser.add_argument("--max-batch", type=int, default=0,
                    help="Cap every phase's batch size (0 = no cap).")
parser.add_argument("--nmn-channels", type=int, default=0,
                    help="Override the NMN module-channel width (0 = the --geometry "
                    "preset's).")

# The JAX script's settings (scripts/run_mini_clevr.py), copied. Phase
# hyperparameters tuned for the mini task's scale: higher LRs / fewer
# iterations than the reference's CLEVR budgets, same loss coefficients.
PHASE_HPARAMS = {
    "program_prior": {"OPTIM.LR_INITIAL": 1e-3, "OPTIM.BATCH_SIZE": 256},
    "question_coding": {
        "OPTIM.LR_INITIAL": 1e-3, "OPTIM.BATCH_SIZE": 256,
        "OBJECTIVE": "ours", "ALPHA": 100.0, "BETA": 0.1, "DELTA": 0.99,
    },
    "module_training": {
        "OPTIM.LR_INITIAL": 1e-3, "OPTIM.BATCH_SIZE": 128,
        # reference configs/module_training.yml disables LR scheduling
        "OPTIM.LR_PATIENCE": 1000000,
    },
    "joint_training": {
        "OPTIM.LR_INITIAL": 1e-4, "OPTIM.BATCH_SIZE": 256,
        "OBJECTIVE": "ours", "ALPHA": 100.0, "BETA": 0.1, "GAMMA": 1.0,
        "DELTA": 0.99,
    },
}

# "Far above chance": the majority-class answer baseline is ~0.29 ('no'),
# program sequence accuracy chance ~0 (46-token vocabulary, length ~7).
THRESHOLDS = {
    "program_prior": ("program_prior", "perplexity", "below", 5.0),
    "question_coding": ("program_generator", "sequence_accuracy", "above", 0.80),
    "module_training": ("nmn", "answer_accuracy", "above", 0.75),
    "joint_training": ("nmn", "answer_accuracy", "above", 0.75),
}

PHASE_ORDER = ["program_prior", "question_coding", "module_training", "joint_training"]
NMN_PHASES = ("module_training", "joint_training")


def phase_config(args, phase: str, num_iterations: int) -> Config:
    r"""The JAX script's ``phase_config`` without the H5 paths: the datasets
    come from memory, the vocabulary from ``--root``."""
    overrides = [
        "PHASE", phase,
        "RANDOM_SEED", args.seed,
        "SUPERVISION", args.supervision,
        "SUPERVISION_QUESTION_MAX_LENGTH", 40,
        "DATA.VOCABULARY", os.path.join(args.root, "vocab"),
        "CHECKPOINTS.PROGRAM_PRIOR",
        os.path.join(args.runs, "program_prior", "checkpoint_best.ckpt"),
        "CHECKPOINTS.QUESTION_CODING",
        os.path.join(args.runs, "question_coding", "checkpoint_best.ckpt"),
        "CHECKPOINTS.MODULE_TRAINING",
        os.path.join(args.runs, "module_training", "checkpoint_best.ckpt"),
        # Production model geometry; only the raw feature depth differs (the
        # generative map's 16 channels instead of ResNet's 1024).
        "NMN.IMAGE_FEATURE_SIZE", [mini_clevr.FEATURE_CHANNELS, args.grid, args.grid],
        "NMN.MODULE_CHANNELS", 128,
        "NMN.CLASS_PROJECTION_CHANNELS", 1024,
        "NMN.CLASSIFIER_LINEAR_SIZE", 1024,
        "OPTIM.NUM_ITERATIONS", num_iterations,
    ]
    for key, value in PHASE_HPARAMS[phase].items():
        if key == "OPTIM.BATCH_SIZE" and args.max_batch:
            value = min(value, args.max_batch)
        overrides += [key, value]
    geom = {
        "tiny": dict(lstm=32, layers=1, channels=16, proj=32, linear=64),
        "small": dict(lstm=128, layers=1, channels=64, proj=128, linear=256),
    }.get(args.geometry)
    if geom:
        for model in ("PROGRAM_PRIOR", "PROGRAM_GENERATOR", "QUESTION_RECONSTRUCTOR"):
            overrides += [f"{model}.INPUT_SIZE", geom["lstm"],
                          f"{model}.HIDDEN_SIZE", geom["lstm"],
                          f"{model}.NUM_LAYERS", geom["layers"]]
        overrides += ["NMN.MODULE_CHANNELS", geom["channels"],
                      "NMN.CLASS_PROJECTION_CHANNELS", geom["proj"],
                      "NMN.CLASSIFIER_LINEAR_SIZE", geom["linear"]]
    if args.nmn_channels:
        overrides += ["NMN.MODULE_CHANNELS", args.nmn_channels]
    for key, value in args.hparam:
        for cast in (int, float):
            try:
                value = cast(value)
                break
            except ValueError:
                continue
        overrides += [key, value]
    return Config(None, overrides)


def check_threshold(phase: str, metrics) -> tuple:
    model, metric, direction, bar = THRESHOLDS[phase]
    value = float(metrics[model][metric])
    ok = value < bar if direction == "below" else value > bar
    return value, f"{metric} {'<' if direction == 'below' else '>'} {bar}", ok


def _write_json(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _floats(tree):
    r"""``tree`` with every number a Python float (JSON-ready)."""
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items()}
    return float(tree)


def _flat_logs(logs, prefix=""):
    for key, value in logs.items():
        if isinstance(value, dict):
            yield from _flat_logs(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", float(value)


class MiniClevrRun:
    r"""One invocation over ``--runs``: the data (made on first use), then each
    phase trained and evaluated, or its existing best evaluated."""

    def __init__(self, args):
        self.args = args
        self.device = resolve_device(args.device)
        self._splits = None
        self.data = {}

    # ------------------------------------------------------------------ data ----------
    def splits(self):
        if self._splits is None:
            a = self.args
            t0 = time.perf_counter()
            vocab = make_clevr_like_vocabulary()
            self._splits = {
                split: mini_clevr.make_split(vocab, split, n, a.questions_per_image, a.seed,
                                             a.grid, a.grid)
                for split, n in (("train", a.train_images), ("val", a.val_images))
            }
            vocab.save_to_files(os.path.join(a.root, "vocab"))
            self.data.update({
                "train_examples": len(self._splits["train"].questions),
                "val_examples": len(self._splits["val"].questions),
                "generate_s": time.perf_counter() - t0,
            })
            logger.info("mini-CLEVR: %d train / %d val examples over %d / %d images in %.1f s",
                        self.data["train_examples"], self.data["val_examples"],
                        a.train_images, a.val_images, self.data["generate_s"])
        return self._splits

    def build(self, phase: str, config: Config, writer):
        r"""(trainer, evaluator, val set) of ``phase`` over the in-memory splits;
        the global numpy seed is set first, as the train CLI sets it, since
        the supervision subset depends on it."""
        np.random.seed(config.RANDOM_SEED)
        splits = self.splits()
        kw = dict(num_supervision=config.SUPERVISION,
                  supervision_question_max_length=config.SUPERVISION_QUESTION_MAX_LENGTH)
        train_set = mini_clevr.phase_dataset(splits["train"], phase, **kw)
        val_set = mini_clevr.phase_dataset(splits["val"], phase, **kw)
        trainer, evaluator = train.build(phase, config, self.phase_dir(phase), self.device,
                                         writer=writer, train_dataset=train_set,
                                         val_dataset=val_set)
        return trainer, evaluator, val_set

    def phase_dir(self, phase: str) -> str:
        return os.path.join(self.args.runs, phase)

    # ------------------------------------------------------------------ training ------
    def train_phase(self, phase: str, num_iterations: int):
        r"""Train ``phase`` from scratch to ``num_iterations`` (in two legs when
        it is ``--resume-split-phase``); returns the run's record: legs,
        steps, times and the val trajectories."""
        a = self.args
        sdir = self.phase_dir(phase)
        os.makedirs(sdir, exist_ok=True)
        config = phase_config(a, phase, num_iterations)
        config.dump(os.path.join(sdir, "mini_config.yml"))
        record = {"train_s": 0.0, "step_s": 0.0, "steps": 0, "nonfinite_steps": 0, "legs": [],
                  "trajectories": {}, "train_logs": {}}
        ends = [num_iterations]
        if phase == a.resume_split_phase and num_iterations >= 2 * a.checkpoint_every:
            # Crash-resume exercise, as the JAX script's: train to about half,
            # then resume from the half-way periodic checkpoint with a new trainer.
            ends.insert(0, num_iterations // 2 // a.checkpoint_every * a.checkpoint_every)
        start = 0
        for end in ends:
            mark = time.perf_counter()
            writer = RecordingWriter()
            trainer, evaluator, _ = self.build(phase, config, writer)
            resumed_from = None
            if start:
                resumed_from = os.path.join(sdir, f"checkpoint_{start - 1}.ckpt")
                trainer.load_checkpoint(resumed_from)
                logger.info("%s: resumed from %s", phase, resumed_from)
            record["legs"].append({"start": trainer.iteration + 1, "end": end,
                                   "resumed_from": resumed_from,
                                   "baseline": float(trainer.baseline)})
            for iteration in range(trainer.iteration + 1, end):
                t0 = time.perf_counter()
                logs = dict(_flat_logs(trainer.step(iteration)))
                record["step_s"] += time.perf_counter() - t0
                record["steps"] += 1
                record["nonfinite_steps"] += not all(map(math.isfinite, logs.values()))
                if (iteration + 1) % a.checkpoint_every:
                    continue
                val_metrics = evaluator.evaluate(num_batches=a.num_val_batches)
                seen = len(writer.scalars)
                trainer.after_validation(val_metrics, iteration)
                for tag, value, _ in writer.scalars[seen:]:
                    if tag.startswith("val/"):
                        record["trajectories"].setdefault(tag, []).append([iteration, value])
                    elif tag == "train/lr":
                        logs["lr"] = value
                for key, value in logs.items():
                    record["train_logs"].setdefault(key, []).append([iteration, value])
                model, metric, _, _ = THRESHOLDS[phase]
                losses = {k: round(v, 4) for k, v in logs.items() if k.startswith("loss")}
                logger.info("%s %d: %s %s %.4f, %s, %.2f steps/s", phase, iteration, model,
                            metric, val_metrics[model][metric], losses,
                            record["steps"] / record["step_s"])
            record["train_s"] += time.perf_counter() - mark
            start = end
            del trainer, evaluator
        return record

    # ------------------------------------------------------------------ evaluation ----
    def evaluate_best(self, phase: str):
        r"""Metrics of the phase's best checkpoint on the whole val split, from a
        fresh trainer, and the checkpoint's iteration."""
        sdir = self.phase_dir(phase)
        config = Config(os.path.join(sdir, "mini_config.yml"))
        trainer, evaluator, val_set = self.build(phase, config, RecordingWriter())
        trainer.load_checkpoint(os.path.join(sdir, "checkpoint_best.ckpt"))
        metrics = evaluator.evaluate()
        if phase in NMN_PHASES:
            free = type(evaluator)(config, trainer, dataset=val_set, program_decode="free_greedy")
            metrics["nmn_free_greedy"] = free.evaluate()["nmn"]
        return _floats({k: v for k, v in metrics.items() if isinstance(v, dict)}), trainer.iteration

    def run_phase(self, phase: str, num_iterations: int):
        r"""The report entry of ``phase``: trained and evaluated when asked for,
        else its existing best checkpoint evaluated (a phase trained by an
        earlier invocation, as the JAX script folds it in); None when it has
        none."""
        sdir = self.phase_dir(phase)
        if phase in self.phases:
            logger.info("=== phase %s (%d iterations) ===", phase, num_iterations)
            record = self.train_phase(phase, num_iterations)
        elif os.path.exists(os.path.join(sdir, "checkpoint_best.ckpt")):
            logger.info("=== phase %s (re-evaluating the existing best) ===", phase)
            record = {}
        else:
            return None
        t0 = time.perf_counter()
        metrics, best_iteration = self.evaluate_best(phase)
        value, bar, ok = check_threshold(phase, metrics)
        entry = {
            "iterations": num_iterations, "metric": THRESHOLDS[phase][:2], "value": value,
            "bar": bar, "pass": ok, "metrics": metrics, "best_iteration": best_iteration,
            "eval_s": time.perf_counter() - t0, "trained": bool(record),
            **{k: record.get(k) for k in ("train_s", "step_s", "steps", "nonfinite_steps",
                                          "legs", "trajectories", "train_logs")},
        }
        if entry["steps"]:
            entry["steps_per_s"] = entry["steps"] / entry["step_s"]
        return entry

    def __call__(self):
        a = self.args
        os.makedirs(a.runs, exist_ok=True)
        if self.device.type == "cuda":
            # Build the kernels now, so that no phase's first step pays for it.
            from probnmn_tpu_torch.ops.kernels import _build

            t0 = time.perf_counter()
            _build.library()
            self.data["build_s"] = time.perf_counter() - t0
            logger.info("kernels built in %.1f s", self.data["build_s"])
        self.phases = [] if a.phases == ["none"] else (a.phases or PHASE_ORDER)
        iters = dict(zip(PHASE_ORDER, a.iters))
        results = {}
        for phase in PHASE_ORDER:
            entry = self.run_phase(phase, iters[phase])
            if entry is None:
                continue
            results[phase] = entry
            logger.info("phase %s: %s = %.4f (%s) -> %s", phase, THRESHOLDS[phase][1],
                        entry["value"], entry["bar"], "PASS" if entry["pass"] else "FAIL")
        return results


# ------------------------------------------------------------------ report --------
def device_info(device) -> dict:
    r"""The device's name, and on ``cuda`` the ``nvidia-smi`` line (name, power limit)."""
    if device.type != "cuda":
        return {"type": "cpu", "name": "cpu", "nvidia_smi": None}
    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"not read: {e}"
    return {"type": "cuda", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def command_line(args) -> str:
    cmd = [f"python -m probnmn_tpu_torch.mini_clevr_run --seed {args.seed} "
           f"--train-images {args.train_images} --val-images {args.val_images} "
           f"--questions-per-image {args.questions_per_image} --supervision {args.supervision} "
           f"--iters {' '.join(map(str, args.iters))}"]
    if args.geometry != "production":
        cmd.append(f"--geometry {args.geometry}")
    if args.grid != 14:
        cmd.append(f"--grid {args.grid}")
    if args.max_batch:
        cmd.append(f"--max-batch {args.max_batch}")
    if args.nmn_channels:
        cmd.append(f"--nmn-channels {args.nmn_channels}")
    if args.phases:
        cmd.append(f"--phases {' '.join(args.phases)}")
    if args.resume_split_phase:
        cmd.append(f"--resume-split-phase {args.resume_split_phase}")
    for key, value in args.hparam:
        cmd.append(f"--hparam {key} {value}")
    return " ".join(cmd)


def make_report(args, run: MiniClevrRun, results) -> dict:
    return {
        "command": command_line(args),
        "device": device_info(run.device),
        "data": dict(run.data, train_images=args.train_images, val_images=args.val_images,
                     questions_per_image=args.questions_per_image,
                     supervision=args.supervision, grid=args.grid),
        "iterations": dict(zip(PHASE_ORDER, args.iters)),
        "checkpoint_every": args.checkpoint_every,
        "num_val_batches": args.num_val_batches,
        "phases": {p: {k: v for k, v in e.items() if k not in ("trajectories", "train_logs")}
                   for p, e in results.items()},
        "val_trajectories": {p: e["trajectories"] for p, e in results.items()
                             if e.get("trajectories")},
        "train_logs": {p: e["train_logs"] for p, e in results.items() if e.get("train_logs")},
    }


def write_markdown(path: str, report: dict) -> None:
    device = report["device"]
    lines = [
        "# Mini-CLEVR convergence run (PyTorch port)",
        "",
        f"- command: `{report['command']}`",
        f"- device: {device['name']}"
        + (f" (nvidia-smi: {device['nvidia_smi']})" if device["nvidia_smi"] else ""),
        f"- iterations: {report['iterations']}; val every {report['checkpoint_every']} "
        f"iterations on {report['num_val_batches']} batches",
        "- train s: the legs' wall clock (trainer builds, steps, periodic evaluations, "
        "checkpoints); steps/s: steps over the steps' own host clock",
        "",
        "| phase | headline metric | value | bar | pass | best at | train s | steps/s "
        "| all val metrics |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for phase, entry in report["phases"].items():
        flat = {f"{m}/{k}": round(v, 4) for m, d in entry["metrics"].items()
                for k, v in d.items()}
        train_s = "-" if entry.get("train_s") is None else f"{entry['train_s']:.1f}"
        rate = f"{entry['steps_per_s']:.2f}" if entry.get("steps_per_s") else "-"
        lines.append(
            f"| {phase} | {entry['metric'][1]} | {entry['value']:.4f} | {entry['bar']} | "
            f"{'YES' if entry['pass'] else 'NO'} | {entry['best_iteration']} | {train_s} | "
            f"{rate} | `{json.dumps(flat)}` |")
    lines.append("")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(args):
    r"""Returns the report (a dict, also written to ``--report-json``)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    run = MiniClevrRun(args)
    results = run()
    report = make_report(args, run, results)
    if args.report_json:
        _write_json(args.report_json, report)
    if args.report:
        write_markdown(args.report, report)
        logger.info("report written to %s", args.report)
    if args.assert_thresholds:
        failed = [p for p, e in results.items() if not e["pass"]]
        if failed:
            logger.error("phases below threshold: %s", failed)
            sys.exit(1)
    return report


if __name__ == "__main__":
    main(parser.parse_args())
