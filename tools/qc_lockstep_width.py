r"""The question_coding trainer of the port and of the JAX package in lockstep
on the CPU, at the width the mini-CLEVR recipe trains (256 units, 2 layers,
batch 256 by default): the same initial parameters, the same frozen prior,
the same batches, and both generators sampling from the same Philox Gumbel
noise each step (JAX's jitted step reads it through a host callback), as
``tests/test_torch_port_mini_clevr.py``'s lockstep test does at tiny widths.

    python tools/qc_lockstep_width.py --root DATA --runs RUNS [--steps 200] \
        [--out FILE.json] [-- runner flags]

Runner flags go to ``scripts/run_mini_clevr.py``'s parser (default: the
recipe's ``--supervision 1000 --hparam ALPHA 500.0`` at production geometry
on 3,000 training images); the data are generated into ``--root`` as that
script does unless they are there already. The prior is ``RUNS/
program_prior/checkpoint_best.ckpt`` (a trained one, as the recipe uses)
when it exists, else random parameters from a fixed key, saved there.

Prints, at each step, the largest difference of any log between the two
trainers, the difference of their REINFORCE baselines, how many of the
step's sampled programs z differ (the port's z against the port's sampler
run at JAX's parameters on the same noise: a row flips where two tokens'
noisy logits lie within the parameters' difference of each other), and the
largest parameter difference of each leaf after the step (the leaf with the
largest first); ``--out`` keeps every step's numbers as JSON. Needs both packages
and runs on the CPU only: a step of each at the default width takes about
a second (JAX) and 1.5 s (the port's plain path) on 8 cores.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--root", required=True, help="mini-CLEVR data (generated if absent)")
parser.add_argument("--runs", required=True, help="where the prior checkpoint is, or is put")
parser.add_argument("--steps", type=int, default=200)
parser.add_argument("--out", default="", help="JSON file of every step's differences")
parser.add_argument("runner", nargs=argparse.REMAINDER,
                    help="flags of scripts/run_mini_clevr.py, after --")

RECIPE = ["--supervision", "1000", "--hparam", "ALPHA", "500.0"]


def leaves(tree, prefix=""):
    r"""(path, array) of every leaf of a nested dict / list of arrays."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def main(argv=None):
    args = parser.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import run_mini_clevr
    from probnmn_tpu.data.vocabulary import Vocabulary as JaxVocabulary
    from probnmn_tpu.models.program_prior import init_program_prior_params
    from probnmn_tpu.ops.pallas.seq2seq_decode import sampling_forward_with_noise_xla
    from probnmn_tpu.training import question_coding_trainer as jax_qc
    from probnmn_tpu.training.program_prior_trainer import make_prior_spec
    from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
    from probnmn_tpu_torch import interop
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        philox_gumbel, sampling_forward_with_noise,
    )
    from probnmn_tpu_torch.training._trainer import copy_into
    from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer
    from probnmn_tpu_torch.utils.checkpointing import save_objects
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    flags = [f for f in args.runner if f != "--"]
    runner_args = run_mini_clevr.parser.parse_args(
        ["--root", args.root, "--runs", args.runs] + RECIPE + flags)
    run_mini_clevr.make_dataset(runner_args)
    jax_config = run_mini_clevr.phase_config(runner_args, "question_coding", args.steps)
    prior_path = jax_config.CHECKPOINTS.PROGRAM_PRIOR
    if not os.path.exists(prior_path):
        os.makedirs(os.path.dirname(prior_path), exist_ok=True)
        vocab = JaxVocabulary.from_files(os.path.join(args.root, "vocab"))
        jax_save_objects(prior_path, {"program_prior": init_program_prior_params(
            jax.random.PRNGKey(11), make_prior_spec(jax_config, vocab))})
        print(f"[lockstep] random prior saved to {prior_path}", flush=True)
    work = tempfile.mkdtemp(prefix="qc_lockstep_")
    path = os.path.join(work, "qc.yml")
    jax_config.dump(path)

    draws = {"port": 0, "jax": 0, "rows": 0}

    def noise(side, rows, spec):
        draws[side] += 1
        return philox_gumbel(1000 + draws[side], spec.max_decoding_steps, rows,
                             spec.target_vocab_size)

    sampling = jax_qc.seq2seq_forward

    def jax_sampling(params, spec, source, target=None, *a, **kw):
        if target is not None:
            return sampling(params, spec, source, target, *a, **kw)
        shape = (spec.max_decoding_steps, source.shape[0], spec.target_vocab_size)

        def host_noise():  # the unsupervised rows are the window's last ones
            full = np.zeros(shape, np.float32)
            full[:, shape[1] - draws["rows"]:] = noise("jax", draws["rows"], spec)
            return full

        gumbel = jax.pure_callback(host_noise, jax.ShapeDtypeStruct(shape, jnp.float32))
        return sampling_forward_with_noise_xla(params, spec, source, gumbel)

    jax_qc.seq2seq_forward = jax_sampling  # restored on the way out
    try:
        np.random.seed(jax_config.RANDOM_SEED)
        jax_trainer = jax_qc.QuestionCodingTrainer(jax_config, os.path.join(work, "jax"))
        port_prior = os.path.join(work, "prior_port.ckpt")
        save_objects(port_prior, {"program_prior": interop.program_prior_from_jax(
            jax.tree_util.tree_map(np.asarray, jax_trainer._prior_params))})
        config = Config(path, ["CHECKPOINTS.PROGRAM_PRIOR", port_prior])
        np.random.seed(config.RANDOM_SEED)
        port = QuestionCodingTrainer(config, os.path.join(work, "port"), device="cpu",
                                     writer=RecordingWriter())
        for name in ("program_generator", "question_reconstructor"):
            copy_into(port.params[name], interop.program_generator_from_jax(
                jax.tree_util.tree_map(np.asarray, jax_trainer.params[name])))

        sampled = {}

        def port_sampling(questions, dropout_masks=None):
            draws["rows"] = len(questions)
            gumbel = torch.from_numpy(noise("port", len(questions), port.pg_spec))
            at_jax = interop.program_generator_from_jax(jax.tree_util.tree_map(
                np.asarray, jax_trainer.params["program_generator"]))
            with torch.no_grad():
                z = sampling_forward_with_noise(port.params["program_generator"], port.pg_spec,
                                                questions, gumbel)["predictions"]
                z_jax = sampling_forward_with_noise(at_jax, port.pg_spec, questions,
                                                    gumbel)["predictions"]
            sampled["rows"] = len(questions)
            sampled["differ"] = int((z != z_jax).any(1).sum())
            return z

        port.sample_programs = port_sampling
        print(f"[lockstep] PG {port.pg_spec}; batch {config.OPTIM.BATCH_SIZE}; prior {prior_path}; "
              f"{args.steps} steps", flush=True)
        history = []
        for iteration in range(args.steps):
            t0 = time.perf_counter()
            got = port.step(iteration)
            t1 = time.perf_counter()
            want = jax.tree_util.tree_map(
                float, jax_trainer._do_iteration(next(jax_trainer._batches)))
            t2 = time.perf_counter()
            assert draws["port"] == draws["jax"] == iteration + 1, draws
            logs = {f"{g}/{k}": (got[g][k], v)
                    for g, values in want.items() for k, v in values.items()}
            log_diff = max(abs(a - b) for a, b in logs.values())
            worst_log = max(logs, key=lambda k: abs(logs[k][0] - logs[k][1]))
            baseline_diff = abs(float(port.baseline) - float(jax_trainer._baseline))
            params = {}
            for name in ("program_generator", "question_reconstructor"):
                ours = {k: v.detach().numpy() for k, v in leaves(port.params[name], name)}
                theirs = dict(leaves(jax.tree_util.tree_map(np.asarray, jax_trainer.params[name]),
                                     name))
                for key, value in ours.items():
                    params[key] = float(np.abs(value - theirs[key]).max())
            order = sorted(params, key=params.get, reverse=True)
            row = {"iteration": iteration, "log_diff": log_diff, "worst_log": worst_log,
                   "baseline_diff": baseline_diff, "z_rows": sampled["rows"],
                   "z_rows_differ": sampled["differ"], "params": params,
                   "logs": {k: list(v) for k, v in logs.items()},
                   "port_s": t1 - t0, "jax_s": t2 - t1}
            history.append(row)
            print(f"[lockstep] step {iteration}: max |log diff| {log_diff:.3e} ({worst_log}: "
                  f"{logs[worst_log][0]:.6f} / {logs[worst_log][1]:.6f}), |baseline diff| "
                  f"{baseline_diff:.3e}, z differs in {sampled['differ']} of {sampled['rows']} "
                  f"rows, "
                  f"max |param diff| {params[order[0]]:.3e} ({order[0]}); "
                  + ", ".join(f"{k} {params[k]:.2e}" for k in order[1:6])
                  + f"; {t1 - t0:.2f} / {t2 - t1:.2f} s", flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(history, f)
        return history
    finally:
        jax_qc.seq2seq_forward = sampling
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
