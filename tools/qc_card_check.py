r"""The question_coding phase of the mini-CLEVR runner trained on the card,
held against its plain version on the CPU at the parameters it reaches:

    python3 tools/qc_card_check.py [--steps 1500] [--images 15000] [--sample-float32]
        [-- runner flags, e.g. --geometry small]

The trainer is built as ``probnmn_tpu_torch.mini_clevr_run`` builds it
(``phase_config`` with ``--hparam ALPHA 500.0``, the in-memory splits of
``--images`` train and 750 val images from seed 0, 1,000 supervised
questions), with a frozen prior of random weights. At the start and every
``--check-every`` steps, on the next batch:

- K1 on the unsupervised questions against its plain version on explicit
  Gumbel noise, float32 and bfloat16 (``chip_smoke.k1_against_plain``: the
  share of identical rows and the logprobs' max |dev|, at ``chip_smoke.py``
  phase 2's tolerances); how many of the sampled z end with @end@, and
  their mean length;
- ``question_coding_objective`` at the card's z against the same call on
  the CPU from the same parameters (``chip_smoke.objective_against_cpu``:
  the total, every log and the baseline, and the worst gradient leaf's max
  |dev| over max(1, max|g|), at phase 7's tolerances), once with the
  config's ALPHA and once with ALPHA 0 (the ELBO alone, whose REINFORCE
  gradients the supervised terms would otherwise dwarf).

Every 250 steps it evaluates 6 val batches (program generator and
reconstructor sequence accuracy). ``--sample-float32`` samples z with K1 in
float32 instead of bfloat16. Needs a CUDA card.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from probnmn_tpu_torch import mini_clevr_run, train  # noqa: E402
from probnmn_tpu_torch.data import mini_clevr as mc  # noqa: E402
from probnmn_tpu_torch.models.program_prior import init_program_prior_params  # noqa: E402
from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward  # noqa: E402
from probnmn_tpu_torch.training._trainer import copy_into, tree_map  # noqa: E402
from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec  # noqa: E402
from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY  # noqa: E402
from probnmn_tpu_torch.utils.checkpointing import save_objects  # noqa: E402
from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary  # noqa: E402
from probnmn_tpu_torch.utils.observability import RecordingWriter  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--steps", type=int, default=1500)
parser.add_argument("--images", type=int, default=15000)
parser.add_argument("--check-every", type=int, default=500)
parser.add_argument("--sample-float32", action="store_true")
parser.add_argument("--device", default="cuda", help="cuda; cpu rehearses the script")
parser.add_argument("runner_flags", nargs=argparse.REMAINDER)


def set_alpha(config, alpha):
    r"""Set the (frozen) config's ALPHA in place, for the ELBO-alone check."""
    node = object.__getattribute__(config, "_C")
    object.__setattr__(node, "_frozen", False)
    node.ALPHA = alpha


def main(args):
    torch.backends.cuda.matmul.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="qc_card_check_")
    vocab = make_clevr_like_vocabulary()
    vocab.save_to_files(os.path.join(work, "vocab"))
    train_split = mc.make_split(vocab, "train", args.images, 2, 0)
    val_split = mc.make_split(vocab, "val", 750, 2, 0)
    flags = [f for f in args.runner_flags if f != "--"]
    runner_args = mini_clevr_run.parser.parse_args(
        ["--root", work, "--runs", work, "--hparam", "ALPHA", "500.0"] + flags)
    config = mini_clevr_run.phase_config(runner_args, "question_coding", args.steps)
    alpha = config.ALPHA
    os.makedirs(os.path.join(work, "program_prior"))
    save_objects(config.CHECKPOINTS.PROGRAM_PRIOR, {"program_prior": init_program_prior_params(
        torch.Generator().manual_seed(0), make_prior_spec(config, vocab))})

    def build(device, name):
        np.random.seed(config.RANDOM_SEED)
        kw = dict(num_supervision=config.SUPERVISION,
                  supervision_question_max_length=config.SUPERVISION_QUESTION_MAX_LENGTH)
        return train.build("question_coding", config, os.path.join(work, name), device,
                           writer=RecordingWriter(),
                           train_dataset=mc.phase_dataset(train_split, "question_coding", **kw),
                           val_dataset=mc.phase_dataset(val_split, "question_coding"))

    trainer, evaluator = build(args.device, "card")
    cpu, _ = build("cpu", "cpu")
    spec = trainer.pg_spec
    if args.sample_float32:
        def sample_float32(questions, dropout_masks=None):
            seed = int(torch.randint(2 ** 62, (1,), generator=trainer._generator))
            with torch.no_grad():
                return fused_sampling_forward(trainer.params["program_generator"], spec,
                                              questions, seed=seed, compute_dtype=torch.float32,
                                              dropout_masks=dropout_masks)["predictions"]
        trainer.sample_programs = sample_float32

    def check(tag):
        copy_into(cpu.params, trainer.params)
        batch = next(trainer._batches)
        q = batch["question"][batch[COUNT_KEY]:]
        gen = torch.Generator().manual_seed(5)
        noise = -torch.log(-torch.log(torch.rand(spec.max_decoding_steps, len(q),
                                                 spec.target_vocab_size,
                                                 generator=gen).clamp_min(1e-12)))
        params = tree_map(lambda t: t.detach(), trainer.params["program_generator"])
        chip_smoke.k1_against_plain(torch, params, spec, q, noise.to(q.device), tag=f"{tag} K1")
        z = trainer.sample_programs(q)
        print(f"[{tag}] {len(q)} unsupervised rows; z ending with @end@ "
              f"{float((z == spec.end_index).any(1).float().mean()):.3f}, mean length "
              f"{float((z != spec.pad_index).sum(1).float().mean()):.2f}", flush=True)
        for a in (alpha, 0.0):
            set_alpha(config, a)
            chip_smoke.objective_against_cpu(torch, trainer, cpu, batch, z,
                                             trainer.baseline.detach(), tag=f"{tag} ALPHA {a}")
        set_alpha(config, alpha)

    check("init")
    t0 = time.time()
    for iteration in range(args.steps):
        trainer.step(iteration)
        if (iteration + 1) % 250 == 0:
            metrics = evaluator.evaluate(num_batches=6)
            trainer.after_validation(metrics, iteration)
            print(f"[{iteration}] val sequence accuracy: program generator "
                  f"{metrics['program_generator']['sequence_accuracy']:.4f}, reconstructor "
                  f"{metrics['question_reconstructor']['sequence_accuracy']:.4f} "
                  f"({time.time() - t0:.0f} s)", flush=True)
        if (iteration + 1) % args.check_every == 0:
            check(f"after {iteration + 1}")
    if trainer.device.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main(parser.parse_args())
