#!/usr/bin/env python3
r"""Which part of a float32 NMN training step does not repeat bit for bit:
the step's forward and backward (``nmn.nmn_forward_fast``, the path
module_training and joint_training take) run twice on the same inputs, and
each piece is compared between the two runs:

- forward: the stem's output (two cuDNN 3x3 convs), K5's final encodings,
  the classifier's logits;
- backward: the gradient reaching the final encodings (the classifier's
  backward), the gradient reaching the stem's output (K6), and every
  parameter's gradient (the stem's from cuDNN's backward, the banks' from
  K6, the classifier's).

Then the same with ``torch.backends.cudnn.deterministic`` set, to see
whether cuDNN's algorithm choice is what moves.

    python3 tools/nmn_step_repeat.py [--rows 128] [--out FILE]

The NMN at the shipped widths (C = 128 on 14 x 14 over 1024 channels) from
``init_nmn_params``, CLEVR-like programs, random features and answers, all
from seed 0. Prints a line a setting and one JSON summary (also written to
``--out``): for each piece, equal or the largest difference. Needs a CUDA
card.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--rows", type=int, default=128)
parser.add_argument("--out", default="")


def run_once(torch, nmn, ni, params, spec, tables, feats, programs, answers):
    r"""{piece: tensor} of one forward and backward."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in _flat(params).items()}
    p = _unflat(leaves)
    seen = {}
    banks = ni.build_banks(p, spec, torch.float32)
    stem = nmn.apply_stem(p["stem"], feats)
    stem.retain_grad()
    final, invalid = ni.execute_programs_diff(banks, tables, spec, stem.contiguous(), programs)
    final.retain_grad()
    logits = nmn.apply_classifier(p["classifier"], final).float()
    out = nmn._outputs_from_logits(logits, invalid, spec, answers)
    out["loss"].sum().backward()
    seen.update(stem=stem.detach(), final=final.detach(), logits=logits.detach(),
                g_final=final.grad, g_stem=stem.grad)
    for name, leaf in leaves.items():
        seen["grad " + name] = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
    torch.cuda.synchronize()
    return seen


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def _unflat(flat):
    out = {}
    for path, value in flat.items():
        node = out
        keys = path.strip("/").split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return out


def main():
    args = parser.parse_args()
    import numpy as np
    import torch

    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels import _build
    from probnmn_tpu_torch.ops.kernels import nmn_interpreter as ni
    from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary, sample_clevr_like_programs

    if not torch.cuda.is_available():
        raise RuntimeError("tools/nmn_step_repeat.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda")
    vocab = make_clevr_like_vocabulary()
    spec = nmn.make_spec(vocab)
    tables = ni.build_tables(spec, dev)
    gen = torch.Generator().manual_seed(0)
    params = cast_params(nmn.init_nmn_params(gen, spec), torch.float32, dev)
    programs = torch.from_numpy(sample_clevr_like_programs(vocab, args.rows, seed=0)).to(dev)
    feats = torch.randn(args.rows, spec.height, spec.width, spec.feature_channels,
                        generator=gen).to(dev)
    answers = torch.from_numpy(np.random.RandomState(0).randint(
        0, spec.num_answers - 1, args.rows)).to(dev)
    summary = {"rows": args.rows, "device": torch.cuda.get_device_name(0)}
    for setting in ("cudnn default", "cudnn deterministic"):
        torch.backends.cudnn.deterministic = setting == "cudnn deterministic"
        first = run_once(torch, nmn, ni, params, spec, tables, feats, programs, answers)
        second = run_once(torch, nmn, ni, params, spec, tables, feats, programs, answers)
        moved = {k: float((first[k] - second[k]).abs().max()) for k in first
                 if not torch.equal(first[k], second[k])}
        summary[setting] = moved
        print(f"[nmn-repeat] {setting}: {len(first) - len(moved)} of {len(first)} pieces equal "
              f"bit for bit; moved: {json.dumps(moved) if moved else 'none'}", flush=True)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
