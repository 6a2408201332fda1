#!/usr/bin/env python3
r"""
Do an NMN's answers depend on the batch a row runs in? Both packages on the
CPU, on one random NMN and the same inputs, each row's answer and logits
computed inside a batch of 64 rows and again inside a batch of 256 (the
same 64 rows first, then 192 others), as the serving engine's buckets 64
and 256 run them:

    JAX_PLATFORMS=cpu python tools/bucket_rows.py [--channels 32] [--features 64] \
        [--rows 256] [--small 64] [--seed 0] [--out FILE.json]

- the JAX package's ``nmn_forward`` (jitted at each batch size) in float32;
- the port's serving forward (``nmn.make_fast_inference_fn``: the stem, the
  interpreter's plain version, the classifier) in float32 and in bfloat16,
  each stage (stem, interpreter, classifier) compared between the two
  batches, so the first op whose rows move with the batch is named;
- the port against JAX at 256 rows in float32.

For every row whose answer moves, its top-two logit gap. Valid CLEVR-like
programs of every kind (``sample_clevr_like_programs``), features from a
normal draw, the NMN's parameters JAX's init at ``--seed`` converted to the
port's layout. Prints one JSON object.

``--device cuda`` runs the port alone on the card (no JAX there), the
interpreter as kernel K2, with the NMN's parameters the port's own init
at ``--seed``: ``python3 tools/bucket_rows.py --device cuda --channels 128
--features 1024`` holds the shipped widths.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--channels", type=int, default=32, help="NMN module channels.")
parser.add_argument("--features", type=int, default=64, help="Feature channels.")
parser.add_argument("--grid", type=int, default=14)
parser.add_argument("--rows", type=int, default=256)
parser.add_argument("--small", type=int, default=64)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--device", default="cpu")
parser.add_argument("--out", default="")


def moved(a_small, a_big, logits_small, logits_big):
    r"""Rows whose answer differs between the batches, with each one's
    top-two logit gap in the small batch, and the largest logit change."""
    rows = np.nonzero(a_small != a_big)[0]
    top2 = np.sort(logits_small, axis=1)[:, -2:]
    return {"rows_moved": [int(r) for r in rows],
            "gaps": [float(top2[r, 1] - top2[r, 0]) for r in rows],
            "max_logit_dev": float(np.abs(logits_small - logits_big).max())}


def main():
    args = parser.parse_args()
    import torch

    from probnmn_tpu_torch import interop
    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        execute_programs_kernel, execute_programs_plain,
    )
    from probnmn_tpu_torch.utils.clevr import (
        make_clevr_like_vocabulary, sample_clevr_like_programs,
    )

    card = args.device == "cuda"
    dev = torch.device(args.device)
    widths = dict(feature_channels=args.features, height=args.grid, width=args.grid,
                  module_channels=args.channels, class_projection_channels=2 * args.features,
                  classifier_linear_size=2 * args.features)
    vocab = make_clevr_like_vocabulary()
    spec = nmn.make_spec(vocab)
    for key, value in widths.items():
        setattr(spec, key, value)
    programs = np.asarray(sample_clevr_like_programs(vocab, args.rows, seed=args.seed + 1),
                          np.int64)
    feats = np.random.RandomState(args.seed + 2).randn(
        args.rows, args.grid, args.grid, args.features).astype(np.float32)  # NHWC
    n = args.small
    out = {"widths": widths, "rows": args.rows, "small": n, "programs": "valid CLEVR-like",
           "device": args.device}
    if card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = nmn.init_nmn_params(torch.Generator().manual_seed(args.seed), spec)
    else:
        import jax
        import jax.numpy as jnp

        from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
        from probnmn_tpu.models import nmn as jnmn

        jax.config.update("jax_platforms", "cpu")
        jvocab = JVocabulary({ns: [vocab.get_token_from_index(i, ns)
                                   for i in range(vocab.get_vocab_size(ns))]
                              for ns in ("questions", "programs", "answers")},
                             non_padded_namespaces=["answers"])
        jspec = jnmn.make_spec(jvocab)
        for key, value in widths.items():
            setattr(jspec, key, value)
        jparams = jnmn.init_nmn_params(jax.random.PRNGKey(args.seed), jspec)
        params = interop.nmn_from_jax(jax.tree_util.tree_map(np.asarray, jparams), spec)
        forward = jax.jit(lambda p, f, t: jnmn.nmn_forward(p, jspec, f, t))
        jax_runs = {}
        for rows in (n, args.rows):
            res = forward(jparams, jnp.asarray(feats[:rows]), jnp.asarray(programs[:rows]))
            jax_runs[rows] = (np.asarray(res["predictions"]), np.asarray(res["answer_logits"]))
        out["jax_float32"] = moved(jax_runs[n][0], jax_runs[args.rows][0][:n], jax_runs[n][1],
                                   jax_runs[args.rows][1][:n])

    port_runs = {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        fwd = nmn.make_fast_inference_fn(params, spec, device=dev, dtype=dtype)
        banks = nmn.build_banks(nmn.cast_params(params, device=dev), spec, dtype)
        tables = nmn.build_tables(spec, dev)
        stem_params = nmn.cast_params(params["stem"], dtype, dev)
        interpreter = execute_programs_kernel if card else execute_programs_plain
        stages = {}
        for rows in (n, args.rows):
            f = torch.from_numpy(feats[:rows]).to(dev)
            t = torch.from_numpy(programs[:rows]).to(dev)
            res = fwd(f, t)
            stem = nmn.apply_stem(stem_params, f.to(dtype)).contiguous()
            final, _ = interpreter(banks, tables, spec, stem, t)
            stages[rows] = {"answers": res["predictions"].cpu().numpy(),
                            "logits": res["answer_logits"].float().cpu().numpy(),
                            "stem": stem[:n].float().cpu().numpy(),
                            "final": final[:n].float().cpu().numpy()}
        small, big = stages[n], stages[args.rows]
        entry = moved(small["answers"], big["answers"][:n], small["logits"], big["logits"][:n])
        entry["stage_max_dev"] = {
            "stem": float(np.abs(small["stem"] - big["stem"]).max()),
            "interpreter": float(np.abs(small["final"] - big["final"]).max()),
            "classifier_logits": entry["max_logit_dev"]}
        out[f"port_{name}"] = entry
        port_runs[name] = stages
    if not card:
        big = port_runs["float32"][args.rows]
        out["port_vs_jax_float32_at_rows"] = {
            "max_logit_dev": float(np.abs(big["logits"] - jax_runs[args.rows][1]).max()),
            "answers_differ": int((big["answers"] != jax_runs[args.rows][0]).sum())}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
