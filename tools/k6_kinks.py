#!/usr/bin/env python3
r"""K6's float32 check against its references over many random inputs: how
often K6 stands off the float32 plain version, the by-row float32
reference (``interpreter_grads_plain_by_row``), the plain version run in
float64, and the float64 gradient of the branch K5 and K6 took
(``interpreter_grads_on_branch``, the reference ``chip_smoke.py`` holds
float32 K6 to), and, on every draw where the last fails, which rows stand
off and what in their forward decides it.

    python3 tools/k6_kinks.py [--draws 32] [--rows 64] [--out FILE]

Each draw: the NMN at the shipped widths (C = 128 on 14 x 14 over 1024
channels) with parameters from ``nmn.init_nmn_params`` at the draw's seed,
``--rows`` CLEVR-like programs (two token soups and an all-pad row), random
features through the float32 stem and a random cotangent; K5 and K6 in
float32. Each leaf's error over its limit (``K6_TOL`` 1e-4 of max(1,
max|g|), as ``chip_smoke.py`` holds it) is taken for K6 against the batched
float32 plain version, the by-row one, the float64 one (the same float32
banks, stem and cotangent, every step in float64) and the float64 branch
(with its count of decisions that float64 takes the other way, and their
largest margin over its scale; a decision beyond ``BRANCH_TOL`` fails), and
for the float32 plain version against the float64 one. K6's
weight-gradient stage and conv input gradients are held against float64
sums over its own workspace (``workspace_errors``). A ratio above 1 fails.

On a draw where K6 fails against the float64 branch, every row is run alone
through K5 and K6 and through the float64 plain version. A row whose worst leaf stands above a tenth of the
limit is printed with its tokens in the order they run and, for each step
of its forward, what could send float32 and float64 different ways: ReLU
outputs of a two-conv chain whose sign K5 and float64 disagree on,
``same``'s argmax (K5's against float64's, and float64's gap between its
two largest attentions), and the pixels where ``and`` / ``or`` pick the
other register (with float64's smallest gap between the two). Also how far
K5's register at each step stands from float64's, over its scale.

Prints a line a draw, the rows, and one JSON summary (also written to
``--out``). Needs a CUDA card.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

K6_TOL = 1e-4
WS_TOL = 1e-5  # as chip_smoke.py holds the workspace

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--draws", type=int, default=32)
parser.add_argument("--rows", type=int, default=64)
parser.add_argument("--out", default="")


def ratios(got_stem, got_banks, want_stem, want_banks, names, scales=None):
    r"""{leaf: error over its limit}; the limit's scale is the reference's
    max |g| unless ``scales`` gives it."""
    out = {}
    for leaf, got, want in [("stem", got_stem, want_stem)] + [
            (k, got_banks[k], want_banks[k]) for k in names]:
        err = float((got.double() - want.double()).abs().max())
        scale = scales[leaf] if scales else float(want.double().abs().max())
        out[leaf] = err / (K6_TOL * max(1.0, scale))
    return out


def worst(r):
    leaf = max(r, key=r.get)
    return [r[leaf], leaf]


def forward_decisions(torch, ni, tables, tokens_rev, k5_otraj, k5_atraj, f64_otraj, f64_atraj):
    r"""Per executed step of one row: its token kind and what float32 (K5)
    and float64 decided differently there (see the module docstring)."""
    kinds = tables["kind"].long().cpu()
    steps = []
    saved32 = saved64 = None
    for t, tok in enumerate(tokens_rev.tolist()):
        kind = int(kinds[tok])
        if tok == 0 and not steps:  # K5 leaves the leading pad steps unwritten
            continue
        o32, o64 = k5_otraj[t].double(), f64_otraj[t]
        step = {"t": t, "kind": kind,
                "register_err": float((o32 - o64).abs().max()) / max(1.0, float(o64.abs().max()))}
        if kind in (ni.ATTENTION, ni.QUERY, ni.COMPARE):
            a64 = f64_atraj[t]
            if float(a64.abs().max()) > 0:
                step["relu_flips"] = int(((k5_atraj[t] > 0) != (a64 > 0)).sum())
                step["relu_min_gap"] = float(a64[a64 > 0].min()) if bool((a64 > 0).any()) else None
        if kind == ni.SAME:
            a32, a64 = o32[:, 0], o64[:, 0]
            top = a64.topk(2).values
            step["argmax_32"], step["argmax_64"] = int(a32.argmax()), int(a64.argmax())
            step["argmax_gap_64"] = float(top[0] - top[1])
        if kind in (ni.AND, ni.OR) and saved64 is not None:
            d32, d64 = o32[:, 0] - saved32[:, 0], o64[:, 0] - saved64[:, 0]
            step["minmax_flips"] = int(((d32 > 0) != (d64 > 0)).sum())
            step["minmax_min_gap_64"] = float(d64.abs().min())
        if kind == ni.SCENE:
            saved32, saved64 = o32, o64
        steps.append(step)
    return steps


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
        raise RuntimeError("tools/k6_kinks.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda")
    vocab = make_clevr_like_vocabulary()
    spec = nmn.make_spec(vocab)
    tables = ni.build_tables(spec, dev)
    names = ni.DIFF_BANKS
    kind_names = ["nop", "scene", "and", "or", "attention", "query", "relate", "same", "compare"]
    summary = {"draws": args.draws, "rows": args.rows, "fail": {}, "draw": []}
    for draw in range(args.draws):
        gen = torch.Generator().manual_seed(draw)
        params = cast_params(nmn.init_nmn_params(gen, spec), torch.float32, dev)
        programs_np = sample_clevr_like_programs(vocab, args.rows, seed=draw)
        programs_np[-3:-1] = np.random.RandomState(draw).randint(
            0, vocab.get_vocab_size("programs"), (2, programs_np.shape[1]))
        programs_np[-1] = 0
        programs = torch.from_numpy(programs_np).to(dev)
        feats = torch.randn(args.rows, spec.height, spec.width, spec.feature_channels,
                            generator=gen).to(dev)
        with torch.no_grad():
            stem = nmn.apply_stem(params["stem"], feats).contiguous()
            banks = ni.build_banks(params, spec, torch.float32)
        banks64 = {k: v.double() for k, v in banks.items()}
        _, invalid, otraj, atraj = ni.execute_programs_train_kernel(banks, tables, spec, stem,
                                                                    programs)
        g = torch.randn(stem.shape, generator=gen).to(dev)
        ws = {}
        d_banks, d_stem = ni.interpreter_grads_kernel(banks, tables, spec, stem, programs,
                                                      invalid, g, otraj, atraj, workspace=ws)
        tight = ni.workspace_errors(ws, banks, tables, spec)
        p_banks, p_stem = ni.interpreter_grads_plain(banks, tables, spec, stem, programs, g)
        r_banks, r_stem, taken = ni.interpreter_grads_plain_by_row(
            banks, tables, spec, stem, programs, g, d_stem, K6_TOL)
        w_banks, w_stem = ni.interpreter_grads_plain(banks64, tables, spec, stem.double(),
                                                     programs, g.double())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b_banks, b_stem, _, branch = ni.interpreter_grads_on_branch(
            banks, tables, spec, stem, programs, g, invalid, otraj, atraj, ws)
        torch.cuda.synchronize()
        line = {
            "k6_vs_branch": worst(ratios(d_stem, d_banks, b_stem, b_banks, names)),
            "branch": branch, "branch_s": time.perf_counter() - t0,
            "k6_vs_f32": worst(ratios(d_stem, d_banks, p_stem, p_banks, names)),
            "k6_vs_by_row": worst(ratios(d_stem, d_banks, r_stem, r_banks, names)),
            "k6_vs_f64": worst(ratios(d_stem, d_banks, w_stem, w_banks, names)),
            "f32_vs_f64": worst(ratios(p_stem, p_banks, w_stem, w_banks, names)),
            "by_row_vs_f64": worst(ratios(r_stem, r_banks, w_stem, w_banks, names)),
            "workspace": [tight["weight_grad"], tight["input_grad"]],
            "by_row_taken": {str(r): v for r, v in taken.items()},
        }
        torch.cuda.synchronize()
        failed = [k for k in ("k6_vs_f32", "k6_vs_by_row", "k6_vs_f64", "f32_vs_f64",
                              "k6_vs_branch") if line[k][0] > 1.0]
        if max(line["workspace"]) > WS_TOL:
            failed.append("workspace")
        if branch["far"] or branch["entries"] or branch["rows"]:
            failed.append("branch_decisions")
        for name in failed:
            summary["fail"].setdefault(name, []).append(draw)
        print(f"[k6-kinks] draw {draw}: worst leaf error over its limit: K6 against float32 "
              f"{line['k6_vs_f32'][0]:.3f} ({line['k6_vs_f32'][1]}), by row "
              f"{line['k6_vs_by_row'][0]:.3f} ({line['k6_vs_by_row'][1]}), float64 "
              f"{line['k6_vs_f64'][0]:.3f} ({line['k6_vs_f64'][1]}); float32 plain against "
              f"float64 {line['f32_vs_f64'][0]:.3f} ({line['f32_vs_f64'][1]}); by row against "
              f"float64 {line['by_row_vs_f64'][0]:.3f}; K6 against the float64 branch "
              f"{line['k6_vs_branch'][0]:.3f} ({line['k6_vs_branch'][1]}; {branch}, "
              f"{line['branch_s']:.1f} s); workspace {tight['weight_grad']:.2e} / "
              f"{tight['input_grad']:.2e}; invalid {int(invalid.sum())}/{args.rows}", flush=True)
        if "k6_vs_branch" in failed or "branch_decisions" in failed:
            # The batch's scale per leaf, so a row's ratio reads as its share of
            # the batched check's limit.
            scales = {"stem": float(w_stem.abs().max())}
            scales.update({k: float(w_banks[k].abs().max()) for k in names})
            rows = []
            for r in range(args.rows):
                one = slice(r, r + 1)
                _, inv1, ot1, at1 = ni.execute_programs_train_kernel(banks, tables, spec,
                                                                     stem[one], programs[one])
                k_banks, k_stem = ni.interpreter_grads_kernel(banks, tables, spec, stem[one],
                                                              programs[one], inv1, g[one], ot1,
                                                              at1)
                f_banks, f_stem = ni.interpreter_grads_plain(banks64, tables, spec,
                                                             stem[one].double(), programs[one],
                                                             g[one].double())
                q_banks, q_stem = ni.interpreter_grads_plain(banks, tables, spec, stem[one],
                                                             programs[one], g[one])
                rk = ratios(k_stem, k_banks, f_stem, f_banks, names, scales)
                rq = ratios(q_stem, q_banks, f_stem, f_banks, names, scales)
                if max(max(rk.values()), max(rq.values())) <= 0.1:
                    continue
                _, _, fo, fa = ni.execute_programs_plain(banks64, tables, spec, stem[one].double(),
                                                         programs[one], record=True)
                tokens_rev = programs[r].flip(0).cpu()
                steps = forward_decisions(torch, ni, tables, tokens_rev, ot1[0], at1[0], fo[0],
                                          fa[0])
                for s in steps:
                    s["kind"] = kind_names[s["kind"]]
                row = {"row": r, "k6_vs_f64": worst(rk), "f32_vs_f64": worst(rq),
                       "k6_alone_vs_batched_stem": float((k_stem[0] - d_stem[r]).abs().max()),
                       "invalid": bool(inv1[0]),
                       "tokens": [vocab.get_token_from_index(int(t), "programs")
                                  for t in tokens_rev if int(t) != 0],
                       "steps": [s for s in steps if any(
                           k in s for k in ("relu_flips", "argmax_32", "minmax_flips"))
                           or s["register_err"] > 1e-5]}
                rows.append(row)
                print(f"[k6-kinks]   row {r}: K6 alone against float64 {row['k6_vs_f64'][0]:.3f} "
                      f"({row['k6_vs_f64'][1]}), float32 plain alone against float64 "
                      f"{row['f32_vs_f64'][0]:.3f} ({row['f32_vs_f64'][1]}); "
                      f"{json.dumps(row)}", flush=True)
            line["rows"] = rows
        summary["draw"].append(line)
    summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({k: summary[k] for k in ("draws", "rows", "fail", "device")}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
