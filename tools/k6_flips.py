r"""Phase 8's float32 K6 check (chip_smoke.py) on the input that once failed
it, with what explains the failure:

    python3 tools/k6_flips.py
    python3 tools/k6_flips.py --regenerate DIR

An earlier chip_smoke.py drew phase 5's cuDNN yardstick input, (256, 46,
256), from the shared generator ``gen`` too, which moved every later draw,
and its phase 8 failed: K6's float32 ``w3`` stood 5.20e-3 off autograd
through the batched plain machine, against a limit of 4.57e-3.
``--regenerate DIR`` runs chip_smoke.py's phases 1-7 as they are, then takes
one draw of that shape from ``gen`` at the start of phase 8, which puts
``gen`` where that run had it (a Mersenne twister's state follows from the
count of its draws alone), makes phase 8's scripted generator's draw, and
writes ``gen``'s state before the feature draw to
``DIR/phase8_k6_gen_state.npy``; tests/data holds a copy. Without it the
tool starts from that copy. Then, as phase 8 does at B = 128 in float32 (its
programs, the module_training trainer's NMN parameters, the features and
the cotangent from ``gen``), it prints:

- each leaf's error against ``interpreter_grads_plain`` (autograd through
  the batched plain machine, phase 8's first reference) and against
  ``interpreter_grads_plain_by_row`` (its second; phase 8 now holds float32
  K6 to ``interpreter_grads_on_branch``, see ``tools/k6_kinks.py``), beside
  its limit K6_TOL * max(1, max |g|);
- which rows carry the difference: K6 on a group of rows against the
  batched plain version under a cotangent zeroed off the group, groups of 8,
  then each row of a group above a fifth of a limit;
- for each such row, every 3x3 conv output whose ReLU input takes another
  sign in the batched plain forward than in K5's (relate's chains, which K5
  keeps no residual of, read from the inputs K6's recompute wrote to its
  workspace): the batched plain forward's ReLU input, K5's output, the ReLU
  input recomputed in float64 from K5's own layer input, and the float32
  rounding scale of that sum (2**-24 of its sum of |products|).

Needs a CUDA card; about a minute, or phases 1-7's time more with
``--regenerate``.
"""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = os.path.join(HERE, "tests", "data", "phase8_k6_gen_state.npy")


class _Done(Exception):
    pass


def phase8_input(np, torch, dev, vocab, state, config_dir):
    r"""Phase 8's float32 K5 / K6 batch from ``gen``'s state before its
    feature draw: (spec, tables, banks, stem, programs, g) on ``dev``, the
    NMN parameters as the module_training trainer makes them."""
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import build_banks, build_tables
    from probnmn_tpu_torch.utils.clevr import sample_clevr_like_programs

    vocab.save_to_files(os.path.join(config_dir, "vocab"))
    cfg = Config(os.path.join(HERE, "configs", "module_training.yml"),
                 ["DATA.VOCABULARY", os.path.join(config_dir, "vocab")])
    spec = nmn.make_spec(vocab, cfg)
    batch = cfg.OPTIM.BATCH_SIZE
    params = cast_params(nmn.init_nmn_params(torch.Generator().manual_seed(cfg.RANDOM_SEED), spec),
                         torch.float32, dev)
    programs = sample_clevr_like_programs(vocab, batch, seed=12)
    rs = np.random.RandomState(14)
    programs[-8:] = rs.randint(0, len(vocab.get_index_to_token_vocabulary("programs")),
                               (8, programs.shape[1]))
    programs[-1] = 0
    programs[-2, :] = 0
    programs[-2, :2] = [vocab.get_token_index("count", "programs"),
                        vocab.get_token_index("filter_color[red]", "programs")]
    gen = torch.Generator()
    gen.set_state(state)
    feats = torch.randn(batch, spec.height, spec.width, spec.feature_channels, generator=gen)
    stem = nmn.apply_stem(params["stem"], feats.to(dev)).contiguous()
    g = torch.randn(batch, spec.height, spec.width, spec.module_channels, generator=gen).to(dev)
    return (spec, build_tables(spec, dev), build_banks(params, spec, torch.float32), stem,
            torch.from_numpy(programs).to(dev), g)


def step_groups(tables, programs):
    r"""Per step t of the batched plain machine (``execute_programs_plain``),
    the rows it runs relate's chain for, the rows it runs another chain for
    and the rows it runs compare's two convs for, each in row order: the
    order of its ``gathered_conv3x3`` calls (5, 2 and 2 a step)."""
    kind = tables["kind"].cpu().numpy()
    head = tables["head_slot"].cpu().numpy()
    rev = programs[:, ::-1]
    out_tag, saved_tag, stopped = [2] * len(rev), [0] * len(rev), [False] * len(rev)
    groups = []
    for t in range(rev.shape[1]):
        rel, other, cmp = [], [], []
        for b in range(len(rev)):
            if stopped[b]:
                continue
            k, o, s = kind[rev[b, t]], out_tag[b], saved_tag[b]
            if k == 1:  # scene
                out_tag[b], saved_tag[b] = 1, o
            elif k in (2, 3):  # and / or
                stopped[b] = s == 0
                out_tag[b] = 1 if o == 1 and s == 1 else 2
            elif k in (4, 5, 6):  # attention / query / relate
                stopped[b] = o != 1
                if o == 1:
                    (rel if k == 6 else other).append(b)
                    out_tag[b] = 1 if head[rev[b, t]] >= 0 else 2
            elif k == 8:  # compare
                stopped[b] = o != 2 or s != 2
                if not stopped[b]:
                    cmp.append(b)
            elif k == 7:  # same
                stopped[b] = o != 1
        groups.append((rel, other, cmp))
    return groups


def relu_inputs(torch, banks, tables, spec, stem, programs):
    r"""Every 3x3 conv output before its ReLU (the ReLU's input) in the
    batched plain forward: {(row, step, layer): (H, W, C)}."""
    from probnmn_tpu_torch.ops import gconv
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import execute_programs_plain

    calls = []
    conv = gconv.gathered_conv3x3

    def record(x, bank, idx, dilation=1):
        out = conv(x, bank, idx, dilation)
        calls.append(out.detach())
        return out

    gconv.gathered_conv3x3 = record
    try:
        execute_programs_plain(banks, tables, spec, stem, programs)
    finally:
        gconv.gathered_conv3x3 = conv
    pre, k = {}, 0
    for t, (rel, other, cmp) in enumerate(step_groups(tables, programs.cpu().numpy())):
        for rows, layers in ((rel, 5), (other, 2), (cmp, 2)):
            if rows:
                for layer in range(layers):
                    for i, b in enumerate(rows):
                        pre[(b, t, layer)] = calls[k][i]
                    k += 1
    assert k == len(calls), (k, len(calls))
    return pre


def k5_layers(tables, spec, programs, ws, atraj):
    r"""One valid row's conv inputs on K5's device code, {(step, layer): (H,
    W, C)} in float64, from the workspace K6 (at B = 1) wrote: its sweep
    walks the steps in reverse and each chain's convs from the last, one
    entry a conv, then compare's two projection entries; and K5's residual
    for the output of a two-conv chain's second conv, as (step, 2)."""
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import ATTENTION, COMPARE, QUERY, RELATE

    h, w, c = spec.height, spec.width, spec.module_channels
    rev = programs[0].flip(0).tolist()
    start = next((t for t, tok in enumerate(rev) if tok != 0), len(rev))
    inputs, e = {}, 0
    for t in range(len(rev) - 1, start - 1, -1):
        kind = int(tables["kind"][rev[t]])
        layers = 5 if kind == RELATE else 2 if kind in (ATTENTION, QUERY, COMPARE) else 0
        for layer in range(layers - 1, -1, -1):
            inputs[(t, layer)] = ws["inp"][e].reshape(h, w, c).double()
            e += 1
        if kind == COMPARE:
            e += 2
        if layers == 2:
            inputs[(t, 2)] = atraj[0, t, 1].reshape(h, w, c).double()
    return inputs


def relu_inputs_64(torch, banks, tables, spec, inp, tok, layer, d):
    r"""(z, scale), both (H, W, C): the ReLU inputs of conv ``layer`` of
    token ``tok``'s chain at dilation d over ``inp`` (H, W, C) in float64,
    and each one's sum of |products| over its taps and channels plus |bias|."""
    import torch.nn.functional as F

    c = spec.module_channels
    slot = int(tables["slot3"][tok, layer])
    w = banks["w3"][slot].double().reshape(3, 3, c, c).permute(3, 2, 0, 1)  # (C_out, C_in, ky, kx)
    b = banks["b3"][slot].double()
    x = inp.permute(2, 0, 1)[None]
    z = F.conv2d(x, w, padding=d, dilation=d)[0].permute(1, 2, 0) + b
    scale = F.conv2d(x.abs(), w.abs(), padding=d, dilation=d)[0].permute(1, 2, 0) + b.abs()
    return z, scale


def analyse(np, torch, dev, vocab, smi, state):
    import tempfile

    import chip_smoke
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        DIFF_BANKS, RELATE, RELATE_DILATIONS, execute_programs_train_kernel,
        interpreter_grads_kernel, interpreter_grads_plain, interpreter_grads_plain_by_row,
    )

    log = chip_smoke.log
    spec, tables, banks, stem, programs, g = phase8_input(np, torch, dev, vocab, state,
                                                          tempfile.mkdtemp(prefix="k6_flips_"))
    batch = len(programs)
    final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
    d_banks, d_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                               otraj, atraj)
    tol = chip_smoke.K6_TOL["float32"]
    w_banks, w_stem = interpreter_grads_plain(banks, tables, spec, stem, programs, g)
    r_banks, r_stem, alone = interpreter_grads_plain_by_row(banks, tables, spec, stem, programs, g,
                                                            d_stem, tol)
    limit = {"stem": tol * max(1.0, float(w_stem.abs().max()))}
    limit.update({k: tol * max(1.0, float(w_banks[k].abs().max())) for k in DIFF_BANKS})

    def errors(got_banks, got_stem, ref_banks, ref_stem):
        out = {"stem": float((got_stem - ref_stem).abs().max())}
        out.update({k: float((got_banks[k] - ref_banks[k]).abs().max()) for k in DIFF_BANKS})
        return out

    for what, ref_banks, ref_stem in (("batched plain", w_banks, w_stem),
                                      ("plain by row", r_banks, r_stem)):
        err = errors(d_banks, d_stem, ref_banks, ref_stem)
        log(f"[k6-flips] K6 float32 against the {what} version (max |err| / limit): " + ", ".join(
            f"{k} {e:.3e}/{limit[k]:.3e}" + ("" if e <= limit[k] else " FAIL") for k, e in err.items()))
    log(f"[k6-flips] rows the by-row version takes alone, with their flipped ReLU outputs: "
        f"{alone or 'none'}")

    def share(rows):  # K6 on these rows against their share of the batched plain gradients
        sub = torch.tensor(rows, device=dev)
        masked = torch.zeros_like(g)
        masked[sub] = g[sub]
        ref_banks, ref_stem = interpreter_grads_plain(banks, tables, spec, stem, programs, masked)
        got_banks, got_stem = interpreter_grads_kernel(banks, tables, spec, stem[sub], programs[sub],
                                                       invalid[sub], g[sub], otraj[sub], atraj[sub])
        err = errors(got_banks, got_stem, ref_banks, ref_stem[sub])
        return max(err[k] / limit[k] for k in err), max(err, key=lambda k: err[k] / limit[k])

    culprits = []
    for first in range(0, batch, 8):
        ratio, leaf = share(list(range(first, first + 8)))
        if ratio > 0.2:
            log(f"[k6-flips] rows {first}-{first + 7}: {ratio:.3f} of {leaf}'s limit")
            for row in range(first, first + 8):
                r_ratio, r_leaf = share([row])
                if r_ratio > 0.2:
                    culprits.append(row)
                    log(f"[k6-flips]   row {row}: {r_ratio:.3f} of {r_leaf}'s limit")
    log(f"[k6-flips] rows carrying the difference (over a fifth of a limit alone): "
        f"{culprits or 'none'}")
    ratio = ((d_stem - w_stem).abs().reshape(batch, -1).amax(1) / limit["stem"]).cpu()
    top = ratio.argsort(descending=True)[:8].tolist()
    log("[k6-flips] d(stem) error over its limit, largest rows: "
        + ", ".join(f"{r} {float(ratio[r]):.3e}" for r in top)
        + f"; median {float(ratio.median()):.3e}")
    for row in sorted(set(culprits) | set(range(8))):
        one = slice(row, row + 1)
        a_banks, a_stem = interpreter_grads_plain(banks, tables, spec, stem[one], programs[one], g[one])
        k_banks, k_stem = interpreter_grads_kernel(banks, tables, spec, stem[one], programs[one],
                                                   invalid[one], g[one], otraj[one], atraj[one])
        err = errors(k_banks, k_stem, a_banks, a_stem)
        worst = max(err, key=lambda k: err[k] / limit[k])
        log(f"[k6-flips] row {row} alone: K6 against the plain version on the row alone, "
            f"{err[worst] / limit[worst]:.3e} of {worst}'s limit")

    batched = relu_inputs(torch, banks, tables, spec, stem, programs)
    for row in culprits:
        one = slice(row, row + 1)
        ws = {}
        interpreter_grads_kernel(banks, tables, spec, stem[one], programs[one], invalid[one], g[one],
                                 otraj[one], atraj[one], workspace=ws)
        k5 = k5_layers(tables, spec, programs[one].cpu(), ws, atraj[one])
        rev = programs[row].flip(0).tolist()
        flips = 0
        for (b, t, layer), pre in sorted(batched.items()):
            if b != row:
                continue
            relate = int(tables["kind"][rev[t]]) == RELATE
            d = RELATE_DILATIONS[layer] if relate else 1
            nxt = k5.get((t, layer + 1))  # K5's output of this conv, where a residual holds it
            z, scale = relu_inputs_64(torch, banks, tables, spec, k5[(t, layer)].to(dev), rev[t],
                                      layer, d)
            # relate's last conv keeps no output: its side is the float64 sum's
            side = z > 0 if nxt is None else nxt.to(dev) > 0
            for y, x, ch in torch.nonzero((pre > 0) != side).tolist():
                flips += 1
                log(f"[k6-flips]   row {row} step {t} {'relate' if relate else 'two-conv'} conv "
                    f"{layer} pixel {y * spec.width + x} channel {ch}: ReLU input batched plain "
                    f"{float(pre[y, x, ch]):.3e}, K5's output "
                    f"{'not kept' if nxt is None else format(float(nxt[y, x, ch]), '.3e')}, "
                    f"float64 from K5's input {float(z[y, x, ch]):.3e}, float32 rounding scale "
                    f"{float(scale[y, x, ch]) * 2.0 ** -24:.3e}")
        log(f"[k6-flips] row {row}: {flips} ReLU outputs on the other side of 0 in the batched "
            f"plain forward than in K5's")
    log(f"[k6-flips] card {smi}")


def regenerate(out_dir):
    r"""Phases 1-7 of chip_smoke.py, then ``gen``'s state before phase 8's
    feature draw, as the earlier run had it, to ``out_dir``."""
    sys.path.insert(0, HERE)
    import chip_smoke

    def phase8(np, torch, dev, gen, vocab, smi, qc_ckpt, mt_out):
        import tempfile

        from probnmn_tpu_torch.config import Config
        from probnmn_tpu_torch.models import program_generator

        torch.randn(256, 46, 256, generator=gen)  # the draw the earlier phase 5 took from gen
        work = tempfile.mkdtemp(prefix="k6_flips_")
        vocab.save_to_files(os.path.join(work, "vocab"))
        cfg = Config(os.path.join(HERE, "configs", "module_training.yml"),
                     ["DATA.VOCABULARY", os.path.join(work, "vocab")])
        program_generator.init_params(gen, program_generator.make_spec(vocab, cfg))  # scripted
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "phase8_k6_gen_state.npy"), gen.get_state().numpy())
        raise _Done()

    chip_smoke.train_module_training = phase8
    try:
        chip_smoke.main()
    except _Done:
        return 0
    return 1


def main(argv):
    if argv[:1] == ["--regenerate"]:
        return regenerate(argv[1])
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke
    from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary

    if not torch.cuda.is_available():
        print("k6_flips: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    analyse(np, torch, torch.device("cuda"), make_clevr_like_vocabulary(),
            chip_smoke.nvidia_smi_line(), torch.from_numpy(np.load(STATE)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
