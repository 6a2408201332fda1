r"""K6 (the NMN interpreter's backward) and its replay mode K6r in two
checkouts of the repo, on one card in one call:

    python3 tools/k6_ab.py <other checkout> [--out DIR]

Unpack the other checkout first, e.g. ``git archive <commit> | tar -x -C
build/parent`` (git ignores ``build/``). Each checkout runs in its own
process, which builds that checkout's kernels, in turns (other, this, this,
other). Through the public API both trees share, each process

- makes chip_smoke.py's K6 batches at full NMN width (C = 128 on 14 x 14,
  1024 feature channels, random weights from a fixed seed): phase 8's, 120
  valid CLEVR programs and 8 token soups (B = 128), and phase 9's, 248 and 8
  (B = 256), with K5's residuals and a random cotangent, in bfloat16;
- times K6 over K5's residuals and K6r (replay mode) with CUDA events over
  10 calls each;
- splits each into parts under ``torch.profiler`` (3 calls) with this
  checkout's ``chip_smoke.k6_parts``: the sweep, the weight-gradient stage,
  the small banks' row sums and the glue, each in ms a call, with the
  partials' MB where the tree has a chunked weight gradient
  (``chip_smoke.weight_grad_memory``);
- saves dx, every bank gradient and the workspace's float32 dw3 / dwc of K6
  at both batches (and in float32 at B = 128) to a ``.npz``.

Prints every time and part, and the max |dev| of dx, dw3, dwc and the other
bank gradients between the checkouts' first runs (and between each
checkout's two runs), each beside its largest |value|; with ``--out DIR``
it writes every kernel's time a call to ``DIR/k6_ab.json``. Needs a CUDA
card and the CUDA toolkit.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

RUN = r"""
import importlib.util, json, sys
import numpy as np
import torch
tree, out_npz, smoke_path = sys.argv[1:4]
sys.path.insert(0, tree)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from probnmn_tpu_torch.models import nmn
from probnmn_tpu_torch.models.nmn import cast_params
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    DIFF_BANKS, build_banks, build_tables, execute_programs_train_kernel, interpreter_grads_kernel)
from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary, sample_clevr_like_programs

# This tree's chip_smoke.py: its timer and its split of K6 into parts, the same for both trees.
loader = importlib.util.spec_from_file_location("k6_ab_smoke", smoke_path)
smoke = importlib.util.module_from_spec(loader)
loader.loader.exec_module(smoke)

_build.library()
dev = torch.device("cuda")
vocab = make_clevr_like_vocabulary()
spec = nmn.make_spec(vocab)
gen = torch.Generator().manual_seed(0)
params = cast_params(nmn.init_nmn_params(gen, spec), torch.float32, dev)
tables = build_tables(spec, dev)


def batch(n, seed, soup_seed):
    programs = sample_clevr_like_programs(vocab, n, seed=seed)
    rs = np.random.RandomState(soup_seed)
    programs[-8:] = rs.randint(0, len(vocab.get_index_to_token_vocabulary("programs")),
                               (8, programs.shape[1]))
    programs[-1] = 0
    programs[-2, :] = 0
    programs[-2, :2] = [vocab.get_token_index("count", "programs"),
                        vocab.get_token_index("filter_color[red]", "programs")]
    return torch.from_numpy(programs).to(dev)


result, arrays = {}, {}
for B, seed, soup, dtypes in ((128, 12, 14, (torch.bfloat16, torch.float32)),
                              (256, 16, 18, (torch.bfloat16,))):
    programs = batch(B, seed, soup)
    feats = torch.randn(B, spec.height, spec.width, spec.feature_channels, generator=gen).to(dev)
    for dtype in dtypes:
        name = f"B{B}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
        stem = nmn.apply_stem(cast_params(params["stem"], dtype), feats.to(dtype)).contiguous()
        banks = build_banks(params, spec, dtype)
        final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
        g = torch.randn(final.shape, generator=gen).to(dev).to(dtype).float()
        ws = {}
        d_banks, d_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                                   otraj, atraj, workspace=ws)
        torch.cuda.synchronize()
        arrays[f"{name}.dx"] = d_stem.float().cpu().numpy()
        arrays[f"{name}.dw3"] = ws["dw3"].cpu().numpy()
        arrays[f"{name}.dwc"] = ws["dwc"].cpu().numpy()
        for k in DIFF_BANKS:
            arrays[f"{name}.bank_{k}"] = d_banks[k].float().cpu().numpy()
        if dtype != torch.bfloat16:
            continue
        k6 = lambda: interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g, otraj, atraj)
        k6r = lambda: interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g)
        try:
            chunk, partial = smoke.weight_grad_memory(ws, spec.module_channels)
        except ImportError:  # a tree from before the chunked weight gradient: no partials
            chunk, partial = None, 0
        entry = {"valid_rows": int((~invalid).sum()), "entries": int((ws["tag"] < ws["dw3"].shape[0]
                 + 2 * ws["dwc"].shape[0]).sum()), "partial_mb": partial / 1e6, "chunk": chunk}
        for mode, fn in (("k6", k6), ("k6r", k6r)):
            entry[f"{mode}_ms"] = smoke.cuda_ms(torch, fn, iters=10)
            entry[f"{mode}_parts_ms"], entry[f"{mode}_kernels"] = smoke.k6_parts(torch, fn)
        result[name] = entry
        del otraj, atraj
np.savez(out_npz, **arrays)
print("RESULT " + json.dumps(result))
"""


def run(tree, npz, smoke_path):
    out = subprocess.run([sys.executable, "-c", RUN, tree, npz, smoke_path], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-8000:], sep="\n", file=sys.stderr)
        raise RuntimeError(f"the run in {tree} failed with code {out.returncode}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def max_dev(a, b):
    r"""Per array: (max |a - b|, max |b|)."""
    import numpy as np

    return {k: (float(np.abs(a[k] - b[k]).max()), float(np.abs(b[k]).max())) for k in sorted(b.files)}


def main(argv):
    import numpy as np

    other = os.path.abspath(argv[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tempfile.mkdtemp(prefix="k6_ab_")
    results = {"other": [], "this": []}
    for name, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        res = run(tree, os.path.join(tmp, f"{name}{len(results[name])}.npz"),
                  os.path.join(here, "chip_smoke.py"))
        results[name].append(res)
        for cell, v in res.items():
            fmt = lambda p: ", ".join(f"{k} {x:.4f}" for k, x in p.items())  # noqa: E731
            print(f"[k6-ab] {name} {cell}: {v['valid_rows']} valid rows, {v['entries']} workspace "
                  f"entries; K6 {v['k6_ms']:.4f} ms (parts: {fmt(v['k6_parts_ms'])}); K6r "
                  f"{v['k6r_ms']:.4f} ms (parts: {fmt(v['k6r_parts_ms'])}); partials "
                  f"{v['partial_mb']:.1f} MB, chunk {v['chunk']}", flush=True)
    arrays = {k: np.load(os.path.join(tmp, f"{k}.npz")) for k in ("other0", "other1", "this0", "this1")}
    for a, b, what in (("this0", "other0", "this vs other"), ("this0", "this1", "this, run 1 vs 2"),
                       ("other0", "other1", "other, run 1 vs 2")):
        devs = max_dev(arrays[a], arrays[b])
        print(f"[k6-ab] max |dev| (max |value|), {what}: " + ", ".join(
            f"{k} {d:.3e} ({m:.3e})" for k, (d, m) in devs.items()), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[k6-ab] card {smi}")
    if argv[1:2] == ["--out"]:  # every kernel's time and launches a call, per tree and run
        os.makedirs(argv[2], exist_ok=True)
        with open(os.path.join(argv[2], "k6_ab.json"), "w") as out:
            json.dump({"card": smi, "results": results}, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
