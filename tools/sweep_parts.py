r"""Where a step of the forward LSTM layer sweep (``lstm_fwd_sweep``,
``probnmn_tpu_torch/csrc/lstm_sweep.cuh``) spends its time, on one card in
one call:

    python3 tools/sweep_parts.py

Copies this checkout's package into ``build/sweep_parts/<variant>`` (git
ignores ``build/``), edits each copy's sources, and builds the copies at
once:

- ``full``: the sources as they are;
- ``no_product``: the sweep skips h . W_hh^T (the cell, the stores, the
  DSMEM push and the cluster barrier remain);
- ``no_exchange``: each CTA writes its h into its own buffer only and meets
  no cluster barrier (the product reads stale peers' h);
- ``other_contraction``: the cell update ``f * c_prev + i * g`` fused the
  other way, ``fma(f, c_prev, i * g)`` in place of ``fma(i, g, f * c_prev)``.

Each copy runs in its own process: a K4f pass (``tf_forward_cuda``, lean) at
B = 128 and 256 over sources of S = 46, 27 and 8 steps, five times each
under ``torch.profiler``; prints each sweep launch's mean device time and
time = a + b * S fitted to S = 46 and 27. Then K3f's and K4f's losses at
full width, each variant's max |dev| from ``full``'s (only ``full`` and
``other_contraction`` compute the same function). The edited copies are
for measuring only. Needs a CUDA card and the CUDA toolkit.
"""
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = "csrc/lstm_sweep.cuh"
CELL = "csrc/lstm.cuh"
PRODUCT = "      if (owner) {\n#pragma unroll 2\n        for (int k = 0; k < depth; k += 4) {"
PUSH = ("          for (int p = 0; p < n; ++p) *cluster.map_shared_rank(slot + r[i] * hs, p) = "
        "h_state[i];\n      asm volatile(\"barrier.cluster.arrive;\\n\" ::: \"memory\");")
WAIT = "      asm volatile(\"barrier.cluster.wait;\\n\" ::: \"memory\");"
FUSED = "  const float c_new = __fmaf_rn(a.i, a.g, __fmul_rn(a.f, c_prev));"
EDITS = {
    "full": [],
    "no_product": [(SWEEP, PRODUCT, PRODUCT.replace("if (owner)", "if (owner && T < 0)"))],
    "no_exchange": [(SWEEP, PUSH, "          slot[r[i] * hs] = h_state[i];"), (SWEEP, WAIT, "")],
    "other_contraction": [(CELL, FUSED, FUSED.replace("__fmaf_rn(a.i, a.g, __fmul_rn(a.f, c_prev))",
                                                      "__fmaf_rn(a.f, c_prev, __fmul_rn(a.i, a.g))"))],
}

RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from probnmn_tpu_torch.models import program_prior
from probnmn_tpu_torch.models.seq2seq import Seq2SeqSpec, init_seq2seq_params
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    lm_forward_cuda, pack_lm_weights, pack_tf_weights, param_leaves, params_from_leaves,
    tf_forward_cuda, tf_param_leaves, tf_params_from_leaves)

dev = torch.device("cuda")
spec = Seq2SeqSpec(source_vocab_size=92, target_vocab_size=44, input_size=256, hidden_size=256,
                   num_layers=2)
params = init_seq2seq_params(torch.Generator().manual_seed(2), spec)
params = tf_params_from_leaves([p.to(dev) for p in tf_param_leaves(params)])
packed = pack_tf_weights(params, spec)
rs = np.random.RandomState(0)
result = {"us": {}}
for batch in (128, 256):
    for steps in (46, 27, 8):
        src = torch.from_numpy(rs.randint(4, 92, (batch, steps - 1))).to(dev)
        tgt = torch.from_numpy(rs.randint(4, 44, (batch, 5))).to(dev)
        for _ in range(3):
            tf_forward_cuda(packed, spec, src, tgt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                tf_forward_cuda(packed, spec, src, tgt)
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "lstm_fwd_sweep" in e.name]
        result["us"][f"{batch}/{steps}"] = sum(us) / len(us)
lm_spec = program_prior.ProgramPriorSpec(vocab_size=44, input_size=256, hidden_size=256,
                                         num_layers=2)
prior = program_prior.init_program_prior_params(torch.Generator().manual_seed(1), lm_spec)
prior = params_from_leaves([p.to(dev) for p in param_leaves(prior)])
tok = rs.randint(4, 44, (256, 26)) * (np.arange(26)[None] < rs.randint(1, 27, (256, 1)))
src = rs.randint(4, 92, (128, 45)) * (np.arange(45)[None] < rs.randint(1, 46, (128, 1)))
tgt = rs.randint(4, 44, (128, 26)) * (np.arange(26)[None] < rs.randint(1, 27, (128, 1)))
result["k3f"] = lm_forward_cuda(pack_lm_weights(prior), lm_spec,
                                torch.from_numpy(tok).to(dev)).tolist()
result["k4f"] = tf_forward_cuda(packed, spec, torch.from_numpy(src).to(dev),
                                torch.from_numpy(tgt).to(dev)).tolist()
print("RESULT " + json.dumps(result))
"""


def make_copy(name):
    root = os.path.join(HERE, "build", "sweep_parts", name)
    pkg = os.path.join(root, "probnmn_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "probnmn_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in EDITS[name]:
        path = os.path.join(pkg, rel)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"{name}: {rel} no longer holds the code this variant edits")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def main():
    roots = {name: make_copy(name) for name in EDITS}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from probnmn_tpu_torch.ops.kernels import _build; _build.library()")
    procs = [subprocess.Popen([sys.executable, "-c", build, root]) for root in roots.values()]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a variant failed to build")
    results = {}
    for name, root in roots.items():
        out = subprocess.run([sys.executable, "-c", RUN, root], capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {name} run failed with code {out.returncode}")
        line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
        results[name] = res = json.loads(line[len("RESULT "):])
        for batch in (128, 256):
            t46, t27 = res["us"][f"{batch}/46"], res["us"][f"{batch}/27"]
            b = (t46 - t27) / 19
            times = ", ".join(f"S={s} {res['us'][f'{batch}/{s}']:.1f}" for s in (46, 27, 8))
            print(f"[sweep-parts] {name} B={batch}: µs a sweep {times}; a = {t27 - 27 * b:.2f} µs, "
                  f"b = {b:.3f} µs a step", flush=True)
    full = results["full"]
    for name, res in results.items():
        devs = {k: max(abs(x - y) for x, y in zip(res[k], full[k])) for k in ("k3f", "k4f")}
        print(f"[sweep-parts] {name}: losses' max |dev| from full's: K3f {devs['k3f']:.3e}, "
              f"K4f {devs['k4f']:.3e}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[sweep-parts] card {smi}")
    shutil.rmtree(os.path.join(HERE, "build", "sweep_parts"), ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
