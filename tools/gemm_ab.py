r"""The training GEMM (``csrc/gemm.cu``) in several checkouts of the repo, on
one card in one call, shape class by shape class:

    python3 tools/gemm_ab.py <checkout> [<checkout> ...] [--out FILE.json]

Each checkout must have ``probnmn_tpu_torch/ops/kernels/gemm.py`` (variants
of one source: unpack a copy under ``build/``, which git ignores, and edit
it). Each runs in its own process, which builds that checkout's kernels, in
turns (the list, then the list reversed). A process times ``gemm_cuda`` on
every shape class of one question_coding step and one program_prior step at
the shipped config (batch 256, D = H = 256, G = 1024, 2 layers; a
question_coding pass of 128 rows with S = 46 / T = 27 for the
ProgramGenerator and S = 27 / T = 46 for the QuestionReconstructor, one of
each supervised and one of each from z, T = 26 for the generator's
REINFORCE pass; 27 steps of 256 programs for the prior), on random operands
with the strides K3/K4 pass (20 calls in a CUDA graph, replayed between
CUDA events by this checkout's ``chip_smoke.graph_ms``: free of the host's
time to issue them), beside one
cuBLAS float32 call on the same views (TF32 off) and the class's bound
(2MNK / 67 TFLOP/s or its bytes / 3.35 TB/s, chip_smoke.py's peaks).
Prints each class's launches a step, times and bound, and each
checkout's total a step. Needs a CUDA card and the CUDA toolkit.
"""
import argparse
import json
import os
import subprocess
import sys

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def step_classes(rows=128):
    r"""{phase: {(M, N, K, (sam, sak), (sbk, sbn), split, bias): launches a step}}
    of a question_coding step (four K4 passes of ``rows`` rows and K3f on
    as many) and a program_prior step (K3f and K3b on 256 programs), with
    the strides and the scratch (split allowed) lm_train.cu, tf_train.cu,
    lstm_sweep.cuh and train_common.cuh pass."""
    D = H = 256
    G, L = 4 * H, 2
    out = {"question_coding": {}, "program_prior": {}}

    def add(phase, key, n=1):
        out[phase][key] = out[phase].get(key, 0) + n

    for B, S, T, Vt in ((rows, 46, 27, 44), (rows, 27, 46, 92), (rows, 46, 26, 44),
                        (rows, 27, 46, 92)):
        SB, TB = S * B, T * B
        qc = "question_coding"
        add(qc, (SB, G, D, (D, 1), (1, D), False, True), L)        # x . W_ih^T + b
        add(qc, (TB, G, D, (D, 1), (1, D), False, True))           # emb . W_ih[:, H:]^T + b
        add(qc, (TB, Vt, H, (H, 1), (1, H), False, True))          # logits
        add(qc, (TB, H, Vt, (Vt, 1), (H, 1), False, False))        # dh of the head
        add(qc, (Vt, H, TB, (1, Vt), (H, 1), True, False))         # d proj_w
        add(qc, (B, 2 * H, G, (G, 1), (2 * H, 1), True, False), T)  # the decoder's steps
        add(qc, (G, 2 * H, TB, (1, G), (2 * H, 1), True, False))   # d dec_w
        add(qc, (G, D, TB, (1, G), (D, 1), True, False))           # d dec_wx
        add(qc, (TB, D, G, (G, 1), (D, 1), False, False))          # e0
        add(qc, (G, D, SB, (1, G), (D, 1), True, False), L)        # d W_ih
        add(qc, (G, H, SB - B, (1, G), (H, 1), True, False), L)    # d W_hh
        add(qc, (SB, D, G, (G, 1), (D, 1), False, False), L)       # dx
    V = 44
    for phase, B, T, backward in (("question_coding", rows, 27, False),
                                  ("program_prior", 256, 27, True)):
        TB = T * B
        for _ in range(2 if backward else 1):  # K3f, and K3b's replay of it
            add(phase, (TB, G, D, (D, 1), (1, D), False, True), L)
            add(phase, (TB, D, H, (H, 1), (1, H), False, False))   # top . proj^T
            add(phase, (TB, V, D, (D, 1), (1, D), False, False))   # logits
        if backward:
            add(phase, (TB, D, V, (V, 1), (D, 1), False, False))   # dproj_out
            add(phase, (V, D, TB, (1, V), (D, 1), True, False))    # d emb
            add(phase, (D, H, TB, (1, D), (H, 1), True, False))    # d proj
            add(phase, (TB, H, D, (D, 1), (H, 1), False, False))   # e0
            add(phase, (G, D, TB, (1, G), (D, 1), True, False), L)  # d W_ih
            add(phase, (G, H, TB - B, (1, G), (H, 1), True, False), L)  # d W_hh
            add(phase, (TB, D, G, (G, 1), (D, 1), False, False), L)  # dx
    return out


RUN = r"""
import json, sys
import torch
tree, here = sys.argv[1], sys.argv[3]
classes = json.loads(sys.argv[2])
sys.path.insert(0, tree)
torch.backends.cuda.matmul.allow_tf32 = False
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.kernels.gemm import gemm_cuda
_build.library()
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)

def operand(rows, cols, strides):
    t = torch.empty_strided((rows, cols), strides, device=dev)
    t.copy_(torch.randn(rows, cols, generator=gen))
    return t

sys.path.insert(0, here)
from chip_smoke import graph_ms

def cuda_ms(fn):
    return graph_ms(torch, fn)

out = []
for M, N, K, sa, sb, split, bias in classes:
    a, b = operand(M, K, sa), operand(K, N, sb)
    c = torch.empty(M, N, device=dev)
    v = torch.randn(N, generator=gen).to(dev) if bias else None
    ms = cuda_ms(lambda: gemm_cuda(a, b, bias=v, out=c, split=split))
    if bias:
        lib = cuda_ms(lambda: torch.addmm(v, a, b, out=c))
    else:
        lib = cuda_ms(lambda: torch.mm(a, b, out=c))
    out.append({"ms": ms, "cublas_ms": lib})
print("RESULT " + json.dumps(out))
"""


def run(tree, classes):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", RUN, tree, json.dumps(classes), here], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], sep="\n", file=sys.stderr)
        raise RuntimeError(f"the run in {tree} failed with code {proc.returncode}")
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def bound_ms(M, N, K, bias):
    nbytes = 4 * (M * K + K * N + M * N + (N if bias else 0))
    return max(2.0 * M * N * K / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    per_phase = step_classes()
    keys = sorted({k for counts in per_phase.values() for k in counts},
                  key=lambda k: -k[0] * k[1] * k[2])
    classes = [[M, N, K, list(sa), list(sb), split, bias] for M, N, K, sa, sb, split, bias in keys]
    times = {t: [] for t in trees}
    for tree in trees + trees[::-1]:
        times[tree].append(run(tree, classes))
    rows = []
    for i, key in enumerate(keys):
        M, N, K, sa, sb, split, bias = key
        pattern = ("t" if sa[0] == 1 else "n") + ("n" if sb[1] == 1 else "t")
        row = {"M": M, "N": N, "K": K, "pattern": pattern, "split": split, "bias": bias,
               "launches": {p: per_phase[p].get(key, 0) for p in per_phase},
               "bound_ms": bound_ms(M, N, K, bias),
               "ms": {t: [r[i]["ms"] for r in times[t]] for t in trees},
               "cublas_ms": [r[i]["cublas_ms"] for t in trees for r in times[t]]}
        rows.append(row)
        print(f"[gemm-ab] {M}x{N}x{K} {pattern}{' split' if split else ''}"
              f"{' bias' if bias else ''} x{row['launches']}: bound {row['bound_ms']:.4f} ms, "
              + ", ".join(f"{os.path.basename(t)} {' / '.join(f'{x:.4f}' for x in row['ms'][t])}"
                          for t in trees)
              + f", cuBLAS {min(row['cublas_ms']):.4f}", flush=True)
    for phase in per_phase:
        def total(f):
            return sum(r["launches"][phase] * f(r) for r in rows)
        print(f"[gemm-ab] {phase} step, {total(lambda r: 1)} launches: bound "
              f"{total(lambda r: r['bound_ms']):.3f} ms, "
              + ", ".join(f"{os.path.basename(t)} "
                          + " / ".join(f"{total(lambda r, j=j: r['ms'][t][j]):.3f}"
                                       for j in range(2)) for t in trees)
              + f", cuBLAS {total(lambda r: min(r['cublas_ms'])):.3f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[gemm-ab] card {smi}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
