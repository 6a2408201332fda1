r"""Where a step of K1's decoder (``seq2seq_sample_kernel``) spends its time,
phase by phase, on one card:

    python3 tools/k1_phases.py [--out FILE]

The profiler sees the decoder as one launch. This tool copies the package
into ``build/k1_phases/`` (git ignores ``build/``), adds ``clock64`` stamps
to the copy's kernel (thread 0 of each CTA of the first cluster writes one
at each phase boundary of every step into a ``__device__`` array, which a C
entry added to the copy reads back), builds the copy and runs K1 at
chip_smoke.py's full ProgramGenerator width (B = 256 and 128, both dtypes,
Philox noise). It prints, for the first and the last CTA of the cluster,
the prologue's cycles and each phase's mean cycles over steps 5-24:

- bf16 ``h-mma``: h_{t-1} . W_hh on the tensor cores, before barrier A;
- ``proj+scores``: step t-1's logits and Gumbel noise, step t's scores;
- ``draw+softmax``: step t-1's draw and loss terms, the masked softmax;
- ``context``: the owned rows' context (and float32's embedding);
- ``x push``: the cell inputs into the cluster's other CTAs;
- ``barrier A``, ``products+cell``, ``h push``, ``barrier B`` (float32's
  ``products+cell`` includes its third barrier).

The stamps add a ``__syncthreads`` after the h-mma and after the context,
so the phases sum to a little more than an uninstrumented step. The copy is
made by text substitution at anchors of ``csrc/seq2seq_decode.cu``; an
anchor that is gone raises. Needs a CUDA card and the CUDA toolkit.
"""
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(HERE, "build", "k1_phases")

# (anchor, replacement) pairs; each anchor must occur exactly once.
STAMPS = [
    ("constexpr float kNegInf = -1e9f;\n",
     "constexpr float kNegInf = -1e9f;\n__device__ long long g_stamps[16 * 32 * 16];\n"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const int g = lane >> 2, tq = lane & 3;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const int g = lane >> 2, tq = lane & 3;\n"
     "  auto stamp = [&](int t, int ph) {\n"
     "    if (blockIdx.x < n && tid == 0 && t < 32) g_stamps[(blockIdx.x * 32 + t) * 16 + ph] = clock64();\n"
     "  };\n  stamp(31, 0);\n"),
    ("  cluster.sync();  // every CTA of the cluster runs, its buffers set, before any push into them\n",
     "  cluster.sync();  // every CTA of the cluster runs, its buffers set, before any push into them\n"
     "  stamp(31, 1);\n"),
    ("  for (int t = 0; t <= a.T; ++t) {\n", "  for (int t = 0; t <= a.T; ++t) {\n    stamp(t, 0);\n"),
    ("                         j0, warp * NT, H, lane);\n      }\n    }\n",
     "                         j0, warp * NT, H, lane);\n      }\n    }\n    __syncthreads();\n    stamp(t, 11);\n"),
    ("    __syncthreads();\n    // 2. Warp o:", "    __syncthreads();\n    stamp(t, 1);\n    // 2. Warp o:"),
    ("    __syncthreads();\n    if (t == a.T) break;", "    __syncthreads();\n    stamp(t, 2);\n    if (t == a.T) break;"),
    ("    if constexpr (!kBf) {\n      for (int e = tid; e < own * D;",
     "    __syncthreads();\n    stamp(t, 10);\n    if constexpr (!kBf) {\n      for (int e = tid; e < own * D;"),
    ("    cluster_arrive();\n    cluster_wait();\n\n    // 4. The gates",
     "    stamp(t, 3);\n    cluster_arrive();\n    cluster_wait();\n    stamp(t, 4);\n\n    // 4. The gates"),
    ("    __syncthreads();\n    const int hpieces", "    stamp(t, 9);\n    __syncthreads();\n    const int hpieces"),
    ("    cluster_arrive();\n    cluster_wait();\n  }\n  if (tid < own && live(tid))",
     "    stamp(t, 5);\n    cluster_arrive();\n    cluster_wait();\n    stamp(t, 6);\n  }\n  if (tid < own && live(tid))"),
]
READER = '''
extern "C" int probnmn_k1_stamps(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * 16 * 32 * 16));
}
'''
PHASES = ("h-mma", "proj+scores", "draw+softmax", "context", "x push", "barrier A",
          "products+cell", "h push", "barrier B")
ORDER = (0, 11, 1, 2, 10, 3, 4, 9, 5, 6)  # stamp slots in step order

RUN = r"""
import ctypes, json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.kernels import seq2seq_decode as sd
from probnmn_tpu_torch.models import program_generator
from probnmn_tpu_torch.models.nmn import cast_params
from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH, make_clevr_like_vocabulary
import chip_smoke as smoke
lib = _build.library()
lib.probnmn_k1_stamps.argtypes = [ctypes.c_void_p]
order, phases = json.loads(sys.argv[3]), json.loads(sys.argv[4])
vocab = make_clevr_like_vocabulary()
spec = program_generator.make_spec(vocab)
dev = torch.device("cuda")
pg = cast_params(program_generator.init_params(torch.Generator().manual_seed(0), spec),
                 torch.float32, dev)
q = torch.from_numpy(smoke.random_questions(np, vocab, 256, MAX_QUESTION_LENGTH, seed=1)).to(dev)
out = {}
for dtype, dn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
    packed = sd.pack_weights(pg, spec, dtype, dev)
    for B in (256, 128):
        for _ in range(3):
            sd.fused_sampling_forward(pg, spec, q[:B], seed=3, compute_dtype=dtype, packed=packed)
        torch.cuda.synchronize()
        buf = np.zeros(16 * 32 * 16, np.int64)
        assert lib.probnmn_k1_stamps(buf.ctypes.data) == 0
        st = buf.reshape(16, 32, 16)
        plan = sd.decoder_plan(B, q.shape[1], spec.input_size, spec.hidden_size,
                               spec.target_vocab_size, dtype)
        for cta in (0, plan["cluster"] - 1):
            steps = st[cta, 5:25][:, order].astype(np.float64)
            parts = np.diff(steps, axis=1).mean(0)
            row = {"prologue": int(st[cta, 31, 1] - st[cta, 31, 0]),
                   "step": float((st[cta, 25, 0] - st[cta, 5, 0]) / 20),
                   "phases": dict(zip(phases, parts.tolist())),
                   "rows_owned": -(-(plan["rows"] - cta) // plan["cluster"])}
            out[f"{dn} B={B} cta {cta}"] = row
            print(f"[k1-phases] {dn} B={B} cta {cta} ({row['rows_owned']} rows): prologue "
                  f"{row['prologue']} cycles, step {row['step']:.0f}; "
                  + ", ".join(f"{k} {v:.0f}" for k, v in row["phases"].items()), flush=True)
print("RESULT " + json.dumps(out))
"""


def make_copy():
    r"""The package copied under build/k1_phases/ with the stamps added."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "probnmn_tpu_torch"),
                    os.path.join(COPY, "probnmn_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(COPY, "probnmn_tpu_torch", "csrc", "seq2seq_decode.cu")
    with open(path) as f:
        src = f.read()
    for anchor, replacement in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor found {src.count(anchor)} times: {anchor[:60]!r}")
        src = src.replace(anchor, replacement)
    with open(path, "w") as f:
        f.write(src + READER)


def main(argv):
    make_copy()
    out = subprocess.run([sys.executable, "-c", RUN, COPY, HERE, json.dumps(ORDER),
                          json.dumps(PHASES)], cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-8000:], sep="\n", file=sys.stderr)
        return out.returncode
    print("\n".join(l for l in out.stdout.splitlines() if l.startswith("[k1-phases]")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[k1-phases] card {smi}")
    if "--out" in argv:
        line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
        path = argv[argv.index("--out") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"card": smi, "phases": json.loads(line[len("RESULT "):])}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
