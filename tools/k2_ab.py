r"""K2 (the NMN interpreter kernel) and K5 (its training build) in two
checkouts of the repo (or more), on one card in one call:

    python3 tools/k2_ab.py <other checkout> [<another checkout> ...] [--sass DIR]

Times K2 and K5 in bfloat16 on 256 valid CLEVR programs (chip_smoke.py phase
5's batch), and K2 on the batch's longest program alone (the batch's critical
path: one block runs its chain of convs in series), with CUDA events over 50
launches each, in ``<other checkout>`` and in this one, in turns (other,
this, this, other; with several other checkouts, other1, other2, ..., this,
this, ..., other2, other1), each in its own process that builds its
checkout's kernels; prints each time and the registers ``ptxas`` gave the
kernels. With ``--sass DIR`` it also writes the SASS of each checkout's
``csrc/nmn_interpreter.cu`` (``nvcc -cubin``, then ``cuobjdump -sass``) to
``DIR/<name>.sass``. Needs a CUDA card and the CUDA toolkit.
"""
import os
import subprocess
import sys

TIMING = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from probnmn_tpu_torch.models import nmn
from probnmn_tpu_torch.models.nmn import cast_params
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    build_banks, build_tables, execute_programs_kernel, execute_programs_train_kernel)
from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary, sample_clevr_like_programs
dev = torch.device("cuda")
vocab = make_clevr_like_vocabulary()
spec = nmn.make_spec(vocab)
gen = torch.Generator().manual_seed(0)
params = cast_params(nmn.init_nmn_params(gen, spec), torch.float32, dev)
programs = torch.from_numpy(sample_clevr_like_programs(vocab, 256, seed=1)).to(dev)
feats = torch.randn(256, spec.height, spec.width, spec.feature_channels, generator=gen).to(dev)
stem = nmn.apply_stem(cast_params(params["stem"], torch.bfloat16), feats.to(torch.bfloat16)).contiguous()
banks, tables = build_banks(params, spec, torch.bfloat16), build_tables(spec, dev)

def ms(kernel, rows=slice(None)):
    for _ in range(3):
        kernel(banks, tables, spec, stem[rows], programs[rows])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        kernel(banks, tables, spec, stem[rows], programs[rows])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 50


longest = int(sys.argv[2])
times = [ms(execute_programs_kernel), ms(execute_programs_train_kernel),
         ms(execute_programs_kernel, slice(longest, longest + 1))]
lines = str(_build.BUILD_INFO["log"]).splitlines()
for i, line in enumerate(lines):
    if "nmn_interpreter_kernel" in line and "Compiling entry" in line:
        used = next(l for l in lines[i:] if "Used" in l)
        print(line.split("nmn_interpreter_kernel")[1][:30], used.strip())
print(*times)
"""


def sass(tree, path):
    r"""Write the SASS of ``tree``'s csrc/nmn_interpreter.cu to ``path``."""
    from probnmn_tpu_torch.ops.kernels import _build

    cuda = os.path.dirname(os.path.dirname(_build._nvcc()))
    src = os.path.join(tree, "probnmn_tpu_torch", "csrc", "nmn_interpreter.cu")
    cubin = path + ".cubin"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin", src,
                    "-o", cubin], check=True, timeout=600)
    with open(path, "w") as out:
        subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", cubin], stdout=out,
                       check=True, timeout=600)
    os.remove(cubin)


def longest_program():
    r"""(index, 3x3 convs) of the longest program of the timed batch."""
    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import build_tables, interpreter_plan_plain
    from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary, sample_clevr_like_programs

    import torch

    vocab = make_clevr_like_vocabulary()
    programs = torch.from_numpy(sample_clevr_like_programs(vocab, 256, seed=1))
    convs, order = interpreter_plan_plain(build_tables(nmn.make_spec(vocab)), programs)
    return int(order[0]), int(convs[order[0]])


def main(argv):
    sass_dir = None
    if "--sass" in argv:
        i = argv.index("--sass")
        sass_dir, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    others = [os.path.abspath(tree) for tree in argv]
    names = ["other"] if len(others) == 1 else [f"other{i + 1}" for i in range(len(others))]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    longest, chain = longest_program()
    trees = list(zip(names, others)) + [("this", here)]
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        for name, tree in trees:
            sass(tree, os.path.join(sass_dir, f"{name}.sass"))
    times = {name: [] for name, _ in trees}
    for name, tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, "-c", TIMING, tree, str(longest)], cwd=tree,
                             capture_output=True, text=True, check=True, timeout=600)
        *regs, last = out.stdout.strip().splitlines()
        k2, k5, k2_one = (float(v) for v in last.split())
        times[name].append((k2, k5, k2_one))
        for line in regs:
            print(f"[k2-ab] {name} [ptxas] {line}", flush=True)
        print(f"[k2-ab] {name}: K2 {k2:.4f} ms, K5 {k5:.4f} ms per batch of 256 valid programs; "
              f"K2 {k2_one:.4f} ms on its longest program alone ({chain} convs: "
              f"{k2_one / chain * 1e3:.1f} us a conv)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print("[k2-ab] (K2, K5, K2 on the longest program) ms: "
          + ", ".join(f"{name} {times[name]}" for name, _ in trees) + f"; card {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
