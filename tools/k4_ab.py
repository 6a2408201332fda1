r"""K4f/K4b (the teacher-forced seq2seq loss and its backward) and K3f/K3b in
two checkouts of the repo, on one card in one call:

    python3 tools/k4_ab.py <other checkout> [results.json]

Unpack the other checkout first, e.g. ``git archive <commit> | tar -x -C
build/parent`` (git ignores ``build/``). Each checkout runs in its own
process, which builds that checkout's kernels, in turns (other, this, this,
other). Through the public API both trees share, each process

- builds the question_coding trainer (``configs/question_coding_ours.yml``,
  batch 256, D = H = 256, 2 layers; a random frozen prior) on 8,192
  in-memory CLEVR-like programs and random questions, and takes the four
  passes of its first batch, as ``chip_smoke.py`` phase 7 does: supervised
  ProgramGenerator and QuestionReconstructor, the generator in REINFORCE
  mode at the z that K1 sampled, the reconstructor from z;
- times ``fused_tf_loss`` forward + ``.backward`` on each pass (K4f, K4b),
  K4f alone under ``torch.no_grad()`` (lean), K4f keeping its residuals and
  K4b alone from fresh residuals, with CUDA events over 10 calls, and each
  LSTM kernel's launches inside one K4f and one K4b under the profiler
  (the decoder's sweeps among them, where the tree has them);
- saves each pass's loss and ten gradients to a ``.npz`` in a temporary
  directory, and K4f's whole residual workspace (allocated zeroed, so that
  its padding compares too) beside it; the first run of this tree also
  saves the decoder cell's gradient from the by-step float64 reference
  (``tf_decoder_reverse_plain``);
- reads the memory the four passes' forwards and backward take beyond what
  was allocated before them, and that of one trainer step;
- times the trainer step (host clock over 10 steps that each fetch their
  logs) and counts the LSTM kernels of one step under ``torch.profiler``;
- times K3f and K3b alone on 256 programs of a random prior and saves
  K3f's loss and K3b's gradients;
- sums the device time of the training GEMM's launches (``gemm_kernel``
  in a tree before ``gemm.cu``, ``gemm_tile`` after it, each with the
  split-K reduction that follows it) in the profiled trainer step and in
  one K3f + K3b (a program_prior step's kernels); in a tree with the GEMM's
  recorder it notes each launch's shape, which ``main`` uses to sum both
  trees' launches by shape class when their launch counts agree.

Prints every time and the max |dev| of each pass's loss and gradients, and
of K3f's loss and K3b's gradients, between the checkouts' first runs (and
between each checkout's two runs), against 1e-4 * max(1, max|g|); the words
of K4f's loss and residuals that differ between the checkouts and between
runs; each tree's decoder cell gradient against the float64 reference,
against the same tolerance. Needs a CUDA card and the CUDA toolkit.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

PASSES = ("pg_sup", "qr_sup", "pg_z", "qr_z")
KERNELS = ("lstm_fwd_step", "lstm_fwd_sweep", "lstm_bwd_step", "lstm_bwd_sweep", "tf_attend",
           "tf_attend_bwd", "tf_decoder_fwd_sweep", "tf_decoder_bwd_sweep")

RUN = r"""
import json, os, sys, tempfile, time
import numpy as np
import torch
tree, out_npz, want_ref = sys.argv[1], sys.argv[2], sys.argv[3] == "ref"
sys.path.insert(0, tree)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.datasets import QuestionCodingDataset
from probnmn_tpu_torch.models.program_prior import init_program_prior_params
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
    fused_tf_loss, lm_backward_cuda, lm_forward_cuda, pack_lm_weights, pack_tf_weights,
    param_leaves, tf_backward_cuda, tf_forward_cuda, tf_param_leaves, tf_params_from_leaves)
from probnmn_tpu_torch.training._trainer import tree_map
from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec
from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY, QuestionCodingTrainer
from probnmn_tpu_torch.utils.checkpointing import save_objects
from probnmn_tpu_torch.utils.clevr import (
    MAX_QUESTION_LENGTH, make_clevr_like_vocabulary, sample_clevr_like_programs)
from probnmn_tpu_torch.utils.observability import RecordingWriter

KERNELS = KERNEL_NAMES
try:  # the GEMM's recorder, in a tree that has it
    from probnmn_tpu_torch.ops.kernels import gemm as gemm_module
except ImportError:
    gemm_module = None
_build.library()
dev = torch.device("cuda")
vocab = make_clevr_like_vocabulary()
work = tempfile.mkdtemp(prefix="k4_ab_")
vocab.save_to_files(os.path.join(work, "vocab"))
overrides = ["DATA.VOCABULARY", os.path.join(work, "vocab"),
             "CHECKPOINTS.PROGRAM_PRIOR", os.path.join(work, "prior.ckpt")]
config = Config(os.path.join(tree, "configs", "question_coding_ours.yml"), overrides)
prior_spec = make_prior_spec(config, vocab)
prior = init_program_prior_params(torch.Generator().manual_seed(1), prior_spec)
save_objects(os.path.join(work, "prior.ckpt"), {"program_prior": prior})

def data(n, seed):
    programs = sample_clevr_like_programs(vocab, n, seed=seed)
    rs = np.random.RandomState(seed)
    programs[0] = rs.randint(4, vocab.get_vocab_size("programs"), programs.shape[1])
    programs[1] = 0
    q = rs.randint(4, vocab.get_vocab_size("questions"), (n, MAX_QUESTION_LENGTH))
    q = q * (np.arange(MAX_QUESTION_LENGTH)[None, :] < rs.randint(4, MAX_QUESTION_LENGTH + 1, (n, 1)))
    q[0] = rs.randint(4, vocab.get_vocab_size("questions"), MAX_QUESTION_LENGTH)
    q[1] = 0
    return programs.astype(np.int64), q.astype(np.int64)

np.random.seed(config.RANDOM_SEED)
train_set = QuestionCodingDataset.from_tokens(
    *data(8192, 7), num_supervision=config.SUPERVISION,
    supervision_question_max_length=config.SUPERVISION_QUESTION_MAX_LENGTH)
trainer = QuestionCodingTrainer(config, os.path.join(work, "run"), device="cuda",
                                writer=RecordingWriter(), dataset=train_set)
init = tree_map(lambda t: t.detach().clone(), trainer.params)
batch = next(trainer._batches)
n_sup = batch[COUNT_KEY]
questions, programs = batch["question"], batch["program"]
z = trainer.sample_programs(questions[n_sup:])
pg, qr = init["program_generator"], init["question_reconstructor"]
passes = [("pg_sup", pg, trainer.pg_spec, questions[:n_sup], programs[:n_sup], False),
          ("qr_sup", qr, trainer.qr_spec, programs[:n_sup], questions[:n_sup], False),
          ("pg_z", pg, trainer.pg_spec, questions[n_sup:], z, True),
          ("qr_z", qr, trainer.qr_spec, z, questions[n_sup:], False)]
gen = torch.Generator().manual_seed(3)

def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters

def kernel_us(fn):
    # {kernel: [device µs of each launch]} inside one call of fn, under the profiler.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    out = {k: [] for k in KERNELS}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in KERNELS:
                if k + "(" in e.name or k + "<" in e.name:
                    out[k].append(e.time_range.elapsed_us())
    return out

def transient_mb(fn):
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6

result = {"passes": {}, "n_sup": int(n_sup)}
grads, runs = {}, []
for name, params, spec, src, tgt, reinforce in passes:
    leaves = [p.detach().clone().requires_grad_(True) for p in tf_param_leaves(params)]
    dloss = (torch.rand(src.shape[0], generator=gen) + 0.5).to(dev)
    def fwd_bwd():
        for leaf in leaves:
            leaf.grad = None
        loss = fused_tf_loss(tf_params_from_leaves(leaves), spec, src, tgt, reinforce)
        (loss * dloss).sum().backward()
    def fwd():
        with torch.no_grad():
            fused_tf_loss(tf_params_from_leaves(leaves), spec, src, tgt, reinforce)
    fwd_bwd()
    torch.cuda.synchronize()
    for i, leaf in enumerate(leaves):
        grads[f"{name}.{i}"] = leaf.grad.cpu().numpy()
    with torch.no_grad():
        grads[f"loss.{name}"] = fused_tf_loss(params, spec, src, tgt, reinforce).cpu().numpy()
    packed = pack_tf_weights(params, spec)
    def keep():
        return tf_forward_cuda(packed, spec, src, tgt, reinforce, keep=True)[1]
    def bwd_ms(iters=10):
        tf_backward_cuda(keep(), dloss)
        pairs = []
        for _ in range(iters):
            res = keep()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            tf_backward_cuda(res, dloss)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters
    result["passes"][name] = {"B": int(src.shape[0]), "fwd_bwd_ms": cuda_ms(fwd_bwd),
                              "fwd_ms": cuda_ms(fwd), "keep_ms": cuda_ms(keep),
                              "bwd_ms": bwd_ms()}
    res = keep()
    result["passes"][name]["k4f_us"] = kernel_us(keep)
    result["passes"][name]["k4b_us"] = kernel_us(lambda: tf_backward_cuda(res, dloss))
    # K4f's loss and residuals, from a zeroed workspace.
    real_empty = torch.empty
    torch.empty = lambda *a, **k: torch.zeros(*a, **k)
    try:
        loss_k, res = tf_forward_cuda(packed, spec, src, tgt, reinforce, keep=True)
    finally:
        torch.empty = real_empty
    grads[f"k4f.{name}"] = loss_k.cpu().numpy()
    np.save(f"{out_npz}.ws.{name}.npy", res.workspace.cpu().numpy())
    del res
    if want_ref:  # the decoder cell's gradient, by-step reverse in float64
        from probnmn_tpu_torch.ops.kernels.seq2seq_train import tf_decoder_reverse_plain
        double = tf_params_from_leaves([p.double() for p in tf_param_leaves(params)])
        ref = tf_decoder_reverse_plain(double, spec, src, tgt, dloss.double(), reinforce)
        dec = 2 + 4 * spec.num_layers
        for i, key in enumerate(("w_ih", "w_hh", "b", "b")):
            grads[f"ref.{name}.{dec + i}"] = ref[key].cpu().numpy()
    runs.append((leaves, spec, src, tgt, reinforce, dloss))
def all_passes():
    losses = [fused_tf_loss(tf_params_from_leaves(l), s, a, b, r) for l, s, a, b, r, _ in runs]
    sum((loss * d).sum() for loss, (_, _, _, _, _, d) in zip(losses, runs)).backward()
result["four_passes_mb"] = transient_mb(all_passes)

prior_dev = tree_map(lambda t: t.to(dev), prior)
packed = pack_lm_weights(prior_dev)
tokens = torch.from_numpy(data(256, 11)[0]).to(dev)
lm_dloss = (torch.rand(256, generator=gen) + 0.5).to(dev)
result["k3f_ms"] = cuda_ms(lambda: lm_forward_cuda(packed, prior_spec, tokens))
result["k3b_ms"] = cuda_ms(lambda: lm_backward_cuda(packed, prior_spec, tokens, lm_dloss))
grads["k3f.loss"] = lm_forward_cuda(packed, prior_spec, tokens).cpu().numpy()
for i, g in enumerate(param_leaves(lm_backward_cuda(packed, prior_spec, tokens, lm_dloss))):
    grads[f"k3b.{i}"] = g.cpu().numpy()
np.savez(out_npz, **grads)

for _ in range(3):
    trainer.step()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(10):
    trainer.step()
result["step_ms"] = (time.perf_counter() - t0) / 10 * 1e3
result["step_mb"] = transient_mb(trainer.step)
def profiled(fn):
    torch.cuda.synchronize()
    if gemm_module is not None:
        gemm_module.gemm_record(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)  # the card idle at both ends: the profiler can lose first kernels
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    records = []
    if gemm_module is not None:
        gemm_module.gemm_record(False)
        records = gemm_module.gemm_records()
    return prof, records

def gemm_launches(prof):
    # [µs of the GEMM kernel, µs of the split-K reduction right after it] a launch.
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    out, after_gemm = [], False
    for e in events:
        if "gemm_kernel(" in e.name or "gemm_tile<" in e.name:
            out.append([e.time_range.elapsed_us(), 0.0])
            after_gemm = True
            continue
        if after_gemm and ("splitk_reduce(" in e.name or "gemm_reduce(" in e.name):
            out[-1][1] += e.time_range.elapsed_us()
        after_gemm = False
    return out

lm_prof, lm_records = profiled(lambda: (lm_forward_cuda(packed, prior_spec, tokens),
                                        lm_backward_cuda(packed, prior_spec, tokens, lm_dloss)))
result["gemm_k3"] = {"launches": gemm_launches(lm_prof), "records": lm_records}
prof, records = profiled(trainer.step)
result["gemm_step"] = {"launches": gemm_launches(prof), "records": records}
counts = dict.fromkeys(KERNELS, 0)
for event in prof.key_averages():
    for k in KERNELS:
        if k + "(" in event.key or k + "<" in event.key or event.key.endswith(k):
            counts[k] += event.count
result["step_launches"] = counts
print("RESULT " + json.dumps(result))
"""


def run(tree, npz, ref=False):
    out = subprocess.run([sys.executable, "-c", RUN.replace("KERNEL_NAMES", repr(KERNELS)), tree, npz,
                          "ref" if ref else "-"], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-8000:], sep="\n", file=sys.stderr)
        raise RuntimeError(f"the run in {tree} failed with code {out.returncode}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def max_dev(a, b):
    r"""Per pass, for the losses, and for K3b: (max |a - b| over its arrays,
    the worst ratio to the tolerance 1e-4 * max(1, max|b|))."""
    import numpy as np

    out = {}
    for name in PASSES + ("loss", "k3f", "k3b"):
        keys = sorted(k for k in b.files if k.startswith(name + "."))
        devs = [(float(np.abs(a[k] - b[k]).max()), 1e-4 * max(1.0, float(np.abs(b[k]).max())))
                for k in keys]
        out[name] = (max(d for d, _ in devs), max(d / t for d, t in devs))
    return out


def k4f_bits(tmp, a, b):
    r"""Per pass: (words of K4f's residual workspace that differ between runs
    a and b, their count, whether the losses are equal bit for bit)."""
    import numpy as np

    la, lb = np.load(os.path.join(tmp, f"{a}.npz")), np.load(os.path.join(tmp, f"{b}.npz"))
    out = {}
    for name in PASSES:
        wa = np.load(os.path.join(tmp, f"{a}.npz.ws.{name}.npy")).view(np.uint32)
        wb = np.load(os.path.join(tmp, f"{b}.npz.ws.{name}.npy")).view(np.uint32)
        loss_same = la[f"k4f.{name}"].tobytes() == lb[f"k4f.{name}"].tobytes()
        out[name] = (int((wa != wb).sum()) if wa.shape == wb.shape else -1, wa.size, loss_same)
    return out


def against_reference(grads, ref):
    r"""Per pass: the decoder cell leaves' worst ratio of max |g - ref| to
    1e-4 * max(1, max |ref|), with the largest |g - ref|."""
    import numpy as np

    out = {}
    for name in PASSES:
        worst = (0.0, 0.0)
        for key in (k for k in ref.files if k.startswith(f"ref.{name}.")):
            r = ref[key]
            g = grads[key[len("ref."):]]
            dev = float(np.abs(g - r).max())
            worst = max(worst, (dev / (1e-4 * max(1.0, float(np.abs(r).max()))), dev))
        out[name] = worst
    return out


def gemm_summary(res):
    r"""The GEMM's launches and device ms in the question_coding step and in
    K3f + K3b."""
    out = {}
    for key in ("gemm_step", "gemm_k3"):
        launches = res[key]["launches"]
        out[key] = (len(launches), sum(a + b for a, b in launches) / 1e3)
    return out


def gemm_classes(results):
    r"""Per shape class of this tree's recorded question_coding step, each
    tree's mean device ms per step (every run whose launch count equals the
    records'), with the class's launches per step."""
    records = results["this"][0]["gemm_step"]["records"]
    fields = ("M", "N", "K", "sam", "sak", "sbk", "sbn", "bias", "accumulate")
    keys = [tuple(r[f] for f in fields) for r in records]
    out = {}
    for name, runs in results.items():
        usable = [r["gemm_step"]["launches"] for r in runs
                  if len(r["gemm_step"]["launches"]) == len(keys)]
        for key in set(keys):
            idx = [i for i, k in enumerate(keys) if k == key]
            entry = out.setdefault(str(key), {"launches_per_step": len(idx)})
            if usable:
                entry[name] = sum(sum(run[i]) for run in usable for i in idx) / len(usable) / 1e3
    return out


def main(argv):
    import numpy as np

    other = os.path.abspath(argv[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tempfile.mkdtemp(prefix="k4_ab_grads_")
    results = {"other": [], "this": []}
    for i, (name, tree) in enumerate((("other", other), ("this", here), ("this", here),
                                      ("other", other))):
        res = run(tree, os.path.join(tmp, f"{name}{len(results[name])}.npz"), ref=i == 1)
        results[name].append(res)
        per = ", ".join(f"{p} B={v['B']} {v['fwd_bwd_ms']:.3f} (K4f lean {v['fwd_ms']:.3f}, "
                        f"keeping {v['keep_ms']:.3f}; K4b {v['bwd_ms']:.3f})"
                        for p, v in res["passes"].items())
        def total(key):
            return sum(v[key] for v in res["passes"].values())
        sweeps = {k: [round(sum(v[part][k]), 2) for v in res["passes"].values()]
                  for part, k in (("k4f_us", "tf_decoder_fwd_sweep"),
                                  ("k4b_us", "tf_decoder_bwd_sweep"),
                                  ("k4f_us", "lstm_fwd_sweep"), ("k4b_us", "lstm_bwd_sweep"))}
        print(f"[k4-ab] {name}: device µs per pass of the sweeps inside K4f / K4b: {sweeps}",
              flush=True)
        print(f"[k4-ab] {name}: fused_tf_loss forward + backward, ms per pass: {per}; four passes "
              f"{total('fwd_bwd_ms'):.3f} (K4f lean {total('fwd_ms'):.3f}, keeping "
              f"{total('keep_ms'):.3f}; K4b {total('bwd_ms'):.3f}); memory of the four passes {res['four_passes_mb']:.1f} "
              f"MB; question_coding step {res['step_ms']:.3f} ms, {res['step_mb']:.1f} MB; K3f "
              f"{res['k3f_ms']:.4f} ms, K3b {res['k3b_ms']:.4f} ms; launches a step "
              f"{res['step_launches']}; the GEMM (launches, device ms) in the step and in "
              f"K3f + K3b: {gemm_summary(res)}", flush=True)
    grads = {k: np.load(os.path.join(tmp, f"{k}.npz")) for k in ("other0", "other1", "this0", "this1")}
    checks = {"k4f_bits": {}, "against_float64": {}}
    for a, b, what in (("this0", "other0", "this vs other"), ("this0", "this1", "this, run 1 vs 2"),
                       ("other0", "other1", "other, run 1 vs 2")):
        devs = max_dev(grads[a], grads[b])
        print(f"[k4-ab] losses and gradients, {what}: " + ", ".join(
            f"{p} max |dev| {d:.3e} ({r:.3e} of the tolerance)" for p, (d, r) in devs.items()),
            flush=True)
    for a, b, what in (("this0", "other0", "this vs other"), ("this0", "this1", "this, run 1 vs 2"),
                       ("other0", "other1", "other, run 1 vs 2")):
        bits = k4f_bits(tmp, a, b)
        print(f"[k4-ab] K4f's loss and residual words, {what}: " + ", ".join(
            f"{p} {d} of {n} words differ, losses {'equal' if same else 'DIFFER'}"
            for p, (d, n, same) in bits.items()), flush=True)
        checks["k4f_bits"][what] = bits
    for key in ("this0", "other0"):
        worst = against_reference(grads[key], grads["this0"])
        print(f"[k4-ab] {key}'s decoder cell gradient against the float64 reference: " + ", ".join(
            f"{p} {r:.3e} of the tolerance (max |dev| {d:.3e})" for p, (r, d) in worst.items()),
            flush=True)
        checks["against_float64"][key] = worst
    shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for key, entry in sorted(gemm_classes(results).items(), key=lambda kv: -kv[1].get("this", 0)):
        print(f"[k4-ab] GEMM class (M, N, K, sam, sak, sbk, sbn, bias, accumulate) {key}: "
              + json.dumps(entry), flush=True)
    print(f"[k4-ab] card {smi}")
    if len(argv) > 1:  # every number, the GEMM's launches and records too
        with open(argv[1], "w") as f:
            json.dump({**results, **checks}, f)
    for runs in results.values():
        for res in runs:
            res.update(gemm_summary(res))
    print("[k4-ab] " + json.dumps({**results, **checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
