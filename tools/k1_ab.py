r"""K1 (the ProgramGenerator's sampling forward) in two checkouts of the repo,
on one card in one call:

    python3 tools/k1_ab.py <other checkout> [--kernels-only] [--sass DIR] [--out DIR]

Unpack the other checkout first, e.g. ``git archive <commit> | tar -x -C
build/parent`` (git ignores ``build/``). Each checkout runs in its own
process, which builds that checkout's kernels, in turns (other, this, this,
other). Through the public API both trees share, each process

- makes chip_smoke.py's K1 batch at full ProgramGenerator width (CLEVR
  vocabulary, 256 random questions of up to 45 tokens with a full-length
  and an all-pad row, D = H = 256, 2 layers, T = 26, random weights from a
  fixed seed);
- times K1 (``fused_sampling_forward`` on a Philox seed) in bfloat16 and
  float32 at B = 256 and 128 with CUDA events over 20 calls each, and K1's
  encoder alone: ``sampling_encode``'s sweeps where the tree has them, else
  the per-row kernel's C entry with no decode steps;
- splits one K1 at B = 256 and one at B = 128 into its kernels under
  ``torch.profiler`` (this checkout's ``chip_smoke.launch_times``): the
  encoder sweeps and the decoder, or the per-row kernel; and records the
  decoder's plan where the tree has ``decoder_plan``;
- saves K1's predictions, logprobs and loss on explicit Gumbel noise and
  the encoder's outputs, in both dtypes, to a ``.npz``;
- unless ``--kernels-only``: times ``InferenceEngine.predict`` at batch 256
  (host clock over 10 calls, and one call under the profiler) and the
  question_coding trainer step (``configs/question_coding_ours.yml``, a
  random frozen prior, 8,192 in-memory questions; host clock over 10 steps,
  and one step under the profiler).

Prints every time, and between the checkouts' first runs (and between each
checkout's two runs) the share of identical token rows, the max |dev| of
the logprobs and losses and of the encoder's outputs, and whether the
predictions, logprobs, losses and encoder outputs are equal bit for bit. With ``--sass DIR`` it also writes the SASS of
each checkout's ``csrc/seq2seq_decode.cu`` to ``DIR/{other,this}.sass``; with
``--out DIR`` every time to ``DIR/k1_ab.json``. Needs a CUDA card and the
CUDA toolkit.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile

RUN = r"""
import importlib.util, json, os, shutil, sys, tempfile, time
import numpy as np
import torch
tree, out_npz, smoke_path, kernels_only = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4] == "1"
sys.path.insert(0, tree)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from probnmn_tpu_torch.models import nmn, program_generator
from probnmn_tpu_torch.models.nmn import cast_params
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.kernels import seq2seq_decode as sd
from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH, make_clevr_like_vocabulary

# This tree's chip_smoke.py: its batch, timers and profiler helpers, the same for both trees.
loader = importlib.util.spec_from_file_location("k1_ab_smoke", smoke_path)
smoke = importlib.util.module_from_spec(loader)
loader.loader.exec_module(smoke)

_build.library()
dev = torch.device("cuda")
vocab = make_clevr_like_vocabulary()
spec = program_generator.make_spec(vocab)
gen = torch.Generator().manual_seed(0)
params = program_generator.init_params(gen, spec)
pg = cast_params(params, torch.float32, dev)
questions = smoke.random_questions(np, vocab, 256, MAX_QUESTION_LENGTH, seed=1)
q_dev = torch.from_numpy(questions).to(dev)
T, V = spec.max_decoding_steps, spec.target_vocab_size
noise = torch.from_numpy(np.random.RandomState(2).gumbel(size=(T, 256, V)).astype(np.float32)).to(dev)
seed = 20261016
sweeps = hasattr(sd, "sampling_encode")


def encode(q, dtype, packed):
    if sweeps:
        return sd.sampling_encode(pg, spec, q, compute_dtype=dtype, packed=packed)[0]
    # The per-row kernel with no decode steps: its encoder alone.
    B, L = q.shape
    src = q.to(torch.int32).contiguous()
    enc = torch.empty(B, L + 1, spec.hidden_size, dtype=dtype, device=dev)
    scratch = torch.empty(B, dtype=torch.float32, device=dev)
    p = packed
    code = _build.library().probnmn_seq2seq_sample(
        sd._DTYPE_CODES[dtype], src.data_ptr(), B, L, None, 0, 0,
        p["src_emb"].data_ptr(), p["tgt_emb"].data_ptr(), p["enc_wih"].data_ptr(),
        p["enc_whh"].data_ptr(), p["enc_bias"].data_ptr(), p["dec_wih"].data_ptr(),
        p["dec_whh"].data_ptr(), p["dec_bias"].data_ptr(), p["proj_w"].data_ptr(),
        p["proj_b"].data_ptr(), enc.data_ptr(), scratch.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr(), spec.input_size, spec.hidden_size, spec.num_layers, V, 0,
        spec.pad_index, spec.unk_index, spec.start_index, spec.end_index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "the per-row kernel's encoder")
    return enc


result = {"sweeps": sweeps, "k1_ms": {}, "encoder_ms": {}, "parts_us": {}, "decoder_plan": {}}
arrays = {}
for dtype, dn in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
    packed = sd.pack_weights(pg, spec, dtype, dev)
    for B in (256, 128):
        q = q_dev[:B]
        key = f"{dn} B={B}"
        result["k1_ms"][key] = smoke.cuda_ms(torch, lambda: sd.fused_sampling_forward(
            pg, spec, q, seed=seed, compute_dtype=dtype, packed=packed), iters=20)
        result["encoder_ms"][key] = smoke.cuda_ms(torch, lambda: encode(q, dtype, packed), iters=20)
    for B in (256, 128):
        result["parts_us"][f"{dn} B={B}"] = smoke.launch_times(
            torch, lambda: sd.fused_sampling_forward(pg, spec, q_dev[:B], seed=seed,
                                                     compute_dtype=dtype, packed=packed),
            ("k1_encoder_sweep", "seq2seq_sample_kernel"))
        if hasattr(sd, "decoder_plan"):
            result["decoder_plan"][f"{dn} B={B}"] = sd.decoder_plan(
                B, q_dev.shape[1], spec.input_size, spec.hidden_size, V, dtype)
    out = sd.fused_sampling_forward(pg, spec, q_dev, noise=noise, compute_dtype=dtype, packed=packed)
    for k in ("predictions", "logprobs", "loss"):
        arrays[f"{dn}.{k}"] = out[k].cpu().numpy()
    arrays[f"{dn}.encoder"] = encode(q_dev, dtype, packed).float().cpu().numpy()

if not kernels_only:
    from probnmn_tpu_torch.serving import InferenceEngine
    nmn_spec = nmn.make_spec(vocab)
    engine = InferenceEngine(vocab, spec, nmn_spec, params, nmn.init_nmn_params(gen, nmn_spec),
                             batch_size=256, device="cuda")
    images = np.random.RandomState(4).randn(256, nmn_spec.feature_channels, nmn_spec.height,
                                            nmn_spec.width).astype(np.float32)
    engine.warmup()
    for _ in range(2):
        engine.predict(questions, images, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        engine.predict(questions, images, seed=seed)
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t0) / 10 * 1e3
    wall, busy, top, _ = smoke.trace(torch, lambda: engine.predict(questions, images, seed=seed))
    result["predict"] = {"ms": predict_ms, "traced_ms": wall, "busy_ms": busy,
                         "top": [(us, name[:60], n) for us, name, n in top]}

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import QuestionCodingDataset
    from probnmn_tpu_torch.models.program_prior import init_program_prior_params
    from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec
    from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer
    from probnmn_tpu_torch.utils.checkpointing import save_objects
    from probnmn_tpu_torch.utils.clevr import sample_clevr_like_programs
    from probnmn_tpu_torch.utils.observability import RecordingWriter
    work = tempfile.mkdtemp(prefix="k1_ab_")
    vocab.save_to_files(os.path.join(work, "vocab"))
    config = Config(os.path.join(tree, "configs", "question_coding_ours.yml"),
                    ["DATA.VOCABULARY", os.path.join(work, "vocab"),
                     "CHECKPOINTS.PROGRAM_PRIOR", os.path.join(work, "prior.ckpt")])
    prior = init_program_prior_params(torch.Generator().manual_seed(1), make_prior_spec(config, vocab))
    save_objects(os.path.join(work, "prior.ckpt"), {"program_prior": prior})
    programs = sample_clevr_like_programs(vocab, 8192, seed=7).astype(np.int64)
    qc_questions = smoke.random_questions(np, vocab, 8192, MAX_QUESTION_LENGTH, seed=7)
    np.random.seed(config.RANDOM_SEED)
    train_set = QuestionCodingDataset.from_tokens(
        programs, qc_questions, num_supervision=config.SUPERVISION,
        supervision_question_max_length=config.SUPERVISION_QUESTION_MAX_LENGTH)
    trainer = QuestionCodingTrainer(config, os.path.join(work, "run"), device="cuda",
                                    writer=RecordingWriter(), dataset=train_set)
    for _ in range(3):
        trainer.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(10):
        trainer.step()
    step_ms = (time.perf_counter() - t1) / 10 * 1e3
    wall, busy, top, _ = smoke.trace(torch, trainer.step)
    result["question_coding_step"] = {"ms": step_ms, "traced_ms": wall, "busy_ms": busy,
                                      "top": [(us, name[:60], n) for us, name, n in top]}
    shutil.rmtree(work, ignore_errors=True)
np.savez(out_npz, **arrays)
print("RESULT " + json.dumps(result))
"""


def run(tree, npz, smoke_path, kernels_only):
    out = subprocess.run([sys.executable, "-c", RUN, tree, npz, smoke_path,
                          "1" if kernels_only else "0"], cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-8000:], sep="\n", file=sys.stderr)
        raise RuntimeError(f"the run in {tree} failed with code {out.returncode}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def sass(tree, path):
    r"""Write the SASS of ``tree``'s csrc/seq2seq_decode.cu to ``path``."""
    sys.path.insert(0, tree)
    from probnmn_tpu_torch.ops.kernels import _build

    cuda = os.path.dirname(os.path.dirname(_build._nvcc()))
    src = os.path.join(tree, "probnmn_tpu_torch", "csrc", "seq2seq_decode.cu")
    cubin = path + ".cubin"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin", src,
                    "-o", cubin], check=True, timeout=600)
    with open(path, "w") as out:
        subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass", cubin], stdout=out,
                       check=True, timeout=600)
    os.remove(cubin)


def compare(a, b):
    r"""Per dtype: the share of identical token rows, the max |dev| of the
    logprobs and losses over all rows, the encoder's outputs' max |dev|, and
    whether each of the four is equal bit for bit."""
    import numpy as np

    out = {}
    for dn in ("bfloat16", "float32"):
        same = (a[f"{dn}.predictions"] == b[f"{dn}.predictions"]).all(axis=1)
        out[dn] = {
            "identical_rows": float(same.mean()),
            "logprob_dev": float(np.abs(a[f"{dn}.logprobs"] - b[f"{dn}.logprobs"]).max()),
            "loss_dev": float(np.abs(a[f"{dn}.loss"] - b[f"{dn}.loss"]).max()),
            "encoder_dev": float(np.abs(a[f"{dn}.encoder"] - b[f"{dn}.encoder"]).max()),
            "encoder_bits_equal": bool(np.array_equal(a[f"{dn}.encoder"], b[f"{dn}.encoder"])),
            "bits_equal": {k: bool(np.array_equal(a[f"{dn}.{k}"], b[f"{dn}.{k}"]))
                           for k in ("predictions", "logprobs", "loss")},
        }
    return out


def main(argv):
    import numpy as np

    other = os.path.abspath(argv[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    kernels_only = "--kernels-only" in argv
    if "--sass" in argv:
        sass_dir = argv[argv.index("--sass") + 1]
        os.makedirs(sass_dir, exist_ok=True)
        for name, tree in (("other", other), ("this", here)):
            sass(tree, os.path.join(sass_dir, f"{name}.sass"))
    tmp = tempfile.mkdtemp(prefix="k1_ab_")
    results = {"other": [], "this": []}
    for name, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        res = run(tree, os.path.join(tmp, f"{name}{len(results[name])}.npz"),
                  os.path.join(here, "chip_smoke.py"), kernels_only)
        results[name].append(res)
        times = ", ".join(f"{k} {v:.4f}" for k, v in res["k1_ms"].items())
        enc = ", ".join(f"{k} {v:.4f}" for k, v in res["encoder_ms"].items())
        parts = "; ".join(f"{key}: " + ", ".join(f"{k} {sum(us) / 1e3:.4f} ms in {len(us)}"
                                                 for k, us in p.items() if us)
                          for key, p in res["parts_us"].items())
        print(f"[k1-ab] {name}: K1 ms {times}; encoder alone ms {enc}; K1 under the profiler: "
              f"{parts}", flush=True)
        for key, plan in res["decoder_plan"].items():
            print(f"[k1-ab] {name} decoder plan {key}: {plan}", flush=True)
        for key in ("predict", "question_coding_step"):
            if key in res:
                v = res[key]
                print(f"[k1-ab] {name} {key}: {v['ms']:.3f} ms host clock, {v['traced_ms']:.3f} "
                      f"ms traced, busy {v['busy_ms']:.3f}; top {v['top'][:4]}", flush=True)
    arrays = {k: np.load(os.path.join(tmp, f"{k}.npz")) for k in ("other0", "other1", "this0", "this1")}
    comparisons = {}
    for a, b, what in (("this0", "other0", "this vs other"), ("this0", "this1", "this, run 1 vs 2"),
                       ("other0", "other1", "other, run 1 vs 2")):
        comparisons[what] = compare(arrays[a], arrays[b])
        print(f"[k1-ab] on explicit noise, {what}: {comparisons[what]}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[k1-ab] card {smi}")
    if "--out" in argv:
        out_dir = argv[argv.index("--out") + 1]
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "k1_ab.json"), "w") as out:
            json.dump({"card": smi, "results": results, "comparisons": comparisons}, out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
