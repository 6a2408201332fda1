#!/usr/bin/env python3
r"""
Chip smoke test of the PyTorch/CUDA port (``probnmn_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of the repository.

Phases (any failure raises, and the script exits non-zero with no result):

1. The card and the build: device name and power limit; every kernel is
   built from ``probnmn_tpu_torch/csrc`` (``-Xptxas -v`` summary printed).
2. K1, the sampling decoder, against its plain PyTorch version at full
   ProgramGenerator width (CLEVR vocabulary, B=256, L=45, D=H=256, 2 layers,
   T=26) on explicit Gumbel noise: float32 predictions identical on >= 99% of
   rows with logprobs within 1e-4 there; bfloat16 tokens >= 95% identical;
   the Philox stream never samples pad/unk/start, repeats for a fixed seed
   and matches the host's copy of the stream.
3. K2, the NMN interpreter, against its plain version at full NMN width
   (C=128, 14x14, B=256) on valid CLEVR programs of every module kind plus
   invalid and all-pad rows: float32 invalid flags equal, outputs within
   1e-4 (of max(1, max|out|)); bfloat16 (the tensor-core build predict runs)
   flags equal, outputs within 2e-2 of max|out|.
4. End to end: ``InferenceEngine(batch_size=256, device="cuda").predict``
   on 256 random questions and (1024, 14, 14) features, with every launch
   counter set to 0 before and read after (each kernel must have run); the
   NMN forward over 256 valid programs (every program must stay valid); the
   float32 NMN forward on the card against the CPU plain path on 8 rows; and
   a float32 engine on the card against one on the CPU, both with a scripted
   generator whose programs run: the same answers, none @@UNKNOWN@@.
5. Times with CUDA events after warm-up: each kernel and its plain version
   per batch (the timed K2 batch is checked against the plain version too),
   the NMN forward and ``predict`` per batch and questions/s, each beside its
   bound (operations and bytes of this run's inputs).
6. The program_prior training phase at the shipped width
   (``configs/program_prior.yml``: D=H=256, 2 layers, batch 256) on 8,192
   CLEVR-like programs in memory (1,024 for validation), each set with a
   full-length and an all-pad row: K3f's per-example loss within 1e-4 of its
   plain version and every K3b gradient leaf within 1e-4 * max(1, max|g|) of
   autograd through the plain loss under a random positive cotangent; 20
   ``ProgramPriorTrainer.step()``s on ``cuda`` with the counters set to 0
   before and read after (K3f and K3b once per step) and a falling loss; the
   first step against the same step on the CPU (loss within 1e-4, every
   parameter's gradient within 1e-4 * max(1, max|g|)); the
   evaluator (K3f), ``after_validation``'s checkpoint, and a resume from it
   with identical params; then K3f, K3b, their plain versions, cuDNN's LSTM
   over the same lengths (a partial yardstick: recurrence only) and the
   train step, timed beside their bounds. Its best checkpoint is phase 7's
   frozen prior.
7. The question_coding training phase at the shipped width
   (``configs/question_coding_ours.yml``: D=H=256, 2 layers, batch 256,
   ALPHA 100, BETA 0.1, DELTA 0.99) on 8,192 in-memory CLEVR-like programs
   with random questions (1,000 supervised; 1,024 for validation), each set
   with full-length and all-pad rows. On the four passes of the first
   batch (supervised ProgramGenerator and QuestionReconstructor, the
   generator in REINFORCE mode at the z kernel K1 sampled, the
   reconstructor from z): K4f's per-example loss within 1e-4 of its plain
   version, every K4b gradient leaf within 1e-4 * max(1, max|g|) of
   autograd under a random positive cotangent, and K4b bitwise repeatable;
   ``question_coding_objective`` at the card's z against the same call on
   the CPU (total, logs and baseline within 1e-4, every gradient leaf within
   1e-4 * max(1, max|g|)); 20 ``QuestionCodingTrainer.step()``s on ``cuda``
   with the counters set to 0 before and read after (K4f and K4b four times
   a step, K1 and K3f once), finite logs and a baseline that moved; the
   evaluator, a checkpoint and a resume with identical params and baseline;
   two OBJECTIVE ``baseline`` steps (K4f and K4b twice a step, nothing
   else); then K4f, K4b and their plain versions per pass, cuDNN's LSTM
   over each pass's encoder (a partial yardstick), and the train step,
   timed beside their bounds.

Prints the kernels' JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Weights are random, from fixed seeds.
"""
import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor and float32
# SIMT FLOP/s, HBM bytes/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
BATCH = 256


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def log(message):
    print(message, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, iters, warmup=2):
    r"""Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace(torch, fn):
    r"""One traced call of ``fn``: (host-clock ms, device-busy ms summed over
    the kernels and copies that ran on the card, the six largest of them
    (us, name, count)). Host-side ops are left out: their device time is
    their kernels' time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, event.key, event.count))
    rows.sort(reverse=True)
    return wall_ms, sum(r[0] for r in rows) / 1e3, rows[:6]


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def random_questions(np, vocab, n, length, seed):
    rs = np.random.RandomState(seed)
    q = rs.randint(4, vocab.get_vocab_size("questions"), (n, length))
    lens = rs.randint(4, length + 1, (n,))
    q = q * (np.arange(length)[None, :] < lens[:, None])
    q[0] = rs.randint(4, vocab.get_vocab_size("questions"), (length,))  # no padding
    q[1] = 0                                                            # all padding
    return q.astype(np.int64)


def scripted_generator(torch, params, spec, vocab, program):
    r"""A copy of the ProgramGenerator ``params`` whose decoder emits
    ``program`` (prefix tokens, each at most once) and then @end@, whatever
    the question: the decoder cell's input and output gates are held open and
    its forget gate shut, so its hidden state encodes the previous token
    alone, and the output projection maps that token to the next one with a
    logit margin of ~23, which no Gumbel draw overcomes. The encoder keeps
    its random weights. This gives the engine programs that run."""
    H, D, V = spec.hidden_size, spec.input_size, spec.target_vocab_size
    tokens = ([spec.start_index] + [vocab.get_token_index(t, "programs") for t in program]
              + [spec.end_index])
    check(len(set(tokens)) == len(tokens) and V <= min(H, D), "scripted program")
    units = torch.arange(V)
    w_ih = torch.zeros(4 * H, H + D)
    w_ih[2 * H + units, H + units] = 3.0  # the cell gate reads the previous token's one-hot
    bias = torch.zeros(4 * H)
    bias[:H], bias[H:2 * H], bias[3 * H:] = 20.0, -20.0, 20.0  # gates i open, f shut, o open
    proj = torch.zeros(V, H)
    for prev, nxt in zip(tokens, tokens[1:] + [spec.end_index]):
        proj[nxt, prev] = 30.0
    return dict(
        params,
        target_embedding=torch.eye(V, D),
        decoder_cell={"w_ih": w_ih, "w_hh": torch.zeros(4 * H, H), "b_ih": bias,
                      "b_hh": torch.zeros(4 * H)},
        output_projection={"w": proj, "b": torch.zeros(V)},
    )


def k1_work(spec, questions, weight_bytes):
    r"""FLOPs and bytes K1 needs for these questions: the encoder over each
    row's len+1 valid steps, every decode step with attention over the valid
    source positions; weights read once, tokens in, outputs out."""
    D, H, V, T = spec.input_size, spec.hidden_size, spec.target_vocab_size, spec.max_decoding_steps
    lens = (questions != spec.pad_index).sum(1) + 1
    enc_step = sum(2 * 4 * H * ((D if l == 0 else H) + H) for l in range(spec.num_layers))
    dec_step = 2 * 4 * H * (H + D + H) + 2 * H * V
    flops = float(enc_step * lens.sum() + dec_step * T * len(lens) + 2 * 2 * H * T * lens.sum())
    nbytes = weight_bytes + questions.size * 4 + len(lens) * (T * 8 + 4)
    return flops, nbytes


def k2_work(tables, spec, programs, itemsize):
    r"""FLOPs and bytes K2 needs for these programs: the tag machine replayed
    on the host counts the module work that runs; stem features in and the
    output out once, and each bank slot the programs use read once."""
    kind = tables["kind"].cpu().numpy()
    slot3 = tables["slot3"].cpu().numpy()
    head = tables["head_slot"].cpu().numpy()
    cmp_slot = tables["cmp_slot"].cpu().numpy()
    same_slot = tables["same_slot"].cpu().numpy()
    C, HW = spec.module_channels, spec.height * spec.width
    NOP, SCENE, AND, OR, ATT, QUERY, RELATE, SAME, COMPARE = range(9)
    convs = proj = heads = sames = 0
    used3, used1, usedc, useds = set(), set(), set(), set()
    for row in programs:
        out_tag, saved_tag = 2, 0
        for tok in row[::-1]:
            k = kind[tok]
            if k == SCENE:
                out_tag, saved_tag = 1, out_tag
            elif k in (AND, OR):
                if saved_tag == 0:
                    break
                out_tag = 1 if (out_tag == 1 and saved_tag == 1) else 2
            elif k in (ATT, QUERY, RELATE):
                if out_tag != 1:
                    break
                n = 5 if k == RELATE else 2
                convs += n
                used3.update(slot3[tok, :n].tolist())
                if head[tok] >= 0:
                    heads += 1
                    used1.add(int(head[tok]))
                out_tag = 1 if head[tok] >= 0 else 2
            elif k == COMPARE:
                if out_tag != 2 or saved_tag != 2:
                    break
                convs += 2
                proj += 1
                used3.update(slot3[tok, :2].tolist())
                usedc.add(int(cmp_slot[tok]))
                out_tag = 2
            elif k == SAME:
                if out_tag != 1:
                    break
                sames += 1
                useds.add(int(same_slot[tok]))
    flops = float(convs * 2 * HW * 9 * C * C + proj * 2 * HW * 2 * C * C
                  + heads * 2 * HW * C + sames * 3 * HW * C)
    weights = (len(used3) * 9 * C * C + len(used1) * C + len(usedc) * 2 * C * C
               + len(useds) * C) * itemsize
    nbytes = weights + 2 * len(programs) * HW * C * itemsize + programs.size * 4 + len(programs) * 4
    return flops, nbytes, convs


def stem_classifier_work(spec, batch, feature_itemsize, itemsize):
    r"""FLOPs and bytes of the NMN forward around K2 (stem: two 3x3 convs;
    classifier: 1x1 projection, 2x2 pool, two linears): features in once,
    weights once, float32 logits out."""
    HW, C, F = spec.height * spec.width, spec.module_channels, spec.feature_channels
    P, L, A = spec.class_projection_channels, spec.classifier_linear_size, spec.num_answers
    flat = P * (spec.height // 2) * (spec.width // 2)
    flops = 2.0 * batch * (HW * 9 * (F * C + C * C) + HW * C * P + flat * L + L * A)
    weights = (9 * F * C + 9 * C * C + C * P + flat * L + L * A) * itemsize
    return flops, batch * HW * F * feature_itemsize + weights + batch * A * 4


def lm_programs(np, vocab, n, seed):
    r"""``n`` CLEVR-like programs (Lt=26) with a full-length row and an all-pad row."""
    from probnmn_tpu_torch.utils.clevr import sample_clevr_like_programs

    programs = sample_clevr_like_programs(vocab, n, seed=seed)
    rs = np.random.RandomState(seed)
    programs[0] = rs.randint(4, vocab.get_vocab_size("programs"), programs.shape[1])
    programs[1] = 0
    return programs.astype(np.int64)


def lm_work(spec, programs):
    r"""FLOPs and bytes K3f and K3b need for these programs: the LSTM and the
    head over each row's valid steps (its tokens, @start@ and the @end@
    label: len + 1); K3b replays the forward, sweeps back (dh and dx) and
    contracts the weight gradients, each as much as the forward's LSTM, plus
    the head's three gradient products. Weights and tokens in once, the loss
    or the gradients out once."""
    D, H, V, L = spec.input_size, spec.hidden_size, spec.vocab_size, spec.num_layers
    steps = float(((programs != spec.pad_index).sum(1) + 1).sum())
    lstm = steps * sum(2 * 4 * H * ((D if l == 0 else H) + H) for l in range(L))
    head = steps * (2 * H * D + 2 * D * V)
    weights = 4 * (V * D + D * H + sum(4 * H * ((D if l == 0 else H) + H) + 8 * H for l in range(L)))
    tokens = programs.size * 4
    fwd = (lstm + head, weights + tokens + 4 * len(programs))
    bwd = (3 * lstm + head + steps * (4 * D * V + 4 * D * H), 2 * weights + tokens + 4 * len(programs))
    return fwd, bwd


def train_program_prior(np, torch, dev, gen, vocab, smi, prior_out):
    r"""Phase 6: kernels K3f and K3b against their plain versions at full
    program_prior width, the trainer on the card (launch counts, falling
    loss, evaluation, checkpoint and resume, one step against the CPU's),
    and times. Copies the best checkpoint to ``prior_out`` (phase 7's frozen
    prior) and returns the two kernels' entries of the kernels line."""
    import shutil
    import tempfile

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import ProgramPriorDataset
    from probnmn_tpu_torch.evaluators.program_prior_evaluator import ProgramPriorEvaluator
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_backward_cuda, lm_forward_cuda, lm_grads_plain, lm_loss_plain, pack_lm_weights,
        param_leaves,
    )
    from probnmn_tpu_torch.training._trainer import copy_into, tree_leaves, tree_map
    from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_prior_")
    vocab.save_to_files(os.path.join(work, "vocab"))
    config = Config(os.path.join(repo, "configs", "program_prior.yml"),
                    ["DATA.VOCABULARY", os.path.join(work, "vocab")])
    train_set = ProgramPriorDataset.from_programs(lm_programs(np, vocab, 8192, seed=5))
    val_set = ProgramPriorDataset.from_programs(lm_programs(np, vocab, 1024, seed=6), split="val")

    def make_trainer(device, name="run"):
        return ProgramPriorTrainer(config, os.path.join(work, name), device=device,
                                   writer=RecordingWriter(), dataset=train_set)

    trainer = make_trainer("cuda")
    spec, batch = trainer.spec, config.OPTIM.BATCH_SIZE
    log(f"[prior] {spec}, batch {batch}, {len(train_set)} train / {len(val_set)} val programs")
    init = tree_map(lambda t: t.detach().clone(), trainer.params["program_prior"])

    # K3f and K3b against their plain versions on the first training batch's
    # programs (row 0 full length, row 1 all padding).
    tok_np = train_set.get_batch(np.arange(batch))["program"]
    tok = torch.from_numpy(tok_np).to(dev)
    packed = pack_lm_weights(init)
    loss_k = lm_forward_cuda(packed, spec, tok)
    loss_p = lm_loss_plain(init, spec, tok)
    torch.cuda.synchronize()
    k3f_err = float((loss_k - loss_p).abs().max())
    log(f"[K3f] per-example loss vs plain: max |err| {k3f_err:.3e} (mean loss "
        f"{float(loss_p.mean()):.4f}; all-pad row {float(loss_k[1]):.4f})")
    check(bool(torch.isfinite(loss_k).all()), "K3f loss not finite")
    check(k3f_err <= 1e-4, f"K3f error {k3f_err}")
    dloss = (torch.rand(batch, generator=gen) + 0.5).to(dev)
    names = ["embedding", "projection"] + [
        f"encoder[{l}].{n}" for l in range(spec.num_layers) for n in ("w_ih", "w_hh", "b_ih", "b_hh")]
    k3b_err = 0.0
    for name, got, want in zip(names, param_leaves(lm_backward_cuda(packed, spec, tok, dloss)),
                               param_leaves(lm_grads_plain(init, spec, tok, dloss))):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        log(f"[K3b] {name:18s} {tuple(want.shape)}: max |err| {err:.3e}, max |grad| {scale:.3e}")
        check(err <= 1e-4 * max(1.0, scale), f"K3b {name} error {err}")
        k3b_err = max(k3b_err, err)

    # The trainer on the card: K3f and K3b once per step.
    steps = 20
    lm_forward_cuda.launches = 0
    lm_backward_cuda.launches = 0
    losses = [trainer.step()["loss"]]
    after_one = tree_map(lambda t: t.detach().clone(), trainer.params["program_prior"])
    grads_one = [p.grad.detach().clone() for p in tree_leaves(trainer.params["program_prior"])]
    losses += [trainer.step()["loss"] for _ in range(steps - 1)]
    torch.cuda.synchronize()
    launches = {"lm_forward": lm_forward_cuda.launches, "lm_backward": lm_backward_cuda.launches}
    log(f"[prior] {steps} train steps on cuda: launches {launches}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    check(launches == {"lm_forward": steps, "lm_backward": steps}, f"launches {launches}")
    check(all(np.isfinite(losses)), "train loss not finite")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]) and losses[-1] < losses[0],
          f"the loss did not fall: {losses}")

    # One float32 step on the CPU (plain versions) from the same params and
    # batch: the same loss, the same (clamped) gradient of every parameter as
    # the trainer's pack, K3b and unpack produced it, and the same params.
    cpu = make_trainer("cpu", "cpu_run")
    copy_into(cpu.params["program_prior"], init)
    cpu_loss = cpu.step()["loss"]
    log(f"[prior] one step, card vs CPU: loss {losses[0]:.6f} / {cpu_loss:.6f} (|diff| "
        f"{abs(losses[0] - cpu_loss):.2e})")
    check(abs(losses[0] - cpu_loss) <= 1e-4, "card vs CPU step loss")
    for index, (got, leaf) in enumerate(zip(grads_one, tree_leaves(cpu.params["program_prior"]))):
        err, scale = float((got.cpu() - leaf.grad).abs().max()), float(leaf.grad.abs().max())
        log(f"[prior]   grad of leaf {index} {tuple(leaf.shape)}: max |err| {err:.3e}, "
            f"max |grad| {scale:.3e}")
        check(err <= 1e-4 * max(1.0, scale), f"card vs CPU gradient of leaf {index}: {err}")
    diffs = [(a.detach().cpu() - b.detach()).abs()
             for a, b in zip(tree_leaves(after_one), tree_leaves(cpu.params["program_prior"]))]
    close = sum(int((d <= 1e-5).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    log(f"[prior]   params within 1e-5: {close:.6f}, max |diff| "
        f"{max(float(d.max()) for d in diffs):.2e} (Adam's first step is lr * sign(g))")
    check(close >= 0.99, "card vs CPU params after one step")

    # Evaluation (K3f under no_grad), a checkpoint, and a resume from it.
    before = lm_forward_cuda.launches
    val = ProgramPriorEvaluator(config, trainer, dataset=val_set).evaluate(num_batches=2)
    ppl = val["program_prior"]["perplexity"]
    check(lm_forward_cuda.launches == before + 2, "the evaluator did not run K3f")
    check(1.0 < ppl < spec.vocab_size, f"perplexity {ppl}")
    trainer.after_validation(val, steps - 1)
    ckpt = os.path.join(work, "run", f"checkpoint_{steps - 1}.ckpt")
    check(os.path.exists(ckpt) and os.path.exists(os.path.join(work, "run", "checkpoint_best.ckpt")),
          "checkpoint files")
    resumed = make_trainer("cuda")
    resumed.load_checkpoint(ckpt)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params), tree_leaves(trainer.params)))
    check(same and resumed.iteration == steps - 1, "resume from the checkpoint")
    log(f"[prior] val perplexity {ppl:.4f} on 2 batches; checkpoint_{steps - 1}.ckpt written and "
        f"resumed with identical params at iteration {resumed.iteration}")

    # Times, each beside its bound.
    k3f_ms = cuda_ms(torch, lambda: lm_forward_cuda(packed, spec, tok), iters=20)
    k3b_ms = cuda_ms(torch, lambda: lm_backward_cuda(packed, spec, tok, dloss), iters=20)
    k3f_plain_ms = cuda_ms(torch, lambda: lm_loss_plain(init, spec, tok), iters=5, warmup=1)
    k3b_plain_ms = cuda_ms(torch, lambda: lm_grads_plain(init, spec, tok, dloss), iters=5, warmup=1)
    (f_flops, f_bytes), (b_flops, b_bytes) = lm_work(spec, tok_np)
    k3f_bound, k3f_by = bound(f_flops, f_bytes, "float32")
    k3b_bound, k3b_by = bound(b_flops, b_bytes, "float32")
    # Yardstick: cuDNN's LSTM over the same packed lengths, recurrence only.
    lstm = torch.nn.LSTM(spec.input_size, spec.hidden_size, spec.num_layers, batch_first=True).to(dev)
    lens = torch.from_numpy((tok_np != spec.pad_index).sum(1) + 1)
    x = torch.randn(batch, tok_np.shape[1] + 1, spec.input_size, generator=gen).to(dev)
    packed_x = torch.nn.utils.rnn.pack_padded_sequence(x, lens, batch_first=True, enforce_sorted=False)
    with torch.no_grad():
        cudnn_fwd_ms = cuda_ms(torch, lambda: lstm(packed_x), iters=20)
    cudnn_train_ms = cuda_ms(torch, lambda: lstm(packed_x)[0].data.sum().backward(), iters=20)
    for _ in range(3):
        trainer.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 10
    for _ in range(timed):
        trainer.step()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    log(f"[time] K3f {k3f_ms:.3f} ms/batch (plain {k3f_plain_ms:.3f}, bound {k3f_bound:.4f} by "
        f"{k3f_by}: {f_flops / 1e9:.2f} GFLOP over {int(lens.sum())} valid row-steps of "
        f"{batch * (tok_np.shape[1] + 1)}; cuDNN LSTM forward, recurrence only, {cudnn_fwd_ms:.3f})")
    log(f"[time] K3b {k3b_ms:.3f} ms/batch (plain {k3b_plain_ms:.3f}, bound {k3b_bound:.4f} by "
        f"{k3b_by}: {b_flops / 1e9:.2f} GFLOP; cuDNN LSTM forward+backward, recurrence only, "
        f"{cudnn_train_ms:.3f})")
    log(f"[time] program_prior train step {step_ms:.3f} ms (host clock, loss fetched each step): "
        f"{batch / step_ms * 1e3:.1f} examples/s; kernel bound {k3f_bound + k3b_bound:.4f} ms; "
        f"card {smi}")
    wall_ms, busy_ms, top = trace(torch, trainer.step)
    if busy_ms > 0:
        log(f"[trace] train step under torch.profiler: {wall_ms:.2f} ms host clock, device busy "
            f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for us, name, count in top:
            log(f"[trace]   {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("[trace] the profiler recorded no device time: idle share not measured")
    shutil.copy(os.path.join(work, "run", "checkpoint_best.ckpt"), prior_out)
    shutil.rmtree(work, ignore_errors=True)

    yardstick = "cuDNN LSTM, recurrence only"
    return [
        {"name": "lm_forward", "route": "cuda", "source": "probnmn_tpu_torch/csrc/lm_train.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:917",
         "launches": launches["lm_forward"], "max_abs_err": k3f_err,
         "ms": k3f_ms, "plain_ms": k3f_plain_ms, "bound_ms": k3f_bound, "bound_by": k3f_by,
         "library_ms": None, "yardstick": yardstick, "yardstick_ms": cudnn_fwd_ms},
        {"name": "lm_backward", "route": "cuda", "source": "probnmn_tpu_torch/csrc/lm_train.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:987",
         "launches": launches["lm_backward"], "max_abs_err": k3b_err,
         "ms": k3b_ms, "plain_ms": k3b_plain_ms, "bound_ms": k3b_bound, "bound_by": k3b_by,
         "library_ms": None, "yardstick": yardstick, "yardstick_ms": cudnn_train_ms},
    ]


def tf_work(spec, src, tgt, reinforce_norm):
    r"""FLOPs and bytes K4f and K4b need for one pass over these tokens: the
    encoder over each row's valid source steps (len + 1), the decoder (its
    gates over [attended, embedded, h], attention over the valid source
    positions, the head) over the steps up to each row's last real label
    (len + 1 in cross-entropy mode, the z length in REINFORCE mode). K4b
    replays the forward and does each product twice more (the data and the
    weight gradients). Weights and tokens in once, the loss or the gradients
    out once."""
    D, H, L = spec.input_size, spec.hidden_size, spec.num_layers
    V, pad = spec.target_vocab_size, spec.pad_index
    src_steps = (src != pad).sum(1) + 1
    dec_steps = (tgt != pad).sum(1) + (0 if reinforce_norm else 1)
    enc = float(src_steps.sum()) * sum(2 * 4 * H * ((D if l == 0 else H) + H) for l in range(L))
    dec = float(dec_steps.sum()) * 2 * 4 * H * (H + D + H)
    att = float((dec_steps * src_steps).sum()) * 2 * 2 * H
    head = float(dec_steps.sum()) * 2 * H * V
    weights = 4 * (spec.source_vocab_size * D + V * D + V * (H + 1) + 4 * H * (H + D + H + 2)
                   + sum(4 * H * ((D if l == 0 else H) + H + 2) for l in range(L)))
    tokens = 4 * (src.size + tgt.size)
    fwd = (enc + dec + att + head, weights + tokens + 4 * len(src))
    bwd = (3 * (enc + dec + att + head), 2 * weights + tokens + 4 * len(src))
    return fwd, bwd


def qc_questions(np, vocab, n, seed):
    r"""``n`` random questions (lengths 4-45, a full-length and an all-pad row)
    and ``n`` CLEVR-like programs (a full-length and an all-pad row)."""
    from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH

    return lm_programs(np, vocab, n, seed), random_questions(np, vocab, n, MAX_QUESTION_LENGTH,
                                                             seed + 1)


def train_question_coding(np, torch, dev, gen, vocab, smi, prior_ckpt):
    r"""Phase 7: kernels K4f and K4b against their plain versions on the four
    passes of a question_coding step at full width, the objective on the
    card against the CPU's at the card's z, 20 trainer steps (launch counts),
    two OBJECTIVE baseline steps, the evaluator, checkpoint and resume, and
    times. Returns the two kernels' entries of the kernels line."""
    import shutil
    import tempfile

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import QuestionCodingDataset
    from probnmn_tpu_torch.evaluators.question_coding_evaluator import QuestionCodingEvaluator
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_backward_cuda, lm_forward_cuda, pack_tf_weights, tf_backward_cuda, tf_forward_cuda,
        tf_grads_plain, tf_loss_plain, tf_param_leaves,
    )
    from probnmn_tpu_torch.training._trainer import copy_into, tree_leaves, tree_map
    from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY, QuestionCodingTrainer
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_qc_")
    vocab.save_to_files(os.path.join(work, "vocab"))
    overrides = ["DATA.VOCABULARY", os.path.join(work, "vocab"),
                 "CHECKPOINTS.PROGRAM_PRIOR", prior_ckpt]
    config = Config(os.path.join(repo, "configs", "question_coding_ours.yml"), overrides)
    np.random.seed(config.RANDOM_SEED)  # the supervision subset, as the CLI seeds it
    train_set = QuestionCodingDataset.from_tokens(
        *qc_questions(np, vocab, 8192, seed=7), num_supervision=config.SUPERVISION,
        supervision_question_max_length=config.SUPERVISION_QUESTION_MAX_LENGTH)
    val_set = QuestionCodingDataset.from_tokens(*qc_questions(np, vocab, 1024, seed=9),
                                                split="val")

    def make_trainer(device, name="run", cfg=config):
        return QuestionCodingTrainer(cfg, os.path.join(work, name), device=device,
                                     writer=RecordingWriter(), dataset=train_set)

    trainer = make_trainer("cuda")
    pg_spec, qr_spec, batch_size = trainer.pg_spec, trainer.qr_spec, config.OPTIM.BATCH_SIZE
    log(f"[qc] PG {pg_spec}, QR {qr_spec}, batch {batch_size}, {len(train_set)} train "
        f"({int(train_set.get_supervision_list().sum())} supervised) / {len(val_set)} val")
    init = tree_map(lambda t: t.detach().clone(), trainer.params)

    # The four passes of a step on its first batch: supervised PG and QR,
    # PG in REINFORCE mode at the sampled z, QR reconstructing from z.
    batch = next(trainer._batches)
    n_sup = batch[COUNT_KEY]
    questions, programs = batch["question"], batch["program"]
    z = trainer.sample_programs(questions[n_sup:])
    torch.cuda.synchronize()
    z_np = z.cpu().numpy()
    log(f"[qc] first batch: {n_sup} supervised, {batch_size - n_sup} unsupervised; z lengths "
        f"{int((z_np != 0).sum(1).min())}-{int((z_np != 0).sum(1).max())}, "
        f"{int((z_np == 0).all(1).sum())} all pad, {int((z_np == pg_spec.end_index).any(1).sum())} "
        f"with @end@")
    pg, qr = init["program_generator"], init["question_reconstructor"]
    passes = [
        ("pg_sup", pg, pg_spec, questions[:n_sup], programs[:n_sup], False),
        ("qr_sup", qr, qr_spec, programs[:n_sup], questions[:n_sup], False),
        ("pg_z", pg, pg_spec, questions[n_sup:], z, True),
        ("qr_z", qr, qr_spec, z, questions[n_sup:], False),
    ]
    leaf_names = ["source_embedding", "target_embedding"] + [
        f"encoder[{l}].{n}" for l in range(pg_spec.num_layers) for n in ("w_ih", "w_hh", "b_ih", "b_hh")
    ] + [f"decoder_cell.{n}" for n in ("w_ih", "w_hh", "b_ih", "b_hh")] + ["proj.w", "proj.b"]
    k4f_err = k4b_err = 0.0
    checked = []
    for name, params, spec, src, tgt, reinforce_norm in passes:
        packed = pack_tf_weights(params, spec)
        loss_k = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm)
        loss_p = tf_loss_plain(params, spec, src, tgt, reinforce_norm)
        torch.cuda.synchronize()
        err = float((loss_k - loss_p).abs().max())
        log(f"[K4f {name}] B={src.shape[0]} S={src.shape[1] + 1} T={tgt.shape[1] + (0 if reinforce_norm else 1)} "
            f"V={spec.target_vocab_size}: max |loss err| {err:.3e} (mean loss {float(loss_p.mean()):.4f})")
        check(bool(torch.isfinite(loss_k).all()), f"K4f {name} loss not finite")
        check(err <= 1e-4, f"K4f {name} error {err}")
        k4f_err = max(k4f_err, err)
        dloss = (torch.rand(src.shape[0], generator=gen) + 0.5).to(dev)
        got = tf_param_leaves(tf_backward_cuda(packed, spec, src, tgt, dloss, reinforce_norm))
        again = tf_param_leaves(tf_backward_cuda(packed, spec, src, tgt, dloss, reinforce_norm))
        want = tf_param_leaves(tf_grads_plain(params, spec, src, tgt, dloss, reinforce_norm))
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"K4b {name} is not bitwise repeatable")
        worst = (0.0, 0.0, "")
        for leaf, g, w in zip(leaf_names, got, want):
            e, scale = float((g - w).abs().max()), float(w.abs().max())
            check(e <= 1e-4 * max(1.0, scale), f"K4b {name} {leaf} error {e} (max |g| {scale})")
            worst = max(worst, (e, scale, leaf))
            k4b_err = max(k4b_err, e)
        log(f"[K4b {name}] every leaf within 1e-4 * max(1, max|g|); worst {worst[2]}: max |err| "
            f"{worst[0]:.3e}, max |grad| {worst[1]:.3e}; bitwise repeatable")
        checked.append((name, params, spec, src, tgt, reinforce_norm, packed, dloss))

    # The objective on the card against the same call on the CPU at the card's z.
    baseline0 = torch.tensor(0.25, device=dev)
    total, new_baseline, logs = trainer.question_coding_objective(trainer.params, batch, z, baseline0)
    total.backward()
    card_grads = [p.grad.detach().clone() for p in tree_leaves(trainer.params)]
    trainer._optimizer.zero_grad()
    cpu = make_trainer("cpu", "cpu_run")
    copy_into(cpu.params, init)
    cpu_batch = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
    total_c, baseline_c, logs_c = cpu.question_coding_objective(cpu.params, cpu_batch, z.cpu(),
                                                                baseline0.cpu())
    total_c.backward()
    loss_diff = abs(float(total.detach()) - float(total_c.detach()))
    log(f"[qc] objective at the card's z, card vs CPU: total {float(total.detach()):.6f} / "
        f"{float(total_c.detach()):.6f} (|diff| {loss_diff:.2e}), baseline {float(new_baseline):.6f} / "
        f"{float(baseline_c):.6f}")
    check(loss_diff <= 1e-4 * max(1.0, abs(float(total_c.detach()))), "card vs CPU objective")
    check(abs(float(new_baseline) - float(baseline_c)) <= 1e-4, "card vs CPU baseline")
    for group, values in logs_c.items():
        for key, value in values.items():
            check(abs(float(logs[group][key]) - float(value)) <= 1e-4 * max(1.0, abs(float(value))),
                  f"card vs CPU log {group}/{key}")
    grad_err = 0.0
    for index, (g, leaf) in enumerate(zip(card_grads, tree_leaves(cpu.params))):
        err, scale = float((g.cpu() - leaf.grad).abs().max()), float(leaf.grad.abs().max())
        check(err <= 1e-4 * max(1.0, scale), f"card vs CPU gradient of leaf {index}: {err}")
        grad_err = max(grad_err, err / max(1.0, scale))
    log(f"[qc]   every log within 1e-4; every gradient leaf within 1e-4 * max(1, max|g|) (worst "
        f"ratio {grad_err:.3e})")

    # The trainer on the card: K4f and K4b four times a step, K1 and K3f once.
    steps = 20
    counters = (fused_sampling_forward, lm_forward_cuda, lm_backward_cuda, tf_forward_cuda,
                tf_backward_cuda)
    for fn in counters:
        fn.launches = 0
    step_logs = [trainer.step() for _ in range(steps)]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    values = [v for out in step_logs for group in out.values() for v in group.values()]
    log(f"[qc] {steps} train steps on cuda (OBJECTIVE ours): launches {launches}; supervised "
        f"loss {step_logs[0]['loss']['program_generation_gt']:.4f} -> "
        f"{step_logs[-1]['loss']['program_generation_gt']:.4f} (PG), "
        f"{step_logs[0]['loss']['question_reconstruction_gt']:.4f} -> "
        f"{step_logs[-1]['loss']['question_reconstruction_gt']:.4f} (QR); elbo "
        f"{step_logs[0]['elbo']['elbo']:.4f} -> {step_logs[-1]['elbo']['elbo']:.4f}; baseline "
        f"{float(trainer.baseline):.4f}")
    check(launches == {"fused_sampling_forward": steps, "lm_forward_cuda": steps,
                       "lm_backward_cuda": 0, "tf_forward_cuda": 4 * steps,
                       "tf_backward_cuda": 4 * steps}, f"launches {launches}")
    check(all(np.isfinite(values)), "train logs not finite")
    check(float(trainer.baseline) != 0.0, "the REINFORCE baseline did not move")

    # Evaluation (plain teacher-forced greedy forward), a checkpoint, a resume.
    val = QuestionCodingEvaluator(config, trainer, dataset=val_set).evaluate(num_batches=2)
    for model, metrics in val.items():
        log(f"[qc] val {model}: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
        check(all(np.isfinite(v) for v in metrics.values()) and metrics["perplexity"] > 1.0
              and 0.0 <= metrics["BLEU"] <= 1.0, f"val metrics of {model}")
    trainer.after_validation(val, steps - 1)
    ckpt = os.path.join(work, "run", f"checkpoint_{steps - 1}.ckpt")
    resumed = make_trainer("cuda")
    resumed.load_checkpoint(ckpt)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params), tree_leaves(trainer.params)))
    check(same and torch.equal(resumed.baseline, trainer.baseline) and resumed.iteration == steps - 1,
          "resume from the checkpoint")
    log(f"[qc] checkpoint_{steps - 1}.ckpt written and resumed with identical params and baseline "
        f"{float(resumed.baseline):.6f}")

    # OBJECTIVE baseline: the supervised passes only.
    base_cfg = Config(os.path.join(repo, "configs", "question_coding_baseline.yml"), overrides)
    base = make_trainer("cuda", "baseline_run", base_cfg)
    for fn in counters:
        fn.launches = 0
    base_logs = [base.step() for _ in range(2)]
    base_launches = {fn.__name__: fn.launches for fn in counters}
    log(f"[qc] 2 steps with OBJECTIVE baseline: launches {base_launches}, logs {base_logs[-1]}")
    check(base_launches == {"fused_sampling_forward": 0, "lm_forward_cuda": 0, "lm_backward_cuda": 0,
                            "tf_forward_cuda": 4, "tf_backward_cuda": 4}, f"launches {base_launches}")
    check(all(np.isfinite(v) for out in base_logs for g in out.values() for v in g.values()),
          "baseline logs not finite")

    # Times per pass, each beside its bound; cuDNN's LSTM over each pass's
    # encoder (same lengths) as a partial yardstick.
    per_pass = {}
    lstm = torch.nn.LSTM(pg_spec.input_size, pg_spec.hidden_size, pg_spec.num_layers,
                         batch_first=True).to(dev)
    for name, params, spec, src, tgt, reinforce_norm, packed, dloss in checked:
        fwd_ms = cuda_ms(torch, lambda: tf_forward_cuda(packed, spec, src, tgt, reinforce_norm), iters=10)
        bwd_ms = cuda_ms(torch, lambda: tf_backward_cuda(packed, spec, src, tgt, dloss, reinforce_norm),
                         iters=10)
        fwd_plain = cuda_ms(torch, lambda: tf_loss_plain(params, spec, src, tgt, reinforce_norm),
                            iters=3, warmup=1)
        bwd_plain = cuda_ms(torch, lambda: tf_grads_plain(params, spec, src, tgt, dloss, reinforce_norm),
                            iters=3, warmup=1)
        src_np, tgt_np = src.cpu().numpy(), tgt.cpu().numpy()
        lens = torch.from_numpy((src_np != spec.pad_index).sum(1) + 1)
        x = torch.randn(src.shape[0], src.shape[1] + 1, spec.input_size, generator=gen).to(dev)
        packed_x = torch.nn.utils.rnn.pack_padded_sequence(x, lens, batch_first=True,
                                                           enforce_sorted=False)
        with torch.no_grad():
            cudnn_fwd = cuda_ms(torch, lambda: lstm(packed_x), iters=10)
        cudnn_train = cuda_ms(torch, lambda: lstm(packed_x)[0].data.sum().backward(), iters=10)
        per_pass[name] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_plain=fwd_plain, bwd_plain=bwd_plain,
                              work=tf_work(spec, src_np, tgt_np, reinforce_norm),
                              cudnn_fwd=cudnn_fwd, cudnn_train=cudnn_train)
        (ff, fb), (bf, bb) = per_pass[name]["work"]
        log(f"[time] {name}: K4f {fwd_ms:.3f} ms (plain {fwd_plain:.3f}, bound "
            f"{bound(ff, fb, 'float32')[0]:.4f}: {ff / 1e9:.2f} GFLOP), K4b {bwd_ms:.3f} ms (plain "
            f"{bwd_plain:.3f}, bound {bound(bf, bb, 'float32')[0]:.4f}: {bf / 1e9:.2f} GFLOP); cuDNN "
            f"LSTM encoder, recurrence only: {cudnn_fwd:.3f} forward, {cudnn_train:.3f} forward+backward")

    def total_of(key):
        return sum(p[key] for p in per_pass.values())

    f_flops = sum(p["work"][0][0] for p in per_pass.values())
    f_bytes = sum(p["work"][0][1] for p in per_pass.values())
    b_flops = sum(p["work"][1][0] for p in per_pass.values())
    b_bytes = sum(p["work"][1][1] for p in per_pass.values())
    k4f_bound, k4f_by = bound(f_flops, f_bytes, "float32")
    k4b_bound, k4b_by = bound(b_flops, b_bytes, "float32")
    for _ in range(3):
        trainer.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 10
    for _ in range(timed):
        trainer.step()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    log(f"[time] K4f, the four passes of a step: {total_of('fwd_ms'):.3f} ms (plain "
        f"{total_of('fwd_plain'):.3f}, bound {k4f_bound:.4f} by {k4f_by}: {f_flops / 1e9:.2f} GFLOP); "
        f"K4b {total_of('bwd_ms'):.3f} ms (plain {total_of('bwd_plain'):.3f}, bound {k4b_bound:.4f} "
        f"by {k4b_by}: {b_flops / 1e9:.2f} GFLOP)")
    log(f"[time] question_coding train step {step_ms:.3f} ms (host clock, logs fetched each step): "
        f"{batch_size / step_ms * 1e3:.1f} examples/s; K4 bound {k4f_bound + k4b_bound:.4f} ms; "
        f"card {smi}")
    wall_ms, busy_ms, top = trace(torch, trainer.step)
    if busy_ms > 0:
        log(f"[trace] question_coding train step under torch.profiler: {wall_ms:.2f} ms host clock, "
            f"device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for us, name, count in top:
            log(f"[trace]   {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("[trace] the profiler recorded no device time: idle share not measured")
    shutil.rmtree(work, ignore_errors=True)

    yardstick = "cuDNN LSTM over the four encoders, recurrence only"
    passes_ms = {name: {"ms": p["fwd_ms"], "backward_ms": p["bwd_ms"]} for name, p in per_pass.items()}
    return [
        {"name": "tf_forward", "route": "cuda", "source": "probnmn_tpu_torch/csrc/tf_train.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:163",
         "launches": launches["tf_forward_cuda"], "max_abs_err": k4f_err,
         "ms": total_of("fwd_ms"), "plain_ms": total_of("fwd_plain"), "bound_ms": k4f_bound,
         "bound_by": k4f_by, "library_ms": None, "yardstick": yardstick,
         "yardstick_ms": total_of("cudnn_fwd"), "per_pass": passes_ms},
        {"name": "tf_backward", "route": "cuda", "source": "probnmn_tpu_torch/csrc/tf_train.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:285",
         "launches": launches["tf_backward_cuda"], "max_abs_err": k4b_err,
         "ms": total_of("bwd_ms"), "plain_ms": total_of("bwd_plain"), "bound_ms": k4b_bound,
         "bound_by": k4b_by, "library_ms": None, "yardstick": yardstick,
         "yardstick_ms": total_of("cudnn_train")},
    ]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from probnmn_tpu_torch.models import nmn, program_generator
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels import _build
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        build_banks, build_tables, execute_programs_kernel, execute_programs_plain,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, pack_weights, philox_gumbel, sampling_forward_with_noise,
    )
    from probnmn_tpu_torch.serving import InferenceEngine
    from probnmn_tpu_torch.utils.clevr import (
        CLEVR_ANSWERS, MAX_QUESTION_LENGTH, make_clevr_like_vocabulary,
        sample_clevr_like_programs,
    )

    # Float32 results are compared: no TF32 in cuBLAS or cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 1. card, build
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall (nvcc {_build.BUILD_INFO['seconds']:.1f} s), "
        f"{_build.BUILD_INFO['path']}")
    for line in str(_build.BUILD_INFO["log"]).splitlines():
        if any(key in line for key in ("Compiling entry", "Used", "spill", "==")):
            log(f"[ptxas] {line.strip()}")

    vocab = make_clevr_like_vocabulary()
    gen = torch.Generator().manual_seed(0)
    pg_spec = program_generator.make_spec(vocab)
    nmn_spec = nmn.make_spec(vocab)
    pg_params = program_generator.init_params(gen, pg_spec)
    nmn_params = nmn.init_nmn_params(gen, nmn_spec)
    pg_dev = cast_params(pg_params, torch.float32, dev)
    nmn_dev = cast_params(nmn_params, torch.float32, dev)
    T, V = pg_spec.max_decoding_steps, pg_spec.target_vocab_size
    questions = random_questions(np, vocab, BATCH, MAX_QUESTION_LENGTH, seed=1)
    q_dev = torch.from_numpy(questions).to(dev)

    # ---------------------------------------------------------------- 2. K1 vs plain
    noise = (-torch.log(-torch.log(torch.rand(T, BATCH, V, generator=gen).clamp_min(1e-12)))).to(dev)
    k1 = {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        got = fused_sampling_forward(pg_dev, pg_spec, q_dev, noise=noise, compute_dtype=dtype)
        want = sampling_forward_with_noise(pg_dev, pg_spec, q_dev, noise, compute_dtype=dtype)
        torch.cuda.synchronize()
        same_rows = (got["predictions"] == want["predictions"]).all(dim=1)
        token_agree = float((got["predictions"] == want["predictions"]).float().mean())
        err = float((got["logprobs"] - want["logprobs"])[same_rows].abs().max())
        loss_err = float((got["loss"] - want["loss"])[same_rows].abs().max())
        log(f"[K1 {name}] identical rows {int(same_rows.sum())}/{BATCH}, token agreement "
            f"{token_agree:.4f}, max |logprob err| {err:.3e}, max |loss err| {loss_err:.3e}")
        check(torch.isfinite(got["loss"]).all(), "K1 loss not finite")
        k1[name] = err
        if dtype == torch.float32:
            check(float(same_rows.float().mean()) >= 0.99, "K1 float32 rows differ")
            check(err <= 1e-4, f"K1 float32 logprob error {err}")
        else:
            check(token_agree >= 0.95, f"K1 bfloat16 token agreement {token_agree}")
    seed = 20261016
    p1 = fused_sampling_forward(pg_dev, pg_spec, q_dev, seed=seed, compute_dtype=torch.bfloat16)
    p2 = fused_sampling_forward(pg_dev, pg_spec, q_dev, seed=seed, compute_dtype=torch.bfloat16)
    preds = p1["predictions"].cpu().numpy()
    check(np.array_equal(preds, p2["predictions"].cpu().numpy()), "K1 Philox stream does not repeat")
    check(not np.isin(preds, [pg_spec.unk_index, pg_spec.start_index]).any(), "K1 sampled unk/start")
    zeros_suffix = all((row[np.argmax(row == 0):] == 0).all() if (row == 0).any() else True for row in preds)
    check(zeros_suffix, "K1 sampled pad inside a program")
    host = sampling_forward_with_noise(
        pg_params, pg_spec, torch.from_numpy(questions),
        torch.from_numpy(philox_gumbel(seed, T, BATCH, V)),
    )["predictions"].numpy()
    f32_philox = fused_sampling_forward(pg_dev, pg_spec, q_dev, seed=seed,
                                        compute_dtype=torch.float32)["predictions"].cpu().numpy()
    philox_rows = float((f32_philox == host).all(axis=1).mean())
    log(f"[K1 philox] repeats for a fixed seed; no pad/unk/start sampled; float32 rows equal to "
        f"the host's Philox stream: {philox_rows:.4f}")
    check(philox_rows >= 0.99, "K1 Philox stream differs from the host's")

    # ---------------------------------------------------------------- 3. K2 vs plain
    tables = build_tables(nmn_spec, dev)
    rs = np.random.RandomState(2)
    n_cmp = BATCH
    programs_np = sample_clevr_like_programs(vocab, n_cmp, seed=3)
    programs_np[-8:] = rs.randint(0, len(vocab.get_index_to_token_vocabulary("programs")),
                                  (8, programs_np.shape[1]))  # token soups: mostly invalid
    programs_np[-1] = 0  # all padding: valid, the stem features pass through
    programs_np[-2, :] = 0
    programs_np[-2, :2] = [vocab.get_token_index("count", "programs"),
                           vocab.get_token_index("filter_color[red]", "programs")]  # no scene
    programs = torch.from_numpy(programs_np).to(dev)
    feats = torch.randn(n_cmp, nmn_spec.height, nmn_spec.width, nmn_spec.feature_channels,
                        generator=gen).to(dev)
    k2 = {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        stem = nmn.apply_stem(cast_params(nmn_dev["stem"], dtype), feats.to(dtype)).contiguous()
        banks = build_banks(nmn_dev, nmn_spec, dtype)
        out_k, inv_k = execute_programs_kernel(banks, tables, nmn_spec, stem, programs)
        out_p, inv_p = execute_programs_plain(banks, tables, nmn_spec, stem, programs)
        torch.cuda.synchronize()
        err = float((out_k.float() - out_p.float()).abs().max())
        scale = float(out_p.float().abs().max())
        log(f"[K2 {name}] invalid {int(inv_k.sum())}/{n_cmp} (plain {int(inv_p.sum())}), "
            f"max |out err| {err:.3e}, max |out| {scale:.3e}")
        check(torch.equal(inv_k, inv_p), "K2 invalid flags differ")
        check(not bool(inv_k[:n_cmp - 8].any()), "K2 marked a valid CLEVR program invalid")
        check(bool(inv_k[-2]) and not bool(inv_k[-1]), "K2 invalid/all-pad rows")
        check(torch.isfinite(out_k.float()).all(), "K2 output not finite")
        k2[name] = err
        if dtype == torch.float32:
            check(err <= 1e-4 * max(1.0, scale), f"K2 float32 error {err}")
        else:
            check(err <= 2e-2 * scale, f"K2 bfloat16 error {err}")

    # ---------------------------------------------------------------- 4. end to end
    engine = InferenceEngine(vocab, pg_spec, nmn_spec, pg_params, nmn_params,
                             batch_size=BATCH, device="cuda")
    check(engine.compute_dtype == torch.bfloat16, "engine dtype on cuda")
    images = np.random.RandomState(4).randn(
        BATCH, nmn_spec.feature_channels, nmn_spec.height, nmn_spec.width).astype(np.float32)
    engine.warmup()
    fused_sampling_forward.launches = 0
    execute_programs_kernel.launches = 0
    answers = engine.predict(questions, images, seed=seed)
    torch.cuda.synchronize()
    launches = {"seq2seq_decode": fused_sampling_forward.launches,
                "nmn_interpreter": execute_programs_kernel.launches}
    # The programs predict sampled (same seed, same kernel): what its NMN ran.
    e2e_programs = fused_sampling_forward(
        pg_dev, pg_spec, q_dev, seed=seed, compute_dtype=engine.compute_dtype,
    )["predictions"].cpu().numpy()
    n_unknown = answers.count("@@UNKNOWN@@")
    log(f"[e2e] predict: {len(answers)} answers, launches {launches}, "
        f"{n_unknown} @@UNKNOWN@@ (invalid programs of the random-init generator), "
        f"answers seen {sorted(set(answers))[:8]}...")
    check(len(answers) == BATCH, "answer count")
    check(set(answers) <= set(CLEVR_ANSWERS) | {"@@UNKNOWN@@"}, "answers outside the vocabulary")
    check(all(n > 0 for n in launches.values()), f"a kernel did not run on the main path: {launches}")

    valid_np = sample_clevr_like_programs(vocab, BATCH, seed=1)
    valid = torch.from_numpy(valid_np).to(dev)
    feats_nhwc = torch.from_numpy(images).to(dev).permute(0, 2, 3, 1)
    nmn_fast = nmn.make_fast_inference_fn(nmn_dev, nmn_spec, device=dev, dtype=torch.bfloat16)
    out = nmn_fast(feats_nhwc, valid)
    check(not bool(out["invalid"].any()), "a valid CLEVR program came out invalid")
    check(torch.isfinite(out["answer_logits"]).all(), "answer logits not finite")
    small = slice(0, 8)
    gpu32 = nmn.make_fast_inference_fn(nmn_dev, nmn_spec, device=dev, dtype=torch.float32)(
        feats_nhwc[small], valid[small])
    cpu32 = nmn.make_fast_inference_fn(nmn_params, nmn_spec, device="cpu", dtype=torch.float32)(
        torch.from_numpy(images[small]).permute(0, 2, 3, 1), torch.from_numpy(valid_np[small]))
    ref_err = float((gpu32["answer_logits"].cpu() - cpu32["answer_logits"]).abs().max())
    log(f"[e2e] valid programs: 0/{BATCH} invalid; float32 card vs CPU plain on 8 rows: "
        f"max |logit err| {ref_err:.3e}")
    check(torch.equal(gpu32["invalid"].cpu(), cpu32["invalid"]), "card vs CPU invalid flags")
    check(ref_err <= 1e-3, f"card vs CPU logits {ref_err}")
    # The whole engine in float32 on the card against the CPU's plain path, on
    # programs that run: the random-init generator's are all invalid, so its
    # answers are all @@UNKNOWN@@ and would hide a wrong interpreter or
    # classifier. A scripted generator emits one valid program of scene,
    # attention, relate, same, a no-op and query for every question.
    scripted = scripted_generator(torch, pg_params, pg_spec, vocab, [
        "query_color", "unique", "same_shape", "relate[left]", "filter_color[red]", "scene"])
    small_answers = [
        InferenceEngine(vocab, pg_spec, nmn_spec, scripted, nmn_params, batch_size=8,
                        device=d, compute_dtype="float32").predict(
            questions[small], images[small], seed=seed)
        for d in ("cuda", "cpu")
    ]
    log(f"[e2e] float32 engine with a scripted generator, card vs CPU plain on 8 questions: "
        f"{small_answers[0]} / {small_answers[1]}")
    check("@@UNKNOWN@@" not in small_answers[1], "the scripted program did not run")
    check(small_answers[0] == small_answers[1], "card vs CPU engine answers")

    # ---------------------------------------------------------------- 5. times
    dt = torch.bfloat16
    packed = pack_weights(pg_dev, pg_spec, dt, dev)
    k1_ms = cuda_ms(torch, lambda: fused_sampling_forward(
        pg_dev, pg_spec, q_dev, seed=seed, compute_dtype=dt, packed=packed), iters=10)
    k1_plain_ms = cuda_ms(torch, lambda: sampling_forward_with_noise(
        pg_dev, pg_spec, q_dev, noise, compute_dtype=dt), iters=3, warmup=1)
    weight_bytes = sum(v.numel() * v.element_size() for v in packed.values())
    k1_flops, k1_bytes = k1_work(pg_spec, questions, weight_bytes)
    k1_bound, k1_by = bound(k1_flops, k1_bytes, "bfloat16")

    banks16 = build_banks(nmn_dev, nmn_spec, dt)
    stem16 = nmn.apply_stem(cast_params(nmn_dev["stem"], dt), feats_nhwc.to(dt)).contiguous()
    k2_ms = cuda_ms(torch, lambda: execute_programs_kernel(banks16, tables, nmn_spec, stem16, valid),
                    iters=5)
    k2_plain_ms = cuda_ms(torch, lambda: execute_programs_plain(
        banks16, tables, nmn_spec, stem16, valid), iters=2, warmup=1)
    # The timed batch, checked too: the bf16 tensor-core build that predict runs.
    out_k, inv_k = execute_programs_kernel(banks16, tables, nmn_spec, stem16, valid)
    out_p, inv_p = execute_programs_plain(banks16, tables, nmn_spec, stem16, valid)
    err = float((out_k.float() - out_p.float()).abs().max())
    scale = float(out_p.float().abs().max())
    log(f"[K2 bfloat16, timed batch] invalid {int(inv_k.sum())}/{BATCH} (plain "
        f"{int(inv_p.sum())}), max |out err| {err:.3e}, max |out| {scale:.3e}")
    check(torch.equal(inv_k, inv_p), "K2 invalid flags differ on the timed batch")
    check(err <= 2e-2 * scale, f"K2 bfloat16 error {err} on the timed batch")
    k2["bfloat16"] = max(k2["bfloat16"], err)
    k2_flops, k2_bytes, n_convs = k2_work(tables, nmn_spec, valid_np, 2)
    k2_bound, k2_by = bound(k2_flops, k2_bytes, "bfloat16")
    nmn_ms = cuda_ms(torch, lambda: nmn_fast(feats_nhwc, valid), iters=5)
    dense_flops, dense_bytes = stem_classifier_work(nmn_spec, BATCH, 4, 2)
    nmn_bound, nmn_by = bound(k2_flops + dense_flops, dense_bytes + k2_bytes, "bfloat16")
    e2e_flops, e2e_bytes, e2e_convs = k2_work(tables, nmn_spec, e2e_programs, 2)
    predict_bound = k1_bound + bound(e2e_flops + dense_flops, e2e_bytes + dense_bytes, "bfloat16")[0]

    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.from_numpy(images).to(dev)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict(questions, images, seed=seed)
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"[time] K1 {k1_ms:.3f} ms/batch (plain {k1_plain_ms:.3f}, bound {k1_bound:.4f} by "
        f"{k1_by}: {k1_flops / 1e9:.2f} GFLOP, {k1_bytes / 1e6:.2f} MB)")
    log(f"[time] K2 {k2_ms:.3f} ms/batch of {BATCH} valid programs (plain {k2_plain_ms:.3f}, "
        f"bound {k2_bound:.4f} by {k2_by}: {n_convs} 3x3 convs, {k2_flops / 1e9:.1f} GFLOP, "
        f"{k2_bytes / 1e6:.1f} MB)")
    log(f"[time] NMN forward (stem + K2 + classifier) {nmn_ms:.3f} ms/batch, valid programs "
        f"(bound {nmn_bound:.4f} by {nmn_by}: {(k2_flops + dense_flops) / 1e9:.1f} GFLOP)")
    log(f"[time] feature upload (float32, {images.nbytes / 1e6:.0f} MB, host clock) {upload_ms:.2f} ms/batch")
    log(f"[time] predict {predict_ms:.2f} ms/batch of {BATCH} (host clock, incl. host batch "
        f"assembly and upload): {BATCH / predict_ms * 1e3:.1f} questions/s; device bound "
        f"{predict_bound:.4f} ms (K1 + NMN forward on its {e2e_convs} 3x3 convs, upload "
        f"excluded); card {smi}")
    wall_ms, busy_ms, top = trace(torch, lambda: engine.predict(questions, images, seed=seed))
    if busy_ms > 0:
        log(f"[trace] predict under torch.profiler: {wall_ms:.2f} ms host clock, device busy "
            f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for us, name, count in top:
            log(f"[trace]   {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("[trace] the profiler recorded no device time: idle share not measured")

    # ---------------------------------------------------------------- 6. program_prior training
    import shutil
    import tempfile

    shared = tempfile.mkdtemp(prefix="chip_smoke_")
    prior_ckpt = os.path.join(shared, "program_prior_best.ckpt")
    prior = train_program_prior(np, torch, dev, gen, vocab, smi, prior_ckpt)

    # ---------------------------------------------------------------- 7. question_coding training
    question_coding = train_question_coding(np, torch, dev, gen, vocab, smi, prior_ckpt)
    shutil.rmtree(shared, ignore_errors=True)

    # max_abs_err is the bfloat16 build's, the one predict runs (K1: logprobs
    # on rows with identical tokens; K2: outputs, both 256-row comparisons);
    # the float32 build's error stands beside it.
    kernels = [
        {"name": "seq2seq_decode", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/seq2seq_decode.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_decode.py:99",
         "launches": launches["seq2seq_decode"], "max_abs_err": k1["bfloat16"],
         "max_abs_err_float32": k1["float32"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "nmn_interpreter", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/nmn_interpreter.cu",
         "replaces": "probnmn_tpu/ops/pallas/nmn_interpreter.py:284",
         "launches": launches["nmn_interpreter"], "max_abs_err": k2["bfloat16"],
         "max_abs_err_float32": k2["float32"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None},
        *prior,
        *question_coding,
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
