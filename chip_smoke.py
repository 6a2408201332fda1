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
   and matches the host's copy of the stream. Its encoder sweeps alone
   (``sampling_encode``) against the plain encoder on the card: outputs and
   final hidden state within 1e-5 of max(1, max|x|) in float32 and within
   2e-2 of max|x| in bfloat16; each layer's sweep plan printed, and the
   decoder's plan in both dtypes (``[K1 decoder plan]``: cluster, rows,
   what stays in shared memory); under the profiler K1 is one
   ``k1_encoder_sweep`` launch a layer and one ``seq2seq_sample_kernel``
   launch.
3. K2, the NMN interpreter, against its plain version at full NMN width
   (C=128, 14x14, B=256) on valid CLEVR programs of every module kind plus
   invalid and all-pad rows: float32 invalid flags equal, outputs within
   1e-4 (of max(1, max|out|)); bfloat16 (the tensor-core build predict runs:
   each conv on wgmma, its taps' weights staged by TMA in a shared-memory
   ring; a persistent grid taking the examples longest program first) flags
   equal, outputs within 2e-2 of max|out|.
4. End to end: ``InferenceEngine(batch_size=256, device="cuda").predict``
   on 256 random questions and (1024, 14, 14) features, with every launch
   counter set to 0 before and read after (each kernel must have run); the
   NMN forward over 256 valid programs (every program must stay valid); the
   float32 NMN forward on the card against the CPU plain path on 8 rows; and
   a float32 engine on the card against one on the CPU, both with a scripted
   generator whose programs run: the same answers, none @@UNKNOWN@@.
5. Times with CUDA events after warm-up: each kernel and its plain version
   per batch (the timed K2 batch is checked against the plain version too),
   K1's encoder sweeps alone and K1's two parts under the profiler, the NMN
   forward and ``predict`` per batch and questions/s, each beside its bound
   (operations and bytes of this run's inputs). On K2's timed batch
   (``[K2 plan]``): the plan kernel's conv counts and order equal to its
   plain version's, the longest chain, the persistent grid and the weight
   ring's stages, the makespan the order predicts (longest first, batch
   order, block-index waves), and K2 under the profiler as one
   ``nmn_plan_kernel`` and one ``nmn_interpreter_kernel``; cuDNN's bf16 conv
   forward over as many 3x3 convs beside K2 (a partial yardstick).
6. The program_prior training phase at the shipped width
   (``configs/program_prior.yml``: D=H=256, 2 layers, batch 256) on 8,192
   CLEVR-like programs in memory (1,024 for validation), each set with a
   full-length and an all-pad row: K3f's per-example loss within 1e-4 of its
   plain version and every K3b gradient leaf within 1e-4 * max(1, max|g|) of
   autograd through the plain loss under a random positive cotangent;
   under the profiler each layer of K3f and of K3b's replay one forward
   sweep launch (``lstm_fwd_sweep``; the plan printed); 20
   ``ProgramPriorTrainer.step()``s on ``cuda`` with the counters set to 0
   before and read after (K3f and K3b once per step) and a falling loss; the
   first step against the same step on the CPU (loss within 1e-4, every
   parameter's gradient within 1e-4 * max(1, max|g|)); the
   evaluator (K3f), ``after_validation``'s checkpoint, and a resume from it
   with identical params; then K3f, K3b, their plain versions, cuDNN's LSTM
   over the same lengths (a partial yardstick: recurrence only) and the
   train step, timed beside their bounds, with the step's launches under
   the profiler (2 sweeps a layer, no ``lstm_fwd_step``). Its best
   checkpoint is phase 7's frozen prior.
7. The question_coding training phase at the shipped width
   (``configs/question_coding_ours.yml``: D=H=256, 2 layers, batch 256,
   ALPHA 100, BETA 0.1, DELTA 0.99) on 8,192 in-memory CLEVR-like programs
   with random questions (1,000 supervised; 1,024 for validation), each set
   with full-length and all-pad rows. On the four passes of the first
   batch (supervised ProgramGenerator and QuestionReconstructor, the
   generator in REINFORCE mode at the z kernel K1 sampled, the
   reconstructor from z): K4f's per-example loss within 1e-4 of its plain
   version and equal to the lean forward's, every K4b gradient leaf (from
   the residuals K4f kept) within 1e-4 * max(1, max|g|) of autograd under a
   random positive cotangent, K4f + K4b bitwise repeatable, and under the
   profiler K4f launching one forward encoder sweep a layer and one step
   kernel a decoder step, K4b no forward kernel, one reverse encoder sweep
   a layer and one cell backward a decoder step (both sweeps' plans, and
   time = a + b * S fitted to every sweep launch of the four passes);
   ``question_coding_objective`` at the card's z against the same call on
   the CPU (total, logs and baseline within 1e-4, every gradient leaf within
   1e-4 * max(1, max|g|)); 20 ``QuestionCodingTrainer.step()``s on ``cuda``
   with the counters set to 0 before and read after (K4f and K4b four times
   a step, K1 and K3f once), finite logs and a baseline that moved; the
   evaluator, a checkpoint and a resume with identical params and baseline;
   two OBJECTIVE ``baseline`` steps (K4f and K4b twice a step, nothing
   else); then K4f (keeping its residuals, and lean), K4b and their plain
   versions per pass, cuDNN's LSTM over each pass's encoder (forward, and
   backward alone: a partial yardstick), the memory of a train step, and the
   step itself, timed beside their bounds, with the step's launches under
   the profiler (the forward sweep 10 times: K4f's encoder layers and K3f's;
   the reverse sweep 8 times; ``lstm_fwd_step`` only the decoder's). Its
   checkpoint is phase 8's frozen generator.
8. The module_training training phase at the shipped width
   (``configs/module_training.yml``: NMN C=128 on 14x14 with 1024 feature
   channels, class projection and classifier 1024, batch 128, lr 1e-4,
   bfloat16; the frozen ProgramGenerator at D=H=256, 2 layers) on 8,192
   questions over 512 random (1024, 14, 14) float32 images in memory
   (1,024 for validation), CLEVR-like programs and random questions and
   answers. At B=128 on CLEVR programs plus invalid and all-pad rows: K5's
   final and flags equal K2's bit for bit, its flags the plain version's,
   its final within K2's tolerances of the plain version's (bfloat16) or of
   the float64 branch's below (float32); every K6 leaf under a random cotangent
   within 1e-4 * max(1, max|g|) in float32 of the float64 gradient of the
   branch K5 and K6 took (``interpreter_grads_on_branch``: every step in
   float64, each ReLU side, ``same``'s argmax and ``and`` / ``or``'s pick
   read from K5's residuals and K6's workspace, since an input within
   float32 rounding of a tie falls on either side by the sum order; each
   decision float64 takes the other way must lie within 1e-5 of its tie,
   the count printed), and within 1e-1 * max(1, max|g|) in bfloat16 of
   autograd through the plain version (``interpreter_grads_plain_by_row``:
   the rows whose d(stem) stands off recomputed alone), bitwise repeatable,
   with dx 0 on invalid rows;
   its weight-gradient kernel and conv input gradients within 1e-5 of
   float64 sums over the operands it wrote to its workspace, and the
   weight-gradient kernel within 1e-5 of ``weight_grad_plain`` on the same
   entries (relative to the sum of |products|; targets without entries
   exactly 0).
   20 ``ModuleTrainingTrainer.step()``s in each of two regimes, the
   generator phase 7's checkpoint (programs mostly abort early) and a
   scripted generator whose program runs nine 3x3 convs, with the counters
   set to 0 before and read after (K1, K5 and K6 once a step, K6's
   weight-gradient stage ``weight_grad_kernel`` once a step, K2 never) and
   the 3x3 convs a step counted by a host replay; one float32 step on 16
   rows at the card's K1 programs against the same step on the CPU (loss
   within 1e-4, every gradient leaf within 1e-4 * max(1, max|g|)); the
   evaluator in both decode modes (K2); a checkpoint and a resume; then K5,
   K6, K2 and the plain versions per batch, cuDNN's bf16 conv over as many
   3x3 convs (a partial yardstick), and the train step in both regimes,
   timed beside their bounds, with a profiler trace; K6 split into parts
   under the profiler (``[K6 parts]``: the sweep, the weight-gradient stage
   beside its own bound, the row sums and the glue, with the partials' MB).
   Its checkpoint (the
   valid-programs run) is phase 9's NMN.
9. The joint_training training phase at the shipped width
   (``configs/joint_training_ours.yml``: batch 256, ALPHA 100, BETA 0.1,
   GAMMA 1, DELTA 0.99, lr 1e-6, the bf16 NMN), resuming the prior, the
   generator and reconstructor, and the NMN from phases 6, 7 and 8, on
   8,192 questions over phase 8's 512 in-memory images (1,000 supervised;
   1,024 for validation). K6's replay mode (K6r) at B=256 on CLEVR programs
   plus invalid and all-pad rows, in both dtypes: dx, every bank gradient
   and the workspace entries equal K6's over K5's residuals bit for bit;
   K6r bitwise repeatable, within K6's tolerances of its references as in
   phase 8, and
   within 1e-5 of float64 sums over its own workspace and (its weight
   gradients) of ``weight_grad_plain``. The interpreter's
   memory for a forward and backward at B=256 in each mode; the float32
   objective on 32 rows (16 supervised) at the card's K1 z against the same
   call on the CPU (total, logs and baseline within 1e-4, every gradient
   leaf within 1e-4 * max(1, max|g|)); 20 ``JointTrainingTrainer.step()``s
   (K1 1, K3f 1, K4f 4, K4b 4, K5 1, K6 1 and its weight-gradient stage 1,
   K2 0 a step), 5 with the replay
   selected (K2 1, K5 0, K6 1 in replay mode) and 2 with OBJECTIVE baseline
   (K1 1, K4f 1, K4b 1, K5 1, K6 1, K3f 0), the counters set to 0 before
   and read after each; the evaluator in both decode modes (K2), a
   checkpoint and a resume; then K6r, K6 and the plain version timed beside
   their bounds, both split into parts (``[K6 parts]``), and the train step
   in both modes (host clock, examples/s,
   the memory a step takes), each with a profiler trace.
10. The mini-CLEVR chain through its own entry point
   (``probnmn_tpu_torch.mini_clevr_run``) on ``cuda`` at production geometry
   (D=H=256, 2 layers; NMN C=128 on 14x14 over the task's 16 feature
   channels): 400 train and 160 val images made from seed 0, 200 supervised
   questions, ``--iters 40 40 40 40 --checkpoint-every 20
   --resume-split-phase module_training --hparam ALPHA 500.0``, with every
   launch counter set to 0 before and read after (each kernel of the path
   must have run; K6's replay mode is not on it): finite train logs at every
   step, every phase's best metrics on the whole val split (no bars at 40
   steps), each phase's frozen models read from the earlier phases'
   ``checkpoint_best.ckpt`` (that file's iteration the phase's best),
   module_training's second leg resumed from ``checkpoint_19.ckpt`` at
   iteration 20, and ``[mini-clevr]`` lines with each phase's train seconds
   and steps/s. Then the path's kernels against their plain versions on the
   card, on what the runner feeds them, from its best checkpoints: on a
   question_coding batch K1 and its encoder sweeps (the unsupervised
   questions, explicit Gumbel noise), the four K4 passes at the z K1
   sampled, K3f and K3b on that z under the frozen prior, and the objective
   against the CPU's; on a module_training batch (half the rows at the
   trained generator's programs, half at the task's own) the plan, K2, K5
   and K6 in both dtypes over the 16-channel features; each at the
   tolerances of phases 2, 6, 7 and 8. The kernels' JSON line gains each
   kernel's ``launches_mini_clevr`` and ``max_abs_err_mini_clevr``.
11. The float32 GEMM every product inside K3 and K4 runs on
   (``csrc/gemm.cu``): its launches are counted over phases 6, 7 and 10's
   runs (the count set to 0 before each), and the shape, strides, split
   and epilogue of every launch of one program_prior step (phase 6) and
   one question_coding step (phase 7) recorded, with the GEMM's device
   time inside another such step under the profiler. Every shape class,
   on random operands with the launch's strides, within 1e-5 of the sum
   of |products| (+ |bias| + |C|) of float64 ``torch.matmul`` and the same
   bits twice; then timed in a CUDA graph (host issue time left out)
   beside its bound, the plain version and one cuBLAS float32 call (TF32
   off) on the same views, with each step's totals (``[gemm]`` lines).
12. Serving from a checkpoint, at full width, from a generator of its own:
   one random ProgramGenerator (its decoder scripted to emit a valid
   program, so that the NMN's answers depend on its weights) and NMN
   written as the JAX package's ``.ckpt`` (``save_objects_jax``), as the
   reference's legacy ``.pth`` (state dicts built here with
   tests/ref_checkpoints.py's key names) and by the port's
   ``save_objects``: each file's format read from its bytes, its params
   loaded bit for bit, and ``InferenceEngine.from_checkpoint(...,
   device="cuda").predict`` on 256 questions giving the answers of an
   engine over the params in memory, in bfloat16 and float32, with K1 and
   K2 launched (counted in the JSON line's ``launches_from_checkpoint``);
   K1 (the checkpoint's generator and the random one it came from) and K2
   (half the rows at the programs K1 sampled, half valid CLEVR programs)
   against their plain versions at phases 2 and 3's tolerances; greedy
   against beam 1 (the same tokens), beam 4's scores finite and sorted;
   ``inference.run_inference`` over 300 in-memory test rows (every row once,
   ``predict``'s answers); a QuestionCodingTrainer whose frozen prior is the
   JAX-format file, 2 steps with K1, K3f, K4f and K4b launched; each
   format's write and load time, ``from_checkpoint``'s time to the first
   answer and the CLI's questions/s (host clock, ``[serve]`` lines).
13. Online serving, at full width, from a generator of its own: K1 (random
   questions, explicit Gumbel noise, the decoder's plan) and K2 (two
   programs with a module of every kind between them, valid CLEVR programs,
   token soups, an invalid and an all-pad row; the persistent grid) against
   their plain versions at B = 4, 16 and 64 in both dtypes at phases 2 and
   3's tolerances (``[bucket]`` lines); ``warmup`` launching K1 and K2 once
   a bucket (4, 16, 64, 256), each bucket's ``_run_padded`` by host clock
   and its pipeline by CUDA events; with a scripted generator, 2,048
   requests through ``submit`` from 8 client threads and ``submit_many`` in
   groups of 1-64 at pipeline depth 1 and 2, every answer equal to
   ``predict``'s and to its batch run again alone, K1 and K2 launched once a
   batch, never more batches in flight than the depth, ``stats()`` counting
   every request and the queue empty after ``stop()``; latency p50/p95/p99
   at a light closed-loop load and q/s at saturation (8 threads of
   ``submit_many(64)``) at depth 1 and 2, and at depth 2 with 4 intra-op
   threads and with a 0.5 ms GIL switch interval, a batch's host time split
   into staging, the pipeline's enqueue, the whole launch and the wait for
   its answers (wall and the thread's CPU time), beside the same batches
   launched from one thread alone; ``predict``'s upload
   at 256 rows, pageable float32 with the cast on the card against the host
   cast into pinned bfloat16 (the same bits on the card), ``predict``'s ms
   and q/s with each and its trace; and the serve CLI in-process on the card
   over a port-format checkpoint (``/healthz``, 8 text questions with inline
   features answered as ``predict`` answers them, a malformed payload's 400,
   ``/stats``) (``[serve-online]`` lines).
14. Images -> features -> answers, at full width, from a generator of its
   own: a synthesized torchvision ``resnet101`` state dict (27.45M conv
   parameters; ``layer4``, ``fc`` and ``num_batches_tracked`` present and
   ignored) and 293 random uint8 224 x 224 images through
   ``preprocess.extract_features.extract_features`` on the card (batches
   of 128, 128 and 37; cuDNN convs in IEEE float32), then ``predict`` on
   256 questions over those features with a scripted generator, the
   extractor's, K1's and K2's counters set to 0 before and read after; the
   card's features within 1e-4 of max |f| of the same module's on the CPU
   (4 images) and of the plain forward, the 37-row batch within it of
   the same images inside a full batch, the float32 NMN's logits on the
   card's features within 1e-3 of max(1, max |logit|) of the CPU's on the
   CPU's; a batch of 128's forward by CUDA events (cudnn.benchmark as set,
   then on) beside its bound and the plain forward, the uint8 upload, the
   feature download, the peak memory, 256 images to 256 answers by host
   clock, and ``load_image`` on a 480 x 320 PNG where PIL is installed
   (``[extract]`` lines).
15. The training options, at full width (256 x 2, batch 256), from
   generators of its own: DROPOUT 0.2 on the prior, the generator and the
   reconstructor, OPTIM.ADAM_MU_DTYPE bfloat16. K1's encoder and K1 (on the
   unsupervised rows' mask), the four K4 passes of a question_coding batch
   and K3f/K3b, each with its dropout masks, against its plain version under
   the same masks at phases 2, 6 and 7's tolerances; one question_coding and
   one program_prior step on the card against the CPU trainer fed the
   card's masks (and z): logs within 1e-4, every gradient leaf within 1e-4
   of its scale, 99% of the parameters within 1e-5 after the bf16-moment
   update; the kernels' counters in those steps (K1, its encoder, K3f, K3b,
   K4f, K4b all above 0), the masked launches of a step under the profiler
   (``k1_dropout`` a layer below the top, ``dropout_rows`` 8 times in a
   question_coding step, 3 in a program_prior step), two steps through
   ``train.run(..., profile_dir=)`` whose Chrome trace holds both steps'
   ranges and names every kernel of the path; each masked kernel's time
   beside the same kernel unmasked on the same inputs, and the
   question_coding step at DROPOUT 0 and 0.2 in turns (``[dropout]``,
   ``[time]`` lines; the JSON line's ``*_dropout`` keys).
16. The data-parallel mesh (``parallel/mesh.py``), at the shipped widths
   (program_prior 256 x 2 at batch 256; module_training at batch 128 with
   the NMN in float32 and a random frozen generator, 256 images of (1024,
   14, 14) in shared host memory): 2 ranks spawned by ``mesh.launch``, over
   NCCL one card a rank when there are two cards or more, else over gloo
   both on card 0 (the ``[mesh]`` line says which). Each phase: the
   evaluator and 3 steps at one rank on the card (module_training at
   handed-in programs, 4 of 128 rows token soups), then the same at 2 ranks
   from the same parameters, each rank on its 128 / 64 rows: the logged
   loss within 2e-4 relative and the metrics within 1e-6 of one rank's, the
   first step's all-reduced gradient within 1e-4 * max(1, max|g|) a leaf,
   the parameters where every step's |g| > 1e-5 within 1% of lr a step
   (program_prior; the NMN's plateau gradients: 2 lr a step) and all within
   2 lr a step (rank 0 against the one-rank run), both ranks' parameters
   and logs equal, the evaluators' numbers within 1e-5; each
   rank's launch counters over those 3 steps and a fourth traced under the
   profiler (module_training's through its own K1 sampling): K3f and K3b
   4 a rank, or K1 and its encoder 1 and K5 and K6 4 a rank, and the traced
   step's sweeps and kernels whole; then on each rank's rows K3f and K3b,
   or K1, its encoder, K5 and K6 in both dtypes, at the parameters
   after the steps, against their plain
   versions at the tolerances of phases 2, 6 and 8 (the JSON line's
   ``launches_mesh``, by rank, and ``max_abs_err_mesh``). Then
   module_training again at the shipped ``NMN.COMPUTE_DTYPE`` ('auto':
   bfloat16 on the card), the same steps, programs and counts, held to one
   rank in bfloat16: the loss within 1e-2 relative, the answer accuracy
   within 2 rows of the batch and the invalid count equal, the first
   gradient within 1e-1 * max(1, max|g|) a leaf (ROADMAP's bf16 bound),
   the parameters within 2 lr a step, the evaluator's accuracy within 2
   rows (JSON ``launches_mesh_bf16``). Then question_coding and
   joint_training (OBJECTIVE ours) at the shipped widths (vocabularies 92
   / 44, D = H = 256, 2 layers, batch 256, so 128 rows a rank; joint over
   256 images of (1024, 14, 14) in shared host memory with the NMN at C =
   128 in float32), from random frozen models (``[mesh] semi-supervised
   ranks: <backend>, ...``): the evaluator and 3 steps at one rank, then
   at 2 ranks from the same parameters, every step scoring a z that is a
   function of the row's question (``z_by_question``), so both runs score
   the same z a row: the logged losses within 2e-4 relative, the
   REINFORCE baseline equal on both ranks bit for bit and within 1e-5 of
   one rank's, the first step's summed gradient within 1e-4 * max(1,
   max|g|) a leaf, the parameters by the trainer-parity rule
   (question_coding where every |g| > 1e-5 within 1% of lr a step; joint
   2 lr a step), both ranks' parameters and logs equal, the evaluators
   within 1e-5; a fourth step traced under the profiler samples its own z
   with K1, and each rank's counters over the four steps read K1 and its
   encoder 1, K3f 4, K4f 16, K4b 16 (and K5, K6 4 in joint); then on each
   rank's rows of the next batch K1, its encoder, K3f, the four K4 passes
   (and K5, K6 in float32), at the parameters after the steps, against
   their plain versions at the
   tolerances of phases 2-8 (JSON ``launches_mesh_qc``,
   ``launches_mesh_jt``, ``max_abs_err_mesh_qc``,
   ``max_abs_err_mesh_jt``).
17. Serving over several cards (``InferenceEngine(num_devices=2)``, one
   replica a card in one process), at full width (B = 256, (1024, 14, 14)
   features): the two shards on cards 0 and 1 where there are two cards,
   else both on card 0 (``share_card``; the ``[serve-cards]`` lines say
   which). float32 greedy and sampling answers equal to one card's, every
   row, with the sampling generator leaning toward a valid program by a
   margin the Gumbel draws overturn on some rows; K1 in float32 at a row
   base over half the batch gives the full batch's rows and the plain
   version's on the host's copy of those rows of the stream (>= 99% of the
   rows). bf16 sampling: one ``predict`` with the counters at 0 launches
   K1, its encoder, the plan and K2 once a shard, and under the profiler two
   sweeps, one decoder, one plan and one K2 a shard; each shard's K1 (at its
   row base) and K2 against their plain versions at phase 13's tolerances;
   the answers that differ from one card's counted (bf16 answers may move
   with the rows a launch sees). The dispatcher: 2,048 requests at depth 2
   from 8 client threads, every future answered, at most 2 batches in
   flight, each kernel launched once a shard a batch, each batch's shards
   given its requests' rows on their own cards (JSON ``launches_cards``,
   ``max_abs_err_cards``, ``row_base_cards``). The NMN's classifier is
   rescaled so that its answers follow the image, and the float32 greedy
   engine over two shards also takes the 2,048 requests through its
   dispatcher, each answer equal to one card's ``predict``.
   ``python3 chip_smoke.py --serve-cards`` runs this phase alone, after the
   build.

Prints the kernels' JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Weights are random, from fixed seeds.
"""
import json
import os
from contextlib import contextmanager
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor and float32
# SIMT FLOP/s, HBM bytes/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
BATCH = 256
T_START = time.perf_counter()


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


def cuda_ms_each(torch, setup, fn, iters, warmup=1):
    r"""Mean milliseconds of ``fn(setup())`` over ``iters`` calls, by CUDA
    events around ``fn`` alone (``setup`` runs outside the timed region)."""
    for _ in range(warmup):
        fn(setup())
    pairs = []
    for _ in range(iters):
        arg = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def transient_mb(torch, fn):
    r"""Peak memory ``fn`` allocates beyond what was allocated before it, MB."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def profiled(torch, fn):
    r"""One call of ``fn`` under ``torch.profiler``, with the card idle for
    20 ms after the trace starts and before it stops: without that gap the
    profiler now and then lost the first kernels of a trace, or all of them
    (a program_prior step once read 2 of its 4 sweeps and 14 of its 18
    GEMMs). Returns the profiler and the host-clock ms of ``fn`` to its last
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.02)
    return prof, wall_ms


def trace(torch, fn):
    r"""One traced call of ``fn``: (host-clock ms, device-busy ms summed over
    the kernels and copies that ran on the card, the six largest of them
    (us, name, count), and every one's launch count by name). Host-side ops
    are left out: their device time is their kernels' time again."""
    from torch.autograd import DeviceType

    prof, wall_ms = profiled(torch, fn)
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
    return wall_ms, sum(r[0] for r in rows) / 1e3, rows[:6], {r[1]: r[2] for r in rows}


def graph_ms(torch, fn, calls=20, replays=3):
    r"""Milliseconds a call of ``fn`` takes on the card with its launches
    back to back: ``calls`` calls captured in one CUDA graph, replayed
    ``replays`` times between CUDA events. Free of the host's time to issue
    them, which a small kernel behind a Python wrapper does not hide."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (workspaces, one-time attributes) off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def launches_of(counts, kernel):
    r"""Launches of the kernel named ``kernel`` in a trace's counts (a
    template kernel's name carries its arguments: ``lstm_fwd_sweep<3>(``)."""
    return sum(n for name, n in counts.items() if f"{kernel}(" in name or f"{kernel}<" in name)


def launch_times(torch, fn, kernels):
    r"""One traced call of ``fn``: each named kernel's launches, as a list of
    their device times in µs, in launch order."""
    from torch.autograd import DeviceType

    prof, _ = profiled(torch, fn)
    out = {k: [] for k in kernels}
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        for k in kernels:
            if f"{k}(" in event.name or f"{k}<" in event.name:
                out[k].append(event.time_range.elapsed_us())
    return out


def fit_steps(points):
    r"""Least-squares time = a + b * S over (S, µs) points: (a, b) in µs."""
    n = len(points)
    mean_s = sum(p[0] for p in points) / n
    mean_t = sum(p[1] for p in points) / n
    var = sum((p[0] - mean_s) ** 2 for p in points)
    b = sum((p[0] - mean_s) * (p[1] - mean_t) for p in points) / var
    return mean_t - b * mean_s, b


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


def scripted_generator(torch, params, spec, vocab, program, margin=30.0):
    r"""A copy of the ProgramGenerator ``params`` whose decoder emits
    ``program`` (prefix tokens, each at most once) and then @end@, whatever
    the question: the decoder cell's input and output gates are held open and
    its forget gate shut, so its hidden state encodes the previous token
    alone, and the output projection maps that token to the next one with a
    logit margin of ~0.76 ``margin`` (~23 by default, which no Gumbel draw
    overcomes; a smaller one lets the draws turn some rows aside). The
    encoder keeps its random weights. This gives the engine programs that
    run."""
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
        proj[nxt, prev] = margin
    return dict(
        params,
        target_embedding=torch.eye(V, D),
        decoder_cell={"w_ih": w_ih, "w_hh": torch.zeros(4 * H, H), "b_ih": bias,
                      "b_hh": torch.zeros(4 * H)},
        output_projection={"w": proj, "b": torch.zeros(V)},
    )


def k1_against_plain(torch, params, spec, questions, noise, tag="K1", dropout_masks=None):
    r"""K1 against its plain version on the card on the same ``questions`` and
    explicit Gumbel ``noise`` (and the encoder's ``dropout_masks``, if any),
    in float32 and bfloat16: float32 predictions identical on >= 99% of rows
    with logprobs within 1e-4 there, bfloat16 tokens >= 95% identical,
    finite losses. Returns each dtype's largest logprob error over the
    identical rows."""
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, sampling_forward_with_noise,
    )

    errs = {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        got = fused_sampling_forward(params, spec, questions, noise=noise, compute_dtype=dtype,
                                     dropout_masks=dropout_masks)
        want = sampling_forward_with_noise(params, spec, questions, noise, compute_dtype=dtype,
                                           dropout_masks=dropout_masks)
        if questions.is_cuda:  # tools/qc_card_check.py --device cpu rehearses on the CPU
            torch.cuda.synchronize()
        same_rows = (got["predictions"] == want["predictions"]).all(dim=1)
        token_agree = float((got["predictions"] == want["predictions"]).float().mean())
        err = float((got["logprobs"] - want["logprobs"])[same_rows].abs().max())
        loss_err = float((got["loss"] - want["loss"])[same_rows].abs().max())
        log(f"[{tag} {name}] identical rows {int(same_rows.sum())}/{len(questions)}, token "
            f"agreement {token_agree:.4f}, max |logprob err| {err:.3e}, max |loss err| "
            f"{loss_err:.3e}")
        check(torch.isfinite(got["loss"]).all(), f"{tag} loss not finite")
        errs[name] = err
        if dtype == torch.float32:
            check(float(same_rows.float().mean()) >= 0.99, f"{tag} float32 rows differ")
            check(err <= 1e-4, f"{tag} float32 logprob error {err}")
        else:
            check(token_agree >= 0.95, f"{tag} bfloat16 token agreement {token_agree}")
    return errs


def k1_encoder_against_plain(torch, params, spec, questions, tag="K1 encoder",
                             dropout_masks=None):
    r"""K1's encoder sweeps alone (``sampling_encode``, with the inter-layer
    ``dropout_masks`` if any) against the plain encoder on the card:
    outputs and final hidden state within 1e-5 of max(1, max|x|) in float32
    and within 2e-2 of max|x| in bfloat16. Returns each dtype's output error
    and each layer's sweep plan."""
    from probnmn_tpu_torch.models.seq2seq import _encode
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import encoder_plan, sampling_encode

    n, L, H = len(questions), spec.num_layers, spec.hidden_size
    errs, plans = {}, {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        out, final = sampling_encode(params, spec, questions, compute_dtype=dtype,
                                     dropout_masks=dropout_masks)
        want_out, _, want_final, _ = _encode(params, spec, questions, dtype, dropout_masks)
        torch.cuda.synchronize()
        check(tuple(out.shape) == (n, questions.shape[1] + 1, H) and out.dtype == dtype
              and final.dtype == torch.float32, f"{tag} output shapes")
        parts = []
        for got, want, what in ((out.float(), want_out, "outputs"), (final, want_final, "final h")):
            check(torch.isfinite(got).all(), f"{tag} {what} not finite")
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
            check(err <= tol, f"{tag} {name} {what} error {err} above {tol}")
            parts.append(f"{what} max |err| {err:.3e} (max |x| {scale:.3e}, limit {tol:.3e})")
        errs[name] = float((out.float() - want_out).abs().max())
        plans[name] = [encoder_plan(n, spec.input_size if l == 0 else H, H, dtype)
                       for l in range(L)]
        log(f"[{tag} {name}] sweeps vs plain encoder: " + "; ".join(parts))
        for l, pl in enumerate(plans[name]):
            log(f"[{tag} {name}] layer {l} plan: n {pl['cluster']}, U {pl['units']}, R "
                f"{pl['rows']}, {pl['threads']} threads, {pl['clusters']} clusters ({pl['fit']} at "
                f"once), {pl['smem']} B shared, W_hh "
                f"{'resident' if pl['w_hh_resident'] else 'streamed'}, W_ih "
                f"{'resident' if pl['w_ih_resident'] else 'streamed'}, {pl['registers']} registers")
    return errs, plans


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


def k1_parts_work(spec, questions, packed):
    r"""FLOPs and bytes of K1's two parts for these questions, each counted as
    a function of its own: the encoder (tokens, the source embedding and the
    encoder's weights in; its outputs (B, L+1, H) and final hidden state out)
    and the decoder (tokens, the encoder's outputs and final state, the
    decoder's weights in; predictions, logprobs and loss out). The encoder's
    outputs count in both, so the two bounds add up to more than K1's."""
    D, H, V, T = spec.input_size, spec.hidden_size, spec.target_vocab_size, spec.max_decoding_steps
    B, raw_len = questions.shape
    lens = (questions != spec.pad_index).sum(1) + 1
    itemsize = packed["src_emb"].element_size()
    enc_step = sum(2 * 4 * H * ((D if l == 0 else H) + H) for l in range(spec.num_layers))
    dec_step = 2 * 4 * H * (H + D + H) + 2 * H * V
    enc_weights = sum(packed[k].numel() * packed[k].element_size()
                      for k in ("src_emb", "enc_wih", "enc_whh", "enc_bias"))
    dec_weights = sum(v.numel() * v.element_size() for v in packed.values()) - enc_weights
    tokens = questions.size * 4
    memory = B * (raw_len + 1) * H * itemsize + B * H * 4
    encoder = (float(enc_step * lens.sum()), enc_weights + tokens + memory)
    decoder = (float(dec_step * T * B + 2 * 2 * H * T * lens.sum()),
               dec_weights + tokens + memory + B * (T * 8 + 4))
    return encoder, decoder


def nmn_replay(tables, programs):
    r"""The tag machine replayed on the host over these programs: the module
    work K2 and K5 run (3x3 convs, compare projections, 1x1 heads, same steps,
    relate and two-conv steps, steps run), the same counted over the valid
    rows only (what K6 sweeps back), and the bank slots read."""
    kind = tables["kind"].cpu().numpy()
    slot3 = tables["slot3"].cpu().numpy()
    head = tables["head_slot"].cpu().numpy()
    cmp_slot = tables["cmp_slot"].cpu().numpy()
    same_slot = tables["same_slot"].cpu().numpy()
    NOP, SCENE, AND, OR, ATT, QUERY, RELATE, SAME, COMPARE = range(9)
    keys = ("convs", "proj", "heads", "sames", "relates", "two_conv", "steps")
    total = dict.fromkeys(keys, 0)
    valid_total = dict(dict.fromkeys(keys, 0), rows=0)
    used = {"w3": set(), "w1": set(), "wcmp": set(), "same": set()}
    for row in programs:
        out_tag, saved_tag, ok = 2, 0, True
        work = dict.fromkeys(keys, 0)
        started = False
        for tok in row[::-1]:
            started = started or tok != 0
            if not started:
                continue
            work["steps"] += 1
            k = kind[tok]
            if k == SCENE:
                out_tag, saved_tag = 1, out_tag
            elif k in (AND, OR):
                if saved_tag == 0:
                    ok = False
                    break
                out_tag = 1 if (out_tag == 1 and saved_tag == 1) else 2
            elif k in (ATT, QUERY, RELATE):
                if out_tag != 1:
                    ok = False
                    break
                n = 5 if k == RELATE else 2
                work["convs"] += n
                work["relates" if k == RELATE else "two_conv"] += 1
                used["w3"].update(slot3[tok, :n].tolist())
                if head[tok] >= 0:
                    work["heads"] += 1
                    used["w1"].add(int(head[tok]))
                out_tag = 1 if head[tok] >= 0 else 2
            elif k == COMPARE:
                if out_tag != 2 or saved_tag != 2:
                    ok = False
                    break
                work["convs"] += 2
                work["proj"] += 1
                work["two_conv"] += 1
                used["w3"].update(slot3[tok, :2].tolist())
                used["wcmp"].add(int(cmp_slot[tok]))
                out_tag = 2
            elif k == SAME:
                if out_tag != 1:
                    ok = False
                    break
                work["sames"] += 1
                used["same"].add(int(same_slot[tok]))
        for key in keys:
            total[key] += work[key]
        if ok and out_tag == 2:
            valid_total["rows"] += 1
            for key in keys:
                valid_total[key] += work[key]
    return dict(total, valid=valid_total, used={k: len(v) for k, v in used.items()})


def makespan(convs, order, blocks):
    r"""The 3x3 convs the busiest of ``blocks`` persistent blocks runs when
    each free block takes the next example in ``order`` (the shared counter
    of K2 and K5), every conv taking the same time."""
    import heapq

    free = [0] * blocks
    for i in order:
        heapq.heappush(free, heapq.heappop(free) + convs[i])
    return max(free)


def tap_pixels(h, w, d):
    r"""Products a conv needs per (C_in, C_out) pair on an H x W image, summed
    over its taps: (H - |dy|)(W - |dx|) for each tap of a 3x3 conv at
    dilation d (a tap's other pixels read only the zero padding), H * W for
    a 1x1 (d = 0)."""
    if d == 0:
        return h * w
    return sum(max(h - abs(dy), 0) for dy in (-d, 0, d)) * sum(max(w - abs(dx), 0) for dx in (-d, 0, d))


def relate_pixels(spec):
    r""":func:`tap_pixels` summed over relate's chain of 3x3 convs."""
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import RELATE_DILATIONS

    return sum(tap_pixels(spec.height, spec.width, d) for d in RELATE_DILATIONS)


def conv_pixels(spec, work):
    r""":func:`tap_pixels` summed over the 3x3 convs of a :func:`nmn_replay`
    count: relate's chain at its dilations, every other conv at 1."""
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import RELATE_DILATIONS

    plain = work["convs"] - len(RELATE_DILATIONS) * work["relates"]
    return plain * tap_pixels(spec.height, spec.width, 1) + work["relates"] * relate_pixels(spec)


def module_flops(spec, work):
    r"""FLOPs of the module work of a :func:`nmn_replay` count."""
    C, HW = spec.module_channels, spec.height * spec.width
    return float(2 * C * C * conv_pixels(spec, work) + work["proj"] * 2 * HW * 2 * C * C
                 + work["heads"] * 2 * HW * C + work["sames"] * 3 * HW * C)


def k2_work(tables, spec, programs, itemsize):
    r"""FLOPs and bytes K2 needs for these programs: the module work that
    runs (:func:`nmn_replay`); stem features in and the output out once, and
    each bank slot the programs use read once."""
    run = nmn_replay(tables, programs)
    C, HW = spec.module_channels, spec.height * spec.width
    used = run["used"]
    weights = (used["w3"] * 9 * C * C + used["w1"] * C + used["wcmp"] * 2 * C * C
               + used["same"] * C) * itemsize
    nbytes = weights + 2 * len(programs) * HW * C * itemsize + programs.size * 4 + len(programs) * 4
    return module_flops(spec, run), nbytes, run["convs"]


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


def k3_against_plain(torch, params, spec, tok, dloss, tag="", dropout_masks=None):
    r"""K3f's per-example loss within 1e-4 of its plain version and every K3b
    gradient leaf within 1e-4 * max(1, max|g|) of autograd through the plain
    loss under the cotangent ``dloss``, on the programs ``tok`` (and the
    LM's ``dropout_masks``, if any). Returns both errors."""
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_backward_cuda, lm_forward_cuda, lm_grads_plain, lm_loss_plain, pack_lm_weights,
        param_leaves,
    )

    packed = pack_lm_weights(params)
    loss_k = lm_forward_cuda(packed, spec, tok, dropout_masks)
    loss_p = lm_loss_plain(params, spec, tok, dropout_masks)
    torch.cuda.synchronize()
    k3f_err = float((loss_k - loss_p).abs().max())
    pad_row = f"; all-pad row {float(loss_k[1]):.4f}" if not bool(tok[1].any()) else ""
    log(f"[K3f{tag}] per-example loss vs plain: max |err| {k3f_err:.3e} (mean loss "
        f"{float(loss_p.mean()):.4f}{pad_row})")
    check(bool(torch.isfinite(loss_k).all()), f"K3f{tag} loss not finite")
    check(k3f_err <= 1e-4, f"K3f{tag} error {k3f_err}")
    names = ["embedding", "projection"] + [
        f"encoder[{l}].{n}" for l in range(spec.num_layers) for n in ("w_ih", "w_hh", "b_ih", "b_hh")]
    k3b_err = 0.0
    for name, got, want in zip(
            names, param_leaves(lm_backward_cuda(packed, spec, tok, dloss, dropout_masks)),
            param_leaves(lm_grads_plain(params, spec, tok, dloss, dropout_masks))):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        log(f"[K3b{tag}] {name:18s} {tuple(want.shape)}: max |err| {err:.3e}, max |grad| "
            f"{scale:.3e}")
        check(err <= 1e-4 * max(1.0, scale), f"K3b{tag} {name} error {err}")
        k3b_err = max(k3b_err, err)
    return k3f_err, k3b_err


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
    from probnmn_tpu_torch.ops.kernels.gemm import gemm_launches
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_backward_cuda, lm_forward_cuda, lm_grads_plain, lm_loss_plain, pack_lm_weights,
        tf_sweep_plan,
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
    dloss = (torch.rand(batch, generator=gen) + 0.5).to(dev)
    k3f_err, k3b_err = k3_against_plain(torch, init, spec, tok, dloss)

    # Each layer's recurrence is one forward sweep, in K3f and in K3b's replay.
    L, T = spec.num_layers, tok_np.shape[1] + 1
    kernels = ("lstm_fwd_sweep", "lstm_fwd_step", "lstm_bwd_step")
    k3f_times = launch_times(torch, lambda: lm_forward_cuda(packed, spec, tok), kernels)
    k3b_times = launch_times(torch, lambda: lm_backward_cuda(packed, spec, tok, dloss), kernels)
    inside = {"K3f": {k: len(v) for k, v in k3f_times.items()},
              "K3b": {k: len(v) for k, v in k3b_times.items()}}
    lm_plan = tf_sweep_plan(batch, spec.hidden_size, forward=True)
    log(f"[K3f] launches inside one K3f and one K3b: {inside}; the forward sweep's plan at "
        f"B={batch}: {lm_plan}; a sweep of T={T} steps takes "
        f"{', '.join(f'{t:.1f}' for t in k3f_times['lstm_fwd_sweep'])} µs")
    check(inside == {"K3f": {"lstm_fwd_sweep": L, "lstm_fwd_step": 0, "lstm_bwd_step": 0},
                     "K3b": {"lstm_fwd_sweep": L, "lstm_fwd_step": 0, "lstm_bwd_step": L * T}},
          f"K3f / K3b launches {inside}")

    # The trainer on the card: K3f and K3b once per step, the GEMM inside them.
    steps = 20
    lm_forward_cuda.launches = 0
    lm_backward_cuda.launches = 0
    gemm_launches(reset=True)
    losses = [trainer.step()["loss"]]
    after_one = tree_map(lambda t: t.detach().clone(), trainer.params["program_prior"])
    grads_one = [p.grad.detach().clone() for p in tree_leaves(trainer.params["program_prior"])]
    losses += [trainer.step()["loss"] for _ in range(steps - 1)]
    torch.cuda.synchronize()
    launches = {"lm_forward": lm_forward_cuda.launches, "lm_backward": lm_backward_cuda.launches,
                "gemm": gemm_launches()}
    log(f"[prior] {steps} train steps on cuda: launches {launches}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    check(launches == {"lm_forward": steps, "lm_backward": steps, "gemm": launches["gemm"]}
          and launches["gemm"] > 0, f"launches {launches}")
    GEMM_PATH["launches"]["program_prior"] = launches["gemm"]
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
    wall_ms, busy_ms, top, counts = trace(torch, trainer.step)
    if busy_ms > 0:
        log(f"[trace] train step under torch.profiler: {wall_ms:.2f} ms host clock, device busy "
            f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for us, name, count in top:
            log(f"[trace]   {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("[trace] the profiler recorded no device time: idle share not measured")
    # K3f's sweeps and K3b's replay of them; K3b's reverse keeps a launch a step.
    step_launches = {k: launches_of(counts, k) for k in kernels}
    log(f"[trace] launches in that step: {step_launches}")
    check(step_launches == {"lstm_fwd_sweep": 2 * L, "lstm_fwd_step": 0, "lstm_bwd_step": L * T},
          f"program_prior step launches {step_launches}")
    gemm_in_step(torch, "program_prior", trainer.step)
    shutil.copy(os.path.join(work, "run", "checkpoint_best.ckpt"), prior_out)
    shutil.rmtree(work, ignore_errors=True)

    yardstick = "cuDNN LSTM, recurrence only"
    return [
        {"name": "lm_forward", "route": "cuda", "source": "probnmn_tpu_torch/csrc/lm_train.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:917",
         "launches": launches["lm_forward"], "max_abs_err": k3f_err,
         "ms": k3f_ms, "plain_ms": k3f_plain_ms, "bound_ms": k3f_bound, "bound_by": k3f_by,
         "library_ms": None, "yardstick": yardstick, "yardstick_ms": cudnn_fwd_ms,
         "sweep_plan": lm_plan, "sweep_us": k3f_times["lstm_fwd_sweep"],
         "step_launches": step_launches},
        {"name": "lm_backward", "route": "cuda", "source": "probnmn_tpu_torch/csrc/lm_train.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:987",
         "launches": launches["lm_backward"], "max_abs_err": k3b_err,
         "ms": k3b_ms, "plain_ms": k3b_plain_ms, "bound_ms": k3b_bound, "bound_by": k3b_by,
         "library_ms": None, "yardstick": yardstick, "yardstick_ms": cudnn_train_ms},
    ]


def qc_passes(params, pg_spec, qr_spec, questions, programs, n_sup, z):
    r"""The four K4 passes of a question_coding step on a batch whose first
    ``n_sup`` rows are supervised: supervised ProgramGenerator and
    QuestionReconstructor, the generator in REINFORCE mode at the sampled
    ``z``, the reconstructor from ``z``."""
    pg, qr = params["program_generator"], params["question_reconstructor"]
    return [
        ("pg_sup", pg, pg_spec, questions[:n_sup], programs[:n_sup], False),
        ("qr_sup", qr, qr_spec, programs[:n_sup], questions[:n_sup], False),
        ("pg_z", pg, pg_spec, questions[n_sup:], z, True),
        ("qr_z", qr, qr_spec, z, questions[n_sup:], False),
    ]


def k4_pass_against_plain(torch, name, params, spec, src, tgt, reinforce_norm, dloss,
                          dropout_masks=None):
    r"""One K4 pass (with the encoder's ``dropout_masks``, if any) against
    its plain version: K4f's per-example loss within 1e-4 and equal to the
    lean forward's, every K4b gradient leaf (from the residuals K4f kept)
    within 1e-4 * max(1, max|g|) of autograd under the cotangent ``dloss``,
    K4f + K4b bitwise repeatable. Returns K4f's error, K4b's largest leaf
    error, the packed weights and the residuals' bytes."""
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        pack_tf_weights, tf_backward_cuda, tf_forward_cuda, tf_grads_plain, tf_loss_plain,
        tf_param_leaves,
    )

    leaf_names = ["source_embedding", "target_embedding"] + [
        f"encoder[{l}].{n}" for l in range(spec.num_layers) for n in ("w_ih", "w_hh", "b_ih", "b_hh")
    ] + [f"decoder_cell.{n}" for n in ("w_ih", "w_hh", "b_ih", "b_hh")] + ["proj.w", "proj.b"]
    packed = pack_tf_weights(params, spec)
    masks = {"dropout_masks": dropout_masks}
    lean = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, **masks)
    loss_k, residuals = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True, **masks)
    residual_bytes = residuals.nbytes
    loss_p = tf_loss_plain(params, spec, src, tgt, reinforce_norm, dropout_masks)
    torch.cuda.synchronize()
    err = float((loss_k - loss_p).abs().max())
    log(f"[K4f {name}] B={src.shape[0]} S={src.shape[1] + 1} T={tgt.shape[1] + (0 if reinforce_norm else 1)} "
        f"V={spec.target_vocab_size}: max |loss err| {err:.3e} (mean loss {float(loss_p.mean()):.4f}); "
        f"residuals kept for K4b {residual_bytes / 1e6:.1f} MB")
    check(torch.equal(lean, loss_k), f"K4f {name}: the lean and the keeping forward differ")
    check(bool(torch.isfinite(loss_k).all()), f"K4f {name} loss not finite")
    check(err <= 1e-4, f"K4f {name} error {err}")
    got = tf_param_leaves(tf_backward_cuda(residuals, dloss))
    loss_again, residuals = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True,
                                            **masks)
    again = tf_param_leaves(tf_backward_cuda(residuals, dloss))
    want = tf_param_leaves(tf_grads_plain(params, spec, src, tgt, dloss, reinforce_norm,
                                          dropout_masks))
    check(torch.equal(loss_k, loss_again) and all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K4f + K4b {name} are not bitwise repeatable")
    worst = (0.0, 0.0, "")
    for leaf, g, w in zip(leaf_names, got, want):
        e, scale = float((g - w).abs().max()), float(w.abs().max())
        check(e <= 1e-4 * max(1.0, scale), f"K4b {name} {leaf} error {e} (max |g| {scale})")
        worst = max(worst, (e, scale, leaf))
    log(f"[K4b {name}] every leaf within 1e-4 * max(1, max|g|); worst {worst[2]}: max |err| "
        f"{worst[0]:.3e}, max |grad| {worst[1]:.3e}; K4f + K4b bitwise repeatable")
    return err, worst[0], packed, residual_bytes


def objective_against_cpu(torch, card, cpu, batch, z, baseline0, tag="qc"):
    r"""``question_coding_objective`` of the trainer ``card`` against the same
    call of ``cpu`` (the plain versions, from the same parameters) on
    ``batch`` at the card's sampled ``z``: total, logs and baseline within
    1e-4 (of max(1, |value|)), every gradient leaf within 1e-4 * max(1,
    max|g|). Leaves both trainers' gradients at zero. Returns the total's
    difference and the worst leaf's ratio."""
    from probnmn_tpu_torch.training._trainer import tree_leaves

    out = []
    for trainer in (card, cpu):
        trainer._optimizer.zero_grad()
        on = {k: v.to(trainer.device) if isinstance(v, torch.Tensor) else v
              for k, v in batch.items()}
        total, baseline, logs = trainer.question_coding_objective(
            trainer.params, on, z.to(trainer.device), baseline0.to(trainer.device))
        total.backward()
        out.append((float(total.detach()), float(baseline), logs,
                    [p.grad.detach().cpu().clone() for p in tree_leaves(trainer.params)]))
        trainer._optimizer.zero_grad()
    (total, new_baseline, logs, card_grads), (total_c, baseline_c, logs_c, cpu_grads) = out
    loss_diff = abs(total - total_c)
    log(f"[{tag}] objective at the card's z, card vs CPU: total {total:.6f} / {total_c:.6f} "
        f"(|diff| {loss_diff:.2e}), baseline {new_baseline:.6f} / {baseline_c:.6f}")
    check(loss_diff <= 1e-4 * max(1.0, abs(total_c)), f"{tag}: card vs CPU objective")
    check(abs(new_baseline - baseline_c) <= 1e-4, f"{tag}: card vs CPU baseline")
    for group, values in logs_c.items():
        for key, value in values.items():
            check(abs(float(logs[group][key]) - float(value)) <= 1e-4 * max(1.0, abs(float(value))),
                  f"{tag}: card vs CPU log {group}/{key}")
    grad_err = 0.0
    for index, (g, want) in enumerate(zip(card_grads, cpu_grads)):
        err, scale = float((g - want).abs().max()), float(want.abs().max())
        check(err <= 1e-4 * max(1.0, scale), f"{tag}: card vs CPU gradient of leaf {index}: {err}")
        grad_err = max(grad_err, err / max(1.0, scale))
    log(f"[{tag}]   every log within 1e-4; every gradient leaf within 1e-4 * max(1, max|g|) "
        f"(worst ratio {grad_err:.3e})")
    return loss_diff, grad_err


def tf_work(spec, src, tgt, reinforce_norm, residual_bytes):
    r"""FLOPs and bytes K4f and K4b need for one pass over these tokens: the
    encoder over each row's valid source steps (len + 1), the decoder (its
    gates over [attended, embedded, h], attention over the valid source
    positions, the head) over the steps up to each row's last real label
    (len + 1 in cross-entropy mode, the z length in REINFORCE mode). K4b
    starts from K4f's residuals and does each product twice (the data and
    the weight gradients). Weights and tokens in once, the loss or the
    gradients out once; the residuals (``residual_bytes``) out of K4f once
    and into K4b once."""
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
    fwd = (enc + dec + att + head, weights + tokens + 4 * len(src) + residual_bytes)
    bwd = (2 * (enc + dec + att + head), 2 * weights + residual_bytes + 4 * len(src))
    return fwd, bwd


def qc_questions(np, vocab, n, seed):
    r"""``n`` random questions (lengths 4-45, a full-length and an all-pad row)
    and ``n`` CLEVR-like programs (a full-length and an all-pad row)."""
    from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH

    return lm_programs(np, vocab, n, seed), random_questions(np, vocab, n, MAX_QUESTION_LENGTH,
                                                             seed + 1)


def train_question_coding(np, torch, dev, gen, vocab, smi, prior_ckpt, qc_out):
    r"""Phase 7: kernels K4f and K4b against their plain versions on the four
    passes of a question_coding step at full width, the objective on the
    card against the CPU's at the card's z, 20 trainer steps (launch counts),
    two OBJECTIVE baseline steps, the evaluator, checkpoint and resume, and
    times. Copies its checkpoint to ``qc_out`` (phase 8's frozen generator)
    and returns the two kernels' entries of the kernels line."""
    import shutil
    import tempfile

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import QuestionCodingDataset
    from probnmn_tpu_torch.evaluators.question_coding_evaluator import QuestionCodingEvaluator
    from probnmn_tpu_torch.ops.kernels.gemm import gemm_launches
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_backward_cuda, lm_forward_cuda, tf_backward_cuda, tf_forward_cuda, tf_grads_plain,
        tf_loss_plain, tf_sweep_plan,
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
    passes = qc_passes(init, pg_spec, qr_spec, questions, programs, n_sup, z)
    k4f_err = k4b_err = 0.0
    checked = []
    kernels = ("lstm_fwd_sweep", "lstm_fwd_step", "tf_attend", "lstm_bwd_sweep", "lstm_bwd_step")
    sweep_points = {"lstm_fwd_sweep": [], "lstm_bwd_sweep": []}  # (S, µs) of each launch
    plans = {}
    for name, params, spec, src, tgt, reinforce_norm in passes:
        dloss = (torch.rand(src.shape[0], generator=gen) + 0.5).to(dev)
        err, e, packed, residual_bytes = k4_pass_against_plain(torch, name, params, spec, src, tgt,
                                                               reinforce_norm, dloss)
        k4f_err, k4b_err = max(k4f_err, err), max(k4b_err, e)
        # K4f and K4b alone under the profiler: one encoder sweep a layer each
        # way; the decoder a step launch a step, K4b no forward kernel.
        S, L = src.shape[1] + 1, spec.num_layers
        steps = tgt.shape[1] + (0 if reinforce_norm else 1)
        times = {}
        times["K4f"] = launch_times(
            torch, lambda: tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True), kernels)
        _, residuals = tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True)
        times["K4b"] = launch_times(torch, lambda: tf_backward_cuda(residuals, dloss), kernels)
        inside = {k: {n: len(v) for n, v in t.items()} for k, t in times.items()}
        plans[name] = {"forward": tf_sweep_plan(src.shape[0], spec.hidden_size, forward=True),
                       "reverse": tf_sweep_plan(src.shape[0], spec.hidden_size)}
        log(f"[K4 {name}] launches inside one K4f and one K4b: {inside}; encoder sweep plans "
            f"{plans[name]}")
        check(inside == {"K4f": {"lstm_fwd_sweep": L, "lstm_fwd_step": steps, "tf_attend": steps,
                                 "lstm_bwd_sweep": 0, "lstm_bwd_step": 0},
                         "K4b": {"lstm_fwd_sweep": 0, "lstm_fwd_step": 0, "tf_attend": 0,
                                 "lstm_bwd_sweep": L, "lstm_bwd_step": steps}},
              f"K4 {name} launches {inside}")
        sweep_points["lstm_fwd_sweep"] += [(S, us) for us in times["K4f"]["lstm_fwd_sweep"]]
        sweep_points["lstm_bwd_sweep"] += [(S, us) for us in times["K4b"]["lstm_bwd_sweep"]]
        checked.append((name, params, spec, src, tgt, reinforce_norm, packed, dloss,
                        residual_bytes))

    # A sweep's time against its steps, over the four passes' launches.
    sweep_fit = {}
    for kernel, points in sweep_points.items():
        a, b = fit_steps(points)
        sweep_fit[kernel] = {"a_us": a, "b_us": b, "points": points}
        log(f"[sweep] {kernel}: time = a + b * S over {len(points)} launches at S = "
            f"{sorted({p[0] for p in points})}: a = {a:.2f} µs, b = {b:.3f} µs a step")

    # The objective on the card against the same call on the CPU at the card's z.
    cpu = make_trainer("cpu", "cpu_run")
    copy_into(cpu.params, init)
    objective_against_cpu(torch, trainer, cpu, batch, z, torch.tensor(0.25, device=dev))

    # The trainer on the card: K4f and K4b four times a step, K1 and K3f once.
    steps = 20
    counters = (fused_sampling_forward, lm_forward_cuda, lm_backward_cuda, tf_forward_cuda,
                tf_backward_cuda)
    for fn in counters:
        fn.launches = 0
    gemm_launches(reset=True)
    step_logs = [trainer.step() for _ in range(steps)]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    GEMM_PATH["launches"]["question_coding"] = gemm_launches()
    check(GEMM_PATH["launches"]["question_coding"] > 0, "the GEMM never ran in question_coding")
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
    shutil.copy(ckpt, qc_out)

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

    # Times per pass, each beside its bound: K4f keeping its residuals (as
    # the trainer runs it) and lean, K4b alone from fresh residuals; cuDNN's
    # LSTM over each pass's encoder (same lengths) as a partial yardstick:
    # its forward, and its backward alone (forward outside the timed region).
    per_pass = {}
    lstm = torch.nn.LSTM(pg_spec.input_size, pg_spec.hidden_size, pg_spec.num_layers,
                         batch_first=True).to(dev)
    for name, params, spec, src, tgt, reinforce_norm, packed, dloss, residual_bytes in checked:
        def keep():
            return tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True)[1]

        fwd_ms = cuda_ms(torch, keep, iters=10)
        lean_ms = cuda_ms(torch, lambda: tf_forward_cuda(packed, spec, src, tgt, reinforce_norm),
                          iters=10)
        bwd_ms = cuda_ms_each(torch, keep, lambda res: tf_backward_cuda(res, dloss), iters=10)
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
        xg = x.clone().requires_grad_(True)
        out = lstm(torch.nn.utils.rnn.pack_padded_sequence(xg, lens, batch_first=True,
                                                           enforce_sorted=False))[0].data.sum()
        cudnn_bwd = cuda_ms(torch, lambda: out.backward(retain_graph=True), iters=10)
        del out, xg
        per_pass[name] = dict(fwd_ms=fwd_ms, lean_ms=lean_ms, bwd_ms=bwd_ms, fwd_plain=fwd_plain,
                              bwd_plain=bwd_plain,
                              work=tf_work(spec, src_np, tgt_np, reinforce_norm, residual_bytes),
                              cudnn_fwd=cudnn_fwd, cudnn_bwd=cudnn_bwd)
        (ff, fb), (bf, bb) = per_pass[name]["work"]
        log(f"[time] {name}: K4f {fwd_ms:.3f} ms keeping its residuals, {lean_ms:.3f} lean (plain "
            f"{fwd_plain:.3f}, bound {bound(ff, fb, 'float32')[0]:.4f}: {ff / 1e9:.2f} GFLOP), K4b "
            f"{bwd_ms:.3f} ms (plain {bwd_plain:.3f}, bound {bound(bf, bb, 'float32')[0]:.4f}: "
            f"{bf / 1e9:.2f} GFLOP, {bb / 1e6:.1f} MB); cuDNN LSTM encoder, recurrence only: "
            f"{cudnn_fwd:.3f} forward, {cudnn_bwd:.3f} backward alone")

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
    step_mb = transient_mb(torch, trainer.step)
    log(f"[time] K4f, the four passes of a step: {total_of('fwd_ms'):.3f} ms keeping residuals, "
        f"{total_of('lean_ms'):.3f} lean (plain {total_of('fwd_plain'):.3f}, bound {k4f_bound:.4f} by "
        f"{k4f_by}: {f_flops / 1e9:.2f} GFLOP); K4b {total_of('bwd_ms'):.3f} ms (plain "
        f"{total_of('bwd_plain'):.3f}, bound {k4b_bound:.4f} by {k4b_by}: {b_flops / 1e9:.2f} GFLOP, "
        f"{b_bytes / 1e6:.1f} MB); cuDNN LSTM over the four encoders: {total_of('cudnn_fwd'):.3f} "
        f"forward, {total_of('cudnn_bwd'):.3f} backward alone; residuals kept "
        f"{sum(c[-1] for c in checked) / 1e6:.1f} MB")
    log(f"[time] question_coding train step {step_ms:.3f} ms (host clock, logs fetched each step): "
        f"{batch_size / step_ms * 1e3:.1f} examples/s; peak memory of a step beyond what was "
        f"allocated before it {step_mb:.1f} MB; K4 bound {k4f_bound + k4b_bound:.4f} ms; card {smi}")
    wall_ms, busy_ms, top, counts = trace(torch, trainer.step)
    if busy_ms > 0:
        log(f"[trace] question_coding train step under torch.profiler: {wall_ms:.2f} ms host clock, "
            f"device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for us, name, count in top:
            log(f"[trace]   {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("[trace] the profiler recorded no device time: idle share not measured")
    step_launches = {k: launches_of(counts, k) for k in kernels}
    # Each encoder layer of the four K4f passes, and each layer of K3f, is one
    # forward sweep; the decoder's steps alone launch lstm_fwd_step.
    log(f"[trace] launches in that step: {step_launches}")
    check(step_launches["lstm_bwd_sweep"] == 4 * pg_spec.num_layers
          and step_launches["lstm_bwd_step"] == step_launches["tf_attend"]
          and step_launches["lstm_fwd_step"] == step_launches["tf_attend"]
          and step_launches["lstm_fwd_sweep"] == 4 * pg_spec.num_layers
          + trainer.prior_spec.num_layers,
          f"question_coding step launches {step_launches}")
    gemm_in_step(torch, "question_coding", trainer.step)
    shutil.rmtree(work, ignore_errors=True)

    passes_ms = {name: {"ms": p["fwd_ms"], "lean_ms": p["lean_ms"], "backward_ms": p["bwd_ms"]}
                 for name, p in per_pass.items()}
    return [
        {"name": "tf_forward", "route": "cuda", "source": "probnmn_tpu_torch/csrc/tf_train.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:163",
         "launches": launches["tf_forward_cuda"], "max_abs_err": k4f_err,
         "ms": total_of("fwd_ms"), "lean_ms": total_of("lean_ms"), "plain_ms": total_of("fwd_plain"),
         "bound_ms": k4f_bound, "bound_by": k4f_by, "library_ms": None,
         "yardstick": "cuDNN LSTM over the four encoders, forward, recurrence only",
         "yardstick_ms": total_of("cudnn_fwd"), "per_pass": passes_ms,
         "sweep_plans": plans, "sweep_fit": sweep_fit["lstm_fwd_sweep"],
         "step_launches": {k: step_launches[k] for k in ("lstm_fwd_sweep", "lstm_fwd_step")}},
        {"name": "tf_backward", "route": "cuda", "source": "probnmn_tpu_torch/csrc/tf_train.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:285",
         "launches": launches["tf_backward_cuda"], "max_abs_err": k4b_err,
         "ms": total_of("bwd_ms"), "plain_ms": total_of("bwd_plain"), "bound_ms": k4b_bound,
         "bound_by": k4b_by, "library_ms": None,
         "yardstick": "cuDNN LSTM over the four encoders, backward alone, recurrence only",
         "yardstick_ms": total_of("cudnn_bwd"), "step_mb": step_mb,
         "residual_mb": sum(c[-1] for c in checked) / 1e6, "step_launches": step_launches,
         "sweep_fit": sweep_fit["lstm_bwd_sweep"]},
    ]


# The GEMM of K3/K4 (gemm.cu) on the paths of phases 6 and 7: its launches
# over their 20 steps, the shape of each launch of one step, and its device
# time inside one step under the profiler; phase 11 reads them.
GEMM_PATH = {"launches": {}, "records": {}, "in_step": {}}
GEMM_TOL = 1e-5  # of the sum of |products| (+ |bias| + |C|) in float64


def gemm_in_step(torch, phase, step):
    r"""Records the shape of every GEMM launch of one ``step()`` and times
    the GEMM's kernels inside another under the profiler."""
    from probnmn_tpu_torch.ops.kernels.gemm import gemm_record, gemm_records

    gemm_record(True)
    step()
    torch.cuda.synchronize()
    gemm_record(False)
    GEMM_PATH["records"][phase] = gemm_records()
    times = launch_times(torch, step, ("gemm_tile", "gemm_reduce"))
    GEMM_PATH["in_step"][phase] = {k: (len(v), sum(v) / 1e3) for k, v in times.items()}
    log(f"[gemm] {phase} step: {len(GEMM_PATH['records'][phase])} GEMM launches recorded; under "
        f"the profiler {GEMM_PATH['in_step'][phase]} (launches, ms)")


def gemm_operand(torch, rows, cols, strides, gen, dev):
    r"""A (rows, cols) float32 tensor on the card with the given strides."""
    t = torch.empty_strided((rows, cols), strides, device=dev)
    t.copy_(torch.randn(rows, cols, generator=gen))
    return t


def gemm_against_float64(np, torch, dev, smi):
    r"""Phase 11: every shape class of the GEMM launches of one program_prior
    step and one question_coding step (phases 6 and 7's records), on random
    operands with the launch's strides: within GEMM_TOL of float64, the same
    bits twice, then timed on the card (``graph_ms``) beside its bound,
    the plain version and one cuBLAS float32 call (TF32 off) on the same
    views. Returns the GEMM's entry of the kernels line."""
    from probnmn_tpu_torch.ops.kernels.gemm import gemm_cuda, gemm_plain, gemm_work

    keys = ("M", "N", "K", "sam", "sak", "sbk", "sbn", "splits", "bias", "accumulate", "tile_m",
            "tile_n")
    gen = torch.Generator().manual_seed(11)
    classes, worst, totals = [], 0.0, {}
    for phase in ("program_prior", "question_coding"):
        counts = {}
        for r in GEMM_PATH["records"][phase]:
            key = tuple(r[k] for k in keys)
            counts[key] = counts.get(key, 0) + 1
        total = dict.fromkeys(("launches", "ms", "library_ms", "plain_ms", "bound_ms",
                               "ops_ms", "bytes_ms"), 0.0)
        for key, count in sorted(counts.items(), key=lambda kv: -kv[0][0] * kv[0][1] * kv[0][2]):
            M, N, K, sam, sak, sbk, sbn, splits, has_bias, acc, tile_m, tile_n = key
            a = gemm_operand(torch, M, K, (sam, sak), gen, dev)
            b = gemm_operand(torch, K, N, (sbk, sbn), gen, dev)
            bias = torch.randn(N, generator=gen).to(dev) if has_bias else None
            c0 = torch.randn(M, N, generator=gen).to(dev) if acc else None
            split = splits > 1

            def run(out=None):
                return gemm_cuda(a, b, bias=bias, out=out, accumulate=bool(acc), split=split)

            got = [run(c0.clone() if acc else None) for _ in range(2)]
            want = a.double() @ b.double()
            scale = a.double().abs() @ b.double().abs()
            for extra in (bias, c0):
                if extra is not None:
                    want, scale = want + extra.double(), scale + extra.double().abs()
            err = (got[0].double() - want).abs()
            rel = float((err / scale.clamp_min(1e-30)).max())
            check(bool((err <= GEMM_TOL * scale + 1e-30).all()),
                  f"GEMM {key} against float64: {rel:.2e} of the sum of |products|")
            check(torch.equal(got[0], got[1]), f"GEMM {key} differs between two runs")
            worst = max(worst, float(err.max()))
            out = torch.empty(M, N, device=dev)
            ms = graph_ms(torch, lambda: run(c0 if acc else out))
            plain_ms = graph_ms(torch, lambda: gemm_plain(a, b, bias, c0 if acc else out,
                                                          bool(acc)))
            if has_bias:
                library = lambda: torch.addmm(bias, a, b, out=out)  # noqa: E731
            elif acc:
                library = lambda: c0.addmm_(a, b)  # noqa: E731
            else:
                library = lambda: torch.mm(a, b, out=out)  # noqa: E731
            library_ms = graph_ms(torch, library)
            flops, nbytes = gemm_work(M, N, K, bool(has_bias), bool(acc))
            b_ms, b_by = bound(flops, nbytes, "float32")
            pattern = ("t" if sam == 1 and sak != 1 else "n") + ("n" if sbn == 1 else "t")
            entry = {"phase": phase, "launches_per_step": count, "M": M, "N": N, "K": K,
                     "pattern": pattern, "splits": splits, "bias": bool(has_bias),
                     "accumulate": bool(acc), "tile": [tile_m, tile_n], "ms": ms,
                     "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "gflop": flops / 1e9, "mb": nbytes / 1e6, "max_rel_err": rel}
            classes.append(entry)
            log(f"[gemm] {phase} x{count:<3d} {M}x{N}x{K} {pattern} split {splits} "
                f"{'bias ' if has_bias else ''}{'acc ' if acc else ''}tile {tile_m}x{tile_n}: "
                f"{ms:.4f} ms "
                f"(cuBLAS {library_ms:.4f}, plain {plain_ms:.4f}, bound {b_ms:.4f} by {b_by}: "
                f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; {flops / ms / 1e9:.1f} TFLOP/s); "
                f"err {rel:.1e} of the sum of |products|")
            total["launches"] += count
            for name, value in (("ms", ms), ("library_ms", library_ms), ("plain_ms", plain_ms),
                                ("bound_ms", b_ms)):
                total[name] += count * value
            total["ops_ms" if b_by == "operations" else "bytes_ms"] += count * b_ms
        totals[phase] = total
        in_step = GEMM_PATH["in_step"][phase]
        log(f"[gemm] {phase} step, the GEMM's {int(total['launches'])} launches one at a time: "
            f"{total['ms']:.3f} ms (cuBLAS float32 {total['library_ms']:.3f}, plain "
            f"{total['plain_ms']:.3f}, bound {total['bound_ms']:.4f}); inside the step under the "
            f"profiler {sum(ms for _, ms in in_step.values()):.3f} ms ({in_step}); card {smi}")
    qc = totals["question_coding"]
    return {"name": "gemm", "route": "cuda", "source": "probnmn_tpu_torch/csrc/gemm.cu",
            "replaces": "probnmn_tpu/ops/pallas/seq2seq_train.py:193",
            "launches": GEMM_PATH["launches"]["question_coding"],
            "launches_program_prior": GEMM_PATH["launches"]["program_prior"],
            "max_abs_err": worst, "ms": qc["ms"], "plain_ms": qc["plain_ms"],
            "bound_ms": qc["bound_ms"],
            "bound_by": "operations" if qc["ops_ms"] >= qc["bytes_ms"] else "bytes",
            "library_ms": qc["library_ms"], "per_step": totals,
            "in_step_ms": {p: v for p, v in GEMM_PATH["in_step"].items()}, "classes": classes}


# The program phase 8's scripted generator emits: scene, an attention
# (filter: two convs and a head), relate (five convs and a head), same, a
# no-op and query (two convs): nine 3x3 convs that run.
SCRIPTED_PROGRAM = ["query_color", "unique", "same_shape", "relate[left]", "filter_color[red]",
                    "scene"]
# K6 against autograd through the plain machine (as tests/test_torch_port_cuda.py):
# float32 within 1e-4 of each leaf's scale; bfloat16 within 1e-1. The plain
# version rounds every gradient to bfloat16 where its forward rounds a value;
# the kernel rounds only g_z and the heads' g, as the JAX kernel does: the two
# differ by up to 7.7% of a leaf's scale on this phase's batch. That bound
# is coarse, so the tensor-core pieces are also held tightly, on the operands
# K6 itself wrote: its weight-gradient kernel and its conv input gradients
# against float64 sums over its workspace (``workspace_errors``), within
# 1e-5 of the sum of |products| in both dtypes, where a CLEVR batch at full
# width reads a few 1e-6 or less (this phase prints it; PERF.md records it).
# A dropped tap or a g_z off by a pixel reads above 1e-2
# (tests/test_torch_port_module_training.py).
K6_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
WS_TOL = 1e-5


def mt_arrays(np, vocab, n, n_images, seed):
    r"""``n`` module_training examples: CLEVR-like programs and random
    questions (each with a full-length and an all-pad row), answers in 28 and
    indices into ``n_images`` images."""
    programs, questions = qc_questions(np, vocab, n, seed)
    rs = np.random.RandomState(seed + 2)
    answers = rs.randint(0, vocab.get_vocab_size("answers") - 1, n)
    return programs, questions, answers, rs.randint(0, n_images, n)


def k5_k6_work(tables, spec, programs, itemsize, bank_floats):
    r"""FLOPs and bytes K5 and K6 need for these programs. K5: K2's work
    (:func:`k2_work`) plus the residuals it writes (the out register at
    every step run, the two conv outputs of every two-conv step). K6, over
    the valid rows: each conv's input and weight gradients (twice its
    forward), relate's chain recomputed, compare's projection recomputed and
    its two gradients, the heads' gradients; stem features and the float32
    cotangent in, the residuals read, d(stem) and the gradient banks (in
    the banks' type) out."""
    run = nmn_replay(tables, programs)
    valid = run["valid"]
    C, HW = spec.module_channels, spec.height * spec.width
    N, B = HW * C, len(programs)
    k2_flops, k2_bytes, convs = k2_work(tables, spec, programs, itemsize)
    resid = lambda w: (w["steps"] + 2 * w["two_conv"]) * N * itemsize  # noqa: E731
    mac = 2.0 * C * C
    flops6 = (2 * mac * conv_pixels(spec, valid) + mac * valid["relates"] * relate_pixels(spec)
              + 3 * valid["proj"] * 2 * HW * 2 * C * C + 2 * valid["heads"] * 2 * HW * C
              + valid["sames"] * 8 * HW * C)
    bytes6 = 2 * B * N * itemsize + B * N * 4 + resid(valid) + bank_floats * itemsize
    return (k2_flops, k2_bytes + resid(run)), (flops6, bytes6), convs, run


def weight_grad_check(torch, ws, banks, spec):
    r"""K6's weight-gradient kernel (the float32 dw3 / dwc in its workspace
    ``ws``) against ``weight_grad_plain`` on the same entries: the largest
    difference over a target over the largest sum of |products| there (the
    plain version on |inp| and |g_z|), held to ``WS_TOL``; a target without
    entries must be exactly 0. Returns (error, empty targets)."""
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import weight_grad_plain

    s3, sc = banks["w3"].shape[0], banks["wcmp"].shape[0]
    args = (ws["tag"], ws["dil"], s3, sc, spec.height, spec.width)
    want = weight_grad_plain(ws["inp"], ws["g"], *args)
    scale = weight_grad_plain(ws["inp"].abs(), ws["g"].abs(), *args)
    got = (ws["dw3"].flatten(1), ws["dwc"].flatten(2).flatten(0, 1))
    want = (want[0].flatten(1), want[1].flatten(2).flatten(0, 1))
    scale = (scale[0].flatten(1), scale[1].flatten(2).flatten(0, 1))
    err, empty = 0.0, 0
    for a, b, top in zip(got, want, scale):
        top = top.amax(1)
        err = max(err, float(((a - b).abs().amax(1) / top.clamp_min(1e-30)).max()))
        empty += int((top == 0).sum())
        check(not bool(a[top == 0].any()), "K6's weight gradient of a target without entries is not 0")
    check(err <= WS_TOL, f"K6's weight-gradient kernel against weight_grad_plain: {err}")
    return err, empty


def k5_k6_against_plain(torch, gen, name, dtype, params, spec, tables, feats, programs,
                        tag=""):
    r"""K5 and K6 in ``dtype`` on the NMN ``params`` over ``feats`` (through
    the stem) and ``programs``: K5's final and flags equal K2's bit for bit,
    its flags the plain version's and its final within K2's tolerances of
    the plain version's (bfloat16) or of the float64 branch's (float32);
    every K6 leaf under a
    random cotangent drawn from ``gen`` within ``K6_TOL`` * max(1, max|g|)
    of its reference: in float32 the float64 gradient of the branch K5 and
    K6 took (``interpreter_grads_on_branch``; every decision float64 takes
    the other way within ``BRANCH_TOL`` of its tie, every workspace entry
    where the sweep order puts it), in bfloat16 autograd through the plain
    version (``interpreter_grads_plain_by_row``); bitwise repeatable, dx 0
    on invalid rows; its weight-gradient kernel and conv input gradients
    within ``WS_TOL`` of float64 sums over its workspace, and of
    ``weight_grad_plain``. Returns what it ran and found."""
    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        BRANCH_TOL, DIFF_BANKS, build_banks, execute_programs_kernel, execute_programs_plain,
        execute_programs_train_kernel, interpreter_grads_kernel, interpreter_grads_on_branch,
        interpreter_grads_plain_by_row, workspace_errors,
    )

    batch = len(programs)
    stem = nmn.apply_stem(cast_params(params["stem"], dtype), feats.to(dtype)).contiguous()
    banks = build_banks(params, spec, dtype)
    final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
    out2, inv2 = execute_programs_kernel(banks, tables, spec, stem, programs)
    want, want_inv = execute_programs_plain(banks, tables, spec, stem, programs)
    torch.cuda.synchronize()
    check(torch.equal(final, out2) and torch.equal(invalid, inv2), f"K5{tag} {name} differs from K2")
    check(torch.equal(invalid, want_inv), f"K5{tag} {name} invalid flags differ")
    g = torch.randn(final.shape, generator=gen).to(final.device).to(dtype).float()
    ws = {}
    d_banks, d_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                               otraj, atraj, workspace=ws)
    again_banks, again_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs,
                                                       invalid, g, otraj, atraj)
    if dtype == torch.float32:
        # K5's final too against the branch's: the batched plain forward can
        # take a tie the other way (same's argmax moves a whole step).
        w_banks, w_stem, want, branch = interpreter_grads_on_branch(
            banks, tables, spec, stem, programs, g, invalid, otraj, atraj, ws)
        check(branch["far"] == 0 and branch["entries"] == 0 and branch["rows"] == 0,
              f"K6{tag} {name} took decisions off float64's by more than {BRANCH_TOL} of their "
              f"scale, or its workspace or rows are not where the sweep puts them: {branch}")
        reference = (f"the float64 gradient of the branch K5 and K6 took ({branch['taken']} "
                     f"decisions that float64 takes the other way, within {branch['gap']:.2e} "
                     f"of their scale: ties broken by rounding)")
    else:
        w_banks, w_stem, alone = interpreter_grads_plain_by_row(
            banks, tables, spec, stem, programs, g, d_stem, K6_TOL[name])
        reference = ("autograd through the plain version, rows held to it run alone, with the "
                     f"ReLU outputs whose sign the batched plain forward flips against K5's: "
                     f"{alone or 'none'}")
    torch.cuda.synchronize()
    err = float((final.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    check(err <= (1e-4 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale),
          f"K5{tag} {name} error {err}")
    check(torch.equal(d_stem, again_stem) and all(
        torch.equal(d_banks[k], again_banks[k]) for k in DIFF_BANKS), f"K6{tag} {name} bits differ")
    check(not bool(invalid.any()) or float(d_stem[invalid].float().abs().max()) == 0.0,
          f"K6{tag} {name} dx on invalid rows")
    worst = (0.0, 0.0, 0.0, "")
    for leaf, got, ref in [("stem", d_stem, w_stem)] + [(k, d_banks[k], w_banks[k])
                                                         for k in DIFF_BANKS]:
        e, sc = float((got.float() - ref.float()).abs().max()), float(ref.float().abs().max())
        worst = max(worst, (e / max(1.0, sc), e, sc, leaf))
        check(e <= K6_TOL[name] * max(1.0, sc), f"K6{tag} {name} {leaf} error {e} (max |g| {sc})")
    tight = workspace_errors(ws, banks, tables, spec)
    check(tight["weight_grad"] <= WS_TOL and tight["input_grad"] <= WS_TOL,
          f"K6{tag} {name} against float64 sums over its own workspace: {tight}")
    wg_err, wg_empty = weight_grad_check(torch, ws, banks, spec)
    log(f"[K5{tag} {name}] B={batch}: equal to K2 bit for bit; invalid {int(invalid.sum())}/{batch} "
        f"as the plain version; max |final err| {err:.3e} (max |final| {scale:.3e}) against "
        f"{'the float64 branch' if dtype == torch.float32 else 'the plain version'}")
    log(f"[K6{tag} {name}] reference: {reference}")
    log(f"[K6{tag} {name}] every leaf within {K6_TOL[name]} * max(1, max|g|) of its reference; "
        f"worst {worst[3]}: max |err| {worst[1]:.3e}, max |grad| {worst[2]:.3e} (ratio "
        f"{worst[0]:.3e}); bitwise repeatable; dx 0 on invalid rows")
    log(f"[K6{tag} {name}] against float64 sums over its own {tight['entries']} workspace entries "
        f"(error over the sum of |products|, limit {WS_TOL}): weight-gradient kernel "
        f"{tight['weight_grad']:.3e}; conv input gradients of {tight['chained']} chained "
        f"entries {tight['input_grad']:.3e}")
    log(f"[K6{tag} {name}] weight-gradient kernel against weight_grad_plain on the same entries "
        f"(error over the sum of |products|, limit {WS_TOL}): {wg_err:.3e}; {wg_empty} targets "
        f"without entries exactly 0")
    return dict(banks=banks, stem=stem, invalid=invalid, otraj=otraj, atraj=atraj, g=g, ws=ws,
                err=err, worst=worst[1], tight=tight, wg_err=wg_err)


def weight_grad_work(ws, banks, spec, itemsize):
    r"""FLOPs and bytes K6's weight-gradient stage needs for the entries in
    its workspace ``ws``: 2 * C * C for each pixel a tap of an entry reads
    inside the image (:func:`tap_pixels` at the entry's dilation, 0 for a
    1x1 entry); the entries' inputs and g_z read once, dw3 and dwc written
    once in float32."""
    s3, sc = banks["w3"].shape[0], banks["wcmp"].shape[0]
    c, hw = spec.module_channels, spec.height * spec.width
    live = ws["tag"] < s3 + 2 * sc
    dils, counts = ws["dil"][live].unique(return_counts=True)
    pixels = sum(tap_pixels(spec.height, spec.width, int(d)) * int(n) for d, n in zip(dils, counts))
    flops = 2.0 * c * c * pixels
    nbytes = 2 * int(live.sum()) * hw * c * itemsize + (9 * s3 + 2 * sc) * c * c * 4
    return flops, nbytes


def k6_parts(torch, fn, calls=3):
    r"""K6's parts by device time under ``torch.profiler`` over ``calls``
    calls of ``fn``, in ms a call: the sweep (``nmn_backward_kernel``), the
    weight-gradient stage (every ``nmn_weight_grad*`` kernel), the small
    banks' row sums (``nmn_sum_rows_kernel``) and the glue (every other
    device op: the plan's sort and counts, the host read's copy, fills,
    casts). Returns the parts and, by kernel name, (ms, launches) a call."""
    from torch.autograd import DeviceType

    fn()
    prof, _ = profiled(torch, lambda: [fn() for _ in range(calls)])
    parts = dict.fromkeys(("sweep", "weight_grad", "row_sums", "glue"), 0.0)
    kernels = {}
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        name = event.key
        part = ("sweep" if "nmn_backward_kernel" in name else
                "weight_grad" if "nmn_weight_grad" in name else
                "row_sums" if "nmn_sum_rows" in name else "glue")
        parts[part] += us / 1e3 / calls
        kernels[name[:70]] = (round(us / 1e3 / calls, 4), event.count // calls)
    return parts, kernels


def weight_grad_memory(ws, channels):
    r"""The weight-gradient kernel's chunk (entries) and its partials' bytes
    for the workspace ``ws``: both follow from the workspace's entry count."""
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import weight_grad_chunk, weight_grad_slots

    n = ws["tag"].numel()
    return weight_grad_chunk(n), weight_grad_slots(n) * 9 * channels * channels * 4


def train_module_training(np, torch, dev, gen, vocab, smi, qc_ckpt, mt_out):
    r"""Phase 8: kernels K5 and K6 against K2 and their plain versions at
    full NMN width, 20 trainer steps on the card in two program regimes
    (launch counts, 3x3 convs per step), one float32 step against the CPU's,
    the evaluator in both decode modes, checkpoint and resume, and times.
    Copies the valid-programs run's checkpoint to ``mt_out`` (phase 9's NMN)
    and returns the two kernels' entries of the kernels line."""
    import shutil
    import tempfile

    import torch.nn.functional as F

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import ModuleTrainingDataset
    from probnmn_tpu_torch.evaluators.module_training_evaluator import ModuleTrainingEvaluator
    from probnmn_tpu_torch.models import program_generator
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        DIFF_BANKS, execute_programs_kernel, execute_programs_plain,
        execute_programs_train_kernel, interpreter_grads_kernel, interpreter_grads_plain,
        weight_grad_kernel,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward
    from probnmn_tpu_torch.training._trainer import copy_into, tree_leaves, tree_map
    from probnmn_tpu_torch.training.module_training_trainer import ModuleTrainingTrainer
    from probnmn_tpu_torch.utils.checkpointing import save_objects
    from probnmn_tpu_torch.utils.clevr import sample_clevr_like_programs
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_mt_")
    vocab.save_to_files(os.path.join(work, "vocab"))

    def config(ckpt, *extra):
        return Config(os.path.join(repo, "configs", "module_training.yml"),
                      ["DATA.VOCABULARY", os.path.join(work, "vocab"),
                       "CHECKPOINTS.QUESTION_CODING", ckpt, *extra])

    t0 = time.perf_counter()
    features = np.random.default_rng(10).standard_normal((512, 1024, 14, 14), dtype=np.float32)
    train_set = ModuleTrainingDataset.from_arrays(*mt_arrays(np, vocab, 8192, 512, seed=11),
                                                  features)
    val_set = ModuleTrainingDataset.from_arrays(*mt_arrays(np, vocab, 1024, 512, seed=13),
                                                features, split="val")
    cfg = config(qc_ckpt)
    pg_spec = program_generator.make_spec(vocab, cfg)
    scripted_ckpt = os.path.join(work, "scripted_generator.ckpt")
    save_objects(scripted_ckpt, {"program_generator": scripted_generator(
        torch, program_generator.init_params(gen, pg_spec), pg_spec, vocab, SCRIPTED_PROGRAM)})
    log(f"[mt] {len(train_set)} train / {len(val_set)} val questions over 512 images of "
        f"(1024, 14, 14) float32 ({features.nbytes / 1e6:.0f} MB), made in "
        f"{time.perf_counter() - t0:.1f} s; batch {cfg.OPTIM.BATCH_SIZE}, lr {cfg.OPTIM.LR_INITIAL}")

    def make_trainer(ckpt, name, device="cuda", *extra):
        return ModuleTrainingTrainer(config(ckpt, *extra), os.path.join(work, name), device=device,
                                     writer=RecordingWriter(), dataset=train_set)

    trainer = make_trainer(qc_ckpt, "early_abort")
    spec, tables, batch = trainer.nmn_spec, trainer.tables, cfg.OPTIM.BATCH_SIZE
    init = tree_map(lambda t: t.detach().clone(), trainer.params["nmn"])

    # K5 and K6 at full width: valid CLEVR programs, token soups (mostly
    # invalid), an all-pad row and a program with no scene.
    programs_np = sample_clevr_like_programs(vocab, batch, seed=12)
    rs = np.random.RandomState(14)
    programs_np[-8:] = rs.randint(0, len(vocab.get_index_to_token_vocabulary("programs")),
                                  (8, programs_np.shape[1]))
    programs_np[-1] = 0
    programs_np[-2, :] = 0
    programs_np[-2, :2] = [vocab.get_token_index("count", "programs"),
                           vocab.get_token_index("filter_color[red]", "programs")]
    programs = torch.from_numpy(programs_np).to(dev)
    feats = torch.randn(batch, spec.height, spec.width, spec.feature_channels, generator=gen).to(dev)
    errs, timed = {}, {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        checked = k5_k6_against_plain(torch, gen, name, dtype, init, spec, tables, feats, programs)
        invalid, ws = checked["invalid"], checked["ws"]
        check(not bool(invalid[:batch - 8].any()) and bool(invalid[-2]) and not bool(invalid[-1]),
              f"K5 {name} invalid/all-pad rows")
        chunk, partial = weight_grad_memory(ws, spec.module_channels)
        errs[name] = (checked["err"], checked["worst"], checked["tight"], checked["wg_err"])
        log(f"[K6 {name}] chunks of {chunk} entries, partials {partial / 1e6:.1f} MB")
        timed[name] = tuple(checked[k] for k in ("banks", "stem", "invalid", "otraj", "atraj", "g"))
        wg_work = (weight_grad_work(ws, checked["banks"], spec, checked["stem"].element_size()),
                   partial)

    # The trainer on the card in two regimes: K1, K5 and K6 (its sweep and its
    # weight-gradient stage) once a step, K2 never.
    counters = (fused_sampling_forward, execute_programs_train_kernel, interpreter_grads_kernel,
                weight_grad_kernel, execute_programs_kernel)
    steps = 20

    def run_regime(tr, name):
        sampled = []
        sample = tr.sample_programs

        def recording(questions):
            z = sample(questions)
            sampled.append(z)
            return z

        tr.sample_programs = recording
        for fn in counters:
            fn.launches = 0
        logs = [tr.step() for _ in range(steps)]
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        tr.sample_programs = sample
        run = nmn_replay(tables, torch.cat(sampled).cpu().numpy())
        losses = [out["loss"] for out in logs]
        log(f"[mt {name}] {steps} train steps on cuda: launches {launches}; loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; invalid programs {batch * steps - run['valid']['rows']}/{batch * steps}"
            f"; 3x3 convs per step {run['convs'] / steps:.1f}")
        check(launches == {"fused_sampling_forward": steps, "execute_programs_train_kernel": steps,
                           "interpreter_grads_kernel": steps, "weight_grad_kernel": steps,
                           "execute_programs_kernel": 0},
              f"launches {launches}")
        check(all(np.isfinite(losses)), f"{name} loss not finite")
        return dict(launches=launches, run=run, losses=losses)

    early = run_regime(trainer, "early abort")
    valid_trainer = make_trainer(scripted_ckpt, "valid")
    valid = run_regime(valid_trainer, "valid programs")
    check(valid["run"]["valid"]["rows"] == batch * steps and valid["run"]["convs"] == 9 * batch * steps,
          "the scripted programs did not all run")

    # One float32 step on 16 rows at the programs the card's K1 sampled,
    # against the same step on the CPU.
    f32 = ("NMN.COMPUTE_DTYPE", "float32", "OPTIM.BATCH_SIZE", 16)
    card = make_trainer(scripted_ckpt, "f32_card", "cuda", *f32)
    host = make_trainer(scripted_ckpt, "f32_cpu", "cpu", *f32)
    copy_into(host.params, tree_map(lambda t: t.detach().cpu(), card.params))
    b16 = next(card._batches)
    z = card.sample_programs(b16["question"])
    loss_card = card.module_training_loss(card.params, b16, z)["loss"].mean()
    loss_card.backward()
    loss_host = host.module_training_loss(
        host.params, {k: v.cpu() for k, v in b16.items()}, z.cpu())["loss"].mean()
    loss_host.backward()
    loss_card, loss_host = float(loss_card.detach()), float(loss_host.detach())
    diff = abs(loss_card - loss_host)
    check(diff <= 1e-4, f"card vs CPU float32 loss {loss_card} / {loss_host}")
    ratio = 0.0
    for index, (a, b) in enumerate(zip(tree_leaves(card.params), tree_leaves(host.params))):
        e, sc = float((a.grad.cpu() - b.grad).abs().max()), float(b.grad.abs().max())
        check(e <= 1e-4 * max(1.0, sc), f"card vs CPU float32 gradient of leaf {index}: {e}")
        ratio = max(ratio, e / max(1.0, sc))
    log(f"[mt] float32 step on 16 rows at the card's K1 programs, card vs CPU: loss "
        f"{loss_card:.6f} / {loss_host:.6f} (|diff| {diff:.2e}); every gradient leaf "
        f"within 1e-4 * max(1, max|g|) (worst ratio {ratio:.3e})")

    # The evaluator in both decode modes (K2 over banks rebuilt from the live
    # params), the checkpoint, and a resume from it.
    for decode in ("tf_greedy", "free_greedy"):
        execute_programs_kernel.launches = 0
        val = ModuleTrainingEvaluator(cfg, valid_trainer, dataset=val_set,
                                      program_decode=decode).evaluate(num_batches=2)
        check(execute_programs_kernel.launches == 2, f"the {decode} evaluator did not run K2")
        check(0.0 <= val["nmn"]["answer_accuracy"] <= 1.0
              and 0.0 <= val["nmn"]["average_invalid"] <= batch, f"{decode} metrics {val}")
        log(f"[mt] val ({decode}, 2 batches): answer_accuracy {val['nmn']['answer_accuracy']:.4f}, "
            f"average_invalid {val['nmn']['average_invalid']:.2f}")
    valid_trainer.after_validation(val, steps - 1)
    resumed = make_trainer(scripted_ckpt, "valid")
    resumed.load_checkpoint(os.path.join(work, "valid", f"checkpoint_{steps - 1}.ckpt"))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                                 tree_leaves(valid_trainer.params)))
    check(same and resumed.iteration == steps - 1, "resume from the checkpoint")
    log(f"[mt] checkpoint_{steps - 1}.ckpt written and resumed with identical params")
    shutil.copy(os.path.join(work, "valid", f"checkpoint_{steps - 1}.ckpt"), mt_out)

    # Times, each beside its bound, on the bf16 check batch.
    banks, stem, invalid, otraj, atraj, g = timed["bfloat16"]
    k5_ms = cuda_ms(torch, lambda: execute_programs_train_kernel(banks, tables, spec, stem, programs),
                    iters=10)
    k2_ms = cuda_ms(torch, lambda: execute_programs_kernel(banks, tables, spec, stem, programs),
                    iters=10)
    k6_ms = cuda_ms(torch, lambda: interpreter_grads_kernel(banks, tables, spec, stem, programs,
                                                            invalid, g, otraj, atraj), iters=10)
    k5_plain = cuda_ms(torch, lambda: execute_programs_plain(banks, tables, spec, stem, programs,
                                                             record=True), iters=2, warmup=1)
    k6_plain = cuda_ms(torch, lambda: interpreter_grads_plain(banks, tables, spec, stem, programs, g),
                       iters=2, warmup=1)
    bank_floats = sum(banks[k].numel() for k in DIFF_BANKS)
    (f5, b5), (f6, b6), n_convs, run = k5_k6_work(tables, spec, programs_np, 2, bank_floats)
    k5_bound, k5_by = bound(f5, b5, "bfloat16")
    k6_bound, k6_by = bound(f6, b6, "bfloat16")
    # Yardstick: cuDNN's bf16 conv over as many 14 x 14 x 128 3x3 convs.
    C = spec.module_channels
    x = torch.randn(n_convs, C, spec.height, spec.width, generator=gen).to(dev, torch.bfloat16)
    w = (0.05 * torch.randn(C, C, 3, 3, generator=gen)).to(dev, torch.bfloat16)
    gy = torch.randn(n_convs, C, spec.height, spec.width, generator=gen).to(dev, torch.bfloat16)
    with torch.no_grad():
        cudnn_fwd = cuda_ms(torch, lambda: F.conv2d(x, w, padding=1), iters=10)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    cudnn_train = cuda_ms(torch, lambda: torch.autograd.grad(F.conv2d(xg, wg, padding=1), (xg, wg), gy),
                          iters=10)
    log(f"[time] K5 {k5_ms:.3f} ms/batch of {batch} (K2 on the same batch {k2_ms:.3f}; plain "
        f"{k5_plain:.3f}; bound {k5_bound:.4f} by {k5_by}: {n_convs} 3x3 convs, {f5 / 1e9:.1f} GFLOP, "
        f"{b5 / 1e6:.1f} MB; cuDNN bf16 conv forward over {n_convs} convs {cudnn_fwd:.3f})")
    log(f"[time] K6 {k6_ms:.3f} ms/batch (plain {k6_plain:.3f}; bound {k6_bound:.4f} by {k6_by}: "
        f"{run['valid']['rows']} valid rows, {f6 / 1e9:.1f} GFLOP, {b6 / 1e6:.1f} MB; cuDNN bf16 conv "
        f"forward + both gradients over {n_convs} convs {cudnn_train:.3f})")
    k6_split, _ = k6_parts(torch, lambda: interpreter_grads_kernel(banks, tables, spec, stem, programs,
                                                                invalid, g, otraj, atraj))
    (wg_flops, wg_bytes), wg_partial = wg_work
    wg_bound, wg_by = bound(wg_flops, wg_bytes, "bfloat16")
    log(f"[K6 parts] B={batch}, bf16, ms a call under torch.profiler: sweep {k6_split['sweep']:.4f}, "
        f"weight gradient {k6_split['weight_grad']:.4f} (bound {wg_bound:.4f} by {wg_by}: "
        f"{wg_flops / 1e9:.1f} GFLOP, {wg_bytes / 1e6:.1f} MB), row sums {k6_split['row_sums']:.4f}, "
        f"glue {k6_split['glue']:.4f}; partials {wg_partial / 1e6:.1f} MB; card {smi}")

    step_ms = {}
    for name, tr in (("early abort", trainer), ("valid programs", valid_trainer)):
        for _ in range(3):
            tr.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            tr.step()
        step_ms[name] = (time.perf_counter() - t0) / 10 * 1e3
        stage = tr._batch_source.stage_metrics()
        log(f"[time] module_training train step, {name}: {step_ms[name]:.3f} ms (host clock, loss "
            f"fetched each step): {batch / step_ms[name] * 1e3:.1f} examples/s; "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()) + f"; card {smi}")
    wall_ms, busy_ms, top, _ = trace(torch, valid_trainer.step)
    if busy_ms > 0:
        log(f"[trace] module_training train step (valid programs) under torch.profiler: {wall_ms:.2f} "
            f"ms host clock, device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for us, name, count in top:
            log(f"[trace]   {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("[trace] the profiler recorded no device time: idle share not measured")
    shutil.rmtree(work, ignore_errors=True)

    regimes = {"early_abort": early["launches"], "valid_programs": valid["launches"]}
    return [
        {"name": "nmn_train_forward", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/nmn_interpreter.cu",
         "replaces": "probnmn_tpu/ops/pallas/nmn_interpreter.py:604",
         "launches": valid["launches"]["execute_programs_train_kernel"],
         "launches_by_regime": {k: v["execute_programs_train_kernel"] for k, v in regimes.items()},
         "max_abs_err": errs["bfloat16"][0], "max_abs_err_float32": errs["float32"][0],
         "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound, "bound_by": k5_by,
         "library_ms": None, "yardstick": "cuDNN bf16 conv2d forward over the same 3x3 convs",
         "yardstick_ms": cudnn_fwd, "k2_ms_same_batch": k2_ms},
        {"name": "nmn_backward", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/nmn_interpreter.cu",
         "replaces": "probnmn_tpu/ops/pallas/nmn_interpreter.py:870",
         "launches": valid["launches"]["interpreter_grads_kernel"],
         "launches_by_regime": {k: v["interpreter_grads_kernel"] for k, v in regimes.items()},
         "max_abs_err": errs["bfloat16"][1], "max_abs_err_float32": errs["float32"][1],
         "ms": k6_ms, "plain_ms": k6_plain, "bound_ms": k6_bound, "bound_by": k6_by,
         "library_ms": None,
         "workspace_err": {k: {e: v[2][e] for e in ("weight_grad", "input_grad")}
                           for k, v in errs.items()},
         "weight_grad_plain_err": {k: v[3] for k, v in errs.items()},
         "parts_ms": k6_split, "weight_grad_bound_ms": wg_bound, "weight_grad_bound_by": wg_by,
         "partial_mb": wg_partial / 1e6,
         "yardstick": "cuDNN bf16 conv2d forward and both gradients over the same 3x3 convs",
         "yardstick_ms": cudnn_train},
    ]


def k6r_work(tables, spec, programs, itemsize, bank_floats):
    r"""FLOPs and bytes K6's replay mode needs for these programs: K6's work
    (:func:`k5_k6_work`) plus the forward re-run over the valid rows; the
    stem features, the float32 cotangent and the banks in once, d(stem) and
    the gradient banks out once. The residuals never leave the kernel's own
    scratch, so they are not counted."""
    _, (flops6, bytes6), _, run = k5_k6_work(tables, spec, programs, itemsize, bank_floats)
    valid = run["valid"]
    resid = (valid["steps"] + 2 * valid["two_conv"]) * spec.height * spec.width * spec.module_channels
    return flops6 + module_flops(spec, valid), bytes6 - resid * itemsize


def train_joint_training(np, torch, dev, gen, vocab, smi, prior_ckpt, qc_ckpt, mt_ckpt):
    r"""Phase 9: K6's replay mode against K6 and the plain version at full
    NMN width (B = 256), the interpreter's memory in both modes, the
    objective on the card against the CPU's, trainer steps with launch
    counts in both NMN modes and with OBJECTIVE baseline, the evaluator in
    both decode modes, checkpoint and resume, and times. The trainer resumes
    from phases 6, 7 and 8's checkpoints. Returns K6r's entry of the
    kernels line."""
    import shutil
    import tempfile

    import torch.nn.functional as F

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import JointTrainingDataset
    from probnmn_tpu_torch.data.pipeline import to_device
    from probnmn_tpu_torch.evaluators.joint_training_evaluator import JointTrainingEvaluator
    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels import _build
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        DIFF_BANKS, build_banks, execute_programs_diff, execute_programs_kernel,
        execute_programs_train_kernel, interpreter_grads_kernel, interpreter_grads_plain,
        interpreter_grads_on_branch, interpreter_grads_plain_by_row, weight_grad_kernel,
        workspace_errors,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_forward_cuda, tf_backward_cuda, tf_forward_cuda,
    )
    from probnmn_tpu_torch.training._trainer import tree_leaves, tree_map
    from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer
    from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY
    from probnmn_tpu_torch.utils.clevr import sample_clevr_like_programs
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_jt_")
    vocab.save_to_files(os.path.join(work, "vocab"))
    overrides = ["DATA.VOCABULARY", os.path.join(work, "vocab"), "CHECKPOINTS.PROGRAM_PRIOR",
                 prior_ckpt, "CHECKPOINTS.QUESTION_CODING", qc_ckpt,
                 "CHECKPOINTS.MODULE_TRAINING", mt_ckpt]

    def config(objective="ours", *extra):
        return Config(os.path.join(repo, "configs", f"joint_training_{objective}.yml"),
                      overrides + list(extra))

    cfg = config()
    t0 = time.perf_counter()
    features = np.random.default_rng(10).standard_normal((512, 1024, 14, 14), dtype=np.float32)
    np.random.seed(cfg.RANDOM_SEED)  # the supervision subset, as the CLI seeds it
    train_set = JointTrainingDataset.from_arrays(
        *mt_arrays(np, vocab, 8192, 512, seed=15), features, num_supervision=cfg.SUPERVISION,
        supervision_question_max_length=cfg.SUPERVISION_QUESTION_MAX_LENGTH)
    val_set = JointTrainingDataset.from_arrays(*mt_arrays(np, vocab, 1024, 512, seed=17), features,
                                               split="val")

    def make_trainer(name, device="cuda", objective="ours", extra=(), replay=None):
        return JointTrainingTrainer(config(objective, *extra), os.path.join(work, name),
                                    device=device, writer=RecordingWriter(), dataset=train_set,
                                    replay=replay)

    trainer = make_trainer("run")
    spec, tables, batch = trainer.nmn_spec, trainer.tables, cfg.OPTIM.BATCH_SIZE
    log(f"[jt] {len(train_set)} train ({int(train_set.get_supervision_list().sum())} supervised) / "
        f"{len(val_set)} val questions over 512 images of (1024, 14, 14) float32, made in "
        f"{time.perf_counter() - t0:.1f} s; batch {batch}, lr {cfg.OPTIM.LR_INITIAL}, ALPHA "
        f"{cfg.ALPHA}, BETA {cfg.BETA}, GAMMA {cfg.GAMMA}, DELTA {cfg.DELTA}; PG, QR from phase 7, "
        f"the NMN from phase 8, the prior from phase 6")
    init_nmn = tree_map(lambda t: t.detach().clone(), trainer.params["nmn"])

    # K6's replay mode against K6 over K5's residuals and the plain version:
    # B = 256 CLEVR programs, token soups (mostly invalid), an all-pad row
    # and a program with no scene.
    programs_np = sample_clevr_like_programs(vocab, batch, seed=16)
    rs = np.random.RandomState(18)
    programs_np[-8:] = rs.randint(0, len(vocab.get_index_to_token_vocabulary("programs")),
                                  (8, programs_np.shape[1]))
    programs_np[-1] = 0
    programs_np[-2, :] = 0
    programs_np[-2, :2] = [vocab.get_token_index("count", "programs"),
                           vocab.get_token_index("filter_color[red]", "programs")]
    programs = torch.from_numpy(programs_np).to(dev)
    feats = torch.randn(batch, spec.height, spec.width, spec.feature_channels, generator=gen).to(dev)
    grid = _build.library().probnmn_nmn_backward_grid(1, batch, spec.height, spec.width,
                                                      spec.module_channels)
    errs, timed = {}, {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        stem = nmn.apply_stem(cast_params(init_nmn["stem"], dtype), feats.to(dtype)).contiguous()
        banks = build_banks(init_nmn, spec, dtype)
        final, invalid, otraj, atraj = execute_programs_train_kernel(banks, tables, spec, stem, programs)
        check(not bool(invalid[:batch - 8].any()) and bool(invalid[-2]) and not bool(invalid[-1]),
              f"K5 {name} invalid/all-pad rows")
        g = torch.randn(final.shape, generator=gen).to(dev).to(dtype).float()
        ws, ws_replay = {}, {}
        d_banks, d_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                                   otraj, atraj, workspace=ws)
        r_banks, r_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g,
                                                   workspace=ws_replay)
        a_banks, a_stem = interpreter_grads_kernel(banks, tables, spec, stem, programs, invalid, g)
        if dtype == torch.float32:
            w_banks, w_stem, _, branch = interpreter_grads_on_branch(
                banks, tables, spec, stem, programs, g, invalid, otraj, atraj, ws_replay)
            check(branch["far"] == 0 and branch["entries"] == 0 and branch["rows"] == 0,
                  f"K6r {name} decisions or workspace off the float64 branch: {branch}")
            reference = (f"the float64 gradient of the branch K5 and K6r took "
                         f"({branch['taken']} decisions float64 takes the other way, within "
                         f"{branch['gap']:.2e} of their scale)")
        else:
            w_banks, w_stem, alone = interpreter_grads_plain_by_row(
                banks, tables, spec, stem, programs, g, r_stem, K6_TOL[name])
            reference = ("autograd through the plain version, rows held to it run alone, with "
                         f"the ReLU outputs whose sign the batched plain forward flips against "
                         f"K5's: {alone or 'none'}")
        torch.cuda.synchronize()
        check(torch.equal(d_stem, r_stem) and all(torch.equal(d_banks[k], r_banks[k])
                                                  for k in DIFF_BANKS),
              f"K6r {name} differs from K6")
        check(all(torch.equal(ws[k], ws_replay[k]) for k in ("inp", "g", "tag", "dil", "dw3", "dwc")),
              f"K6r {name} workspace differs from K6's")
        check(torch.equal(r_stem, a_stem) and all(torch.equal(r_banks[k], a_banks[k])
                                                  for k in DIFF_BANKS), f"K6r {name} bits differ")
        check(float(r_stem[invalid].float().abs().max()) == 0.0, f"K6r {name} dx on invalid rows")
        worst = (0.0, 0.0, 0.0, "")
        for leaf, got, ref in [("stem", r_stem, w_stem)] + [(k, r_banks[k], w_banks[k])
                                                             for k in DIFF_BANKS]:
            e, sc = float((got.float() - ref.float()).abs().max()), float(ref.float().abs().max())
            worst = max(worst, (e / max(1.0, sc), e, sc, leaf))
            check(e <= K6_TOL[name] * max(1.0, sc), f"K6r {name} {leaf} error {e} (max |g| {sc})")
        tight = workspace_errors(ws_replay, banks, tables, spec)
        check(tight["weight_grad"] <= WS_TOL and tight["input_grad"] <= WS_TOL,
              f"K6r {name} against float64 sums over its own workspace: {tight}")
        wg_err, wg_empty = weight_grad_check(torch, ws_replay, banks, spec)
        chunk, partial = weight_grad_memory(ws_replay, spec.module_channels)
        errs[name] = (worst[1], tight, wg_err)
        log(f"[K6r {name}] B={batch}, replay grid {grid}: dx, every bank gradient and the "
            f"{tight['entries']} workspace entries equal K6's bit for bit; bitwise repeatable; "
            f"invalid {int(invalid.sum())}/{batch}, dx 0 there")
        log(f"[K6r {name}] reference: {reference}")
        log(f"[K6r {name}] every leaf within {K6_TOL[name]} * max(1, max|g|) of its reference; "
            f"worst {worst[3]}: max |err| {worst[1]:.3e}, max |grad| "
            f"{worst[2]:.3e} (ratio {worst[0]:.3e}); against float64 sums over its own workspace "
            f"(limit {WS_TOL}): weight-gradient kernel {tight['weight_grad']:.3e}, conv input "
            f"gradients of {tight['chained']} chained entries {tight['input_grad']:.3e}")
        log(f"[K6r {name}] weight-gradient kernel against weight_grad_plain on the same entries "
            f"(limit {WS_TOL}): {wg_err:.3e}; {wg_empty} targets without entries exactly 0; chunks "
            f"of {chunk} entries, partials {partial / 1e6:.1f} MB")
        if dtype == torch.bfloat16:
            timed = dict(banks=banks, stem=stem, invalid=invalid, otraj=otraj, atraj=atraj, g=g,
                         wg_work=weight_grad_work(ws_replay, banks, spec, stem.element_size()),
                         wg_partial=partial)
        del otraj, atraj, ws, ws_replay

    # The interpreter's training forward and backward at B = 256, bf16, in
    # each mode: the memory it takes beyond what was allocated before.
    banks, stem, invalid, g = timed["banks"], timed["stem"], timed["invalid"], timed["g"]

    def fwd_bwd(replay):
        leaves = {k: banks[k].detach().clone().requires_grad_(True) for k in DIFF_BANKS}
        stem_leaf = stem.detach().clone().requires_grad_(True)
        final, _ = execute_programs_diff(dict(banks, **leaves), tables, spec, stem_leaf, programs,
                                         replay=replay)
        (final.float() * g).sum().backward()

    interp_mb = {mode: transient_mb(torch, lambda: fwd_bwd(mode == "replay"))
                 for mode in ("no_replay", "replay")}
    log(f"[jt] interpreter forward + backward at B={batch}, bf16, memory beyond what was allocated: "
        f"K5 + K6 {interp_mb['no_replay']:.1f} MB, K2 + K6r {interp_mb['replay']:.1f} MB "
        f"(replay grid {grid})")

    # The objective on the card against the same call on the CPU: float32,
    # 32 rows (16 supervised) at the programs the card's K1 sampled.
    f32 = ("NMN.COMPUTE_DTYPE", "float32", "OPTIM.BATCH_SIZE", 32)
    card = make_trainer("f32_card", "cuda", extra=f32)
    host = make_trainer("f32_cpu", "cpu", extra=f32)
    sup = train_set.get_supervision_list()
    rows = np.concatenate([np.flatnonzero(sup)[:16], np.flatnonzero(sup == 0)[:16]])
    host_batch = train_set.get_batch(rows)
    b_card = dict(to_device(host_batch, dev), **{COUNT_KEY: 16})
    b_cpu = dict(to_device(host_batch, torch.device("cpu")), **{COUNT_KEY: 16})
    z = card.sample_programs(b_card["question"][16:])
    baseline0 = torch.tensor(0.25, device=dev)
    total, new_baseline, logs = card.joint_training_objective(card.params, b_card, z, baseline0)
    total.backward()
    total_c, baseline_c, logs_c = host.joint_training_objective(host.params, b_cpu, z.cpu(),
                                                                baseline0.cpu())
    total_c.backward()
    z_run = nmn_replay(tables, z.cpu().numpy())
    loss_diff = abs(float(total.detach()) - float(total_c.detach()))
    log(f"[jt] float32 objective on 32 rows (16 supervised) at the card's K1 z ({z_run['valid']['rows']}"
        f"/16 valid programs, {z_run['convs']} 3x3 convs), card vs CPU: total "
        f"{float(total.detach()):.6f} / {float(total_c.detach()):.6f} (|diff| {loss_diff:.2e}), "
        f"baseline {float(new_baseline):.6f} / {float(baseline_c):.6f}")
    check(loss_diff <= 1e-4 * max(1.0, abs(float(total_c.detach()))), "card vs CPU objective")
    check(abs(float(new_baseline) - float(baseline_c)) <= 1e-4, "card vs CPU baseline")
    for group, values in logs_c.items():
        for key, value in values.items():
            check(abs(float(logs[group][key]) - float(value)) <= 1e-4 * max(1.0, abs(float(value))),
                  f"card vs CPU log {group}/{key}")
    ratio = 0.0
    for index, (a, b) in enumerate(zip(tree_leaves(card.params), tree_leaves(host.params))):
        e, sc = float((a.grad.cpu() - b.grad).abs().max()), float(b.grad.abs().max())
        check(e <= 1e-4 * max(1.0, sc), f"card vs CPU gradient of leaf {index}: {e}")
        ratio = max(ratio, e / max(1.0, sc))
    log(f"[jt]   every log within 1e-4; every gradient leaf within 1e-4 * max(1, max|g|) (worst "
        f"ratio {ratio:.3e})")
    del card, host

    # The trainer on the card, with the launch counters set to 0 before and
    # read after: OBJECTIVE ours in both NMN modes, then OBJECTIVE baseline.
    counters = (fused_sampling_forward, lm_forward_cuda, tf_forward_cuda, tf_backward_cuda,
                execute_programs_train_kernel, interpreter_grads_kernel, weight_grad_kernel,
                execute_programs_kernel)

    def run_steps(tr, n):
        for fn in counters:
            fn.launches = 0
        interpreter_grads_kernel.replay_launches = 0
        out = [tr.step() for _ in range(n)]
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        launches["replay"] = interpreter_grads_kernel.replay_launches
        check(all(np.isfinite(v) for o in out for group in o.values() for v in group.values()),
              "train logs not finite")
        return out, launches

    def per_step(n, k1, k3f, k4, k5, k6, k2, replay):
        return {"fused_sampling_forward": k1 * n, "lm_forward_cuda": k3f * n,
                "tf_forward_cuda": k4 * n, "tf_backward_cuda": k4 * n,
                "execute_programs_train_kernel": k5 * n, "interpreter_grads_kernel": k6 * n,
                "weight_grad_kernel": k6 * n, "execute_programs_kernel": k2 * n,
                "replay": replay * n}

    steps = 20
    step_logs, launches = run_steps(trainer, steps)
    log(f"[jt] {steps} train steps on cuda (OBJECTIVE ours, K5 + K6): launches {launches}; nmn "
        f"{step_logs[0]['loss']['nmn']:.4f} -> {step_logs[-1]['loss']['nmn']:.4f}, PG "
        f"{step_logs[0]['loss']['program_generation_gt']:.4f} -> "
        f"{step_logs[-1]['loss']['program_generation_gt']:.4f}, elbo "
        f"{step_logs[0]['elbo']['elbo']:.4f} -> {step_logs[-1]['elbo']['elbo']:.4f}; baseline "
        f"{float(trainer.baseline):.4f}")
    check(launches == per_step(steps, 1, 1, 4, 1, 1, 0, 0), f"launches {launches}")
    check(float(trainer.baseline) != 0.0, "the REINFORCE baseline did not move")
    replay_trainer = make_trainer("replay", replay=True)
    replay_logs, replay_launches = run_steps(replay_trainer, 5)
    log(f"[jt] 5 train steps with the replay selected (K2 + K6r): launches {replay_launches}; nmn "
        f"{replay_logs[-1]['loss']['nmn']:.4f}")
    check(replay_launches == per_step(5, 1, 1, 4, 0, 1, 1, 1), f"launches {replay_launches}")
    base = make_trainer("baseline", objective="baseline")
    base_logs, base_launches = run_steps(base, 2)
    log(f"[jt] 2 steps with OBJECTIVE baseline: launches {base_launches}, logs {base_logs[-1]}")
    check(base_launches == per_step(2, 1, 0, 1, 1, 1, 0, 0), f"launches {base_launches}")
    del base

    # The evaluator in both decode modes (K2), a checkpoint and a resume.
    for decode in ("tf_greedy", "free_greedy"):
        execute_programs_kernel.launches = 0
        val = JointTrainingEvaluator(cfg, trainer, dataset=val_set,
                                     program_decode=decode).evaluate(num_batches=2)
        check(execute_programs_kernel.launches == 2, f"the {decode} evaluator did not run K2")
        pg_val = val["program_generator"]
        check(0.0 <= val["nmn"]["answer_accuracy"] <= 1.0 and 0.0 <= val["nmn"]["average_invalid"]
              <= batch and np.isfinite(pg_val["perplexity"]) and 0.0 <= pg_val["BLEU"] <= 1.0,
              f"{decode} metrics {val}")
        log(f"[jt] val ({decode}, 2 batches): answer_accuracy {val['nmn']['answer_accuracy']:.4f}, "
            f"average_invalid {val['nmn']['average_invalid']:.2f}; PG " + ", ".join(
                f"{k} {v:.4f}" for k, v in pg_val.items()))
    trainer.after_validation(val, steps - 1)
    resumed = make_trainer("run")
    resumed.load_checkpoint(os.path.join(work, "run", f"checkpoint_{steps - 1}.ckpt"))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                                 tree_leaves(trainer.params)))
    check(same and torch.equal(resumed.baseline, trainer.baseline)
          and resumed.iteration == steps - 1, "resume from the checkpoint")
    log(f"[jt] checkpoint_{steps - 1}.ckpt written and resumed with identical params and baseline "
        f"{float(resumed.baseline):.6f}")
    del resumed

    # Times, each beside its bound, on the bf16 check batch.
    otraj, atraj = timed["otraj"], timed["atraj"]
    k6_ms = cuda_ms(torch, lambda: interpreter_grads_kernel(banks, tables, spec, stem, programs,
                                                            invalid, g, otraj, atraj), iters=10)
    k6r_ms = cuda_ms(torch, lambda: interpreter_grads_kernel(banks, tables, spec, stem, programs,
                                                             invalid, g), iters=10)
    k2_ms = cuda_ms(torch, lambda: execute_programs_kernel(banks, tables, spec, stem, programs),
                    iters=10)
    plain_ms = cuda_ms(torch, lambda: interpreter_grads_plain(banks, tables, spec, stem, programs, g),
                       iters=2, warmup=1)
    bank_floats = sum(banks[k].numel() for k in DIFF_BANKS)
    _, (f6, b6), n_convs, run = k5_k6_work(tables, spec, programs_np, 2, bank_floats)
    f6r, b6r = k6r_work(tables, spec, programs_np, 2, bank_floats)
    k6_bound, k6_by = bound(f6, b6, "bfloat16")
    k6r_bound, k6r_by = bound(f6r, b6r, "bfloat16")
    C = spec.module_channels
    x = torch.randn(n_convs, C, spec.height, spec.width, generator=gen).to(dev, torch.bfloat16)
    w = (0.05 * torch.randn(C, C, 3, 3, generator=gen)).to(dev, torch.bfloat16)
    gy = torch.randn(n_convs, C, spec.height, spec.width, generator=gen).to(dev, torch.bfloat16)
    with torch.no_grad():
        cudnn_fwd = cuda_ms(torch, lambda: F.conv2d(x, w, padding=1), iters=10)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    cudnn_train = cuda_ms(torch, lambda: torch.autograd.grad(F.conv2d(xg, wg, padding=1), (xg, wg), gy),
                          iters=10)
    del x, gy, xg
    log(f"[time] K6r {k6r_ms:.3f} ms/batch of {batch} (K6 over K5's residuals on the same batch "
        f"{k6_ms:.3f}, bound {k6_bound:.4f} by {k6_by}; K2 {k2_ms:.3f}; plain {plain_ms:.3f}; "
        f"bound {k6r_bound:.4f} by {k6r_by}: {run['valid']['rows']} valid rows, {n_convs} 3x3 "
        f"convs, {f6r / 1e9:.1f} GFLOP, {b6r / 1e6:.1f} MB; cuDNN bf16 conv forward over "
        f"{n_convs} convs {cudnn_fwd:.3f}, forward + both gradients {cudnn_train:.3f}); card {smi}")
    wg_flops, wg_bytes = timed["wg_work"]
    wg_bound, wg_by = bound(wg_flops, wg_bytes, "bfloat16")
    k6_split = {}
    for mode, fn in (("K6", lambda: interpreter_grads_kernel(banks, tables, spec, stem, programs,
                                                             invalid, g, otraj, atraj)),
                     ("K6r", lambda: interpreter_grads_kernel(banks, tables, spec, stem, programs,
                                                              invalid, g))):
        k6_split[mode], _ = k6_parts(torch, fn)
        log(f"[K6 parts] {mode} B={batch}, bf16, ms a call under torch.profiler: sweep "
            f"{k6_split[mode]['sweep']:.4f}, weight gradient {k6_split[mode]['weight_grad']:.4f} "
            f"(bound {wg_bound:.4f} by {wg_by}: {wg_flops / 1e9:.1f} GFLOP, {wg_bytes / 1e6:.1f} "
            f"MB), row sums {k6_split[mode]['row_sums']:.4f}, glue {k6_split[mode]['glue']:.4f}; "
            f"partials {timed['wg_partial'] / 1e6:.1f} MB; card {smi}")

    # The train step in each mode: host clock over steps that each fetch
    # their logs, the memory a step takes beyond what was allocated before
    # it, and one step under the profiler.
    step_ms, step_mb = {}, {}
    for name, tr in (("K5 + K6", trainer), ("K2 + K6r", replay_trainer)):
        for _ in range(3):
            tr.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            tr.step()
        step_ms[name] = (time.perf_counter() - t0) / 10 * 1e3
        step_mb[name] = transient_mb(torch, tr.step)
        stage = tr._batch_source.stage_metrics()
        log(f"[time] joint_training train step, {name}: {step_ms[name]:.3f} ms (host clock, logs "
            f"fetched each step): {batch / step_ms[name] * 1e3:.1f} examples/s; peak memory of a "
            f"step beyond what was allocated before it {step_mb[name]:.1f} MB; "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()) + f"; card {smi}")
        wall_ms, busy_ms, top, _ = trace(torch, tr.step)
        if busy_ms > 0:
            log(f"[trace] joint_training train step ({name}) under torch.profiler: {wall_ms:.2f} ms "
                f"host clock, device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
            for us, kernel, count in top:
                log(f"[trace]   {us / 1e3:8.3f} ms  x{count:<4d} {kernel[:90]}")
        else:
            log("[trace] the profiler recorded no device time: idle share not measured")
    shutil.rmtree(work, ignore_errors=True)

    return [
        {"name": "nmn_backward_replay", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/nmn_interpreter.cu",
         "replaces": "probnmn_tpu/ops/pallas/nmn_interpreter.py:870",
         "launches": replay_launches["replay"], "max_abs_err": errs["bfloat16"][0],
         "max_abs_err_float32": errs["float32"][0],
         "ms": k6r_ms, "plain_ms": plain_ms, "bound_ms": k6r_bound, "bound_by": k6r_by,
         "library_ms": None, "bit_equal_to_no_replay": True, "replay_grid": grid,
         "k6_ms_same_batch": k6_ms, "k6_bound_ms_same_batch": k6_bound,
         "workspace_err": {k: {e: v[1][e] for e in ("weight_grad", "input_grad")}
                           for k, v in errs.items()},
         "weight_grad_plain_err": {k: v[2] for k, v in errs.items()},
         "parts_ms": k6_split["K6r"], "k6_parts_ms_same_batch": k6_split["K6"],
         "weight_grad_bound_ms": wg_bound, "weight_grad_bound_by": wg_by,
         "partial_mb": timed["wg_partial"] / 1e6, "interpreter_mb": interp_mb, "step_ms": step_ms, "step_mb": step_mb,
         "yardstick": "cuDNN bf16 conv2d forward, then forward and both gradients, over the same "
                      "3x3 convs", "yardstick_ms": cudnn_fwd + cudnn_train},
    ]


# Phase 10's kernels: the kernels' JSON names and their launch counters.
MINI_CLEVR_COUNTERS = (
    ("seq2seq_decode", "seq2seq_decode", "fused_sampling_forward"),
    ("k1_encoder_sweep", "seq2seq_decode", "sampling_encode"),
    ("nmn_interpreter", "nmn_interpreter", "execute_programs_kernel"),
    ("nmn_plan", "nmn_interpreter", "interpreter_plan"),
    ("lm_forward", "seq2seq_train", "lm_forward_cuda"),
    ("lm_backward", "seq2seq_train", "lm_backward_cuda"),
    ("tf_forward", "seq2seq_train", "tf_forward_cuda"),
    ("tf_backward", "seq2seq_train", "tf_backward_cuda"),
    ("nmn_train_forward", "nmn_interpreter", "execute_programs_train_kernel"),
    ("nmn_backward", "nmn_interpreter", "interpreter_grads_kernel"),
    ("nmn_weight_grad", "nmn_interpreter", "weight_grad_kernel"),
)


def mini_clevr_against_plain(np, torch, argv):
    r"""Phase 10's kernels against their plain versions on the card, on what
    the runner of ``argv`` feeds them, from the best checkpoints it wrote:
    one question_coding batch (K1 and its encoder sweeps on the unsupervised
    questions; the four K4 passes at the z K1 sampled; K3f and K3b on that z
    under the frozen prior; the objective against the CPU's) and one
    module_training batch (the plan, K2, K5 and K6 in both dtypes, half the
    rows at the programs the trained generator sampled and half at the
    task's own, over its 16-channel features), each at its phase's
    tolerances. Returns the largest error of
    each kernel by its JSON name (bfloat16 where the path runs it)."""
    from probnmn_tpu_torch import mini_clevr_run
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.pipeline import image_to_nhwc
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        interpreter_plan, interpreter_plan_plain,
    )
    from probnmn_tpu_torch.training._trainer import tree_map
    from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    run = mini_clevr_run.MiniClevrRun(mini_clevr_run.parser.parse_args(argv))
    gen = torch.Generator().manual_seed(10)

    def trained(phase, device=None):
        r"""The phase's trainer at its best checkpoint, on the card or ``device``."""
        on = run if device is None else mini_clevr_run.MiniClevrRun(
            mini_clevr_run.parser.parse_args(argv + ["--device", device]))
        sdir = run.phase_dir(phase)
        trainer, _, _ = on.build(phase, Config(os.path.join(sdir, "mini_config.yml")),
                                 RecordingWriter())
        trainer.load_checkpoint(os.path.join(sdir, "checkpoint_best.ckpt"))
        return trainer

    errs = {}
    qc = trained("question_coding")
    pg_spec = qc.pg_spec
    batch = next(qc._batches)
    n_sup = batch[COUNT_KEY]
    questions, programs = batch["question"], batch["program"]
    unsup = questions[n_sup:]
    noise = -torch.log(-torch.log(torch.rand(pg_spec.max_decoding_steps, len(unsup),
                                             pg_spec.target_vocab_size,
                                             generator=gen).clamp_min(1e-12)))
    params = tree_map(lambda t: t.detach(), qc.params)
    pg = params["program_generator"]
    errs["seq2seq_decode"] = k1_against_plain(torch, pg, pg_spec, unsup, noise.to(unsup.device),
                                              tag="K1 mini-CLEVR")["bfloat16"]
    errs["k1_encoder_sweep"] = k1_encoder_against_plain(
        torch, pg, pg_spec, unsup, tag="K1 encoder mini-CLEVR")[0]["bfloat16"]
    z = qc.sample_programs(unsup)
    torch.cuda.synchronize()
    log(f"[mini-clevr] question_coding batch: {n_sup} supervised, {len(unsup)} unsupervised; "
        f"questions {tuple(questions.shape)}, programs {tuple(programs.shape)}, z "
        f"{tuple(z.shape)} ({int((z == pg_spec.end_index).any(1).sum())} with @end@)")
    errs["tf_forward"] = errs["tf_backward"] = 0.0
    for name, weights, spec, src, tgt, reinforce_norm in qc_passes(
            params, pg_spec, qc.qr_spec, questions, programs, n_sup, z):
        dloss = (torch.rand(src.shape[0], generator=gen) + 0.5).to(src.device)
        err, e, _, _ = k4_pass_against_plain(torch, f"mini-CLEVR {name}", weights, spec, src, tgt,
                                             reinforce_norm, dloss)
        errs["tf_forward"], errs["tf_backward"] = (max(errs["tf_forward"], err),
                                                   max(errs["tf_backward"], e))
    dloss = (torch.rand(len(z), generator=gen) + 0.5).to(z.device)
    errs["lm_forward"], errs["lm_backward"] = k3_against_plain(
        torch, qc.prior_params, qc.prior_spec, z, dloss, tag=" mini-CLEVR")
    cpu = trained("question_coding", "cpu")
    objective_against_cpu(torch, qc, cpu, batch, z, qc.baseline.detach(), tag="mini-clevr qc")
    del qc, cpu

    mt = trained("module_training")
    nmn_params = tree_map(lambda t: t.detach(), mt.params["nmn"])
    batch = next(mt._batches)
    # The first half of the rows at the programs the trained generator
    # sampled, the rest at the task's own programs, which all run.
    sampled = mt.sample_programs(batch["question"])
    half = len(sampled) // 2
    gold = torch.zeros_like(sampled)
    gold[:, :batch["program"].shape[1]] = batch["program"]
    programs = torch.cat([sampled[:half], gold[half:]])
    feats = image_to_nhwc(batch["image"])
    plan_convs, plan_order = interpreter_plan(mt.tables, programs)
    want_convs, want_order = interpreter_plan_plain(mt.tables, programs)
    errs["nmn_plan"] = float((plan_convs - want_convs).abs().max())
    check(errs["nmn_plan"] == 0 and torch.equal(plan_order, want_order),
          "mini-CLEVR: the plan kernel differs from its plain version")
    log(f"[mini-clevr] module_training batch: programs {tuple(programs.shape)}, {half} sampled "
        f"by K1 ({int(want_convs[:half].sum())} 3x3 convs), the rest the task's "
        f"({int(want_convs[half:].sum())}), the longest {int(want_convs.max())}; features "
        f"{tuple(feats.shape)} (NHWC); the plan equal to its plain version")
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        checked = k5_k6_against_plain(torch, gen, name, dtype, nmn_params, mt.nmn_spec,
                                      mt.tables, feats, programs, tag=" mini-CLEVR")
        if dtype == torch.bfloat16:
            errs["nmn_interpreter"] = errs["nmn_train_forward"] = checked["err"]
            errs["nmn_backward"] = checked["worst"]
    return errs


def train_mini_clevr(np, torch):
    r"""Phase 10: the mini-CLEVR runner's four phases on the card at
    production geometry, a few steps each, then the path's kernels against
    their plain versions on its batches. Returns the launches of each kernel
    of the path (by its JSON name) in that run, and the kernels' errors."""
    import importlib
    import shutil
    import tempfile

    from probnmn_tpu_torch import mini_clevr_run
    from probnmn_tpu_torch.ops.kernels.gemm import gemm_launches
    from probnmn_tpu_torch.training import _trainer

    counters = {name: getattr(importlib.import_module(f"probnmn_tpu_torch.ops.kernels.{module}"),
                              fn) for name, module, fn in MINI_CLEVR_COUNTERS}
    work = tempfile.mkdtemp(prefix="chip_smoke_mc_")
    runs = os.path.join(work, "runs")
    argv = ["--device", "cuda", "--seed", "0", "--train-images", "400", "--val-images", "160",
            "--supervision", "200", "--iters", "40", "40", "40", "40", "--checkpoint-every", "20",
            "--resume-split-phase", "module_training", "--hparam", "ALPHA", "500.0",
            "--root", os.path.join(work, "data"), "--runs", runs,
            "--report", os.path.join(work, "report.md"),
            "--report-json", os.path.join(work, "report.json")]
    frozen = []
    load_objects = _trainer.load_objects

    def record_frozen(path, templates):
        frozen.append((os.path.relpath(path, runs), sorted(templates)))
        return load_objects(path, templates)

    for fn in counters.values():
        fn.launches = 0
    counters["nmn_backward"].replay_launches = 0
    gemm_launches(reset=True)
    _trainer.load_objects = record_frozen
    t0 = time.perf_counter()
    try:
        report = mini_clevr_run.main(mini_clevr_run.parser.parse_args(argv))
    finally:
        _trainer.load_objects = load_objects
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["gemm"] = gemm_launches()
    launches["nmn_backward_replay"] = counters["nmn_backward"].replay_launches

    data = report["data"]
    log(f"[mini-clevr] {data['train_examples']} train / {data['val_examples']} val questions over "
        f"400 / 160 images of (16, 14, 14), made in {data['generate_s']:.2f} s; the chain "
        f"{wall:.1f} s; launches {launches}")
    phases = report["phases"]
    check(list(phases) == mini_clevr_run.PHASE_ORDER, f"phases {list(phases)}")
    for phase, entry in phases.items():
        model, metric, _, _ = mini_clevr_run.THRESHOLDS[phase]
        log(f"[mini-clevr] {phase}: {metric} {entry['value']:.4f} (best at {entry['best_iteration']}), "
            f"{entry['steps']} steps, train {entry['train_s']:.2f} s, {entry['steps_per_s']:.2f} "
            f"steps/s ({1e3 * entry['step_s'] / entry['steps']:.2f} ms a step), eval "
            f"{entry['eval_s']:.2f} s; all: {json.dumps(entry['metrics'])}")
        check(entry["steps"] == 40 and entry["nonfinite_steps"] == 0,
              f"{phase}: {entry['steps']} steps, {entry['nonfinite_steps']} with non-finite logs")
        check(np.isfinite([v for d in entry["metrics"].values() for v in d.values()]).all(),
              f"{phase} metrics {entry['metrics']}")
        wanted = {model} | ({"nmn_free_greedy"} if phase in mini_clevr_run.NMN_PHASES else set())
        check(wanted <= set(entry["metrics"]), f"{phase} metrics {sorted(entry['metrics'])}")
        trajectory = report["val_trajectories"][phase][f"val/metrics/{model}/{metric}"]
        check([it for it, _ in trajectory] == [19, 39], f"{phase} trajectory {trajectory}")
        best = os.path.join(runs, phase, "checkpoint_best.ckpt")
        best_iteration = torch.load(best, map_location="cpu", weights_only=True, mmap=True)[
            "iteration"]
        check(best_iteration == entry["best_iteration"], f"{phase}: best file at {best_iteration}")
    legs = phases["module_training"]["legs"]
    check([(leg["start"], leg["end"]) for leg in legs] == [(0, 20), (20, 40)]
          and legs[1]["resumed_from"] == os.path.join(runs, "module_training",
                                                      "checkpoint_19.ckpt"),
          f"module_training legs {legs}")
    best = {p: os.path.join(p, "checkpoint_best.ckpt") for p in mini_clevr_run.PHASE_ORDER}
    for path, names in ((best["program_prior"], ["program_prior"]),
                        (best["question_coding"], ["program_generator"]),
                        (best["question_coding"], ["question_reconstructor"]),
                        (best["module_training"], ["nmn"])):
        check((path, names) in frozen, f"{names} not read from {path}: {frozen}")
    check(all(n > 0 for name, n in launches.items() if name != "nmn_backward_replay"),
          f"a kernel of the mini-CLEVR path never launched: {launches}")
    check(launches["nmn_backward_replay"] == 0, f"K6's replay mode ran: {launches}")
    errs = mini_clevr_against_plain(np, torch, argv)
    shutil.rmtree(work, ignore_errors=True)
    return launches, errs


# Phase 12: serving from a checkpoint. The scripted program the checkpoints'
# generator emits (scene, attention, relate, same, a no-op, query), so that
# the NMN's answers depend on its weights.
SERVE_PROGRAM = ["query_color", "unique", "same_shape", "relate[left]", "filter_color[red]",
                 "scene"]


def reference_state_dicts(torch, pg, nmn_params, nmn_spec, vocab):
    r"""The reference's ``state_dict``s (tests/ref_checkpoints.py's key names:
    allennlp's Seq2SeqBase, the NMN's stem, classifier and one module per
    program token) of the port's ProgramGenerator and NMN params, built from
    the port's own NMN constants."""
    from probnmn_tpu_torch.models.nmn import ATTENTION, COMPARE, QUERY, RELATE, SAME

    cell, proj = pg["decoder_cell"], pg["output_projection"]
    pg_state = {"_source_embedder.token_embedder_tokens.weight": pg["source_embedding"],
                "_target_embedder.weight": pg["target_embedding"],
                "_decoder_cell.weight_ih": cell["w_ih"], "_decoder_cell.weight_hh": cell["w_hh"],
                "_decoder_cell.bias_ih": cell["b_ih"], "_decoder_cell.bias_hh": cell["b_hh"],
                "_output_projection_layer.weight": proj["w"],
                "_output_projection_layer.bias": proj["b"]}
    for k, layer in enumerate(pg["encoder"]):
        for name, key in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih"),
                          ("b_hh", "bias_hh")):
            pg_state[f"_encoder._module.{key}_l{k}"] = layer[name]
    stem, cls = nmn_params["stem"], nmn_params["classifier"]
    P, h2, w2 = nmn_spec.class_projection_channels, nmn_spec.height // 2, nmn_spec.width // 2
    lin1 = cls["lin1"]["w"]  # NHWC flatten -> torch's NCHW flatten
    nmn_state = {"stem.0.weight": stem["w1"], "stem.0.bias": stem["b1"],
                 "stem.2.weight": stem["w2"], "stem.2.bias": stem["b2"],
                 "classifier.0.weight": cls["proj_w"].T[:, :, None, None],
                 "classifier.0.bias": cls["proj_b"],
                 "classifier.4.weight": lin1.reshape(-1, h2, w2, P).permute(0, 3, 1, 2)
                 .reshape(lin1.shape[0], -1),
                 "classifier.4.bias": cls["lin1"]["b"],
                 "classifier.6.weight": cls["lin2"]["w"], "classifier.6.bias": cls["lin2"]["b"]}
    modules = {ATTENTION: ("attention", ("conv1", "conv2", "conv3")),
               QUERY: ("query", ("conv1", "conv2")),
               RELATE: ("relate", ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6")),
               SAME: ("same", ("conv",)),
               COMPARE: ("compare", ("projection", "conv1", "conv2"))}
    tokens = vocab.get_index_to_token_vocabulary("programs")
    for index in range(len(tokens)):
        kind = int(nmn_spec.token_kind[index])
        if kind not in modules:
            continue
        bank_name, convs = modules[kind]
        slot = int(nmn_spec.token_bank[index])
        for conv in convs:
            w = nmn_params[bank_name][conv]["w"][slot]
            # 3x3 banks are HWIO, 1x1 banks (C_in, C_out): torch's OIHW.
            w = w.permute(3, 2, 0, 1) if w.dim() == 4 else w.T[:, :, None, None]
            nmn_state[f"{tokens[index]}.{conv}.weight"] = w
            nmn_state[f"{tokens[index]}.{conv}.bias"] = nmn_params[bank_name][conv]["b"][slot]
    clone = lambda d: {k: v.detach().clone().contiguous() for k, v in d.items()}  # noqa: E731
    return clone(pg_state), clone(nmn_state)


def trees_equal(torch, got, want):
    r"""Every tensor of ``want`` equal, bit for bit, to ``got``'s at the same key path."""
    if isinstance(want, torch.Tensor):
        return got.shape == want.shape and torch.equal(got.cpu(), want.cpu())
    keys = list(want) if isinstance(want, dict) else range(len(want))
    return len(got) == len(want) and all(trees_equal(torch, got[k], want[k]) for k in keys)


def serve_from_checkpoints(np, torch, dev, smi):
    r"""Phase 12: one random ProgramGenerator (its decoder scripted, so that
    its programs run) and NMN, at full width, written as the JAX package's
    ``.ckpt`` (``save_objects_jax``), as the reference's legacy ``.pth`` and
    by the port's ``save_objects``; each loads bit for bit, and
    ``InferenceEngine.from_checkpoint`` on each answers 256 questions as an
    engine over the params in memory does, in bfloat16 and float32, with K1
    and K2 launched; K1 and K2 against their plain versions on that batch;
    greedy against beam 1 and beam 4's scores; the inference CLI's
    ``run_inference`` over 300 in-memory test rows; a QuestionCodingTrainer
    whose frozen prior is the JAX-format file, 2 steps. Inputs come from a
    generator of their own. Returns the K1 and K2 entries' launches and
    errors on this path, and its times."""
    import shutil
    import tempfile

    from probnmn_tpu_torch import interop
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import JointTrainingDataset, QuestionCodingDataset
    from probnmn_tpu_torch.inference import run_inference
    from probnmn_tpu_torch.models import nmn, program_generator, program_prior
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.models.seq2seq import GREEDY, beam_search_forward, seq2seq_forward
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        build_banks, build_tables, execute_programs_kernel, execute_programs_plain,
        interpreter_plan,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, sampling_encode,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_backward_cuda, lm_forward_cuda, tf_backward_cuda, tf_forward_cuda,
    )
    from probnmn_tpu_torch.serving import InferenceEngine
    from probnmn_tpu_torch.training._trainer import load_models
    from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec
    from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer
    from probnmn_tpu_torch.utils.checkpointing import (
        MSGPACK, TORCH, TORCH_LEGACY, checkpoint_format, save_objects, save_objects_jax,
    )
    from probnmn_tpu_torch.utils.clevr import (
        MAX_QUESTION_LENGTH, make_clevr_like_vocabulary, sample_clevr_like_programs,
    )
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    vocab = make_clevr_like_vocabulary()
    vocab.save_to_files(os.path.join(work, "vocab"))
    config = Config(os.path.join(repo, "configs", "joint_training_ours.yml"),
                    ["DATA.VOCABULARY", os.path.join(work, "vocab")])
    gen = torch.Generator().manual_seed(12)
    pg_spec, nmn_spec = program_generator.make_spec(vocab, config), nmn.make_spec(vocab, config)
    prior_spec = make_prior_spec(config, vocab)
    random_pg = program_generator.init_params(gen, pg_spec)
    pg = scripted_generator(torch, random_pg, pg_spec, vocab, SERVE_PROGRAM)
    nmn_params = nmn.init_nmn_params(gen, nmn_spec)
    prior = program_prior.init_program_prior_params(gen, prior_spec)
    log(f"[serve] ProgramGenerator {pg_spec}; NMN C {nmn_spec.module_channels} on "
        f"{nmn_spec.height}x{nmn_spec.width} over {nmn_spec.feature_channels} channels, "
        f"{sum(t.numel() for t in _leaves(torch, nmn_params)) / 1e6:.1f}M NMN params")

    # ------------------------------------------------------------ the three files
    files = {"jax": os.path.join(work, "joint.ckpt"), "reference": os.path.join(work, "joint.pth"),
             "port": os.path.join(work, "joint_port.ckpt")}
    write_s = {}
    t0 = time.perf_counter()
    save_objects_jax(files["jax"], {"program_generator": interop.program_generator_to_jax(pg),
                                    "nmn": interop.nmn_to_jax(nmn_params),
                                    "program_prior": interop.program_prior_to_jax(prior)}, 0)
    write_s["jax"] = time.perf_counter() - t0
    ref_pg, ref_nmn = reference_state_dicts(torch, pg, nmn_params, nmn_spec, vocab)
    t0 = time.perf_counter()
    # The reference pins torch 1.4, whose torch.save writes the legacy format.
    torch.save({"program_generator": ref_pg, "nmn": ref_nmn, "optimizer": {}, "iteration": 0},
               files["reference"], _use_new_zipfile_serialization=False)
    write_s["reference"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_objects(files["port"], {"program_generator": pg, "nmn": nmn_params}, 0)
    write_s["port"] = time.perf_counter() - t0
    formats = {fmt: checkpoint_format(path) for fmt, path in files.items()}
    check(formats == {"jax": MSGPACK, "reference": TORCH_LEGACY, "port": TORCH},
          f"formats {formats}")
    specs = {"program_generator": pg_spec, "nmn": nmn_spec}
    load_s = {}
    for fmt, path in files.items():
        t0 = time.perf_counter()
        models = load_models(path, specs, vocab)
        load_s[fmt] = time.perf_counter() - t0
        check(trees_equal(torch, models["program_generator"], pg)
              and trees_equal(torch, models["nmn"], nmn_params),
              f"the {fmt} checkpoint's params differ from the params written")
        log(f"[serve] {fmt}: {os.path.getsize(path) / 1e6:.1f} MB written in "
            f"{write_s[fmt]:.2f} s, read into the port's params in {load_s[fmt]:.2f} s "
            f"(host clock), bit for bit the params written")
    del models

    # ------------------------------------------------------------ from_checkpoint
    rs = np.random.RandomState(12)
    questions = random_questions(np, vocab, BATCH, MAX_QUESTION_LENGTH, seed=121)
    images = rs.randn(BATCH, nmn_spec.feature_channels, nmn_spec.height,
                      nmn_spec.width).astype(np.float32)
    seed = 20261018
    counters = {"seq2seq_decode": fused_sampling_forward, "k1_encoder_sweep": sampling_encode,
                "nmn_interpreter": execute_programs_kernel, "nmn_plan": interpreter_plan}
    launches = {name: 0 for name in counters}
    first_answer_s = {}
    for dtype in ("bfloat16", "float32"):
        memory = InferenceEngine(vocab, pg_spec, nmn_spec, pg, nmn_params, batch_size=BATCH,
                                 rng_seed=config.RANDOM_SEED, device=dev, compute_dtype=dtype)
        want = memory.predict(questions, images, seed=seed)
        check("@@UNKNOWN@@" not in want, f"the scripted program did not run ({dtype})")
        for fmt, path in files.items():
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            engine = InferenceEngine.from_checkpoint(config, path, batch_size=BATCH,
                                                     compute_dtype=dtype, device=dev)
            answers = engine.predict(questions, images, seed=seed)
            torch.cuda.synchronize()
            first_answer_s[(fmt, dtype)] = time.perf_counter() - t0
            ran = {name: fn.launches for name, fn in counters.items()}
            log(f"[serve] from_checkpoint({fmt}, {dtype}) -> predict: {len(answers)} answers in "
                f"{first_answer_s[(fmt, dtype)]:.2f} s to the first answer (host clock); "
                f"launches {ran}; {len(set(answers))} distinct answers")
            check(all(n > 0 for n in ran.values()), f"a kernel did not run: {ran}")
            check(answers == want, f"{fmt} {dtype}: answers differ from the in-memory engine's")
            for name, n in ran.items():
                launches[name] += n
            del engine

    # K1 and K2 against their plain versions on this batch: K1 over the
    # checkpoint's generator on explicit noise, K2 over the programs it
    # sampled (half the rows) and valid CLEVR programs (the other half).
    pg_dev = cast_params(load_models(files["jax"], specs, vocab)["program_generator"],
                         torch.float32, dev)
    q_dev = torch.from_numpy(questions).to(dev)
    T, V = pg_spec.max_decoding_steps, pg_spec.target_vocab_size
    noise = (-torch.log(-torch.log(torch.rand(T, BATCH, V, generator=gen).clamp_min(1e-12)))).to(dev)
    k1 = k1_against_plain(torch, pg_dev, pg_spec, q_dev, noise, tag="K1 from checkpoint")
    # The scripted decoder's tokens win by a wide margin; the random generator
    # it was made from samples programs that depend on every weight.
    random_dev = cast_params(random_pg, torch.float32, dev)
    k1_random = k1_against_plain(torch, random_dev, pg_spec, q_dev, noise,
                                 tag="K1 random generator")
    sampled = fused_sampling_forward(pg_dev, pg_spec, q_dev, seed=seed,
                                     compute_dtype=torch.bfloat16)["predictions"]
    programs = torch.from_numpy(sample_clevr_like_programs(vocab, BATCH, seed=122)).to(dev)
    width = max(programs.shape[1], sampled.shape[1])
    batch_programs = torch.zeros((BATCH, width), dtype=torch.long, device=dev)
    batch_programs[:BATCH // 2, :sampled.shape[1]] = sampled[:BATCH // 2]
    batch_programs[BATCH // 2:, :programs.shape[1]] = programs[BATCH // 2:].long()
    nmn_dev = cast_params(nmn_params, torch.float32, dev)
    tables = build_tables(nmn_spec, dev)
    feats = torch.from_numpy(images).to(dev).permute(0, 2, 3, 1)
    k2 = {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        stem = nmn.apply_stem(cast_params(nmn_dev["stem"], dtype), feats.to(dtype)).contiguous()
        banks = build_banks(nmn_dev, nmn_spec, dtype)
        out_k, inv_k = execute_programs_kernel(banks, tables, nmn_spec, stem, batch_programs)
        out_p, inv_p = execute_programs_plain(banks, tables, nmn_spec, stem, batch_programs)
        torch.cuda.synchronize()
        err = float((out_k.float() - out_p.float()).abs().max())
        scale = float(out_p.float().abs().max())
        log(f"[K2 from checkpoint {name}] invalid {int(inv_k.sum())}/{BATCH} (plain "
            f"{int(inv_p.sum())}), max |out err| {err:.3e}, max |out| {scale:.3e}")
        check(torch.equal(inv_k, inv_p) and not bool(inv_k.any()), "K2 invalid flags")
        check(torch.isfinite(out_k.float()).all(), "K2 output not finite")
        check(err <= (1e-4 * max(1.0, scale) if name == "float32" else 2e-2 * scale),
              f"K2 {name} error {err}")
        k2[name] = err

    # ------------------------------------------------------------ beam decoding
    with torch.no_grad():
        greedy = seq2seq_forward(random_dev, pg_spec, q_dev, GREEDY)["predictions"]
        beam1 = beam_search_forward(random_dev, pg_spec, q_dev, 1)
        beam4 = beam_search_forward(random_dev, pg_spec, q_dev, 4)
    torch.cuda.synchronize()
    scores = beam4["beam_scores"]
    log(f"[serve] beam: greedy vs beam 1 identical tokens on "
        f"{int((greedy == beam1['predictions']).all(1).sum())}/{BATCH} rows; beam 4 scores "
        f"{float(scores[:, 0].mean()):.4f} (best) .. {float(scores[:, -1].mean()):.4f} (4th) "
        f"on average")
    check(torch.equal(greedy, beam1["predictions"]), "beam 1 differs from greedy")
    check(bool(torch.isfinite(scores).all()) and bool((scores[:, 1:] <= scores[:, :-1]).all()),
          "beam 4 scores not finite or not sorted best first")
    beam_ms = cuda_ms(torch, lambda: beam_search_forward(random_dev, pg_spec, q_dev, 4), iters=2,
                      warmup=1)
    beam_engine = InferenceEngine.from_checkpoint(config, files["jax"], batch_size=BATCH,
                                                  decoding="beam", beam_size=4, device=dev)
    beam_answers = beam_engine.predict(questions, images)
    check(len(beam_answers) == BATCH and "@@UNKNOWN@@" not in beam_answers,
          "the beam engine's answers")
    del beam_engine

    # ------------------------------------------------------------ the inference CLI
    n_test, n_images = 300, 64
    test_questions = random_questions(np, vocab, n_test, MAX_QUESTION_LENGTH, seed=123)
    test_images = rs.randint(0, n_images, n_test)
    features = rs.randn(n_images, nmn_spec.feature_channels, nmn_spec.height,
                        nmn_spec.width).astype(np.float32)
    test_set = JointTrainingDataset.from_arrays(None, test_questions, None, test_images,
                                                features, split="test")
    engine = InferenceEngine.from_checkpoint(config, files["jax"], batch_size=BATCH,
                                             device=dev)
    engine.warmup()
    out_path = os.path.join(work, "joint_predictions.json")
    t0 = time.perf_counter()
    predictions = run_inference(engine, test_set, BATCH, out_path)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    with open(out_path) as f:
        written = json.load(f)
    check(written == predictions and len(written) == n_test
          and sorted(p["question_index"] for p in written) == list(range(n_test)),
          "the predictions JSON does not cover every test row once")
    again = InferenceEngine.from_checkpoint(config, files["jax"], batch_size=BATCH,
                                            device=dev)
    again.warmup()
    want = []
    for start in range(0, n_test, BATCH):
        rows = np.arange(start, min(start + BATCH, n_test))
        want += again.predict(test_questions[rows], features[test_images[rows]])
    check([p["answer"] for p in written] == want, "run_inference's answers differ from predict's")
    cli_qps = n_test / cli_s
    log(f"[serve] run_inference: {n_test} test rows in batches of {BATCH} (the last "
        f"{n_test % BATCH}) in {cli_s:.3f} s, {cli_qps:.1f} questions/s (host clock, sampling, "
        f"bfloat16), {len(set(want))} distinct answers; the same answers as predict")
    del engine, again

    # ------------------------------------------------------------ a trainer seeded from it
    qc_config = Config(os.path.join(repo, "configs", "question_coding_ours.yml"),
                       ["DATA.VOCABULARY", os.path.join(work, "vocab"),
                        "CHECKPOINTS.PROGRAM_PRIOR", files["jax"]])
    np.random.seed(qc_config.RANDOM_SEED)
    qc_set = QuestionCodingDataset.from_tokens(
        *qc_questions(np, vocab, 2048, seed=124), num_supervision=qc_config.SUPERVISION,
        supervision_question_max_length=qc_config.SUPERVISION_QUESTION_MAX_LENGTH)
    trainer = QuestionCodingTrainer(qc_config, os.path.join(work, "qc"), device=dev,
                                    writer=RecordingWriter(), dataset=qc_set)
    check(trees_equal(torch, trainer.prior_params, prior), "the JAX-format prior differs")
    qc_counters = (fused_sampling_forward, lm_forward_cuda, lm_backward_cuda, tf_forward_cuda,
                   tf_backward_cuda)
    for fn in qc_counters:
        fn.launches = 0
    logs = [trainer.step() for _ in range(2)]
    torch.cuda.synchronize()
    qc_launches = {fn.__name__: fn.launches for fn in qc_counters}
    log(f"[serve] question_coding from the JAX-format prior: 2 steps, launches {qc_launches}, "
        f"last logs {logs[-1]}")
    check(all(qc_launches[fn.__name__] > 0 for fn in (fused_sampling_forward, lm_forward_cuda,
                                                       tf_forward_cuda, tf_backward_cuda)),
          f"a kernel did not run: {qc_launches}")
    check(all(np.isfinite(v) for out in logs for g in out.values() for v in g.values()),
          "train logs not finite")
    del trainer
    shutil.rmtree(work, ignore_errors=True)

    times = {"write_s": write_s, "load_s": load_s,
             "first_answer_s": {f"{fmt} {dtype}": t for (fmt, dtype), t in first_answer_s.items()},
             "cli_questions_per_s": cli_qps, "beam4_ms": beam_ms}
    log(f"[serve] times on {smi}: {json.dumps(times)}")
    errs = {"seq2seq_decode": max(k1["bfloat16"], k1_random["bfloat16"]),
            "nmn_interpreter": k2["bfloat16"]}
    return launches, errs, times


# Phase 13: online serving. Two programs that hold a module of every kind
# between them (compare, query, no-op, same, relate, attention, scene; or,
# and), the first two rows K2 runs at each bucket.
EVERY_KIND_PROGRAMS = (
    ["equal_color", "query_color", "unique", "same_shape", "relate[left]", "filter_color[red]",
     "scene", "query_color", "unique", "filter_size[large]", "scene"],
    ["count", "union", "filter_shape[cube]", "scene", "intersect", "filter_color[red]", "scene",
     "filter_size[large]", "scene"],
)
ONLINE_BUCKETS = (4, 16, 64)
ONLINE_REQUESTS = 2048
ONLINE_IMAGES = 512
SERVE_QUESTIONS = ["how many red cubes are there", "is there a big metal ball",
                   "what color is the cylinder left of the cube",
                   "are there more cubes than balls", "what is the material of the big cylinder",
                   "is the green ball the same size as the cube",
                   "how many things are behind the red block", "what shape is the small thing"]


def bucket_against_plain(np, torch, dev, batch, pg_dev, pg_spec, nmn_dev, nmn_spec, vocab, seed):
    r"""Phase 13 (a) at one bucket of ``batch`` rows, on inputs from a
    generator of its own (``seed``): K1 on random questions and explicit
    Gumbel noise (``k1_against_plain``, phase 2's tolerances; the decoder's
    plan printed) and K2 on two programs with a module of every kind between
    them, valid CLEVR programs, token soups (from 16 rows), an invalid and an all-pad row
    (phase 3's tolerances; the persistent grid printed), each in float32 and
    bfloat16. Returns K1's and K2's errors by dtype."""
    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        build_banks, build_tables, execute_programs_kernel, execute_programs_plain,
        interpreter_launch,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import decoder_plan
    from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH, sample_clevr_like_programs

    gen = torch.Generator().manual_seed(seed)
    rs = np.random.RandomState(seed)
    T, V, L = pg_spec.max_decoding_steps, pg_spec.target_vocab_size, MAX_QUESTION_LENGTH
    q_dev = torch.from_numpy(random_questions(np, vocab, batch, L, seed=seed)).to(dev)
    noise = (-torch.log(-torch.log(torch.rand(T, batch, V, generator=gen).clamp_min(1e-12)))).to(dev)
    dtypes = ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"))
    for dtype, name in dtypes:
        pl = decoder_plan(batch, L, pg_spec.input_size, pg_spec.hidden_size, V, dtype)
        log(f"[bucket] B={batch} K1 decoder plan {name}: cluster {pl['cluster']} CTAs, rows "
            f"{pl['rows']} a cluster ({pl['rows_per_cta']} a CTA), {pl['clusters']} clusters "
            f"({pl['fit']} at once), {pl['smem']} B shared")
    k1 = k1_against_plain(torch, pg_dev, pg_spec, q_dev, noise, tag=f"bucket B={batch} K1")

    programs_np = sample_clevr_like_programs(vocab, batch, seed=seed)
    for row, program in enumerate(EVERY_KIND_PROGRAMS):
        programs_np[row] = 0
        programs_np[row, :len(program)] = [vocab.get_token_index(t, "programs") for t in program]
    valid_rows = batch - 2
    if batch >= 16:  # token soups: mostly invalid
        valid_rows = batch - 6
        programs_np[-6:-2] = rs.randint(0, vocab.get_vocab_size("programs"),
                                        (4, programs_np.shape[1]))
    programs_np[-2] = 0
    programs_np[-2, :2] = [vocab.get_token_index("count", "programs"),
                           vocab.get_token_index("filter_color[red]", "programs")]  # no scene
    programs_np[-1] = 0  # all padding: valid, the stem features pass through
    programs = torch.from_numpy(programs_np).to(dev)
    h, w, C = nmn_spec.height, nmn_spec.width, nmn_spec.module_channels
    feats = torch.randn(batch, h, w, nmn_spec.feature_channels, generator=gen).to(dev)
    tables = build_tables(nmn_spec, dev)
    k2 = {}
    for dtype, name in dtypes:
        launch = interpreter_launch(dtype, batch, h, w, C)
        stem = nmn.apply_stem(cast_params(nmn_dev["stem"], dtype), feats.to(dtype)).contiguous()
        banks = build_banks(nmn_dev, nmn_spec, dtype)
        out_k, inv_k = execute_programs_kernel(banks, tables, nmn_spec, stem, programs)
        out_p, inv_p = execute_programs_plain(banks, tables, nmn_spec, stem, programs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err = float((out_k.float() - out_p.float()).abs().max())
        scale = float(out_p.float().abs().max())
        log(f"[bucket] B={batch} K2 {name}: persistent grid {launch['grid']} blocks, weight ring "
            f"{launch['stages']} stages; invalid {int(inv_k.sum())}/{batch} (plain "
            f"{int(inv_p.sum())}), max |out err| {err:.3e}, max |out| {scale:.3e}")
        check(torch.equal(inv_k, inv_p), f"K2 invalid flags differ at B={batch}")
        check(not bool(inv_k[:valid_rows].any()), f"K2 marked a valid program invalid at B={batch}")
        check(bool(inv_k[-2]) and not bool(inv_k[-1]), f"K2 invalid/all-pad rows at B={batch}")
        check(torch.isfinite(out_k.float()).all(), f"K2 output not finite at B={batch}")
        check(err <= (1e-4 * max(1.0, scale) if name == "float32" else 2e-2 * scale),
              f"K2 {name} error {err} at B={batch}")
        k2[name] = err
    return k1, k2


def _percentiles(np, seconds):
    return {f"p{q}_ms": float(np.percentile(seconds, q)) * 1e3 for q in (50, 95, 99)}


def serve_online(np, torch, dev, smi):
    r"""Phase 13: online serving at full width, on inputs and weights from a
    generator of its own. (a) K1 and K2 against their plain versions at the
    buckets below the full batch; (b) ``warmup`` launching each bucket once,
    each bucket's ``_run_padded`` timed; (c) 2,048 requests through
    ``submit`` from 8 client threads and ``submit_many`` in groups of 1-64,
    at pipeline depth 1 and 2, answered as ``predict`` answers them and as
    the same batches answer again when run alone, with K1 and K2 launched;
    (d) never more than the depth in flight, the counters, an empty queue;
    (e) latency at a light closed-loop load and q/s at saturation; (f)
    ``predict``'s upload, the pageable float32 one with the cast on the card
    against the host cast into pinned bfloat16, and ``predict`` traced; (g)
    the serve CLI in-process on the card. Returns the dispatcher's launches
    of each kernel, K1's and K2's errors by bucket and dtype, and times."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    from probnmn_tpu_torch import serve
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.models import nmn, program_generator
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        execute_programs_kernel, interpreter_plan,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward, sampling_encode
    from probnmn_tpu_torch.data.preprocessing import tokenize_questions
    from probnmn_tpu_torch.serving import InferenceEngine
    from probnmn_tpu_torch.utils.checkpointing import save_objects
    from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH, make_clevr_like_vocabulary

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_online_")
    vocab = make_clevr_like_vocabulary()
    vocab.save_to_files(os.path.join(work, "vocab"))
    config = Config(os.path.join(repo, "configs", "joint_training_ours.yml"),
                    ["DATA.VOCABULARY", os.path.join(work, "vocab")])
    gen = torch.Generator().manual_seed(13)
    pg_spec, nmn_spec = program_generator.make_spec(vocab, config), nmn.make_spec(vocab, config)
    random_pg = program_generator.init_params(gen, pg_spec)
    pg = scripted_generator(torch, random_pg, pg_spec, vocab, SERVE_PROGRAM)
    nmn_params = nmn.init_nmn_params(gen, nmn_spec)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    # ------------------------------------------------------------ (a) buckets
    errs = {"seq2seq_decode": {}, "nmn_interpreter": {}}
    pg_dev = cast_params(random_pg, torch.float32, dev)
    nmn_dev = cast_params(nmn_params, torch.float32, dev)
    for i, batch in enumerate(ONLINE_BUCKETS):
        k1, k2 = bucket_against_plain(np, torch, dev, batch, pg_dev, pg_spec, nmn_dev, nmn_spec,
                                      vocab, seed=1300 + i)
        for name, got in (("seq2seq_decode", k1), ("nmn_interpreter", k2)):
            for dtype, err in got.items():
                errs[name].setdefault(dtype, {})[str(batch)] = err
    del pg_dev, nmn_dev

    # ------------------------------------------------------------ (b) warmup
    rs = np.random.RandomState(1310)
    questions = random_questions(np, vocab, ONLINE_REQUESTS, MAX_QUESTION_LENGTH, seed=1311)
    pool = torch.randn(ONLINE_IMAGES, nmn_spec.feature_channels, nmn_spec.height, nmn_spec.width,
                       generator=torch.Generator().manual_seed(1312)).numpy()
    image_of = rs.randint(0, ONLINE_IMAGES, ONLINE_REQUESTS)
    engine = InferenceEngine(vocab, pg_spec, nmn_spec, pg, nmn_params, batch_size=BATCH,
                             rng_seed=config.RANDOM_SEED, device=dev)
    counters = {"seq2seq_decode": fused_sampling_forward, "k1_encoder_sweep": sampling_encode,
                "nmn_interpreter": execute_programs_kernel, "nmn_plan": interpreter_plan}

    def reset():
        sync()
        for fn in counters.values():
            fn.launches = 0

    def read():
        sync()
        return {name: fn.launches for name, fn in counters.items()}

    reset()
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    warm = read()
    log(f"[serve-online] warmup over buckets {engine._buckets}: {warmup_s:.2f} s, launches {warm}")
    check(warm["seq2seq_decode"] == warm["nmn_interpreter"] == len(engine._buckets) == 4,
          f"warmup did not launch each bucket once: {warm}")
    run_padded = {}
    for b in engine._buckets:
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._run_padded(questions[:b], pool[:b], None, b, count_stats=False)
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        q_b = torch.from_numpy(questions[:b]).to(dev)
        im_b = torch.from_numpy(pool[:b]).to(dev).to(engine.compute_dtype)
        device_ms = cuda_ms(torch, lambda: engine._pipeline(q_b, im_b, 7), iters=10) \
            if dev.type == "cuda" else 0.0
        run_padded[str(b)] = {"host_ms": host_ms, "pipeline_ms": device_ms}
        log(f"[serve-online] bucket {b}: _run_padded {host_ms:.3f} ms (host clock, {b} rows "
            f"staged, uploaded, answered); its pipeline alone {device_ms:.3f} ms (CUDA events)")

    # ------------------------------------------------------------ (c), (d) dispatcher
    want = []
    for start in range(0, ONLINE_REQUESTS, BATCH):
        rows = slice(start, start + BATCH)
        want += engine.predict(questions[rows], pool[image_of[rows]])
    check("@@UNKNOWN@@" not in want, "the scripted program did not run")
    # The synchronous path's answers with every row padded to a smaller
    # bucket, in order: bf16 answers may differ by bucket (its convs and
    # GEMMs may take other algorithms at another batch size), never by a
    # row's neighbours.
    want_at = {BATCH: want}

    def synchronous_at(b):
        if b not in want_at:
            want_at[b] = []
            for start in range(0, ONLINE_REQUESTS, b):
                rows = slice(start, start + b)
                want_at[b] += engine._run_padded(questions[rows], pool[image_of[rows]], None, b,
                                                 count_stats=False)
        return want_at[b]

    def row_of(group):  # requests are views of `questions`: their first row
        offset = group.__array_interface__["data"][0] - questions.__array_interface__["data"][0]
        return offset // questions.strides[0]
    launch, finish = engine._launch_padded_groups, engine._finish
    records = {}

    def recording_launch(q_groups, im_groups, seed, pad_to):
        launched = launch(q_groups, im_groups, seed, pad_to)
        records[id(launched)] = [q_groups, im_groups, pad_to, None, launched]
        return launched

    def recording_finish(launched, count_stats=True):
        answers = finish(launched, count_stats)
        if id(launched) in records:
            records[id(launched)][3] = answers
        return answers

    units = [(i, i + 1, True) for i in range(ONLINE_REQUESTS // 2)]
    i = ONLINE_REQUESTS // 2
    while i < ONLINE_REQUESTS:
        j = min(i + int(rs.randint(1, 65)), ONLINE_REQUESTS)
        units.append((i, j, False))
        i = j
    units = [units[k] for k in rs.permutation(len(units))]
    launches = {name: 0 for name in counters}
    dispatcher = {}
    for depth in (1, 2):
        records.clear()
        engine._launch_padded_groups, engine._finish = recording_launch, recording_finish
        engine._max_in_flight = 0
        before = engine.stats()
        futures = [None] * ONLINE_REQUESTS
        reset()
        engine.start(max_batch_delay=0.005, pipeline_depth=depth)

        def client(t):
            for a, b, single in units[t::8]:
                if single:
                    futures[a] = engine.submit(questions[a], pool[image_of[a]])
                else:
                    futures[a:b] = engine.submit_many(questions[a:b], pool[image_of[a:b]])

        t0 = time.perf_counter()
        try:
            threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            got = [f.result(timeout=120) for f in futures]
            seconds = time.perf_counter() - t0
        finally:
            engine.stop()
        ran = read()
        after = engine.stats()
        del engine._launch_padded_groups, engine._finish
        for name, n in ran.items():
            launches[name] += n
        bucket_of = np.zeros(ONLINE_REQUESTS, np.int64)
        for q_groups, _, pad_to, _, _ in records.values():
            for qg in q_groups:
                bucket_of[row_of(qg):row_of(qg) + len(qg)] = pad_to
        check(bool((bucket_of > 0).all()), "a request is in no recorded batch")
        mismatched = sum(a != synchronous_at(int(b))[r]
                         for r, (a, b) in enumerate(zip(got, bucket_of)))
        off_predict = [r for r, (a, b) in enumerate(zip(got, want)) if a != b]
        off_buckets = sorted({int(bucket_of[r]) for r in off_predict})
        dispatcher_distinct = len(set(got))
        # What the card received for each batch, against its requests cast
        # here: a staging buffer rewritten while its copy was in flight
        # would differ. (The random NMN's answers barely depend on the
        # features, so the answers alone would not show it.) Then the same
        # batches again, each alone.
        staged_bad, again = 0, 0
        for q_groups, im_groups, pad_to, answers, launched in records.values():
            want_q = torch.zeros((pad_to, q_groups[0].shape[1]), dtype=torch.int64)
            want_im = torch.zeros((pad_to,) + im_groups[0].shape[1:], dtype=engine.compute_dtype)
            cursor = 0
            for qg, img in zip(q_groups, im_groups):
                want_q[cursor:cursor + len(qg)] = torch.from_numpy(qg)
                want_im[cursor:cursor + len(img)] = torch.from_numpy(img)
                cursor += len(qg)
            if dev.type == "cuda":  # the CPU engine computes on its staging buffer itself
                got_q = torch.cat([shard[0].cpu() for shard in launched.keep])
                got_im = torch.cat([shard[1].cpu() for shard in launched.keep])
                staged_bad += int(not (torch.equal(got_q, want_q) and torch.equal(
                    got_im.view(torch.int16), want_im.view(torch.int16))))
            again += sum(a != b for a, b in zip(
                finish(launch(q_groups, im_groups, 0, pad_to), False), answers))
        sizes = {}
        for _, _, pad_to, _, _ in records.values():
            sizes[pad_to] = sizes.get(pad_to, 0) + 1
        answered = after["requests"] - before["requests"]
        dispatcher[str(depth)] = {"seconds": seconds, "batches": len(records), "buckets": sizes,
                                  "differ_from_predict": len(off_predict),
                                  "max_in_flight": after["max_in_flight"], "launches": ran}
        log(f"[serve-online] dispatcher depth {depth}: {ONLINE_REQUESTS} requests "
            f"({ONLINE_REQUESTS // 2} by submit, the rest by submit_many in groups of 1-64, 8 "
            f"client threads) in {seconds:.3f} s, {len(records)} batches by bucket "
            f"{dict(sorted(sizes.items()))}; {dispatcher_distinct} distinct answers, {mismatched} "
            f"differ from the synchronous path's at their bucket, {len(off_predict)} from "
            f"predict's (in buckets {off_buckets}), {again} from the same batches run alone; "
            f"{staged_bad} "
            f"batches whose features on the card differ from their requests'; launches {ran}; "
            f"most in flight {after['max_in_flight']}; stats requests +{answered}, queue depth "
            f"{after['queue_depth']}")
        check(mismatched == 0, f"depth {depth}: {mismatched} dispatcher answers differ from the "
              f"synchronous path's at their bucket")
        check(BATCH not in off_buckets, f"depth {depth}: a {BATCH}-row batch answered otherwise "
              f"than predict")
        check(again == 0, f"depth {depth}: {again} answers differ from their batch run alone")
        check(staged_bad == 0, f"depth {depth}: {staged_bad} batches reached the card altered")
        check(ran["seq2seq_decode"] > 0 and ran["nmn_interpreter"] > 0
              and ran["seq2seq_decode"] == len(records), f"K1/K2 launches {ran}")
        check(1 <= after["max_in_flight"] <= depth, f"{after['max_in_flight']} batches in flight "
              f"at depth {depth}")
        check(answered == ONLINE_REQUESTS and after["queue_depth"] == 0,
              f"stats {after} after {ONLINE_REQUESTS} requests")

    bucket_flips = {str(b): sum(x != y for x, y in zip(want_at[b], want))
                    for b in sorted(want_at) if b != BATCH}
    dispatcher["synchronous_differ_from_predict"] = bucket_flips
    log(f"[serve-online] the synchronous path over the same {ONLINE_REQUESTS} rows padded to a "
        f"smaller bucket: rows answered otherwise than at {BATCH}, by bucket {bucket_flips}")

    # ------------------------------------------------------------ (e) load
    records.clear()
    engine._launch_padded_groups = recording_launch
    engine.start(max_batch_delay=0.005, pipeline_depth=2)
    light = []
    try:
        for k in range(150):
            t0 = time.perf_counter()
            engine.submit(questions[k], pool[image_of[k]]).result(timeout=60)
            light.append(time.perf_counter() - t0)
    finally:
        engine.stop()
    light_buckets = {}
    for _, _, pad_to, _, _ in records.values():
        light_buckets[pad_to] = light_buckets.get(pad_to, 0) + 1
    del engine._launch_padded_groups
    light_load = dict(_percentiles(np, light), buckets=light_buckets, requests=len(light))
    log(f"[serve-online] light load (one client, one request at a time, max_batch_delay 5 ms): "
        f"{len(light)} requests, latency p50 {light_load['p50_ms']:.3f} / p95 "
        f"{light_load['p95_ms']:.3f} / p99 {light_load['p99_ms']:.3f} ms (host clock), buckets "
        f"{light_buckets}")
    # Where a batch's host time goes: staging (the cast included), the
    # pipeline enqueued, the whole launch (staging, the copy and the
    # pipeline), and the wait for its answers; each as wall and as the
    # calling thread's CPU time (what it neither waited for nor lost to
    # another thread). At saturation with the intra-op threads as they
    # are, with 4 of them, and with a 0.5 ms GIL switch interval; and the
    # same 4 x 64-row batches launched and fetched from one thread alone.
    part_names = ("_stage", "_pipeline", "_launch_padded_groups", "_fetch")

    def timed_parts():
        parts = {name: [] for name in part_names}

        def timed(name, fn):
            def run(*args):
                t0, c0 = time.perf_counter(), time.thread_time()
                out = fn(*args)
                parts[name].append((time.perf_counter() - t0, time.thread_time() - c0))
                return out
            return run

        for name in part_names:
            setattr(engine, name, timed(name, getattr(engine, name)))
        return parts

    def part_ms(parts):
        out = {"batches": len(parts["_fetch"])}
        for name, v in parts.items():
            out[name] = {"wall": 1e3 * sum(w for w, _ in v) / max(len(v), 1),
                         "cpu": 1e3 * sum(c for _, c in v) / max(len(v), 1)}
        return out

    def part_text(ms):
        return ", ".join(f"{name.strip('_')} {ms[name]['wall']:.3f} (CPU {ms[name]['cpu']:.3f})"
                         for name in part_names)

    intra_op = torch.get_num_threads()
    saturation, saturation_parts = {}, {}
    variants = [("1", 1, intra_op, None), ("2", 2, intra_op, None),
                ("2_intra_op_4", 2, 4, None), ("2_switch_0.5ms", 2, intra_op, 0.0005)]
    for key, depth, n_threads, switch in variants:
        done = [0] * 8
        parts = timed_parts()
        old_switch = sys.getswitchinterval()
        torch.set_num_threads(n_threads)
        if switch is not None:
            sys.setswitchinterval(switch)
        engine.start(max_batch_delay=0.005, pipeline_depth=depth)
        end = time.perf_counter() + 2.0

        def loader(t):
            rows = slice(64 * t, 64 * t + 64)
            while time.perf_counter() < end:
                futures = engine.submit_many(questions[rows], pool[rows])
                for f in futures:
                    f.result(timeout=60)
                done[t] += len(futures)

        t0 = time.perf_counter()
        try:
            threads = [threading.Thread(target=loader, args=(t,)) for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            seconds = time.perf_counter() - t0
        finally:
            engine.stop()
            torch.set_num_threads(intra_op)
            sys.setswitchinterval(old_switch)
            for name in part_names:
                delattr(engine, name)
        saturation[key] = sum(done) / seconds
        saturation_parts[key] = part_ms(parts)
        log(f"[serve-online] saturation depth {depth} ({n_threads} intra-op threads, GIL switch "
            f"{1e3 * (switch or old_switch):g} ms): 8 threads of submit_many(64), {sum(done)} "
            f"requests in {seconds:.3f} s: {saturation[key]:.1f} q/s (host clock); "
            f"{saturation_parts[key]['batches']} batches, a batch's mean host ms: "
            f"{part_text(saturation_parts[key])}")
    groups = [slice(BATCH // 4 * t, BATCH // 4 * (t + 1)) for t in range(4)]
    for key, n_threads in (("alone", intra_op), ("alone_intra_op_4", 4)):
        torch.set_num_threads(n_threads)
        parts = timed_parts()
        try:
            for _ in range(12):
                engine._finish(engine._launch_padded_groups(
                    [questions[g] for g in groups], [pool[g] for g in groups], None, BATCH), False)
        finally:
            torch.set_num_threads(intra_op)
            for name in part_names:
                delattr(engine, name)
        for name in part_names:
            parts[name] = parts[name][2:]  # the first two take new pinned blocks
        saturation_parts[key] = part_ms(parts)
        log(f"[serve-online] the same 4 x {BATCH // 4}-row batches from one thread alone ({n_threads} "
            f"intra-op threads), launch then fetch, a batch's mean host ms: "
            f"{part_text(saturation_parts[key])}")

    # ------------------------------------------------------------ (f) predict's upload
    q256, im256 = questions[:BATCH], np.ascontiguousarray(pool[:BATCH])
    reps = 5

    def host_ms(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    dt = engine.compute_dtype
    old_upload = host_ms(lambda: torch.from_numpy(im256).to(dev).to(dt))
    host_cast = host_ms(lambda: engine._stage([q256], [im256], BATCH))
    _, staged_im = engine._stage([q256], [im256], BATCH)
    plain_cast = host_ms(lambda: staged_im.copy_(torch.from_numpy(im256)))
    pinned_copy = host_ms(lambda: staged_im.to(dev, non_blocking=True))
    new_upload = host_ms(lambda: engine._stage([q256], [im256], BATCH)[1].to(
        dev, non_blocking=True))
    # A batch staged as one group and as four of a quarter each, back to
    # back (the intra-op threads busy) and each after 5 ms asleep (as the
    # launcher stages after waiting on the card).
    quarters = [slice(BATCH // 4 * t, BATCH // 4 * (t + 1)) for t in range(4)]
    stage_split = {}
    for n_groups, groups in ((1, [slice(0, BATCH)]), (4, quarters)):
        def stage_groups():
            return engine._stage([q256[g] for g in groups], [im256[g] for g in groups], BATCH)

        stage_split[f"{n_groups}_back_to_back"] = host_ms(stage_groups)
        cold = []
        for _ in range(reps):
            time.sleep(0.005)
            t0 = time.perf_counter()
            stage_groups()
            cold.append(time.perf_counter() - t0)
        stage_split[f"{n_groups}_after_5ms"] = 1e3 * sum(cold) / reps
    log(f"[serve-online] _stage of {BATCH} rows (host clock, ms) as 1 group / 4 groups: back to "
        f"back {stage_split['1_back_to_back']:.3f} / {stage_split['4_back_to_back']:.3f}, each "
        f"after 5 ms asleep {stage_split['1_after_5ms']:.3f} / {stage_split['4_after_5ms']:.3f}")
    card_cast = torch.from_numpy(im256).to(dev).to(dt)
    staged = engine._stage([q256], [im256], BATCH)[1].to(dev)
    same_bits = torch.equal(card_cast.view(torch.int16) if dt == torch.bfloat16 else card_cast,
                            staged.view(torch.int16) if dt == torch.bfloat16 else staged)
    check(same_bits, "the host cast's features differ from the card's cast")

    def old_predict():
        q_dev = torch.from_numpy(q256).to(dev)
        im = torch.from_numpy(im256).to(dev).to(dt)
        return [vocab.get_token_from_index(int(a), "answers")
                for a in engine._pipeline(q_dev, im, 7).cpu().tolist()]

    old_predict_ms = host_ms(old_predict)
    predict_ms = host_ms(lambda: engine.predict(q256, im256))
    check(old_predict() == engine.predict(q256, im256), "old and new predict answer otherwise")
    upload = {"old_upload_ms": old_upload, "host_cast_ms": host_cast, "copy_cast_ms": plain_cast,
              "pinned_copy_ms": pinned_copy,
              "new_upload_ms": new_upload, "old_predict_ms": old_predict_ms,
              "predict_ms": predict_ms, "predict_qps": BATCH / predict_ms * 1e3,
              "old_predict_qps": BATCH / old_predict_ms * 1e3,
              "old_bytes": im256.nbytes, "new_bytes": staged_im.numel() * staged_im.element_size(),
              "stage_split_ms": stage_split}
    log(f"[serve-online] predict's upload at {BATCH} rows (host clock): pageable float32 "
        f"({im256.nbytes / 1e6:.1f} MB) + cast on the card {old_upload:.3f} ms; host cast into "
        f"pinned {str(dt).split('.')[-1]} ({upload['new_bytes'] / 1e6:.1f} MB) {host_cast:.3f} ms "
        f"(its cast into a buffer already pinned {plain_cast:.3f}) + copy {pinned_copy:.3f} ms = {new_upload:.3f} ms "
        f"together; the card sees the same bits")
    log(f"[serve-online] predict {predict_ms:.3f} ms/batch, {upload['predict_qps']:.1f} q/s; the old "
        f"upload's predict {old_predict_ms:.3f} ms/batch, {upload['old_predict_qps']:.1f} q/s")
    if dev.type == "cuda":
        wall_ms, busy_ms, top, _ = trace(torch, lambda: engine.predict(q256, im256))
        upload["trace"] = {"wall_ms": wall_ms, "busy_ms": busy_ms}
        if busy_ms > 0:
            log(f"[trace] predict (pinned {str(dt).split('.')[-1]} staging) under torch.profiler: "
                f"{wall_ms:.2f} ms host clock, device busy {busy_ms:.2f} ms, idle share "
                f"{1 - busy_ms / wall_ms:.3f}")
            for us, name, count in top:
                log(f"[trace]   {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}")
        else:
            log("[trace] the profiler recorded no device time: idle share not measured")

    # ------------------------------------------------------------ (g) the serve CLI
    config.dump(os.path.join(work, "joint.yml"))
    ckpt = os.path.join(work, "joint_port.ckpt")
    save_objects(ckpt, {"program_generator": pg, "nmn": nmn_params}, 0)
    del engine
    args = serve.parser.parse_args([
        "--config-yml", os.path.join(work, "joint.yml"), "--checkpoint", ckpt,
        "--batch-size", str(BATCH), "--device", dev.type, "--port", "0",
        "--features-h5", os.path.join(work, "no_features.h5")])
    t0 = time.perf_counter()
    ctx = serve.ServingContext(args)
    ready_s = time.perf_counter() - t0
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(ctx))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        health = call("/healthz")
        # Scaled apart, so that the eight answers need not agree.
        images = pool[image_of[:len(SERVE_QUESTIONS)]] * np.float32(
            np.geomspace(0.1, 10.0, len(SERVE_QUESTIONS)))[:, None, None, None]
        replies = [None] * len(SERVE_QUESTIONS)

        def ask(k):
            replies[k] = call("/predict", {"question": SERVE_QUESTIONS[k],
                                           "features": images[k].tolist()})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(k,)) for k in range(len(SERVE_QUESTIONS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        http_s = time.perf_counter() - t0
        bad = call("/predict", {"question": "what", "features": [[1.0, 2.0]]})
        stats = call("/stats")
    finally:
        httpd.shutdown()
        ctx.engine.stop()
    ids, _ = tokenize_questions(SERVE_QUESTIONS, ctx.engine.vocabulary, max_len=MAX_QUESTION_LENGTH)
    want_cli = ctx.engine.predict(ids.astype(np.int64), images)
    got_cli = [body["answers"][0] if status == 200 else None for status, body in replies]
    log(f"[serve-online] serve CLI on {dev.type}: ready in {ready_s:.2f} s (checkpoint, warmup, "
        f"start); /healthz {health}; {len(SERVE_QUESTIONS)} text questions with inline features "
        f"from {len(SERVE_QUESTIONS)} threads in {http_s:.3f} s: {got_cli} (predict: {want_cli}); "
        f"a malformed payload: {bad[0]}")
    log(f"[serve-online] /stats: {json.dumps(stats[1])}")
    check(health == (200, {"ok": True}), f"/healthz {health}")
    check(got_cli == want_cli, "the serve CLI's answers differ from engine.predict's")
    check(bad[0] == 400, f"a malformed payload got {bad}")
    check(stats[0] == 200 and stats[1]["requests"] >= len(SERVE_QUESTIONS)
          and stats[1]["queue_depth"] == 0, f"/stats {stats}")
    del ctx
    shutil.rmtree(work, ignore_errors=True)

    times = {"warmup_s": warmup_s, "run_padded": run_padded, "dispatcher": dispatcher,
             "light_load": light_load, "saturation_qps": saturation,
             "saturation_batch_ms": saturation_parts, "upload": upload,
             "serve_cli": {"ready_s": ready_s, "http_s": http_s}, "card": smi}
    log(f"[serve-online] times on {smi}: {json.dumps(times)}")
    return launches, errs, times


# Phase 14: images -> features -> answers. 293 images make batches of 128,
# 128 and 37 at the extract CLI's default batch.
EXTRACT_IMAGES = 293
EXTRACT_BATCH = 128
EXTRACT_TOL = 1e-4  # of max |f|: IEEE float32 holds it, TF32 would not


def extract_work(model, batch, size=224):
    r"""FLOPs and bytes of the extractor on ``batch`` images of ``size``
    squared: every conv's multiply-adds from its shapes (the stride on
    conv2); the uint8 images read once, the float32 weights read once, the
    float32 features written once."""
    from probnmn_tpu_torch.models.resnet import FEATURE_CHANNELS, STAGES

    s, cin = size // 2, 64
    macs = s * s * 64 * 3 * 49
    s //= 2  # the maxpool
    for blocks, mid, out, stride in STAGES:
        for i in range(blocks):
            so = s // stride if i == 0 else s
            macs += s * s * mid * cin + so * so * (mid * mid * 9 + out * mid)
            if i == 0:
                macs += so * so * out * cin
            s, cin = so, out
    weight_bytes = sum(b.numel() * b.element_size() for b in model.buffers())
    nbytes = batch * size * size * 3 + weight_bytes + batch * FEATURE_CHANNELS * s * s * 4
    return 2.0 * macs * batch, nbytes


def plain_extract(torch, F, params, x):
    r"""The extractor written out over its unfolded ``params`` (OIHW convs,
    batch norm as scale and shift after each conv, as the JAX function
    applies it), with ``F.conv2d``'s torchvision padding: the plain version
    the module is held to and timed against on the card."""
    from probnmn_tpu_torch.models.resnet import STAGES

    def conv_bn(p, x, stride=1, padding=0):
        y = F.conv2d(x, p["w"], None, stride, padding)
        return y * p["bn"]["scale"].view(-1, 1, 1) + p["bn"]["shift"].view(-1, 1, 1)

    x = torch.relu(conv_bn(params["conv1"], x, 2, 3))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, (_, _, _, stride) in zip(params["layers"], STAGES):
        for i, block in enumerate(stage):
            s = stride if i == 0 else 1
            out = torch.relu(conv_bn(block["conv1"], x))
            out = torch.relu(conv_bn(block["conv2"], out, s, 1))
            out = conv_bn(block["conv3"], out)
            identity = conv_bn(block["downsample"], x, s) if "downsample" in block else x
            x = torch.relu(out + identity)
    return x


def extract_to_answers(np, torch, dev, smi):
    r"""Phase 14: a synthesized torchvision ``resnet101`` state dict (its
    ``layer4``, ``fc`` and ``num_batches_tracked`` keys present) and 293
    random uint8 224 x 224 images through ``extract_features`` on the card
    (batches of 128, 128, 37), then ``InferenceEngine.predict`` on 256
    questions over the first 256 features, with a scripted generator; the
    extractor's, K1's and K2's counters set to 0 before that path and read
    after. The card's features against the same module's on the CPU (4
    images) and against the plain forward, the partial batch against
    the same images inside a full batch, the float32 NMN's logits on the
    card's features against the CPU's on the CPU's features; times, memory,
    bound. Inputs come from a generator of their own. Returns the JSON
    entry."""
    import tempfile

    import torch.nn.functional as F

    from probnmn_tpu_torch.models import nmn, program_generator, resnet
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        execute_programs_kernel, interpreter_plan,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, sampling_encode,
    )
    from probnmn_tpu_torch.preprocess.extract_features import (
        extract_features, load_image, normalize_images,
    )
    from probnmn_tpu_torch.serving import InferenceEngine
    from probnmn_tpu_torch.utils.clevr import (
        CLEVR_ANSWERS, MAX_QUESTION_LENGTH, make_clevr_like_vocabulary,
        sample_clevr_like_programs,
    )

    gen = torch.Generator().manual_seed(14)
    state = resnet.synthetic_torchvision_state_dict(gen)
    check(any(k.startswith("layer4.") for k in state) and "fc.weight" in state
          and "bn1.num_batches_tracked" in state, "the state dict lacks torchvision's extra keys")
    params = resnet.params_from_torch_state_dict(state)
    model, cpu_model = resnet.ResNet101Stage3(params), resnet.ResNet101Stage3(params)
    n_conv = sum(b.numel() for name, b in model.named_buffers() if name.endswith("weight"))
    images = torch.randint(0, 256, (EXTRACT_IMAGES, 224, 224, 3), generator=gen,
                           dtype=torch.uint8).numpy()
    vocab = make_clevr_like_vocabulary()
    pg_spec, nmn_spec = program_generator.make_spec(vocab), nmn.make_spec(vocab)
    pg = scripted_generator(torch, program_generator.init_params(gen, pg_spec), pg_spec, vocab,
                            SERVE_PROGRAM)
    nmn_params = nmn.init_nmn_params(gen, nmn_spec)
    questions = random_questions(np, vocab, BATCH, MAX_QUESTION_LENGTH, seed=14)
    engine = InferenceEngine(vocab, pg_spec, nmn_spec, pg, nmn_params, batch_size=BATCH,
                             device="cuda")
    engine.warmup()
    extract_features(model, images[:EXTRACT_BATCH], EXTRACT_BATCH, "cuda")  # cuDNN's first calls
    log(f"[extract] {n_conv / 1e6:.2f}M conv parameters of {len(state)} state-dict keys; "
        f"{EXTRACT_IMAGES} images 224x224 uint8, batch {EXTRACT_BATCH}; cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}")

    # ------------------------------------------------------------ the main path
    resnet.ResNet101Stage3.launches = 0
    fused_sampling_forward.launches = 0
    sampling_encode.launches = 0
    execute_programs_kernel.launches = 0
    interpreter_plan.launches = 0
    features = extract_features(model, images, EXTRACT_BATCH, "cuda")
    answers = engine.predict(questions, features[:BATCH], seed=14)
    torch.cuda.synchronize()
    launches = {"extract": resnet.ResNet101Stage3.launches,
                "seq2seq_decode": fused_sampling_forward.launches,
                "k1_encoder_sweep": sampling_encode.launches,
                "nmn_interpreter": execute_programs_kernel.launches,
                "nmn_plan": interpreter_plan.launches}
    f_scale = float(np.abs(features).max())
    log(f"[extract] images -> features -> answers: launches {launches}; features "
        f"{features.shape} {features.dtype}, max |f| {f_scale:.4f}, mean |f| "
        f"{float(np.abs(features).mean()):.4f}; answers seen {sorted(set(answers))[:8]}")
    check(launches["extract"] == -(-EXTRACT_IMAGES // EXTRACT_BATCH),
          f"the extractor's batches: {launches['extract']}")
    check(all(n > 0 for n in launches.values()), f"a kernel did not run on the path: {launches}")
    check(features.shape == (EXTRACT_IMAGES, 1024, 14, 14) and features.dtype == np.float32,
          f"features {features.shape} {features.dtype}")
    check(bool(np.isfinite(features).all()) and 1.0 < f_scale < 100.0, f"features max {f_scale}")
    check(len(answers) == BATCH and "@@UNKNOWN@@" not in answers
          and set(answers) <= set(CLEVR_ANSWERS), "the answers on the extracted features")

    # ------------------------------------------------------------ checks
    cpu_features = extract_features(cpu_model, images[:4], 4, "cpu")
    cpu_scale = float(np.abs(cpu_features).max())
    cpu_err = float(np.abs(features[:4] - cpu_features).max())
    full = extract_features(model, images[-EXTRACT_BATCH:], EXTRACT_BATCH, "cuda")
    tail = EXTRACT_IMAGES % EXTRACT_BATCH
    tail_err = float(np.abs(features[-tail:] - full[-tail:]).max())
    x128 = torch.from_numpy(images[:EXTRACT_BATCH]).to(dev)
    params_dev = cast_params(params, torch.float32, dev)
    with torch.no_grad(), resnet.ieee_float32_convs():
        plain = plain_extract(torch, F, params_dev, normalize_images(x128))
    plain_err = float((plain - torch.from_numpy(features[:EXTRACT_BATCH]).to(dev)).abs().max())
    del plain
    log(f"[extract] card vs CPU on 4 images: max |err| {cpu_err:.3e} (max |f| {cpu_scale:.4f}, "
        f"limit {EXTRACT_TOL * cpu_scale:.3e}); the {tail}-row batch vs its rows in a full batch "
        f"{tail_err:.3e}; the module vs the plain forward on the card, {EXTRACT_BATCH} images "
        f"{plain_err:.3e}")
    check(cpu_err <= EXTRACT_TOL * cpu_scale, f"card vs CPU features {cpu_err}")
    check(tail_err <= EXTRACT_TOL * f_scale, f"partial vs full batch {tail_err}")
    check(plain_err <= EXTRACT_TOL * f_scale, f"module vs plain forward {plain_err}")
    programs = sample_clevr_like_programs(vocab, 4, seed=14)
    gpu32 = nmn.make_fast_inference_fn(cast_params(nmn_params, torch.float32, dev), nmn_spec,
                                       device=dev, dtype=torch.float32)(
        torch.from_numpy(features[:4]).to(dev).permute(0, 2, 3, 1),
        torch.from_numpy(programs).to(dev))
    cpu32 = nmn.make_fast_inference_fn(nmn_params, nmn_spec, device="cpu", dtype=torch.float32)(
        torch.from_numpy(cpu_features).permute(0, 2, 3, 1), torch.from_numpy(programs))
    logit_err = float((gpu32["answer_logits"].cpu() - cpu32["answer_logits"]).abs().max())
    logit_scale = max(1.0, float(cpu32["answer_logits"].abs().max()))
    log(f"[extract] float32 NMN on the card's features vs the CPU's on the CPU's, 4 rows: "
        f"max |logit err| {logit_err:.3e} (limit {1e-3 * logit_scale:.3e})")
    check(not bool(cpu32["invalid"].any()) and torch.equal(gpu32["invalid"].cpu(), cpu32["invalid"]),
          "NMN invalid flags on the extracted features")
    check(logit_err <= 1e-3 * logit_scale, f"NMN logits on card vs CPU features {logit_err}")

    # ------------------------------------------------------------ times
    def forward():
        return model(normalize_images(x128))

    ms = cuda_ms(torch, forward, iters=10)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        ms_benchmark = cuda_ms(torch, forward, iters=10, warmup=3)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    with torch.no_grad(), resnet.ieee_float32_convs():
        plain_ms = cuda_ms(torch, lambda: plain_extract(torch, F, params_dev,
                                                         normalize_images(x128)), iters=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = forward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    upload_ms = cuda_ms(torch, lambda: torch.from_numpy(images[:EXTRACT_BATCH]).to(dev), iters=10)
    download_ms = cuda_ms(torch, lambda: out.contiguous().cpu(), iters=5)
    flops, nbytes = extract_work(model, EXTRACT_BATCH)
    bound_ms, bound_by = bound(flops, nbytes, "float32")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f256 = extract_features(model, images[:BATCH], EXTRACT_BATCH, "cuda")
        engine.predict(questions, f256, seed=14)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"[extract] forward {ms:.3f} ms per {EXTRACT_BATCH}-image batch (CUDA events, "
        f"cudnn.benchmark {benchmark}; with cudnn.benchmark on {ms_benchmark:.3f}), "
        f"{EXTRACT_BATCH / ms * 1e3:.1f} images/s; plain forward {plain_ms:.3f}; bound "
        f"{bound_ms:.3f} by {bound_by} ({flops / 1e9:.1f} GFLOP at "
        f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s float32 SIMT, {nbytes / 1e6:.1f} MB); "
        f"card {smi}")
    log(f"[extract] uint8 upload {upload_ms:.3f} ms per batch ({EXTRACT_BATCH * 150528 / 1e6:.1f} "
        f"MB), feature download {download_ms:.3f} ms ({out.numel() * 4 / 1e6:.1f} MB); "
        f"max_memory_allocated at B = {EXTRACT_BATCH}: {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} "
        f"GB above what was allocated before)")
    log(f"[extract] {BATCH} images -> {BATCH} answers (extract_features + predict, host clock): "
        f"{', '.join(f'{w:.2f}' for w in walls)} ms")
    del out
    try:
        from PIL import Image
    except ImportError:
        load_ms = None
        log("[extract] PIL is not installed here: load_image not timed")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "clevr_like.png")
            Image.fromarray(np.ascontiguousarray(
                images[0].repeat(2, axis=0).repeat(3, axis=1)[:320, :480])).save(path)
            load_image(path)
            t0 = time.perf_counter()
            for _ in range(20):
                load_image(path)
            load_ms = (time.perf_counter() - t0) / 20 * 1e3
        log(f"[extract] load_image on a 480x320 PNG (decode, resize): {load_ms:.3f} ms per image")
    return {
        "name": "extract", "route": "cuda", "source": "probnmn_tpu_torch/models/resnet.py",
        "replaces": "probnmn_tpu/models/resnet.py:86",
        "kernel": "cuDNN float32 (IEEE) convs through PyTorch; the JAX extractor is XLA, no Pallas",
        "launches": launches["extract"], "max_abs_err": cpu_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "ms_cudnn_benchmark": ms_benchmark, "images_per_s": EXTRACT_BATCH / ms * 1e3,
        "max_abs_err_partial_batch": tail_err, "max_abs_err_plain": plain_err,
        "max_abs_logit_err": logit_err, "max_abs_f": f_scale, "upload_ms": upload_ms,
        "download_ms": download_ms, "peak_bytes": peak, "images_to_answers_ms": walls,
        "load_image_ms": load_ms, "route_launches": launches,
    }


DROPOUT = 0.2
DROPOUT_MODELS = ("PROGRAM_PRIOR", "PROGRAM_GENERATOR", "QUESTION_RECONSTRUCTOR")


def traced_route(torch, fn, names, want, tries=3):
    r"""Launches of each named kernel in one traced call of ``fn``, traced up
    to ``tries`` times until they read ``want``. Late in a run the profiler
    on the H100 dropped the first kernels of a trace, idle gaps and all
    (``profiled``): a program_prior step read 3 of its 4 sweeps and 2 of its
    3 dropout passes three times running, while the same step traced in a
    fresh process read them all. So each trace starts with 64 small fills
    and a synchronize, which take the loss, before ``fn``. Returns every
    try's counts; the last is the one to check."""
    def padded():
        pad = torch.empty(1, device="cuda")
        for _ in range(64):
            pad.fill_(0.0)
        torch.cuda.synchronize()
        fn()

    seen = []
    for _ in range(tries):
        _, _, _, counts = trace(torch, padded)
        seen.append({k: launches_of(counts, k) for k in names})
        if seen[-1] == want:
            break
    return seen


def step_against_cpu(torch, tag, card, cpu, record, replay):
    r"""One step of the trainer ``card`` and one of ``cpu`` (the plain
    versions, from the same parameters and batch), the CPU step fed the
    random draws the card's took (``record`` wraps the card's draws,
    ``replay`` hands them to the CPU's): the logged losses within 1e-4 (of
    max(1, |value|)), every clamped gradient leaf within 1e-4 * max(1,
    max|g|), and 99% of the parameters within 1e-5 after the update (Adam's
    first step is about lr * sign(g), which may flip where |g| is at the
    float32 noise floor). Returns the card's logs and the largest loss
    difference."""
    from probnmn_tpu_torch.training._trainer import tree_leaves

    with record():
        got = card.step()
    with replay():
        want = cpu.step()
    flat = {f"{g}/{k}": v for g, vals in want.items() for k, v in
            (vals.items() if isinstance(vals, dict) else [("", vals)])}
    flat_card = {f"{g}/{k}": v for g, vals in got.items() for k, v in
                 (vals.items() if isinstance(vals, dict) else [("", vals)])}
    loss_diff = max(abs(flat_card[k] - v) for k, v in flat.items())
    log(f"[{tag}] one step, card vs CPU on the card's draws: logs {flat_card} / {flat}")
    for key, value in flat.items():
        check(abs(flat_card[key] - value) <= 1e-4 * max(1.0, abs(value)),
              f"{tag}: card vs CPU {key}")
    worst = 0.0
    for index, (a, b) in enumerate(zip(tree_leaves(card.params), tree_leaves(cpu.params))):
        err, scale = float((a.grad.cpu() - b.grad).abs().max()), float(b.grad.abs().max())
        check(err <= 1e-4 * max(1.0, scale), f"{tag}: card vs CPU gradient of leaf {index}: {err}")
        worst = max(worst, err / max(1.0, scale))
    diffs = [(a.detach().cpu() - b.detach()).abs()
             for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params))]
    close = sum(int((d <= 1e-5).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    log(f"[{tag}]   every gradient leaf within 1e-4 * max(1, max|g|) (worst ratio {worst:.3e}); "
        f"params within 1e-5 after the update: {close:.6f}")
    check(close >= 0.99, f"{tag}: card vs CPU params after one step")
    return got, loss_diff


def train_with_dropout(np, torch, dev, smi):
    r"""Phase 15: the deferred training options at the shipped width (256 x
    2, the configs' batch of 256) with DROPOUT 0.2 on the ProgramPrior, the
    generator and the reconstructor and OPTIM.ADAM_MU_DTYPE bfloat16: K1's
    encoder and K1, K3f/K3b and K4f/K4b (the four passes of a
    question_coding step) with dropout masks against their plain versions
    under the same masks, at phases 2, 6 and 7's tolerances; one
    question_coding and one program_prior step on the card against the CPU
    trainer on the masks (and the programs) the card drew, with every
    kernel's launch counter above 0 and the masked launches under the
    profiler; a 2-step ``--profile-dir`` run (``train.run``) whose Chrome
    trace names the kernels; each masked kernel's time beside the same
    kernel without masks on the same inputs; and the question_coding step's
    time at DROPOUT 0 and 0.2. Its inputs come from generators of its own.
    Returns ``{kernel name: the entries phase 15 adds to its kernels line
    entry}``."""
    import contextlib
    import shutil
    import tempfile

    from probnmn_tpu_torch import train as train_cli
    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import ProgramPriorDataset, QuestionCodingDataset
    from probnmn_tpu_torch.models.program_prior import init_program_prior_params, lm_dropout_masks
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, pack_weights, sampling_encode,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_backward_cuda, lm_forward_cuda, pack_lm_weights, tf_backward_cuda, tf_forward_cuda,
    )
    from probnmn_tpu_torch.training import program_prior_trainer
    from probnmn_tpu_torch.training._trainer import copy_into, tree_map
    from probnmn_tpu_torch.training.program_prior_trainer import (
        ProgramPriorTrainer, make_prior_spec,
    )
    from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY, QuestionCodingTrainer
    from probnmn_tpu_torch.utils.checkpointing import save_objects
    from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(1500)  # this phase's inputs, apart from phases 1-14's
    mgen = torch.Generator(device=dev).manual_seed(1501)  # its kernel checks' masks
    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_dropout_")
    vocab = make_clevr_like_vocabulary()
    vocab.save_to_files(os.path.join(work, "vocab"))

    def phase_options(p):
        out = ["DATA.VOCABULARY", os.path.join(work, "vocab"), "OPTIM.ADAM_MU_DTYPE", "bfloat16"]
        for model in DROPOUT_MODELS:
            out += [f"{model}.DROPOUT", p]
        return out

    prior_config = Config(os.path.join(repo, "configs", "program_prior.yml"),
                          phase_options(DROPOUT))
    prior_spec = make_prior_spec(prior_config, vocab)
    prior_ckpt = os.path.join(work, "prior.ckpt")
    save_objects(prior_ckpt, {"program_prior": init_program_prior_params(gen, prior_spec)})
    qc_yml = os.path.join(repo, "configs", "question_coding_ours.yml")
    qc_config = Config(qc_yml, phase_options(DROPOUT) + ["CHECKPOINTS.PROGRAM_PRIOR", prior_ckpt])
    batch_size = qc_config.OPTIM.BATCH_SIZE
    np.random.seed(qc_config.RANDOM_SEED)  # the supervision subset, as the CLI seeds it
    qc_set = QuestionCodingDataset.from_tokens(
        *qc_questions(np, vocab, 4096, seed=151), num_supervision=qc_config.SUPERVISION,
        supervision_question_max_length=qc_config.SUPERVISION_QUESTION_MAX_LENGTH)
    prior_set = ProgramPriorDataset.from_programs(lm_programs(np, vocab, 2048, seed=152))

    def qc_trainer(device, name, cfg=qc_config):
        return QuestionCodingTrainer(cfg, os.path.join(work, name), device=device,
                                     writer=RecordingWriter(), dataset=qc_set)

    def prior_trainer(device, name):
        return ProgramPriorTrainer(prior_config, os.path.join(work, name), device=device,
                                   writer=RecordingWriter(), dataset=prior_set)

    card = qc_trainer("cuda", "qc")
    pg_spec, qr_spec = card.pg_spec, card.qr_spec
    check(pg_spec.dropout == qr_spec.dropout == card.prior_spec.dropout == DROPOUT
          and card._optimizer.mu_dtype == "bfloat16", "the phase's options did not reach the trainer")
    init = tree_map(lambda t: t.detach().clone(), card.params)
    log(f"[dropout] DROPOUT {DROPOUT} on the prior, PG and QR ({pg_spec.num_layers} x "
        f"{pg_spec.hidden_size}), ADAM_MU_DTYPE bfloat16, batch {batch_size}")

    # ---- the kernels with masks against their plain versions under the same masks
    batch = next(card._batches)
    n_sup = batch[COUNT_KEY]
    questions, programs = batch["question"], batch["program"]
    masks = card.draw_dropout_masks(batch)
    keep = {k: float(m.float().mean()) for k, m in masks.items()}
    log(f"[dropout] first batch: {n_sup} supervised; masks {({k: tuple(m.shape) for k, m in masks.items()})}, "
        f"kept {keep}")
    check(all(m.is_cuda and abs(keep[k] - (1 - DROPOUT)) < 0.01 for k, m in masks.items()),
          "dropout masks")
    pg = init["program_generator"]
    q_unsup = questions[n_sup:]
    k1_enc, _ = k1_encoder_against_plain(torch, pg, pg_spec, q_unsup, "K1 encoder, dropout",
                                         masks["pg_unsup"])
    T, V = pg_spec.max_decoding_steps, pg_spec.target_vocab_size
    noise = (-torch.log(-torch.log(torch.rand(T, len(q_unsup), V, generator=gen)
                                   .clamp_min(1e-12)))).to(dev)
    k1 = k1_against_plain(torch, pg, pg_spec, q_unsup, noise, "K1, dropout", masks["pg_unsup"])
    z = card.sample_programs(q_unsup, masks["pg_unsup"])
    mask_of = {"pg_sup": "pg_sup", "qr_sup": "qr_sup", "pg_z": "pg_unsup", "qr_z": "qr_unsup"}
    k4f_err = k4b_err = 0.0
    k4_inputs = []
    for name, params, spec, src, tgt, reinforce_norm in qc_passes(init, pg_spec, qr_spec,
                                                                  questions, programs, n_sup, z):
        dloss = (torch.rand(src.shape[0], generator=gen) + 0.5).to(dev)
        err, e, packed, _ = k4_pass_against_plain(torch, f"{name}, dropout", params, spec, src,
                                                  tgt, reinforce_norm, dloss, masks[mask_of[name]])
        k4f_err, k4b_err = max(k4f_err, err), max(k4b_err, e)
        k4_inputs.append((packed, spec, src, tgt, reinforce_norm, dloss, masks[mask_of[name]]))
    prior = prior_trainer("cuda", "prior")
    prior_init = tree_map(lambda t: t.detach().clone(), prior.params["program_prior"])
    tok = torch.from_numpy(prior_set.get_batch(np.arange(batch_size))["program"]).to(dev)
    lm_masks = lm_dropout_masks(mgen, prior_spec, tok)
    lm_dloss = (torch.rand(batch_size, generator=gen) + 0.5).to(dev)
    k3f_err, k3b_err = k3_against_plain(torch, prior_init, prior_spec, tok, lm_dloss, ", dropout",
                                        lm_masks)

    # ---- one step each on the card against the CPU trainer on the card's draws
    counters = (fused_sampling_forward, sampling_encode, lm_forward_cuda, lm_backward_cuda,
                tf_forward_cuda, tf_backward_cuda)
    for fn in counters:
        fn.launches = 0
    drawn = {}
    qc_card, qc_cpu = qc_trainer("cuda", "qc_step"), qc_trainer("cpu", "qc_cpu")
    copy_into(qc_card.params, init)
    copy_into(qc_cpu.params, init)

    @contextlib.contextmanager
    def record_qc():
        draw, sample = qc_card.draw_dropout_masks, qc_card.sample_programs

        def draw_and_keep(b):
            drawn["qc"] = draw(b)
            return drawn["qc"]

        def sample_and_keep(q, m):
            drawn["z"] = sample(q, m)
            return drawn["z"]

        qc_card.draw_dropout_masks, qc_card.sample_programs = draw_and_keep, sample_and_keep
        yield
        del qc_card.draw_dropout_masks, qc_card.sample_programs

    @contextlib.contextmanager
    def replay_qc():
        qc_cpu.draw_dropout_masks = lambda b: {k: m.cpu() for k, m in drawn["qc"].items()}
        qc_cpu.sample_programs = lambda q, m: drawn["z"].cpu()
        yield
        del qc_cpu.draw_dropout_masks, qc_cpu.sample_programs

    qc_logs, qc_diff = step_against_cpu(torch, "qc, dropout", qc_card, qc_cpu, record_qc,
                                        replay_qc)
    pp_card, pp_cpu = prior_trainer("cuda", "prior_step"), prior_trainer("cpu", "prior_cpu")
    copy_into(pp_card.params["program_prior"], prior_init)
    copy_into(pp_cpu.params["program_prior"], prior_init)

    @contextlib.contextmanager
    def patched_lm_masks(fn):
        real = program_prior_trainer.lm_dropout_masks
        program_prior_trainer.lm_dropout_masks = lambda g, spec, p: fn(real, g, spec, p)
        yield
        program_prior_trainer.lm_dropout_masks = real

    def keep_lm(real, g, spec, p):
        drawn["lm"] = real(g, spec, p)
        return drawn["lm"]

    pp_logs, pp_diff = step_against_cpu(
        torch, "prior, dropout", pp_card, pp_cpu, lambda: patched_lm_masks(keep_lm),
        lambda: patched_lm_masks(lambda real, g, spec, p: drawn["lm"].cpu()))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"[dropout] launches in those two card steps: {launches}")
    check(launches == {"fused_sampling_forward": 1, "sampling_encode": 1, "lm_forward_cuda": 2,
                       "lm_backward_cuda": 1, "tf_forward_cuda": 4, "tf_backward_cuda": 4},
          f"dropout steps' launches {launches}")
    check(all(m.dtype == torch.bfloat16
              for m in (s["exp_avg"] for s in qc_card._optimizer.state_dict()["state"].values())),
          "the Adam first moment is not bfloat16")
    names = ("dropout_rows", "k1_dropout", "k1_encoder_sweep", "lstm_fwd_sweep", "lstm_bwd_sweep")
    # A question_coding step: K1's encoder (a sweep a layer, a dropout pass a
    # layer below the top), the four K4 passes (a forward and a reverse sweep
    # a layer, a dropout pass each way a layer below the top), the frozen
    # prior's K3f (a sweep a layer, no mask). A program_prior step: K3f and
    # K3b's replay (a sweep a layer each) and three dropout passes a layer
    # below the top (K3f, the replay, the gradient).
    L, Lp = pg_spec.num_layers, prior_spec.num_layers
    qc_want = {"dropout_rows": 8 * (L - 1), "k1_dropout": L - 1, "k1_encoder_sweep": L,
               "lstm_fwd_sweep": 4 * L + Lp, "lstm_bwd_sweep": 4 * L}
    pp_want = {"dropout_rows": 3 * (Lp - 1), "k1_dropout": 0, "k1_encoder_sweep": 0,
               "lstm_fwd_sweep": 2 * Lp, "lstm_bwd_sweep": 0}
    qc_tries = traced_route(torch, qc_card.step, names, qc_want)
    pp_tries = traced_route(torch, pp_card.step, names, pp_want)
    qc_route, pp_route = qc_tries[-1], pp_tries[-1]
    log(f"[dropout] under the profiler, a question_coding step: {qc_tries}; a program_prior "
        f"step: {pp_tries} (traced until the counts were whole, at most 3 times)")
    check(qc_route == qc_want, f"question_coding step route {qc_tries}")
    check(pp_route == pp_want, f"program_prior step route {pp_tries}")

    # ---- two steps under --profile-dir's window (the train CLI's loop)
    trace_dir = os.path.join(work, "trace")
    start = qc_card.iteration + 1
    train_cli.run(qc_card, None, start + 4, checkpoint_every=10 ** 9, profile_dir=trace_dir,
                  profile_steps=2)
    files = os.listdir(trace_dir)
    check(len(files) == 1, f"--profile-dir wrote {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernel_names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    steps_seen = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("train_step_")})
    wanted = ("k1_encoder_sweep", "k1_dropout", "seq2seq_sample_kernel", "lstm_fwd_sweep",
              "lstm_bwd_sweep", "dropout_rows", "tf_attend")
    named = {k: sum(1 for n in kernel_names if f"{k}(" in n or f"{k}<" in n) > 0 for k in wanted}
    log(f"[dropout] --profile-dir trace {files[0]}: {len(events)} events, {len(kernel_names)} "
        f"kernel names, ranges {steps_seen}; kernels named: {named}")
    check(steps_seen == [f"train_step_{start + 2}", f"train_step_{start + 3}"],
          f"profile window {steps_seen}")
    check(all(named.values()), f"the trace does not name every kernel: {named}")

    # ---- times: each masked kernel beside the same kernel without masks, same inputs
    pg_packed = pack_weights(pg, pg_spec, torch.bfloat16, dev)
    m1 = masks["pg_unsup"]
    times = {}

    def pair(key, fn, iters=10):
        times[key] = {"ms_dropout": cuda_ms(torch, lambda: fn(True), iters),
                      "ms_no_dropout": cuda_ms(torch, lambda: fn(False), iters)}

    pair("seq2seq_decode", lambda d: fused_sampling_forward(
        pg, pg_spec, q_unsup, seed=7, compute_dtype=torch.bfloat16, packed=pg_packed,
        dropout_masks=m1 if d else None))
    pair("k1_encoder_sweep", lambda d: sampling_encode(
        pg, pg_spec, q_unsup, compute_dtype=torch.bfloat16, packed=pg_packed,
        dropout_masks=m1 if d else None))
    lm_packed = pack_lm_weights(prior_init)
    pair("lm_forward", lambda d: lm_forward_cuda(lm_packed, prior_spec, tok,
                                                 lm_masks if d else None))
    pair("lm_backward", lambda d: lm_backward_cuda(lm_packed, prior_spec, tok, lm_dloss,
                                                   lm_masks if d else None))
    fwd = {True: 0.0, False: 0.0}
    bwd = {True: 0.0, False: 0.0}
    for packed, spec, src, tgt, reinforce_norm, dloss, m in k4_inputs:
        for d in (True, False):
            def keep_forward(d=d):
                return tf_forward_cuda(packed, spec, src, tgt, reinforce_norm, keep=True,
                                       dropout_masks=m if d else None)[1]

            fwd[d] += cuda_ms(torch, keep_forward, iters=5)
            bwd[d] += cuda_ms_each(torch, keep_forward, lambda res: tf_backward_cuda(res, dloss),
                                   iters=5)
    times["tf_forward"] = {"ms_dropout": fwd[True], "ms_no_dropout": fwd[False]}
    times["tf_backward"] = {"ms_dropout": bwd[True], "ms_no_dropout": bwd[False]}
    for key, t in times.items():
        log(f"[time] {key} with dropout masks {t['ms_dropout']:.4f} ms, without "
            f"{t['ms_no_dropout']:.4f} ms, same inputs; card {smi}")

    # ---- the question_coding step at DROPOUT 0 and 0.2, in turns (0, 0.2, 0.2, 0)
    plain_config = Config(qc_yml, phase_options(0.0) + ["CHECKPOINTS.PROGRAM_PRIOR", prior_ckpt])
    runs = {0.0: qc_trainer("cuda", "qc_p0", plain_config), DROPOUT: qc_trainer("cuda", "qc_p2")}
    for trainer in runs.values():
        copy_into(trainer.params, init)
        for _ in range(2):
            trainer.step()
    step_ms = {0.0: [], DROPOUT: []}
    for p in (0.0, DROPOUT, DROPOUT, 0.0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            runs[p].step()
        step_ms[p].append((time.perf_counter() - t0) / 5 * 1e3)
    mean_ms = {p: sum(v) / len(v) for p, v in step_ms.items()}
    log(f"[time] question_coding train step (host clock, logs fetched each step, 5 steps a turn "
        f"in turns 0, 0.2, 0.2, 0): DROPOUT 0 {step_ms[0.0]} ms, DROPOUT {DROPOUT} "
        f"{step_ms[DROPOUT]} ms; means {mean_ms[0.0]:.3f} / {mean_ms[DROPOUT]:.3f}; card {smi}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[dropout] phase 15 took {time.perf_counter() - t_phase:.1f} s")

    errs = {"seq2seq_decode": k1["bfloat16"], "k1_encoder_sweep": k1_enc["bfloat16"],
            "lm_forward": k3f_err, "lm_backward": k3b_err, "tf_forward": k4f_err,
            "tf_backward": k4b_err}
    launch_keys = {"seq2seq_decode": "fused_sampling_forward", "k1_encoder_sweep": "sampling_encode",
                   "lm_forward": "lm_forward_cuda", "lm_backward": "lm_backward_cuda",
                   "tf_forward": "tf_forward_cuda", "tf_backward": "tf_backward_cuda"}
    out = {name: {"launches_dropout": launches[launch_keys[name]],
                  "max_abs_err_dropout": errs[name], **times[name]} for name in errs}
    out["seq2seq_decode"]["max_abs_err_dropout_float32"] = k1["float32"]
    out["k1_encoder_sweep"]["max_abs_err_dropout_float32"] = k1_enc["float32"]
    out["tf_forward"]["qc_step_ms"] = {"dropout_0": step_ms[0.0], "dropout_0.2": step_ms[DROPOUT]}
    out["tf_forward"]["dropout_route"] = {"question_coding": qc_route, "program_prior": pp_route}
    out["tf_forward"]["step_vs_cpu_max_log_diff"] = {"question_coding": qc_diff,
                                                     "program_prior": pp_diff}
    return out


MESH_RANKS = 2
MESH_STEPS = 3
MESH_LOSS_RTOL = 2e-4
MESH_VAL_RTOL = 1e-5


def mesh_rank(parallel, phase, config, run_dir, train_set, val_set, init, programs, reference):
    r"""One rank of phase 16, spawned by ``parallel.mesh.launch``: the
    evaluator on ``init``, ``MESH_STEPS`` steps (module_training at the
    rank's rows of the handed-in ``programs``) and one more traced under the
    profiler (module_training with its own K1 sampling), the launch counters
    set to 0 before those steps and read after; rank 0's parameters against
    the one-rank run's (``reference``: flat parameters and the mask of those
    whose |g| cleared 1e-5 at every step, in shared memory); then each
    kernel of the path against its plain version on the rank's rows."""
    import numpy as np
    import torch

    from probnmn_tpu_torch.evaluators.module_training_evaluator import ModuleTrainingEvaluator
    from probnmn_tpu_torch.evaluators.program_prior_evaluator import ProgramPriorEvaluator
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        execute_programs_train_kernel, interpreter_grads_kernel,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, sampling_encode,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import lm_backward_cuda, lm_forward_cuda
    from probnmn_tpu_torch.training._trainer import copy_into, tree_leaves, tree_map
    from probnmn_tpu_torch.training.module_training_trainer import ModuleTrainingTrainer
    from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = parallel.device
    gen = torch.Generator().manual_seed(160 + parallel.rank)
    batch = config.OPTIM.BATCH_SIZE
    rows = batch // parallel.world_size
    mine = slice(parallel.rank * rows, (parallel.rank + 1) * rows)
    common = dict(device=dev, writer=RecordingWriter(), dataset=train_set, parallel=parallel)
    model = "program_prior" if phase == "program_prior" else "module_training"
    if phase == "program_prior":
        trainer = ProgramPriorTrainer(config, run_dir, **common)
        params = trainer.params["program_prior"]
        evaluator = ProgramPriorEvaluator(config, trainer, dataset=val_set)
        counters = (lm_forward_cuda, lm_backward_cuda)
        L, T = trainer.spec.num_layers, train_set.get_batch(np.arange(1))["program"].shape[1] + 1
        names, want = ("lstm_fwd_sweep", "lstm_bwd_step"), {"lstm_fwd_sweep": 2 * L,
                                                             "lstm_bwd_step": L * T}
    else:
        trainer = ModuleTrainingTrainer(config, run_dir, **common)
        params = trainer.params["nmn"]
        evaluator = ModuleTrainingEvaluator(config, trainer, dataset=val_set)
        counters = (fused_sampling_forward, sampling_encode, execute_programs_train_kernel,
                    interpreter_grads_kernel)
        names = ("k1_encoder_sweep", "seq2seq_sample_kernel", "nmn_interpreter_kernel",
                 "nmn_backward_kernel")
        want = dict(zip(names, (trainer.pg_spec.num_layers, 1, 1, 1)))
        sampler = trainer.sample_programs
        handed = torch.from_numpy(programs[mine]).to(dev)
        trainer.sample_programs = lambda questions: handed
    copy_into(params, tree_map(lambda t: t.to(dev), init))
    val = evaluator.evaluate(num_batches=2)

    # The main path: MESH_STEPS steps, then one traced (module_training's
    # through its own sampler, so that K1 runs).
    for fn in counters:
        fn.launches = 0
    logs, grad_ratio = [], None
    for i in range(MESH_STEPS):
        logs.append(trainer.step(i))
        if i == 0 and parallel.is_writer:
            # The first step's gradient (all-reduced, clamped) against one
            # rank's at the same parameters, leaf by leaf.
            got = [p.grad.reshape(-1) for p in tree_leaves(params)]
            want_g = reference["grad"].to(dev).split([g.numel() for g in got])
            grad_ratio = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                             for a, b in zip(got, want_g))
    leaves = [p.detach().reshape(-1) for p in tree_leaves(params)]
    flat = torch.cat(leaves).float()
    compared = {"checksum": [float(flat.double().sum()), float(flat.double().abs().sum())]}
    if parallel.is_writer:
        want_p = reference["params"].to(dev)
        smooth = reference["smooth"].to(dev)
        diff = (flat - want_p).abs()
        compared.update(smooth_err=float(diff[smooth].max()) if bool(smooth.any()) else 0.0,
                        rest_err=float(diff.max()), smooth_share=float(smooth.float().mean()),
                        grad_ratio=grad_ratio)
    if model == "module_training":
        trainer.sample_programs = sampler
    route = traced_route(torch, lambda: trainer.step(MESH_STEPS), names, want, tries=1)[-1]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    # The gradient all-reduce alone (host clock; the ranks' gradients are
    # already equal, so it leaves them as they are).
    leaves = tree_leaves(params)
    parallel.barrier()
    t0 = time.perf_counter()
    for _ in range(5):
        parallel.all_reduce_grads(leaves)
    torch.cuda.synchronize()
    allreduce = {"ms": (time.perf_counter() - t0) / 5 * 1e3,
                 "mb": sum(p.numel() for p in leaves) * 4 / 1e6}

    # The path's kernels against their plain versions at the rank's rows.
    errs = {}
    first = train_set.get_batch(np.arange(batch))
    detached = tree_map(lambda t: t.detach(), params)
    if phase == "program_prior":
        tok = torch.from_numpy(first["program"][mine]).to(dev)
        dloss = (torch.rand(rows, generator=gen) + 0.5).to(dev)
        errs["lm_forward"], errs["lm_backward"] = k3_against_plain(
            torch, detached, trainer.spec, tok, dloss, tag=f" rank {parallel.rank}")
    elif phase == "module_training":
        # The bfloat16 pass runs the same kernels at the same rows, checked
        # here in both dtypes.
        questions = torch.from_numpy(first["question"][mine]).to(dev)
        pg_spec = trainer.pg_spec
        noise = (-torch.log(-torch.log(torch.rand(
            pg_spec.max_decoding_steps, rows, pg_spec.target_vocab_size,
            generator=gen).clamp_min(1e-12)))).to(dev)
        k1 = k1_against_plain(torch, trainer.pg_params, pg_spec, questions, noise,
                              tag=f"K1 rank {parallel.rank}")
        enc, _ = k1_encoder_against_plain(torch, trainer.pg_params, pg_spec, questions,
                                          tag=f"K1 encoder rank {parallel.rank}")
        errs["seq2seq_decode"], errs["k1_encoder_sweep"] = k1["bfloat16"], enc["bfloat16"]
        spec = trainer.nmn_spec
        feats = torch.randn(rows, spec.height, spec.width, spec.feature_channels,
                            generator=gen).to(dev)
        for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
            checked = k5_k6_against_plain(torch, gen, name, dtype, detached, spec, trainer.tables,
                                          feats, handed, tag=f" rank {parallel.rank}")
            if dtype == torch.bfloat16:
                errs["nmn_train_forward"], errs["nmn_backward"] = checked["err"], checked["worst"]
    return dict(logs=logs, val=val, launches=launches, route=route, route_want=want, errs=errs,
                compared=compared, device=str(dev), rows=rows, allreduce=allreduce)


def train_mesh(np, torch, smi):
    r"""Phase 16: program_prior and module_training at 2 ranks over
    ``torch.distributed`` (``parallel/mesh.py``) at the shipped widths,
    against the same steps at one rank on the card: losses, parameters by the
    trainer-parity rule, the evaluators' numbers, each rank's launches and
    each kernel of the path at B / 2 rows against its plain version. With two
    cards or more the ranks go over NCCL, one card a rank; with one, they
    share it over gloo. Returns {kernel name: mesh keys of the kernels
    line}."""
    import shutil
    import tempfile

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import ModuleTrainingDataset, ProgramPriorDataset
    from probnmn_tpu_torch.data.readers import SharedFeatures
    from probnmn_tpu_torch.evaluators.module_training_evaluator import ModuleTrainingEvaluator
    from probnmn_tpu_torch.evaluators.program_prior_evaluator import ProgramPriorEvaluator
    from probnmn_tpu_torch.models import program_generator
    from probnmn_tpu_torch.parallel import mesh
    from probnmn_tpu_torch.training._trainer import tree_leaves, tree_map
    from probnmn_tpu_torch.training.module_training_trainer import ModuleTrainingTrainer
    from probnmn_tpu_torch.training.program_prior_trainer import ProgramPriorTrainer
    from probnmn_tpu_torch.utils.checkpointing import save_objects
    from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary, sample_clevr_like_programs
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    cards = torch.cuda.device_count()
    share = cards < MESH_RANKS
    log(f"[mesh] {MESH_RANKS} ranks over "
        f"{'gloo, both on card 0 (one card)' if share else f'nccl, one card a rank ({cards} cards)'}"
        f"; card {smi}")
    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    vocab = make_clevr_like_vocabulary()
    vocab.save_to_files(os.path.join(work, "vocab"))
    gen = torch.Generator().manual_seed(16)
    dev = torch.device("cuda")
    t_phase = time.perf_counter()

    # program_prior (configs/program_prior.yml: 256 x 2, batch 256) and
    # module_training (configs/module_training.yml: batch 128, the NMN in
    # float32 so that one rank and two agree to float32 rounding) over the
    # same in-memory data; module_training's features in shared memory.
    pp_config = Config(os.path.join(repo, "configs", "program_prior.yml"),
                       ["DATA.VOCABULARY", os.path.join(work, "vocab")])
    qc_ckpt = os.path.join(work, "generator.ckpt")
    mt_shipped = Config(os.path.join(repo, "configs", "module_training.yml"),
                        ["DATA.VOCABULARY", os.path.join(work, "vocab"),
                         "CHECKPOINTS.QUESTION_CODING", qc_ckpt])
    mt_config = Config(os.path.join(repo, "configs", "module_training.yml"),
                       ["DATA.VOCABULARY", os.path.join(work, "vocab"),
                        "CHECKPOINTS.QUESTION_CODING", qc_ckpt, "NMN.COMPUTE_DTYPE", "float32"])
    pg_spec = program_generator.make_spec(vocab, mt_config)
    save_objects(qc_ckpt, {"program_generator": program_generator.init_params(gen, pg_spec)})
    features = SharedFeatures.from_array(
        np.random.default_rng(17).standard_normal((256, 1024, 14, 14), dtype=np.float32))
    mt_batch = mt_config.OPTIM.BATCH_SIZE
    handed = sample_clevr_like_programs(vocab, mt_batch, seed=18)
    handed[-4:] = np.random.RandomState(19).randint(
        0, vocab.get_vocab_size("programs"), (4, handed.shape[1]))  # token soups: mostly invalid
    handed[-1] = 0
    mt_sets = (ModuleTrainingDataset.from_arrays(*mt_arrays(np, vocab, 4096, 256, seed=23),
                                                 features),
               ModuleTrainingDataset.from_arrays(*mt_arrays(np, vocab, 1024, 256, seed=25),
                                                 features, split="val"))
    cases = {
        "program_prior": (pp_config,
                          ProgramPriorDataset.from_programs(lm_programs(np, vocab, 4096, seed=20)),
                          ProgramPriorDataset.from_programs(lm_programs(np, vocab, 1024, seed=21),
                                                            split="val"),
                          None),
        "module_training": (mt_config, *mt_sets, handed),
        # The shipped dtype ('auto': bfloat16 on the card).
        "module_training_bf16": (mt_shipped, *mt_sets, handed),
    }
    out = {}
    for phase, (config, train_set, val_set, programs) in cases.items():
        t0 = time.perf_counter()
        common = dict(device=dev, writer=RecordingWriter(), dataset=train_set)
        if phase == "program_prior":
            one = ProgramPriorTrainer(config, os.path.join(work, "one_pp"), **common)
            params, evaluator = one.params["program_prior"], ProgramPriorEvaluator(
                config, one, dataset=val_set)
        else:
            one = ModuleTrainingTrainer(config, os.path.join(work, "one_mt"), **common)
            fixed = torch.from_numpy(programs).to(dev)
            one.sample_programs = lambda questions: fixed
            params, evaluator = one.params["nmn"], ModuleTrainingEvaluator(config, one,
                                                                           dataset=val_set)
        init = tree_map(lambda t: t.detach().cpu().clone(), params)
        one_val = evaluator.evaluate(num_batches=2)
        one_logs, smooth = [], None
        for i in range(MESH_STEPS):
            one_logs.append(one.step(i))
            grads = torch.cat([p.grad.reshape(-1) for p in tree_leaves(params)])
            if i == 0:
                first_grad = grads.cpu()
            smooth = grads.abs() > 1e-5 if smooth is None else smooth & (grads.abs() > 1e-5)
        reference = {"params": torch.cat([p.detach().reshape(-1) for p in tree_leaves(params)])
                     .cpu().share_memory_(), "smooth": smooth.cpu().share_memory_(),
                     "grad": first_grad.share_memory_()}
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = mesh.launch(mesh_rank, MESH_RANKS, "cuda", work, share_card=share, timeout=900,
                            collective_timeout=600,
                            args=(phase, config, os.path.join(work, f"mesh_{phase}"), train_set,
                                  val_set, init, programs, reference))
        mesh_s = time.perf_counter() - t0
        lr = config.OPTIM.LR_INITIAL
        cmp = ranks[0]["compared"]
        log(f"[mesh {phase}] one rank: {one_s:.1f} s (evaluator, {MESH_STEPS} steps); "
            f"{MESH_RANKS} ranks on {[r['device'] for r in ranks]} at {ranks[0]['rows']} rows "
            f"each: {mesh_s:.1f} s (spawn, evaluator, {MESH_STEPS + 1} steps, kernel checks)")
        bf16 = phase == "module_training_bf16"
        # bfloat16 keeps 8 bits: the loss within 1e-2 relative; an answer
        # whose logits tie to within the rows' rounding may flip (5 of
        # 2,048 rows between buckets 64 and 256, ROADMAP section 3), so the
        # accuracy within 2 rows of the batch; the invalid count equal.
        loss_rtol = 1e-2 if bf16 else MESH_LOSS_RTOL
        accuracy_tol = 2.0 / config.OPTIM.BATCH_SIZE if bf16 else 1e-6
        for i, (got, want) in enumerate(zip(ranks[0]["logs"], one_logs)):
            log(f"[mesh {phase}] step {i}: {MESH_RANKS} ranks {got} / one rank {want}")
            flat_got = {k: v for k, v in got.items() if not isinstance(v, dict)}
            flat_got.update(got.get("metrics", {}))
            flat_want = {k: v for k, v in want.items() if not isinstance(v, dict)}
            flat_want.update(want.get("metrics", {}))
            for key, value in flat_want.items():
                tol = (loss_rtol * abs(value) if key == "loss" else
                       accuracy_tol if key == "answer_accuracy" else 0.0 if bf16 else 1e-6)
                check(abs(flat_got[key] - value) <= tol,
                      f"mesh {phase} step {i} {key}: {flat_got[key]} against {value}")
        check(ranks[1]["logs"] == ranks[0]["logs"], f"mesh {phase}: the ranks logged otherwise")
        check(ranks[1]["compared"]["checksum"] == cmp["checksum"],
              f"mesh {phase}: the ranks' parameters differ: {[r['compared'] for r in ranks]}")
        # ROADMAP.md's trainer-parity rule. The NMN's gradients sit on the
        # random-init plateau, where a sum's order moves a |g| above 1e-5 by
        # a sizeable part of it (K6's weight gradients sum more rows at one
        # rank than at two); there the bound is absolute, 2 lr a step, and
        # the first step's gradient is held leaf by leaf.
        # 1% of lr a step does not hold for the NMN: one rank and two part
        # there by up to 1.6e-4 where that allows 3e-6.
        limit = 1e-2 * lr * MESH_STEPS if phase == "program_prior" else 2 * lr * MESH_STEPS
        grad_limit = 1e-1 if bf16 else 1e-4
        log(f"[mesh {phase}] the first step's all-reduced gradient against one rank's: worst "
            f"leaf max |dev| / max(1, max|g|) {cmp['grad_ratio']:.3e} (limit {grad_limit:.0e})")
        log(f"[mesh {phase}] params after {MESH_STEPS} steps against one rank: where every "
            f"step's |g| > 1e-5 ({cmp['smooth_share']:.4f} of them) max |dev| "
            f"{cmp['smooth_err']:.3e} (limit {limit:.1e}); all {cmp['rest_err']:.3e} (limit "
            f"{2 * lr * MESH_STEPS:.1e}, 2 lr a step); the ranks' parameters equal (checksums "
            f"{cmp['checksum']})")
        check(cmp["grad_ratio"] <= grad_limit,
              f"mesh {phase} first gradient against one rank: {cmp}")
        check(cmp["smooth_err"] <= limit and cmp["rest_err"] <= 2 * lr * MESH_STEPS,
              f"mesh {phase} params against one rank: {cmp}")
        for model, metrics in one_val.items():
            for key, value in metrics.items():
                got = [r["val"][model][key] for r in ranks]
                log(f"[mesh {phase}] evaluator {model}/{key}: {MESH_RANKS} ranks {got}, one "
                    f"rank {value}")
                tol = (accuracy_tol if bf16 and key == "answer_accuracy" else
                       MESH_VAL_RTOL * max(1.0, abs(value)))
                check(all(abs(g - value) <= tol for g in got), f"mesh {phase} evaluator {key}")
        log(f"[mesh {phase}] the gradient all-reduce alone ({ranks[0]['allreduce']['mb']:.1f} MB "
            f"float32, host clock): {[round(r['allreduce']['ms'], 3) for r in ranks]} ms a rank")
        for r in ranks:
            log(f"[mesh {phase}] rank launches over the main path: {r['launches']}; one traced "
                f"step under the profiler: {r['route']}; kernels against plain at "
                f"{r['rows']} rows: {r['errs']}")
        # Phase 16's counts: 3 steps and a traced one; K1 in the traced step alone.
        want = ({"lm_forward_cuda": MESH_STEPS + 1, "lm_backward_cuda": MESH_STEPS + 1}
                if phase == "program_prior" else
                {"fused_sampling_forward": 1, "sampling_encode": 1,
                 "execute_programs_train_kernel": MESH_STEPS + 1,
                 "interpreter_grads_kernel": MESH_STEPS + 1})
        for r in ranks:
            check(r["launches"] == want, f"mesh {phase} launches {r['launches']}")
        names = {"lm_forward_cuda": "lm_forward", "lm_backward_cuda": "lm_backward",
                 "fused_sampling_forward": "seq2seq_decode", "sampling_encode": "k1_encoder_sweep",
                 "execute_programs_train_kernel": "nmn_train_forward",
                 "interpreter_grads_kernel": "nmn_backward"}
        for r in ranks:
            check(r["route"] == r["route_want"],
                  f"mesh {phase} traced step {r['route']}, not {r['route_want']}")
        for counter, name in names.items():
            if counter in want and bf16:
                out[name]["launches_mesh_bf16"] = [r["launches"][counter] for r in ranks]
            elif counter in want:
                out[name] = {"launches_mesh": [r["launches"][counter] for r in ranks],
                             "max_abs_err_mesh": max(r["errs"][name] for r in ranks)}
        del one, params, evaluator, reference
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    log(f"[mesh] program_prior and module_training cases in {time.perf_counter() - t_phase:.1f} s")
    return out


def z_by_question(torch, questions, table):
    r"""A program for each row, a function of the row's question alone, so
    that one rank and two score the same z a row: row i takes
    ``table[sum_t q[i, t] * (t + 1) mod len(table)]``."""
    weights = torch.arange(1, questions.shape[1] + 1, device=questions.device)
    return table[(questions * weights).sum(1) % len(table)]


SEMI_NAMES = {"fused_sampling_forward": "seq2seq_decode", "sampling_encode": "k1_encoder_sweep",
              "lm_forward_cuda": "lm_forward", "tf_forward_cuda": "tf_forward",
              "tf_backward_cuda": "tf_backward", "execute_programs_train_kernel": "nmn_train_forward",
              "interpreter_grads_kernel": "nmn_backward"}


def mesh_semi_rank(parallel, phase, config, run_dir, train_set, val_set, init, table, reference):
    r"""One rank of phase 16's question_coding or joint_training case,
    spawned by ``parallel.mesh.launch``: the evaluator on ``init``,
    ``MESH_STEPS`` steps at z by question (:func:`z_by_question` over
    ``table``) and one more traced under the profiler with the trainer's own
    K1 sampling, the launch counters set to 0 before those steps and read
    after; the baseline after each step; rank 0's first summed gradient and
    parameters against the one-rank run's (``reference``); then each kernel
    of the path against its plain version on the rank's rows of the next
    batch (K5 and K6 at ``init``)."""
    import torch

    from probnmn_tpu_torch.data.pipeline import image_to_nhwc
    from probnmn_tpu_torch.evaluators.joint_training_evaluator import JointTrainingEvaluator
    from probnmn_tpu_torch.evaluators.question_coding_evaluator import QuestionCodingEvaluator
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        execute_programs_train_kernel, interpreter_grads_kernel,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, sampling_encode,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_train import (
        lm_forward_cuda, tf_backward_cuda, tf_forward_cuda,
    )
    from probnmn_tpu_torch.training._trainer import copy_into, tree_leaves, tree_map
    from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer
    from probnmn_tpu_torch.training.question_coding_trainer import COUNT_KEY, QuestionCodingTrainer
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, rank = parallel.device, parallel.rank
    gen = torch.Generator().manual_seed(170 + rank)
    joint = phase == "joint_training"
    trainer = (JointTrainingTrainer if joint else QuestionCodingTrainer)(
        config, run_dir, device=dev, writer=RecordingWriter(), dataset=train_set,
        parallel=parallel)
    copy_into(trainer.params, tree_map(lambda t: t.to(dev), init))
    val = (JointTrainingEvaluator if joint else QuestionCodingEvaluator)(
        config, trainer, dataset=val_set).evaluate(num_batches=2)
    table = table.to(dev)
    sampler = trainer.sample_programs
    trainer.sample_programs = lambda questions, dropout_masks=None: z_by_question(
        torch, questions, table)
    counters = [fused_sampling_forward, sampling_encode, lm_forward_cuda, tf_forward_cuda,
                tf_backward_cuda] + ([execute_programs_train_kernel, interpreter_grads_kernel]
                                     if joint else [])
    L = trainer.pg_spec.num_layers
    names = ("k1_encoder_sweep", "seq2seq_sample_kernel", "lstm_fwd_sweep", "lstm_bwd_sweep") + (
        ("nmn_interpreter_kernel", "nmn_backward_kernel") if joint else ())
    want = dict(zip(names, (L, 1, 4 * L + trainer.prior_spec.num_layers, 4 * L, 1, 1)))

    # The main path: MESH_STEPS steps at z by question, then one traced
    # with the trainer's own K1.
    for fn in counters:
        fn.launches = 0
    logs, baselines, grad_ratio = [], [], None
    for i in range(MESH_STEPS):
        logs.append(trainer.step(i))
        baselines.append(float(trainer.baseline))
        if i == 0 and parallel.is_writer:
            got = [p.grad.reshape(-1) for p in tree_leaves(trainer.params)]
            want_g = reference["grad"].to(dev).split([g.numel() for g in got])
            grad_ratio = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                             for a, b in zip(got, want_g))
    flat = torch.cat([p.detach().reshape(-1) for p in tree_leaves(trainer.params)])
    compared = {"checksum": [float(flat.double().sum()), float(flat.double().abs().sum())]}
    if parallel.is_writer:
        smooth = reference["smooth"].to(dev)
        diff = (flat - reference["params"].to(dev)).abs()
        compared.update(smooth_err=float(diff[smooth].max()) if bool(smooth.any()) else 0.0,
                        rest_err=float(diff.max()), smooth_share=float(smooth.float().mean()),
                        grad_ratio=grad_ratio)
    trainer.sample_programs = sampler
    route = traced_route(torch, lambda: trainer.step(MESH_STEPS), names, want, tries=1)[-1]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    baselines.append(float(trainer.baseline))

    # The path's kernels against their plain versions on the rank's rows of
    # the next batch, z by question for all but K1.
    batch = next(trainer._batches)
    n_sup = batch[COUNT_KEY]
    questions, programs = batch["question"], batch["program"]
    detached = tree_map(lambda t: t.detach(), trainer.params)
    pg_spec, unsup = trainer.pg_spec, questions[n_sup:]
    tag = f"{phase} rank {rank}"
    noise = (-torch.log(-torch.log(torch.rand(
        pg_spec.max_decoding_steps, len(unsup), pg_spec.target_vocab_size,
        generator=gen).clamp_min(1e-12)))).to(dev)
    k1 = k1_against_plain(torch, detached["program_generator"], pg_spec, unsup, noise,
                          tag=f"K1 {tag}")
    enc, _ = k1_encoder_against_plain(torch, detached["program_generator"], pg_spec, unsup,
                                      tag=f"K1 encoder {tag}")
    errs = {"seq2seq_decode": k1["bfloat16"], "k1_encoder_sweep": enc["bfloat16"]}
    z = z_by_question(torch, unsup, table)
    dloss = (torch.rand(len(z), generator=gen) + 0.5).to(dev)
    errs["lm_forward"], _ = k3_against_plain(torch, trainer.prior_params, trainer.prior_spec, z,
                                             dloss, tag=f" {tag}")
    errs["tf_forward"] = errs["tf_backward"] = 0.0
    for name, params, spec, src, tgt, reinforce_norm in qc_passes(
            detached, pg_spec, trainer.qr_spec, questions, programs, n_sup, z):
        dl = (torch.rand(src.shape[0], generator=gen) + 0.5).to(dev)
        f_err, b_err, _, _ = k4_pass_against_plain(torch, f"{name} {tag}", params, spec, src, tgt,
                                                   reinforce_norm, dl)
        errs["tf_forward"] = max(errs["tf_forward"], f_err)
        errs["tf_backward"] = max(errs["tf_backward"], b_err)
    if joint:
        feats = image_to_nhwc(batch["image"][n_sup:]).contiguous()
        checked = k5_k6_against_plain(torch, gen, "float32", torch.float32, detached["nmn"],
                                      trainer.nmn_spec, trainer.tables, feats, z, tag=f" {tag}")
        errs["nmn_train_forward"], errs["nmn_backward"] = checked["err"], checked["worst"]
    return dict(logs=logs, baselines=baselines, val=val, launches=launches, route=route,
                route_want=want, errs=errs, compared=compared, device=str(dev),
                rows=len(questions), n_sup=n_sup)


def train_mesh_semisupervised(np, torch, smi):
    r"""Phase 16's question_coding and joint_training cases (OBJECTIVE ours)
    at the shipped widths (vocabularies 92 / 44, D = H = 256, 2 layers,
    batch 256; joint over 256 images of (1024, 14, 14) in shared host
    memory with the NMN at C = 128 in float32), from random frozen models:
    the evaluator and 3 steps at one rank on the card, then at 2 ranks from
    the same parameters, each on its 128 rows, both scoring z by question;
    held as the docstring's phase 16 says. Returns {kernel name: mesh keys
    of the kernels line} (``launches_mesh_qc``, ``launches_mesh_jt`` by
    rank, ``max_abs_err_mesh_qc``, ``max_abs_err_mesh_jt``)."""
    import shutil
    import tempfile

    from probnmn_tpu_torch.config import Config
    from probnmn_tpu_torch.data.datasets import JointTrainingDataset, QuestionCodingDataset
    from probnmn_tpu_torch.data.readers import SharedFeatures
    from probnmn_tpu_torch.evaluators.joint_training_evaluator import JointTrainingEvaluator
    from probnmn_tpu_torch.evaluators.question_coding_evaluator import QuestionCodingEvaluator
    from probnmn_tpu_torch.models import nmn, program_generator, question_reconstructor
    from probnmn_tpu_torch.models.program_prior import init_program_prior_params
    from probnmn_tpu_torch.parallel import mesh
    from probnmn_tpu_torch.training._trainer import tree_leaves, tree_map
    from probnmn_tpu_torch.training.joint_training_trainer import JointTrainingTrainer
    from probnmn_tpu_torch.training.program_prior_trainer import make_prior_spec
    from probnmn_tpu_torch.training.question_coding_trainer import QuestionCodingTrainer
    from probnmn_tpu_torch.utils.checkpointing import save_objects
    from probnmn_tpu_torch.utils.clevr import make_clevr_like_vocabulary, sample_clevr_like_programs
    from probnmn_tpu_torch.utils.observability import RecordingWriter

    cards = torch.cuda.device_count()
    share = cards < MESH_RANKS
    backend = ("gloo, both on card 0 (one card)" if share else
               f"nccl, one card a rank ({cards} cards)")
    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_semi_")
    vocab = make_clevr_like_vocabulary()
    vocab.save_to_files(os.path.join(work, "vocab"))
    gen = torch.Generator().manual_seed(161)
    dev = torch.device("cuda")
    t_cases = time.perf_counter()

    # Random frozen models: the prior, the question_coding generator and
    # reconstructor and the NMN, saved as the port's checkpoints.
    ckpt = {name: os.path.join(work, f"{name}.ckpt")
            for name in ("program_prior", "question_coding", "module_training")}
    overrides = ["DATA.VOCABULARY", os.path.join(work, "vocab"),
                 "CHECKPOINTS.PROGRAM_PRIOR", ckpt["program_prior"],
                 "CHECKPOINTS.QUESTION_CODING", ckpt["question_coding"],
                 "CHECKPOINTS.MODULE_TRAINING", ckpt["module_training"]]
    qc_config = Config(os.path.join(repo, "configs", "question_coding_ours.yml"), overrides)
    jt_config = Config(os.path.join(repo, "configs", "joint_training_ours.yml"),
                       overrides + ["NMN.COMPUTE_DTYPE", "float32"])
    save_objects(ckpt["program_prior"], {"program_prior": init_program_prior_params(
        gen, make_prior_spec(jt_config, vocab))})
    save_objects(ckpt["question_coding"], {
        "program_generator": program_generator.init_params(
            gen, program_generator.make_spec(vocab, jt_config)),
        "question_reconstructor": question_reconstructor.init_params(
            gen, question_reconstructor.make_spec(vocab, jt_config))})
    save_objects(ckpt["module_training"], {"nmn": nmn.init_nmn_params(
        gen, nmn.make_spec(vocab, jt_config))})
    np.random.seed(qc_config.RANDOM_SEED)  # the supervision subsets, drawn once
    supervision = dict(num_supervision=qc_config.SUPERVISION,
                       supervision_question_max_length=qc_config.SUPERVISION_QUESTION_MAX_LENGTH)
    qc_sets = (QuestionCodingDataset.from_tokens(*qc_questions(np, vocab, 4096, seed=26),
                                                 **supervision),
               QuestionCodingDataset.from_tokens(*qc_questions(np, vocab, 1024, seed=27),
                                                 split="val"))
    features = SharedFeatures.from_array(
        np.random.default_rng(28).standard_normal((256, 1024, 14, 14), dtype=np.float32))
    jt_sets = (JointTrainingDataset.from_arrays(*mt_arrays(np, vocab, 4096, 256, seed=29),
                                                features, **supervision),
               JointTrainingDataset.from_arrays(*mt_arrays(np, vocab, 1024, 256, seed=31),
                                                features, split="val"))
    # z by question: 62 CLEVR-like programs, a token soup and an all-pad row.
    table_np = sample_clevr_like_programs(vocab, 64, seed=30)
    table_np[-2] = np.random.RandomState(32).randint(0, vocab.get_vocab_size("programs"),
                                                     table_np.shape[1])
    table_np[-1] = 0
    table = torch.from_numpy(table_np)
    log(f"[mesh] semi-supervised ranks: {backend}; question_coding (OBJECTIVE ours, batch "
        f"{qc_config.OPTIM.BATCH_SIZE}) and joint_training (ours, batch "
        f"{jt_config.OPTIM.BATCH_SIZE}, NMN float32, 256 images of (1024, 14, 14) in shared "
        f"memory) at 2 ranks against one, z by question over {len(table_np)} programs; card {smi}")
    cases = {"question_coding": (qc_config, *qc_sets, QuestionCodingTrainer,
                                 QuestionCodingEvaluator),
             "joint_training": (jt_config, *jt_sets, JointTrainingTrainer,
                                JointTrainingEvaluator)}
    out = {}
    for phase, (config, train_set, val_set, cls, evaluator_cls) in cases.items():
        t0 = time.perf_counter()
        short = "qc" if phase == "question_coding" else "jt"
        one = cls(config, os.path.join(work, f"one_{short}"), device=dev,
                  writer=RecordingWriter(), dataset=train_set)
        table_dev = table.to(dev)
        one.sample_programs = lambda questions, dropout_masks=None: z_by_question(
            torch, questions, table_dev)
        init = tree_map(lambda t: t.detach().cpu().clone(), one.params)
        one_val = evaluator_cls(config, one, dataset=val_set).evaluate(num_batches=2)
        one_logs, one_baselines, smooth = [], [], None
        for i in range(MESH_STEPS):
            one_logs.append(one.step(i))
            one_baselines.append(float(one.baseline))
            grads = torch.cat([p.grad.reshape(-1) for p in tree_leaves(one.params)])
            if i == 0:
                first_grad = grads.cpu()
            smooth = grads.abs() > 1e-5 if smooth is None else smooth & (grads.abs() > 1e-5)
        reference = {"params": torch.cat([p.detach().reshape(-1) for p in tree_leaves(one.params)])
                     .cpu().share_memory_(), "smooth": smooth.cpu().share_memory_(),
                     "grad": first_grad.share_memory_()}
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = mesh.launch(mesh_semi_rank, MESH_RANKS, "cuda", work, share_card=share,
                            timeout=900, collective_timeout=600,
                            args=(phase, config, os.path.join(work, f"mesh_{short}"), train_set,
                                  val_set, init, table, reference))
        mesh_s = time.perf_counter() - t0
        cmp = ranks[0]["compared"]
        log(f"[mesh {phase}] one rank: {one_s:.1f} s (evaluator, {MESH_STEPS} steps); "
            f"{MESH_RANKS} ranks on {[r['device'] for r in ranks]} at {ranks[0]['rows']} rows each "
            f"({[r['n_sup'] for r in ranks]} supervised in the checked batch): {mesh_s:.1f} s "
            f"(spawn, evaluator, {MESH_STEPS + 1} steps, kernel checks)")
        for i, (got, want) in enumerate(zip(ranks[0]["logs"], one_logs)):
            log(f"[mesh {phase}] step {i}: {MESH_RANKS} ranks {got} / one rank {want}")
            for group, values in want.items():
                for key, value in values.items():
                    check(abs(got[group][key] - value) <= MESH_LOSS_RTOL * abs(value) + 1e-6,
                          f"mesh {phase} step {i} {group}/{key}: {got[group][key]} against "
                          f"{value}")
        check(ranks[1]["logs"] == ranks[0]["logs"], f"mesh {phase}: the ranks logged otherwise")
        baselines = [r["baselines"] for r in ranks]
        log(f"[mesh {phase}] REINFORCE baseline after each step: ranks {baselines} (one rank "
            f"{one_baselines}; the last after the traced step)")
        check(baselines[0] == baselines[1], f"mesh {phase}: the ranks' baselines differ")
        check(all(abs(a - b) <= 1e-5 for a, b in zip(baselines[0], one_baselines)),
              f"mesh {phase}: baseline against one rank")
        check(baselines[0][-1] != 0.0, f"mesh {phase}: the baseline did not move")
        check(ranks[1]["compared"]["checksum"] == cmp["checksum"],
              f"mesh {phase}: the ranks' parameters differ: {[r['compared'] for r in ranks]}")
        # ROADMAP.md's trainer-parity rule, as program_prior's and the NMN's
        # above: question_coding's parameters where every |g| > 1e-5 within
        # 1% of lr a step; joint's (the NMN's plateau) 2 lr a step.
        lr = config.OPTIM.LR_INITIAL
        limit = (1e-2 if phase == "question_coding" else 2) * lr * MESH_STEPS
        log(f"[mesh {phase}] the first step's summed gradient against one rank's: worst leaf max "
            f"|dev| / max(1, max|g|) {cmp['grad_ratio']:.3e} (limit 1e-4)")
        log(f"[mesh {phase}] params after {MESH_STEPS} steps against one rank: where every "
            f"step's |g| > 1e-5 ({cmp['smooth_share']:.4f} of them) max |dev| "
            f"{cmp['smooth_err']:.3e} (limit {limit:.1e}); all {cmp['rest_err']:.3e} (limit "
            f"{2 * lr * MESH_STEPS:.1e}); the ranks' parameters equal (checksums "
            f"{cmp['checksum']})")
        check(cmp["grad_ratio"] <= 1e-4, f"mesh {phase} first gradient against one rank: {cmp}")
        check(cmp["smooth_err"] <= limit and cmp["rest_err"] <= 2 * lr * MESH_STEPS,
              f"mesh {phase} params against one rank: {cmp}")
        for model, metrics in one_val.items():
            for key, value in metrics.items():
                got = [r["val"][model][key] for r in ranks]
                log(f"[mesh {phase}] evaluator {model}/{key}: {MESH_RANKS} ranks {got}, one "
                    f"rank {value}")
                check(all(abs(g - value) <= MESH_VAL_RTOL * max(1.0, abs(value)) for g in got),
                      f"mesh {phase} evaluator {model}/{key}")
        for r in ranks:
            log(f"[mesh {phase}] rank launches over the main path: {r['launches']}; one traced "
                f"step under the profiler: {r['route']}; kernels against plain at "
                f"{r['rows']} rows: {r['errs']}")
            check(r["route"] == r["route_want"],
                  f"mesh {phase} traced step {r['route']}, not {r['route_want']}")
        # 3 steps and a traced one: K3f once, K4f and K4b four times a step
        # (K5 and K6 once in joint); K1 and its encoder in the traced step.
        steps = MESH_STEPS + 1
        want = {"fused_sampling_forward": 1, "sampling_encode": 1, "lm_forward_cuda": steps,
                "tf_forward_cuda": 4 * steps, "tf_backward_cuda": 4 * steps}
        if phase == "joint_training":
            want.update(execute_programs_train_kernel=steps, interpreter_grads_kernel=steps)
        for r in ranks:
            check(r["launches"] == want, f"mesh {phase} launches {r['launches']}")
        for counter, launched in want.items():
            name = SEMI_NAMES[counter]
            out.setdefault(name, {}).update({
                f"launches_mesh_{short}": [r["launches"][counter] for r in ranks],
                f"max_abs_err_mesh_{short}": max(r["errs"][name] for r in ranks)})
        del one, init, reference
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    log(f"[mesh] semi-supervised cases in {time.perf_counter() - t_cases:.1f} s")
    return out


# Phase 17: serving over several cards. The sampling engines' generator leans
# toward SERVE_PROGRAM with a margin (~6.8) that the Gumbel draws overturn on
# about a quarter of the rows, so the answers show which rows of the batch's
# Philox stream each shard drew; the classifier is rescaled so that the
# answers follow the image (:func:`image_sensitive_classifier`), so they show
# which image each row was given.
CARDS = 2
CARDS_MARGIN = 9.0
CARDS_REQUESTS = 2048


@contextmanager
def strict_float32(torch):
    r"""No TF32 in cuBLAS or cuDNN inside (``main`` turns it off for the
    whole run; the card tests call phase 17's helpers alone)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def image_sensitive_classifier(torch, nmn_params, nmn_spec, programs, images, dev):
    r"""``nmn_params`` with the classifier's last layer rescaled so that
    each answer's logit has mean 0 and standard deviation 1 over the rows
    of ``images`` under ``programs`` (float32 on ``dev``). A random NMN
    answers nearly the same whatever the features; this one's answers
    follow the image."""
    from probnmn_tpu_torch.data.pipeline import image_to_nhwc
    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.models.nmn import cast_params

    params = cast_params(nmn_params, torch.float32, dev)
    with strict_float32(torch):
        stem = nmn.apply_stem(params["stem"], image_to_nhwc(torch.from_numpy(images).to(dev)))
        final, invalid = nmn.execute_programs(params, nmn_spec, stem.contiguous(),
                                              programs.to(dev))
        logits = nmn.apply_classifier(params["classifier"], final)[~invalid].double().cpu()
    mean, std = logits.mean(0), logits.std(0).clamp_min(1e-6)
    lin2 = nmn_params["classifier"]["lin2"]
    lin2 = {"w": (lin2["w"].double() / std[:, None]).float(),
            "b": ((lin2["b"].double() - mean) / std).float()}
    return dict(nmn_params, classifier=dict(nmn_params["classifier"], lin2=lin2))


def cards_inputs(np, torch, batch):
    r"""Phase 17's models and inputs at full width, from generators of its
    own: (vocabulary, the two specs, the random generator scripted to emit
    :data:`SERVE_PROGRAM`, the same leaning toward it with the margin
    :data:`CARDS_MARGIN`, random NMN parameters whose classifier is rescaled
    on these images under that program, ``batch`` random questions with an
    all-pad row in each half, (1024, 14, 14) features, a seed)."""
    from probnmn_tpu_torch.models import nmn, program_generator
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.models.seq2seq import GREEDY, seq2seq_forward
    from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH, make_clevr_like_vocabulary

    vocab = make_clevr_like_vocabulary()
    gen = torch.Generator().manual_seed(17)
    pg_spec, nmn_spec = program_generator.make_spec(vocab), nmn.make_spec(vocab)
    random_pg = program_generator.init_params(gen, pg_spec)
    scripted = scripted_generator(torch, random_pg, pg_spec, vocab, SERVE_PROGRAM)
    soft = scripted_generator(torch, random_pg, pg_spec, vocab, SERVE_PROGRAM, CARDS_MARGIN)
    questions = random_questions(np, vocab, batch, MAX_QUESTION_LENGTH, seed=1701)
    questions[batch // 2 + 1] = 0  # all padding, as row 1: one in each shard
    images = torch.randn(batch, nmn_spec.feature_channels, nmn_spec.height, nmn_spec.width,
                         generator=torch.Generator().manual_seed(1702)).numpy()
    dev = torch.device("cuda", 0)
    programs = seq2seq_forward(cast_params(scripted, torch.float32, dev), pg_spec,
                               torch.from_numpy(questions).to(dev), GREEDY)["predictions"]
    nmn_params = image_sensitive_classifier(torch, nmn.init_nmn_params(gen, nmn_spec), nmn_spec,
                                            programs, images, dev)
    return vocab, pg_spec, nmn_spec, scripted, soft, nmn_params, questions, images, 1703


def cards_requests(np, vocab, images, n):
    r"""``n`` dispatcher requests: random questions, each with one of
    ``images`` (copied), from generators of their own."""
    from probnmn_tpu_torch.utils.clevr import MAX_QUESTION_LENGTH

    rs = np.random.RandomState(1704)
    return (random_questions(np, vocab, n, MAX_QUESTION_LENGTH, seed=1705),
            images[rs.randint(0, len(images), n)])


def cards_dispatch(np, engine, questions, images, depth=2, clients=8):
    r"""The rows of ``questions`` and ``images`` through ``engine``'s
    dispatcher at ``depth``, from ``clients`` threads, each calling
    ``submit_many`` on groups of 1-64 rows; returns (the answers in row
    order, seconds on the host clock)."""
    import threading

    rs = np.random.RandomState(1706)
    n = len(questions)
    units, i = [], 0
    while i < n:
        j = min(i + int(rs.randint(1, 65)), n)
        units.append((i, j))
        i = j
    futures = [None] * n

    def client(t):
        for a, b in units[t::clients]:
            futures[a:b] = engine.submit_many(questions[a:b], images[a:b])

    engine.start(max_batch_delay=0.005, pipeline_depth=depth)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = [f.result(timeout=120) for f in futures]
        seconds = time.perf_counter() - t0
    finally:
        engine.stop()
    return got, seconds


def cards_float32_check(np, torch, vocab, pg_spec, nmn_spec, scripted, soft, nmn_params,
                        questions, images, seed, share, requests):
    r"""Phase 17's float32 check: engines over :data:`CARDS` shards (one a
    card, or all on card 0 with ``share``) against one card, greedy over
    ``scripted`` and sampling over ``soft`` (a generator the draws turn
    aside): every answer equal, with answers that vary with the image (a
    shard given another shard's rows would answer otherwise). Then the
    greedy engine over the shards takes ``requests`` (questions, images)
    through its dispatcher at depth 2: every answer equal to the one-card
    engine's ``predict`` on the same requests. Returns each decoding's
    answers at :data:`CARDS` shards."""
    from probnmn_tpu_torch.serving import InferenceEngine

    out = {}
    half = len(questions) // 2
    with strict_float32(torch):
        for decoding, pg in (("greedy", scripted), ("sampling", soft)):
            engines = [InferenceEngine(vocab, pg_spec, nmn_spec, pg, nmn_params,
                                       batch_size=len(questions), decoding=decoding,
                                       device="cuda", compute_dtype="float32", num_devices=n,
                                       share_card=share) for n in (1, CARDS)]
            check([e.num_devices for e in engines] == [1, CARDS],
                  f"shards made {[e.num_devices for e in engines]}")
            answers = [e.predict(questions, images, seed=seed) for e in engines]
            differ = sum(a != b for a, b in zip(*answers))
            unknown = answers[1].count("@@UNKNOWN@@")
            # What a shard given the other half's rows would get wrong.
            crossed = sum(a != b for a, b in zip(answers[0][:half], answers[0][half:]))
            log(f"[serve-cards] float32 {decoding}, {len(questions)} rows: {differ} answers "
                f"differ between 1 and {CARDS} shards; {unknown} @@UNKNOWN@@, "
                f"{len(set(answers[1]))} distinct answers, {crossed} of {half} rows answered "
                f"otherwise than the row {half} away")
            check(differ == 0, f"float32 {decoding}: {differ} answers differ over {CARDS} shards")
            check(len(answers[1]) == len(questions), "answer count over the shards")
            check(crossed >= half // 2, f"float32 {decoding}: the answers barely follow the "
                  f"image ({crossed} of {half} rows differ from the row {half} away)")
            out[decoding] = answers[1]
            if decoding == "greedy":
                want = engines[0].predict(*requests)
                got, seconds = cards_dispatch(np, engines[1], *requests)
                off = sum(a != b for a, b in zip(got, want))
                log(f"[serve-cards] float32 greedy dispatcher, depth 2 over {CARDS} shards: "
                    f"{len(got)} requests in {seconds:.3f} s, {off} answers differ from one "
                    f"card's predict, {len(set(got))} distinct answers, most in flight "
                    f"{engines[1].stats()['max_in_flight']}")
                check(len(got) == len(want) and off == 0,
                      f"float32 dispatcher: {off} answers differ from one card's predict")
            del engines
    check("@@UNKNOWN@@" not in out["greedy"], "the scripted program did not run")
    check(0 < out["sampling"].count("@@UNKNOWN@@") < len(questions),
          "the draws left every row valid or none: the answers cannot show the shards' rows")
    torch.cuda.empty_cache()
    return out


def k1_row_base_check(np, torch, pg_dev, pg_spec, q_dev, seed):
    r"""K1 in float32 at ``row_base`` r over rows [r, r + B / 2) against the
    full batch's K1 (the same rows of one Philox stream) and against the
    plain version on the host's copy of those rows of the stream: rows
    identical on >= 99% of the rows each time. Returns the fractions."""
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, philox_gumbel, sampling_forward_with_noise,
    )

    T, V = pg_spec.max_decoding_steps, pg_spec.target_vocab_size
    batch = len(q_dev)
    half = batch // 2
    full = fused_sampling_forward(pg_dev, pg_spec, q_dev, seed=seed,
                                  compute_dtype=torch.float32)["predictions"]
    out = {}
    for lo in (0, half):
        part = fused_sampling_forward(pg_dev, pg_spec, q_dev[lo:lo + half], seed=seed,
                                      row_base=lo, compute_dtype=torch.float32)["predictions"]
        noise = torch.from_numpy(philox_gumbel(seed, T, half, V, lo)).to(q_dev.device)
        plain = sampling_forward_with_noise(pg_dev, pg_spec, q_dev[lo:lo + half], noise,
                                            compute_dtype=torch.float32)["predictions"]
        torch.cuda.synchronize()
        as_full = float((part == full[lo:lo + half]).all(dim=1).float().mean())
        as_plain = float((part == plain).all(dim=1).float().mean())
        log(f"[serve-cards] K1 float32 row_base {lo}, {half} rows: rows equal to the full "
            f"batch's {as_full:.4f}, to the plain version on the host's stream {as_plain:.4f}")
        check(as_full >= 0.99 and as_plain >= 0.99, f"K1 at row_base {lo} draws other rows")
        out[str(lo)] = {"as_full_batch": as_full, "as_plain": as_plain}
    return out


def shard_against_plain(np, torch, engine, shard, nmn_params, nmn_spec, pg_spec, questions,
                        images, seed):
    r"""One bf16 shard of ``engine`` on its card: K1 on the shard's rows of
    ``questions`` at its ``row_base`` against the plain version on the
    host's copy of those rows of the Philox stream (tokens >= 95% equal),
    then K2 on the kernel's programs against its plain version (flags
    equal, outputs within 2e-2 of max |out|): phase 13's tolerances.
    Returns (K1's largest logprob error on identical rows, K2's error)."""
    from probnmn_tpu_torch.data.pipeline import image_to_nhwc
    from probnmn_tpu_torch.models import nmn
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        build_banks, build_tables, execute_programs_kernel, execute_programs_plain,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        fused_sampling_forward, philox_gumbel, sampling_forward_with_noise,
    )

    replica = engine._replicas[shard]
    card, dt = replica.device, engine.compute_dtype
    rows = len(questions) // engine.num_devices
    lo = shard * rows
    T, V = pg_spec.max_decoding_steps, pg_spec.target_vocab_size
    with torch.cuda.device(card):
        q = torch.from_numpy(questions[lo:lo + rows]).to(card)
        got = fused_sampling_forward(replica.pg_params, pg_spec, q, seed=seed, row_base=lo,
                                     compute_dtype=dt, packed=replica.pg_packed)
        noise = torch.from_numpy(philox_gumbel(seed, T, rows, V, lo)).to(card)
        want = sampling_forward_with_noise(replica.pg_params, pg_spec, q, noise, compute_dtype=dt)
        feats = image_to_nhwc(torch.from_numpy(images[lo:lo + rows])).to(card)
        stem = nmn.apply_stem(cast_params(nmn_params["stem"], dt, card), feats.to(dt)).contiguous()
        banks = build_banks(cast_params(nmn_params, torch.float32, card), nmn_spec, dt)
        tables = build_tables(nmn_spec, card)
        out_k, inv_k = execute_programs_kernel(banks, tables, nmn_spec, stem, got["predictions"])
        out_p, inv_p = execute_programs_plain(banks, tables, nmn_spec, stem, got["predictions"])
        torch.cuda.synchronize(card)
    same = (got["predictions"] == want["predictions"]).all(dim=1)
    agree = float((got["predictions"] == want["predictions"]).float().mean())
    k1_err = float((got["logprobs"] - want["logprobs"])[same].abs().max())
    k2_err = float((out_k.float() - out_p.float()).abs().max())
    scale = float(out_p.float().abs().max())
    log(f"[serve-cards] shard {shard} on {card} (rows {lo}-{lo + rows - 1}), bf16: K1 token "
        f"agreement {agree:.4f}, identical rows {int(same.sum())}/{rows}, max |logprob err| "
        f"{k1_err:.3e}; K2 invalid {int(inv_k.sum())}/{rows} (plain {int(inv_p.sum())}), max "
        f"|out err| {k2_err:.3e}, max |out| {scale:.3e}")
    check(agree >= 0.95, f"shard {shard}: K1 bf16 token agreement {agree}")
    check(torch.isfinite(got["loss"]).all(), f"shard {shard}: K1 loss not finite")
    check(torch.equal(inv_k, inv_p), f"shard {shard}: K2 invalid flags differ")
    check(torch.isfinite(out_k.float()).all(), f"shard {shard}: K2 output not finite")
    check(k2_err <= 2e-2 * scale, f"shard {shard}: K2 bf16 error {k2_err}")
    return k1_err, k2_err


def serve_cards(np, torch, smi):
    r"""Phase 17: the serving engine over :data:`CARDS` shards at full width
    (B = 256, (1024, 14, 14) features), one card a shard where there are two
    cards or more, else both on card 0 (``share_card``), on inputs and
    weights from a generator of its own. (a) float32, greedy and sampling:
    every answer equal to one card's, and the greedy dispatcher's 2,048
    answers equal to one card's ``predict`` (:func:`cards_float32_check`);
    K1 at a row base draws the rows of the full batch's stream
    (:func:`k1_row_base_check`). (b) bf16 sampling, the shipped path: one
    ``predict`` with the counters at 0 (K1, its encoder, the plan and K2
    once a shard) and traced (two sweeps, one decoder, one plan and one K2
    launch a shard); each shard's K1 and K2 against their plain versions
    (:func:`shard_against_plain`); the answers that differ from one card's
    counted. (c) the same 2,048 requests through the bf16 dispatcher at
    depth 2 from 8 client threads (``submit_many`` in groups of 1-64):
    every future answered, each batch's shards given its requests' rows on
    their own cards, at most 2 batches in flight, the counters one launch a
    shard a batch. Returns {kernel name: ``launches_cards``,
    ``max_abs_err_cards``} for the kernels line."""
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        execute_programs_kernel, interpreter_plan,
    )
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import fused_sampling_forward, sampling_encode
    from probnmn_tpu_torch.serving import InferenceEngine

    t17 = time.perf_counter()
    share = torch.cuda.device_count() < CARDS
    where = "both on card 0 (one card)" if share else f"cards 0-{CARDS - 1}"
    log(f"[serve-cards] {CARDS} shards, {where}; {torch.cuda.device_count()} cards: {smi}")
    (vocab, pg_spec, nmn_spec, scripted, soft, nmn_params, questions, images,
     seed) = cards_inputs(np, torch, BATCH)

    # ------------------------------------------------------------ (a) float32
    requests = cards_requests(np, vocab, images, CARDS_REQUESTS)
    answers32 = cards_float32_check(np, torch, vocab, pg_spec, nmn_spec, scripted, soft,
                                    nmn_params, questions, images, seed, share, requests)
    dev = torch.device("cuda", 0)
    row_base = k1_row_base_check(np, torch, cast_params(soft, torch.float32, dev), pg_spec,
                                 torch.from_numpy(questions).to(dev), seed)

    # ------------------------------------------------------------ (b) bf16
    counters = {"seq2seq_decode": fused_sampling_forward, "k1_encoder_sweep": sampling_encode,
                "nmn_interpreter": execute_programs_kernel, "nmn_plan": interpreter_plan}

    def sync():
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)

    def reset():
        sync()
        for fn in counters.values():
            fn.launches = 0

    def read():
        sync()
        return {name: fn.launches for name, fn in counters.items()}

    one = InferenceEngine(vocab, pg_spec, nmn_spec, soft, nmn_params, batch_size=BATCH,
                          device="cuda")
    want = one.predict(questions, images, seed=seed)
    del one
    engine = InferenceEngine(vocab, pg_spec, nmn_spec, soft, nmn_params, batch_size=BATCH,
                             device="cuda", num_devices=CARDS, share_card=share)
    check(engine.compute_dtype == torch.bfloat16 and engine.num_devices == CARDS,
          f"bf16 engine over {engine.num_devices} shards")
    check(all(b % CARDS == 0 for b in engine._buckets) and engine._buckets[-1] == BATCH,
          f"buckets {engine._buckets}")
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    reset()
    answers = engine.predict(questions, images, seed=seed)
    predict_launches = read()
    differ = sum(a != b for a, b in zip(answers, want))
    log(f"[serve-cards] bf16 predict over {CARDS} shards (warmup over buckets {engine._buckets} "
        f"{warmup_s:.2f} s): launches {predict_launches}; {differ} of {BATCH} answers differ from one card's (bf16 rows may answer otherwise with the "
        f"rows a launch sees, PERF.md §7); {answers.count('@@UNKNOWN@@')} @@UNKNOWN@@ against "
        f"{answers32['sampling'].count('@@UNKNOWN@@')} in float32")
    check(all(n == CARDS for n in predict_launches.values()),
          f"predict over {CARDS} shards launched {predict_launches}")
    check(len(answers) == BATCH, "bf16 answer count")
    want_route = {"k1_encoder_sweep": pg_spec.num_layers * CARDS, "seq2seq_sample_kernel": CARDS,
                  "nmn_plan_kernel": CARDS, "nmn_interpreter_kernel": CARDS}
    routes = traced_route(torch, lambda: engine.predict(questions, images, seed=seed),
                          tuple(want_route), want_route)
    log(f"[serve-cards] one predict under the profiler, each trace (late in a run the profiler "
        f"can drop a trace's first kernels): {routes}")
    check(routes[-1] == want_route, f"the traced predict is not one K1 and one K2 a shard: "
          f"{routes[-1]}")
    errs = [shard_against_plain(np, torch, engine, k, nmn_params, nmn_spec, pg_spec, questions,
                                images, seed) for k in range(CARDS)]

    # ------------------------------------------------------------ (c) dispatcher
    # Every batch recorded with what the shards received: each shard's rows
    # on its own card, together the batch's requests cast as staged.
    records = []
    launch = engine._launch_padded_groups

    def recording_launch(q_groups, im_groups, batch_seed, pad_to):
        launched = launch(q_groups, im_groups, batch_seed, pad_to)
        records.append((q_groups, im_groups, pad_to, launched))
        return launched

    before = engine.stats()
    reset()
    engine._launch_padded_groups = recording_launch
    try:
        got, seconds = cards_dispatch(np, engine, *requests)
    finally:
        del engine._launch_padded_groups
    ran = read()
    after = engine.stats()
    batches = after["batches"] - before["batches"]
    staged_bad, misplaced = 0, 0
    cards = [torch.device("cuda", 0 if share else k) for k in range(CARDS)]
    for q_groups, im_groups, pad_to, launched in records:
        want_q = torch.zeros((pad_to, q_groups[0].shape[1]), dtype=torch.int64)
        want_im = torch.zeros((pad_to,) + im_groups[0].shape[1:], dtype=engine.compute_dtype)
        cursor = 0
        for qg, img in zip(q_groups, im_groups):
            want_q[cursor:cursor + len(qg)] = torch.from_numpy(qg)
            want_im[cursor:cursor + len(img)] = torch.from_numpy(img)
            cursor += len(qg)
        if engine._replicas[0].device.type != "cuda":  # the CPU engine runs on its buffer
            continue
        misplaced += int([(shard[0].device, shard[1].device) for shard in launched.keep]
                         != [(card, card) for card in cards])
        got_q = torch.cat([shard[0].cpu() for shard in launched.keep])
        got_im = torch.cat([shard[1].cpu() for shard in launched.keep])
        staged_bad += int(not (torch.equal(got_q, want_q) and torch.equal(
            got_im.view(torch.int16), want_im.view(torch.int16))))
    del records
    log(f"[serve-cards] bf16 dispatcher depth 2 over {CARDS} shards: {len(got)} requests in "
        f"{seconds:.3f} s ({len(got) / seconds:.1f} q/s, host clock, one call, not a "
        f"measurement), {batches} batches, {staged_bad} whose shards did not receive their "
        f"requests' rows, {misplaced} whose shards' rows were not on {', '.join(map(str, cards))}, most in "
        f"flight {after['max_in_flight']}, launches "
        f"{ran}, queue depth {after['queue_depth']}")
    check(len(got) == CARDS_REQUESTS and all(isinstance(a, str) for a in got),
          "dispatcher answers")
    check(staged_bad == 0 and misplaced == 0, f"dispatcher batches: {staged_bad} reached the "
          f"shards altered, {misplaced} on other cards")
    check(after["requests"] - before["requests"] == CARDS_REQUESTS and after["queue_depth"] == 0,
          f"stats {after}")
    check(1 <= after["max_in_flight"] <= 2, f"{after['max_in_flight']} batches in flight")
    check(all(n == CARDS * batches for n in ran.values()),
          f"{batches} dispatcher batches over {CARDS} shards launched {ran}")
    del engine
    torch.cuda.empty_cache()
    log(f"[serve-cards] phase 17 in {time.perf_counter() - t17:.1f} s; the run so far "
        f"{time.perf_counter() - T_START:.1f} s")
    out = {name: {"launches_cards": {
        "shards": CARDS, "share_card": share, "predict": predict_launches[name],
        "dispatcher": ran[name], "dispatcher_batches": batches}} for name in counters}
    out["seq2seq_decode"]["max_abs_err_cards"] = max(e[0] for e in errs)
    out["seq2seq_decode"]["row_base_cards"] = row_base
    out["nmn_interpreter"]["max_abs_err_cards"] = max(e[1] for e in errs)
    return out


def _leaves(torch, tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in _leaves(torch, item)]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if sys.argv[1:] not in ([], ["--serve-cards"]):
        print("usage: chip_smoke.py [--serve-cards]", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from probnmn_tpu_torch.models import nmn, program_generator
    from probnmn_tpu_torch.models.nmn import cast_params
    from probnmn_tpu_torch.ops.kernels import _build
    import torch.nn.functional as F

    from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
        build_banks, build_tables, execute_programs_kernel, execute_programs_plain,
        interpreter_launch, interpreter_plan, interpreter_plan_plain,
    )
    from probnmn_tpu_torch.models.seq2seq import _encode
    from probnmn_tpu_torch.ops.kernels.seq2seq_decode import (
        decoder_plan, fused_sampling_forward, pack_weights, philox_gumbel, sampling_encode,
        sampling_forward_with_noise,
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

    if sys.argv[1:] == ["--serve-cards"]:
        # Phase 17 alone: its lines and its part of the kernels line, no ok line.
        print(json.dumps({"serve_cards": serve_cards(np, torch, smi)}), flush=True)
        print(nvidia_smi_line(), flush=True)
        return 0

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
    k1 = k1_against_plain(torch, pg_dev, pg_spec, q_dev, noise)
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
    # K1's encoder sweeps alone against the plain encoder on the card.
    L, H = pg_spec.num_layers, pg_spec.hidden_size
    k1_enc, k1_plans = k1_encoder_against_plain(torch, pg_dev, pg_spec, q_dev)
    _, _, _, counts = trace(torch, lambda: fused_sampling_forward(
        pg_dev, pg_spec, q_dev, seed=seed, compute_dtype=torch.bfloat16))
    k1_route = {k: launches_of(counts, k) for k in ("k1_encoder_sweep", "seq2seq_sample_kernel")}
    k1_decoder_plans = {}
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        pl = decoder_plan(BATCH, questions.shape[1], pg_spec.input_size, H,
                          pg_spec.target_vocab_size, dtype)
        k1_decoder_plans[name] = pl
        kept = [what for key, what in (("w_hh_resident", "W_hh"), ("w_ih_resident", "W_ih"),
                                       ("encoder_resident", "encoder outputs"),
                                       ("projection_resident", "projection")) if pl[key]]
        log(f"[K1 decoder plan] {name}: n {pl['cluster']}, U {pl['units']}, R {pl['rows']} "
            f"({pl['rows_per_cta']} a CTA), {pl['clusters']} clusters ({pl['fit']} at once), "
            f"{pl['threads']} threads, {pl['smem']} B shared holding {', '.join(kept) or 'no weights'}, "
            f"{pl['tiles']} {'m-tiles' if name == 'bfloat16' else 'rows a thread'}, "
            f"{pl['registers']} registers")
    log(f"[K1 route] one K1 under the profiler: {k1_route}")
    check(k1_route == {"k1_encoder_sweep": L, "seq2seq_sample_kernel": 1},
          f"K1 is not one sweep a layer and one decoder launch: {k1_route}")

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
    sampling_encode.launches = 0
    execute_programs_kernel.launches = 0
    interpreter_plan.launches = 0
    answers = engine.predict(questions, images, seed=seed)
    torch.cuda.synchronize()
    launches = {"seq2seq_decode": fused_sampling_forward.launches,
                "k1_encoder_sweep": sampling_encode.launches,
                "nmn_interpreter": execute_programs_kernel.launches,
                "nmn_plan": interpreter_plan.launches}
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
    # K1's encoder sweeps alone, and K1's two parts under the profiler.
    enc_ms = cuda_ms(torch, lambda: sampling_encode(
        pg_dev, pg_spec, q_dev, compute_dtype=dt, packed=packed), iters=10)
    enc_plain_ms = cuda_ms(torch, lambda: _encode(pg_dev, pg_spec, q_dev, dt), iters=3, warmup=1)
    k1_parts = launch_times(torch, lambda: fused_sampling_forward(
        pg_dev, pg_spec, q_dev, seed=seed, compute_dtype=dt, packed=packed),
        ("k1_encoder_sweep", "seq2seq_sample_kernel"))
    sweep_us = k1_parts["k1_encoder_sweep"]
    dec_ms = sum(k1_parts["seq2seq_sample_kernel"]) / 1e3
    (enc_flops, enc_bytes), (dec_flops, dec_bytes) = k1_parts_work(pg_spec, questions, packed)
    enc_bound, enc_by = bound(enc_flops, enc_bytes, "bfloat16")
    dec_bound, dec_by = bound(dec_flops, dec_bytes, "bfloat16")
    # Yardstick: cuDNN's float32 LSTM over the same lengths, recurrence only.
    # Its input comes from a generator of its own: the later phases draw
    # their weights and data from ``gen``.
    lstm = torch.nn.LSTM(pg_spec.input_size, H, L, batch_first=True).to(dev)
    enc_lens = torch.from_numpy((questions != pg_spec.pad_index).sum(1) + 1)
    x_enc = torch.randn(BATCH, MAX_QUESTION_LENGTH + 1, pg_spec.input_size,
                        generator=torch.Generator().manual_seed(5)).to(dev)
    packed_x = torch.nn.utils.rnn.pack_padded_sequence(x_enc, enc_lens, batch_first=True,
                                                       enforce_sorted=False)
    with torch.no_grad():
        cudnn_enc_ms = cuda_ms(torch, lambda: lstm(packed_x), iters=10)

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
    # The plan K2 takes the timed batch in (each program's convs, counted on
    # the card, longest first) against its plain version, the makespan it
    # predicts for the persistent grid, and K2's route under the profiler.
    plan_convs, plan_order = interpreter_plan(tables, valid)
    want_convs, want_order = interpreter_plan_plain(tables, valid.cpu())
    plan_err = float((plan_convs.cpu() - want_convs).abs().max())
    check(plan_err == 0 and torch.equal(plan_order.cpu(), want_order),
          "the plan kernel differs from its plain version")
    check(int(want_convs.sum()) == n_convs, "the plan's convs differ from the host replay's")
    plan_ms = cuda_ms(torch, lambda: interpreter_plan(tables, valid), iters=20)
    plan_plain_ms = cuda_ms(torch, lambda: interpreter_plan_plain(tables, valid), iters=3, warmup=1)
    plan_bound, plan_by = bound(0.0, valid_np.size * 4 + 2 * BATCH * 4, "bfloat16")
    h, w, C = nmn_spec.height, nmn_spec.width, nmn_spec.module_channels
    launch = interpreter_launch(dt, BATCH, h, w, C)
    counts = want_convs.long().tolist()
    grid = launch["grid"]
    waves = max(sum(counts[j::grid]) for j in range(grid))
    log(f"[K2 plan] {BATCH} valid programs, {n_convs} 3x3 convs: longest chain {max(counts)} convs "
        f"(p90 {int(np.percentile(counts, 90))}, mean {np.mean(counts):.1f}); persistent grid "
        f"{grid} blocks, weight ring of {launch['stages']} stages; predicted makespan "
        f"{makespan(counts, want_order.long().tolist(), grid)} convs longest first, "
        f"{makespan(counts, range(BATCH), grid)} in batch order, {waves} in block-index waves")
    _, _, _, k2_counts = trace(torch, lambda: execute_programs_kernel(
        banks16, tables, nmn_spec, stem16, valid))
    k2_route = {k: launches_of(k2_counts, k) for k in ("nmn_plan_kernel", "nmn_interpreter_kernel")}
    log(f"[K2 plan] route under the profiler, one K2 (bf16: wgmma m64n128k16 with each tap's "
        f"weights staged by TMA): {k2_route}; the plan {plan_ms:.4f} ms (plain "
        f"{plan_plain_ms:.4f}, bound {plan_bound:.6f} by {plan_by})")
    check(k2_route == {"nmn_plan_kernel": 1, "nmn_interpreter_kernel": 1},
          f"K2 is not one plan and one interpreter launch: {k2_route}")
    # Yardstick: cuDNN's bf16 conv forward over as many 3x3 convs, from a
    # generator of its own.
    ygen = torch.Generator(device=dev).manual_seed(6)
    xk = torch.randn(n_convs, C, h, w, device=dev, generator=ygen, dtype=dt)
    wk = (0.05 * torch.randn(C, C, 3, 3, device=dev, generator=ygen)).to(dt)
    with torch.no_grad():
        cudnn_k2_ms = cuda_ms(torch, lambda: F.conv2d(xk, wk, padding=1), iters=10)
    del xk
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
    log(f"[time] K1 parts under the profiler: encoder {sum(sweep_us) / 1e3:.3f} ms in "
        f"{len(sweep_us)} sweeps ({', '.join(f'{u:.1f}' for u in sweep_us)} us; bound "
        f"{enc_bound:.4f} by {enc_by}: {enc_flops / 1e9:.2f} GFLOP, {enc_bytes / 1e6:.2f} MB), "
        f"decoder {dec_ms:.3f} ms (bound {dec_bound:.4f} by {dec_by}: {dec_flops / 1e9:.2f} GFLOP, "
        f"{dec_bytes / 1e6:.2f} MB)")
    log(f"[time] K1 encoder sweeps alone {enc_ms:.3f} ms/batch (plain {enc_plain_ms:.3f}; cuDNN "
        f"float32 LSTM, recurrence only, {cudnn_enc_ms:.3f})")
    log(f"[time] K2 {k2_ms:.3f} ms/batch of {BATCH} valid programs (plain {k2_plain_ms:.3f}, "
        f"bound {k2_bound:.4f} by {k2_by}: {n_convs} 3x3 convs, {k2_flops / 1e9:.1f} GFLOP, "
        f"{k2_bytes / 1e6:.1f} MB; cuDNN bf16 conv forward over {n_convs} convs {cudnn_k2_ms:.3f})")
    log(f"[time] NMN forward (stem + K2 + classifier) {nmn_ms:.3f} ms/batch, valid programs "
        f"(bound {nmn_bound:.4f} by {nmn_by}: {(k2_flops + dense_flops) / 1e9:.1f} GFLOP)")
    log(f"[time] feature upload (float32, {images.nbytes / 1e6:.0f} MB, host clock) {upload_ms:.2f} ms/batch")
    log(f"[time] predict {predict_ms:.2f} ms/batch of {BATCH} (host clock, incl. host batch "
        f"assembly and upload): {BATCH / predict_ms * 1e3:.1f} questions/s; device bound "
        f"{predict_bound:.4f} ms (K1 + NMN forward on its {e2e_convs} 3x3 convs, upload "
        f"excluded); card {smi}")
    wall_ms, busy_ms, top, _ = trace(torch, lambda: engine.predict(questions, images, seed=seed))
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
    qc_ckpt = os.path.join(shared, "question_coding.ckpt")
    question_coding = train_question_coding(np, torch, dev, gen, vocab, smi, prior_ckpt, qc_ckpt)

    # ---------------------------------------------------------------- 8. module_training
    mt_ckpt = os.path.join(shared, "module_training.ckpt")
    module_training = train_module_training(np, torch, dev, gen, vocab, smi, qc_ckpt, mt_ckpt)

    # ---------------------------------------------------------------- 9. joint_training
    joint_training = train_joint_training(np, torch, dev, gen, vocab, smi, prior_ckpt, qc_ckpt,
                                          mt_ckpt)
    shutil.rmtree(shared, ignore_errors=True)

    # ---------------------------------------------------------------- 10. mini-CLEVR
    mini_clevr, mini_clevr_errs = train_mini_clevr(np, torch)

    # ---------------------------------------------------------------- 11. GEMM
    gemm = gemm_against_float64(np, torch, dev, smi)

    # ---------------------------------------------------------------- 12. serving from a checkpoint
    serve_launches, serve_errs, serve_times = serve_from_checkpoints(np, torch, dev, smi)

    # ---------------------------------------------------------------- 13. online serving
    online_launches, online_errs, online_times = serve_online(np, torch, dev, smi)

    # ---------------------------------------------------------------- 14. images -> answers
    extract = extract_to_answers(np, torch, dev, smi)

    # ---------------------------------------------------------------- 15. dropout, bf16 Adam moment
    dropout = train_with_dropout(np, torch, dev, smi)

    # ---------------------------------------------------------------- 16. the mesh
    t16 = time.perf_counter()
    mesh_keys = train_mesh(np, torch, smi)
    for name, keys in train_mesh_semisupervised(np, torch, smi).items():
        mesh_keys.setdefault(name, {}).update(keys)
    log(f"[mesh] phase 16 in {time.perf_counter() - t16:.1f} s; the run so far "
        f"{time.perf_counter() - T_START:.1f} s")

    # ---------------------------------------------------------------- 17. serving over cards
    cards = serve_cards(np, torch, smi)

    # max_abs_err is the bfloat16 build's, the one predict runs (K1: logprobs
    # on rows with identical tokens; its encoder sweeps: outputs; K2:
    # outputs, all 256-row comparisons); the float32 build's error stands
    # beside it.
    kernels = [
        {"name": "seq2seq_decode", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/seq2seq_decode.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_decode.py:99",
         "launches": launches["seq2seq_decode"], "max_abs_err": k1["bfloat16"],
         "max_abs_err_float32": k1["float32"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "route_launches": k1_route,
         "parts": {"encoder_ms": sum(sweep_us) / 1e3, "encoder_bound_ms": enc_bound,
                   "decoder_ms": dec_ms, "decoder_bound_ms": dec_bound},
         "decoder_plan": k1_decoder_plans},
        {"name": "k1_encoder_sweep", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/seq2seq_decode.cu",
         "replaces": "probnmn_tpu/ops/pallas/seq2seq_decode.py:137",
         "launches": launches["k1_encoder_sweep"], "max_abs_err": k1_enc["bfloat16"],
         "max_abs_err_float32": k1_enc["float32"],
         "ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": enc_bound, "bound_by": enc_by,
         "library_ms": None, "yardstick": "cuDNN LSTM, float32, recurrence only",
         "yardstick_ms": cudnn_enc_ms, "sweep_plan": k1_plans, "sweep_us": sweep_us},
        {"name": "nmn_interpreter", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/nmn_interpreter.cu",
         "replaces": "probnmn_tpu/ops/pallas/nmn_interpreter.py:284",
         "launches": launches["nmn_interpreter"], "max_abs_err": k2["bfloat16"],
         "max_abs_err_float32": k2["float32"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "yardstick": "cuDNN bf16 conv2d forward over the same 3x3 convs",
         "yardstick_ms": cudnn_k2_ms, "route_launches": k2_route, "grid": launch["grid"],
         "ring_stages": launch["stages"]},
        {"name": "nmn_plan", "route": "cuda",
         "source": "probnmn_tpu_torch/csrc/nmn_interpreter.cu",
         "replaces": "probnmn_tpu/ops/pallas/nmn_interpreter.py:284",
         "launches": launches["nmn_plan"], "max_abs_err": plan_err,
         "ms": plan_ms, "plain_ms": plan_plain_ms, "bound_ms": plan_bound, "bound_by": plan_by,
         "library_ms": None},
        *prior,
        *question_coding,
        *module_training,
        *joint_training,
        gemm,
    ]
    for entry in kernels:
        entry["launches_mini_clevr"] = mini_clevr[entry["name"]]
        entry["max_abs_err_mini_clevr"] = mini_clevr_errs.get(entry["name"])
        if entry["name"] in serve_launches:
            entry["launches_from_checkpoint"] = serve_launches[entry["name"]]
            entry["max_abs_err_from_checkpoint"] = serve_errs.get(entry["name"])
        if entry["name"] in online_launches:
            entry["launches_dispatcher"] = online_launches[entry["name"]]
        if entry["name"] in online_errs:
            entry["max_abs_err_buckets"] = online_errs[entry["name"]]
        entry.update(dropout.get(entry["name"], {}))
        entry.update(mesh_keys.get(entry["name"], {}))
        entry.update(cards.get(entry["name"], {}))
    kernels.append(extract)
    kernels[0]["from_checkpoint_times"] = serve_times
    kernels[0]["serve_online"] = online_times
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
