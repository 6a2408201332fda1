#!/usr/bin/env python3
r"""
The serving engine over 1, 2 and 4 cards of this machine
(``InferenceEngine(num_devices=N)``: one process, one replica a card, each
batch split into N contiguous shards), bf16 sampling at batch 256 on
(1024, 14, 14) features, the shipped configuration, with a generator
scripted to emit one valid program (``chip_smoke.scripted_generator``), so
the NMN runs a whole program on every row (the valid regime of
``bench.py``):

    python3 tools/serve_cards_times.py [--cards 1 2 4] [--reps 20] \
        [--requests 4096] [--out build/serve_cards_times.json]

For each card count: ``predict`` on 256 rows, ``--reps`` calls by host
clock (staging, the cast to bf16 and the uploads in) as ms a batch and
questions/s, and a call's host ms split into staging (``_stage``, the
cast in), the shards' pipelines enqueued (``_pipeline``, summed over the
shards), the whole launch (``_launch_padded_groups``) and the wait for the
answers (``_fetch``); card 0's idle share over 5 ``predict`` calls under
``torch.profiler`` (1 - the union of its kernels' and copies' intervals
over the host-clock span) and each card's busy ms a call; the dispatcher at
saturation, ``--requests`` requests from 8 client threads, each submitting
64 (``submit_many``) and waiting for their answers before the next 64 (so
at most 512 requests are outstanding), at pipeline depth 1 and 2, as
questions/s, with ``stats()``'s p50 / p99 latency and the most batches in
flight. A request's features are a view of a pool of 512 feature maps,
so the clients copy nothing. A count above the machine's cards is
recorded as not measured. Prints one JSON line and writes it to ``--out``,
beside the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from probnmn_tpu_torch.models import nmn, program_generator  # noqa: E402
from probnmn_tpu_torch.serving import InferenceEngine  # noqa: E402
from probnmn_tpu_torch.utils.clevr import (  # noqa: E402
    MAX_QUESTION_LENGTH,
    make_clevr_like_vocabulary,
)

parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
parser.add_argument("--cards", type=int, nargs="+", default=[1, 2, 4])
parser.add_argument("--reps", type=int, default=20)
parser.add_argument("--requests", type=int, default=4096)
parser.add_argument("--batch-size", type=int, default=256)
parser.add_argument("--out", default="build/serve_cards_times.json")

POOL = 512  # distinct feature maps the requests draw from
THREADS = 8
GROUP = 64


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()


PARTS = ("_stage", "_pipeline", "_launch_padded_groups", "_fetch")


def host_parts(engine, fn, calls):
    r"""``calls`` calls of ``fn`` with the engine's :data:`PARTS` timed by
    host clock: {part: ms a call}."""
    spent = dict.fromkeys(PARTS, 0.0)

    def timed(name, method):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return method(*args)
            finally:
                spent[name] += time.perf_counter() - t0
        return run

    for name in PARTS:
        setattr(engine, name, timed(name, getattr(engine, name)))
    try:
        for _ in range(calls):
            fn()
    finally:
        for name in PARTS:
            delattr(engine, name)
    return {name.strip("_"): 1e3 * v / calls for name, v in spent.items()}


def union_ms(intervals):
    r"""Total length of the union of (start, end) µs intervals, in ms."""
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e3


def device_busy(engine, fn, calls):
    r"""``calls`` calls of ``fn`` under the profiler: (host-clock ms of the
    span, {card index: busy ms}), busy being the union of the card's kernel,
    copy and set intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.02)
    spans = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            spans.setdefault(event.device_index, []).append(
                (event.time_range.start, event.time_range.end))
    return wall_ms, {k: union_ms(v) for k, v in sorted(spans.items())}


def saturate(engine, questions, pool, depth, requests):
    r"""``requests`` requests from :data:`THREADS` threads, each submitting
    a group of :data:`GROUP` (request a's features: pool row a mod
    :data:`POOL`) and waiting for its answers before the next; returns
    (seconds, stats)."""
    engine._latencies.clear()
    engine._max_in_flight = 0
    engine.start(max_batch_delay=0.005, pipeline_depth=depth)
    futures = [None] * requests

    def client(t):
        for a in range(t * GROUP, requests, THREADS * GROUP):
            b = min(a + GROUP, requests)
            futures[a:b] = engine.submit_many(questions[a:b], pool[a % POOL:a % POOL + b - a])
            for f in futures[a:b]:
                f.result(timeout=300)

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        answers = [f.result(timeout=300) for f in futures]
        seconds = time.perf_counter() - t0
    finally:
        engine.stop()
    if "@@UNKNOWN@@" in answers:
        raise RuntimeError("the scripted program did not run")
    return seconds, engine.stats()


def main(args):
    if not torch.cuda.is_available():
        print("serve_cards_times: no CUDA device", file=sys.stderr)
        return 1
    available = torch.cuda.device_count()
    smi = smi_line()
    vocab = make_clevr_like_vocabulary()
    gen = torch.Generator().manual_seed(23)
    pg_spec, nmn_spec = program_generator.make_spec(vocab), nmn.make_spec(vocab)
    pg = chip_smoke.scripted_generator(torch, program_generator.init_params(gen, pg_spec), pg_spec,
                                       vocab, chip_smoke.SERVE_PROGRAM)
    nmn_params = nmn.init_nmn_params(gen, nmn_spec)
    B = args.batch_size
    questions = chip_smoke.random_questions(np, vocab, args.requests, MAX_QUESTION_LENGTH, 24)
    pool = torch.randn(POOL, nmn_spec.feature_channels, nmn_spec.height, nmn_spec.width,
                       generator=torch.Generator().manual_seed(25)).numpy()
    out = {"card": smi, "cards_present": available, "batch": B, "dtype": "bfloat16",
           "decoding": "sampling", "cases": {}}
    for n in args.cards:
        if n > available:
            out["cases"][str(n)] = f"not measured ({available} cards present)"
            continue
        engine = InferenceEngine(vocab, pg_spec, nmn_spec, pg, nmn_params, batch_size=B,
                                 device="cuda", num_devices=n)
        if engine.num_devices != n:
            raise RuntimeError(f"{n} cards asked, {engine.num_devices} made")
        engine.warmup()
        batch_q, batch_im = questions[:B], pool[:B]
        engine.predict(batch_q, batch_im)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            engine.predict(batch_q, batch_im)
        predict_ms = (time.perf_counter() - t0) / args.reps * 1e3
        parts = host_parts(engine, lambda: engine.predict(batch_q, batch_im), args.reps)
        wall_ms, busy = device_busy(engine, lambda: engine.predict(batch_q, batch_im), 5)
        case = {"predict_ms": predict_ms, "predict_qps": B / predict_ms * 1e3,
                "predict_host_ms": parts,
                "traced_ms_per_call": wall_ms / 5,
                "busy_ms_per_call": {str(k): v / 5 for k, v in busy.items()},
                "card0_idle_share": 1 - busy.get(0, 0.0) / wall_ms}
        for depth in (1, 2):
            seconds, stats = saturate(engine, questions, pool, depth, args.requests)
            case[f"dispatcher_depth{depth}"] = {
                "qps": args.requests / seconds, "seconds": seconds,
                "latency_p50_ms": stats["latency_p50"] * 1e3,
                "latency_p99_ms": stats["latency_p99"] * 1e3,
                "max_in_flight": stats["max_in_flight"]}
        out["cases"][str(n)] = case
        print(f"[serve-cards-times] {n} card(s): predict {predict_ms:.3f} ms "
              f"({case['predict_qps']:.1f} q/s; host ms {parts}), card 0 idle "
              f"{case['card0_idle_share']:.3f}, "
              f"busy/call {case['busy_ms_per_call']}; dispatcher depth 1 "
              f"{case['dispatcher_depth1']['qps']:.1f} q/s, depth 2 "
              f"{case['dispatcher_depth2']['qps']:.1f} q/s; {smi[0]}", flush=True)
        del engine
        torch.cuda.empty_cache()
    line = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(parser.parse_args()))
