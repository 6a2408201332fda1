"""The port's micro-batching dispatcher (InferenceEngine.start / submit /
submit_many / stop / stats) on the CPU, against the JAX engine's dispatcher on
the same params (carried across by interop): the same greedy answers, the
same bucket ladder, coalescing that keeps groups whole and never overshoots
the batch, padding to the smallest bucket, a malformed request failing only
its batch, a sustained load; and three fixes the JAX engine lacks (at most
pipeline_depth batches in flight, counters counted when a batch's answers
are in, stop() keeping a thread whose join timed out). Every future is taken
with a timeout and every dispatcher is stopped in a finally."""
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest

import jax

from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.models import program_generator as jpg
from probnmn_tpu.serving import InferenceEngine as JaxInferenceEngine
from probnmn_tpu_torch import interop
from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models import nmn, program_generator
from probnmn_tpu_torch.serving import InferenceEngine

from tests.clevr_fixtures import ANSWERS, PROGRAM_TOKENS, QUESTION_WORDS

TOKENS = {"questions": QUESTION_WORDS, "programs": PROGRAM_TOKENS, "answers": ANSWERS}
PG_SIZES = dict(input_size=16, hidden_size=16)
NMN_SIZES = dict(feature_channels=12, height=6, width=6, module_channels=8,
                 class_projection_channels=16, classifier_linear_size=10)
BATCH = 8
N = 24
TIMEOUT = 30


@pytest.fixture(scope="module")
def setup():
    jvocab = JVocabulary(TOKENS, non_padded_namespaces=["answers"])
    vocab = Vocabulary(TOKENS, non_padded_namespaces=["answers"])
    jpg_spec = dataclasses.replace(jpg.make_spec(jvocab), **PG_SIZES)
    pg_spec = dataclasses.replace(program_generator.make_spec(vocab), **PG_SIZES)
    jnmn_spec, nmn_spec = jnmn.make_spec(jvocab), nmn.make_spec(vocab)
    for k, v in NMN_SIZES.items():
        setattr(jnmn_spec, k, v)
        setattr(nmn_spec, k, v)
    k1, k2 = jax.random.split(jax.random.PRNGKey(17))
    jpg_params = jpg.init_params(k1, jpg_spec)
    jnmn_params = jnmn.init_nmn_params(k2, jnmn_spec)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    pg_params = interop.program_generator_from_jax(to_np(jpg_params))
    nmn_params = interop.nmn_from_jax(to_np(jnmn_params), nmn_spec)
    rs = np.random.RandomState(3)
    questions = rs.randint(4, len(QUESTION_WORDS), (N, 12)).astype(np.int64)
    questions[1, 5:] = 0
    images = rs.randn(N, 12, 6, 6).astype(np.float32)
    return dict(jvocab=jvocab, vocab=vocab, jpg_spec=jpg_spec, pg_spec=pg_spec,
                jnmn_spec=jnmn_spec, nmn_spec=nmn_spec, jpg_params=jpg_params,
                jnmn_params=jnmn_params, pg_params=pg_params, nmn_params=nmn_params,
                questions=questions, images=images)


def _engine(s, batch_size=BATCH, decoding="greedy"):
    return InferenceEngine(s["vocab"], s["pg_spec"], s["nmn_spec"], s["pg_params"],
                           s["nmn_params"], batch_size=batch_size, decoding=decoding,
                           device="cpu", compute_dtype="float32")


def _jax_engine(s, batch_size=BATCH):
    return JaxInferenceEngine(s["jvocab"], s["jpg_spec"], s["jnmn_spec"], s["jpg_params"],
                              s["jnmn_params"], batch_size=batch_size, num_devices=1,
                              decoding="greedy")


def _results(futures):
    return [f.result(timeout=TIMEOUT) for f in futures]


def _drive(engine, s, depth=2, delay=0.05):
    r"""Singles for the first 5 rows, then groups of 3, 4, 5 and 7 (a group
    of 7 cannot join a batch that already holds 5, so it straddles into the
    next), submitted at once so that they coalesce."""
    q, im = s["questions"], s["images"]
    engine.start(max_batch_delay=delay, pipeline_depth=depth)
    try:
        futures = [engine.submit(q[i], im[i]) for i in range(5)]
        start = 5
        for size in (3, 4, 5, 7):
            futures += engine.submit_many(q[start:start + size], im[start:start + size])
            start += size
        return _results(futures)
    finally:
        engine.stop()


@pytest.mark.parametrize("depth", [1, 2])
def test_dispatcher_matches_jax_dispatcher(setup, depth):
    s = setup
    want = _drive(_jax_engine(s), s, depth)
    engine = _engine(s)
    got = _drive(engine, s, depth)
    assert got == want
    assert got == engine.predict(s["questions"], s["images"])
    stats = engine.stats()
    assert stats["queue_depth"] == 0 and stats["max_in_flight"] <= depth


@pytest.mark.parametrize("batch_size", [8, 64, 100, 256])
def test_bucket_ladder_matches_jax(setup, batch_size):
    s = setup
    jax_engine, engine = _jax_engine(s, batch_size), _engine(s, batch_size)
    assert engine._buckets == jax_engine._buckets
    for n in range(1, batch_size + 1):
        assert engine.bucket_for(n) == jax_engine.bucket_for(n), n


def test_submit_many_equals_individual_submits(setup):
    s = setup
    engine = _engine(s)
    q, im = s["questions"][:6], s["images"][:6]
    engine.start(max_batch_delay=0.05)
    try:
        singles = _results([engine.submit(q[i], im[i]) for i in range(6)])
        grouped = _results(engine.submit_many(q[:4], im[:4]) + engine.submit_many(q[4:], im[4:]))
    finally:
        engine.stop()
    assert grouped == singles == engine.predict(q, im)


def _record_batches(engine, monkeypatch):
    batches = []
    launch = engine._launch_padded_groups

    def recording(q_groups, im_groups, seed, pad_to):
        batches.append((sum(g.shape[0] for g in q_groups), [g.shape[0] for g in q_groups], pad_to))
        return launch(q_groups, im_groups, seed, pad_to)

    monkeypatch.setattr(engine, "_launch_padded_groups", recording)
    return batches


def test_no_batch_overshoots_the_batch_size(setup, monkeypatch):
    s = setup
    engine = _engine(s)
    batches = _record_batches(engine, monkeypatch)
    q, im = s["questions"], s["images"]
    engine.start(max_batch_delay=0.2)
    try:
        futures = []
        for start in range(0, 21, 3):  # seven groups of 3 within one window
            futures += engine.submit_many(q[start:start + 3], im[start:start + 3])
        answers = _results(futures)
    finally:
        engine.stop()
    dispatched = list(batches)
    assert sum(b[0] for b in dispatched) == 21
    assert all(n <= BATCH and all(g == 3 for g in groups) for n, groups, _ in dispatched)
    assert all(pad_to == engine.bucket_for(n) for n, _, pad_to in dispatched)
    assert answers == engine.predict(q[:21], im[:21])


def test_a_group_larger_than_the_batch_runs_in_batches(setup, monkeypatch):
    s = setup
    engine = _engine(s)
    batches = _record_batches(engine, monkeypatch)
    q, im = s["questions"][:20], s["images"][:20]
    engine.start(max_batch_delay=0.05)
    try:
        answers = _results(engine.submit_many(q, im))
    finally:
        engine.stop()
    assert sorted(b[0] for b in batches) == [4, 8, 8]
    assert answers == engine.predict(q, im)


def test_groups_are_padded_to_the_smallest_bucket(setup, monkeypatch):
    s = setup
    engine = _engine(s)
    assert engine._buckets == [2, 8]
    batches = _record_batches(engine, monkeypatch)
    q, im = s["questions"], s["images"]
    engine.start(max_batch_delay=0.001)
    try:
        one = _results([engine.submit(q[0], im[0])])              # bucket 2: 1 padded slot
        three = _results(engine.submit_many(q[1:4], im[1:4]))     # bucket 8: 5 padded slots
    finally:
        engine.stop()
    assert [b[2] for b in batches] == [2, 8]
    stats = engine.stats()
    assert stats["requests"] == 4 and stats["batches"] == 2 and stats["padded_slots"] == 1 + 5
    assert one + three == engine.predict(q[:4], im[:4])


def test_malformed_request_fails_its_batch_and_the_dispatcher_lives(setup):
    s = setup
    engine = _engine(s)
    q, im = s["questions"], s["images"]
    bad_token = q[0].copy()
    bad_token[0] = len(QUESTION_WORDS)  # past the embedding table
    engine.start(max_batch_delay=0.05)
    try:
        bad = engine.submit(bad_token, im[0])
        neighbor = engine.submit(q[1], im[1])  # fails with it if they share a batch
        with pytest.raises(ValueError, match="question tokens"):
            bad.result(timeout=TIMEOUT)
        try:
            neighbor_answer = neighbor.result(timeout=TIMEOUT)
        except ValueError:
            neighbor_answer = None
        clean = engine.submit(q[3], im[3]).result(timeout=TIMEOUT)
    finally:
        engine.stop()
    stats = engine.stats()
    assert stats["queue_depth"] == 0
    assert stats["requests"] == 1 + (neighbor_answer is not None)
    assert clean == engine.predict(q[3:4], im[3:4])[0]
    assert neighbor_answer in (None, engine.predict(q[1:2], im[1:2])[0])


def test_sustained_load_resolves_every_request(setup):
    r"""About 2 s of load from more client threads than the host has cores,
    with a short switch interval: every request is answered once and the
    counters lose no update."""
    s = setup
    engine = _engine(s, decoding="sampling")
    q, im = s["questions"], s["images"]
    clients = (os.cpu_count() or 1) + 2
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    engine.start(max_batch_delay=0.002)
    futures, errors = [], []
    try:
        def client(k):
            rs = np.random.RandomState(k)
            end = time.monotonic() + 2.0
            while time.monotonic() < end:
                i = rs.randint(N)
                size = 1 + rs.randint(3)
                fs = engine.submit_many(q[i:i + size], im[i:i + size])
                futures.extend(fs)
                try:
                    _results(fs[:1])
                except Exception as error:  # noqa: BLE001 - collected for the assert
                    errors.append(error)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        answers = _results(futures)
    finally:
        sys.setswitchinterval(interval)
        engine.stop()
    assert not errors
    assert len(answers) == len(futures) > 20 and set(answers) <= set(ANSWERS)
    stats = engine.stats()
    assert stats["requests"] == len(futures) and stats["queue_depth"] == 0
    assert stats["latency_count"] == len(futures)
    assert all(np.isfinite(stats[k]) and stats[k] > 0
               for k in ("latency_p50", "latency_p95", "latency_p99", "qps"))
    assert stats["latency_p50"] <= stats["latency_p95"] <= stats["latency_p99"]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_at_most_depth_batches_in_flight(setup, monkeypatch, depth):
    r"""A slow pipeline (``_pipeline`` slowed) whose answers arrive late
    (``_fetch`` slowed, as a card's would): the batches that entered
    ``_launch_padded_groups`` and have not left ``_fetch``, counted outside
    the engine, never exceed the depth; reserving the slot after the launch,
    as the JAX engine does, gives depth + 1. The fetches wait until depth
    batches have entered the launch (with a timeout), so that the overlap
    is reached however slowly a loaded host launches."""
    s = setup
    engine = _engine(s)
    pipeline, fetch, launch = engine._pipeline, engine._fetch, engine._launch_padded_groups
    lock = threading.Lock()
    seen = {"now": 0, "most": 0}
    full = threading.Event()

    def counted_launch(*args):
        with lock:
            seen["now"] += 1
            seen["most"] = max(seen["most"], seen["now"])
            if seen["now"] == depth:
                full.set()
        return launch(*args)

    def slow_pipeline(*args):
        time.sleep(0.01)
        return pipeline(*args)

    def slow_fetch(launched):
        full.wait(TIMEOUT)
        time.sleep(0.08)
        out = fetch(launched)
        with lock:
            seen["now"] -= 1
        return out

    monkeypatch.setattr(engine, "_launch_padded_groups", counted_launch)
    monkeypatch.setattr(engine, "_pipeline", slow_pipeline)
    monkeypatch.setattr(engine, "_fetch", slow_fetch)
    q, im = s["questions"], s["images"]
    engine.start(max_batch_delay=0.0, pipeline_depth=depth)
    try:
        answers = _results([engine.submit(q[i], im[i]) for i in range(12)])
    finally:
        engine.stop()
    assert answers == engine.predict(q[:12], im[:12])
    assert 1 <= seen["most"] <= engine.stats()["max_in_flight"] <= depth
    if depth > 1:
        assert seen["most"] == depth  # the overlap is used


def test_failed_finish_counts_nothing(setup, monkeypatch):
    s = setup
    engine = _engine(s)
    fetch = engine._fetch
    calls = []

    def failing_once(launched):
        calls.append(launched.n)
        if len(calls) == 1:
            raise RuntimeError("fetch failed")
        return fetch(launched)

    monkeypatch.setattr(engine, "_fetch", failing_once)
    q, im = s["questions"], s["images"]
    engine.start(max_batch_delay=0.05)
    try:
        lost = engine.submit_many(q[:3], im[:3])
        for fut in lost:
            with pytest.raises(RuntimeError, match="fetch failed"):
                fut.result(timeout=TIMEOUT)
        assert engine.stats()["requests"] == 0 and engine.stats()["batches"] == 0
        engine.submit(q[3], im[3]).result(timeout=TIMEOUT)
    finally:
        engine.stop()
    stats = engine.stats()
    assert (stats["requests"], stats["batches"], stats["padded_slots"]) == (1, 1, 1)
    assert stats["queue_depth"] == 0


def test_stop_keeps_a_thread_whose_join_timed_out(setup, monkeypatch):
    s = setup
    engine = _engine(s)
    pipeline = engine._pipeline
    entered, release = threading.Event(), threading.Event()

    def stuck_pipeline(*args):
        entered.set()
        release.wait(TIMEOUT)
        return pipeline(*args)

    monkeypatch.setattr(engine, "_pipeline", stuck_pipeline)
    engine._join_timeout = 0.1
    q, im = s["questions"], s["images"]
    engine.start(max_batch_delay=0.0, pipeline_depth=1)
    try:
        fut = engine.submit(q[0], im[0])
        assert entered.wait(TIMEOUT)
        with pytest.raises(RuntimeError, match="did not stop"):
            engine.stop()
        launcher = engine._dispatcher
        assert launcher is not None and launcher.is_alive()
        with pytest.raises(RuntimeError, match="still alive"):
            engine.start()
        assert engine._dispatcher is launcher
        with pytest.raises(RuntimeError, match="start"):
            engine.submit(q[1], im[1])
        release.set()
        assert fut.result(timeout=TIMEOUT) == engine.predict(q[:1], im[:1])[0]
    finally:
        release.set()
        engine._join_timeout = TIMEOUT
        engine.stop()
    assert engine._dispatcher is None
    engine.start()  # a clean restart
    try:
        assert engine.submit(q[2], im[2]).result(timeout=TIMEOUT) == engine.predict(
            q[2:3], im[2:3])[0]
    finally:
        engine.stop()
