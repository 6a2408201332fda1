"""The port's HTTP serve CLI (python -m probnmn_tpu_torch.serve) against the
JAX package's scripts/serve.py: both built in-process on port 0 over the same
JAX-format .ckpt (written as tests/test_serve_cli.py writes it, with the
generator's decoder scripted to emit one valid program, so that the answers
depend on the features) and the same features H5, greedy in float32, the
port on --device cpu. Every request form
(text questions by image_index, image_indices, question_tokens with inline
features) gets the same answers from both; the malformed payloads of
tests/test_serve_cli.py get the same status codes; /stats carries the JAX
keys; /healthz answers. ``--num-devices 2`` serves over two shards with the
same answers, and --device cuda without a card raises."""
import json
import os
import threading
import urllib.request

import h5py
import jax
import numpy as np
import pytest
import torch

from probnmn_tpu.data.vocabulary import Vocabulary as JVocabulary
from probnmn_tpu.models import nmn as jnmn
from probnmn_tpu.models import program_generator as jpg
from probnmn_tpu.utils.checkpointing import save_objects as jax_save_objects
from probnmn_tpu_torch import serve
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.preprocessing import tokenize_questions

from tests.clevr_fixtures import build_fixture_data, make_fixture_config
from tests.test_torch_port_inference import OVERRIDES, PROGRAM, _scripted

TIMEOUT = 60


def _args(module, config_path, ckpt, features_h5, *extra):
    return module.parser.parse_args([
        "--config-yml", config_path, "--checkpoint", ckpt, "--batch-size", "8",
        "--decoding", "greedy", "--compute-dtype", "float32", "--features-h5", features_h5,
        "--max-question-length", "12", "--port", "0", *extra])


def _serve(module, ctx):
    httpd = module.ThreadingHTTPServer(("127.0.0.1", 0), module.make_handler(ctx))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from scripts import serve as jax_serve

    root = str(tmp_path_factory.mktemp("port_serve_cli"))
    build_fixture_data(root)
    config = make_fixture_config(root, "joint_training", OVERRIDES)
    vocab = JVocabulary.from_files(config.DATA.VOCABULARY)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    pg_spec = jpg.make_spec(vocab, config)
    pg_params = _scripted(jpg.init_params(k1, pg_spec), pg_spec, vocab, PROGRAM)
    nmn_params = jnmn.init_nmn_params(k2, jnmn.make_spec(vocab, config))
    ckpt = os.path.join(root, "serve.ckpt")
    jax_save_objects(ckpt, {"program_generator": pg_params, "nmn": nmn_params})
    feats = np.random.RandomState(0).randn(4, 12, 6, 6).astype(np.float32)
    features_h5 = os.path.join(root, "serve_features.h5")
    with h5py.File(features_h5, "w") as f:
        f.attrs["split"] = "test"
        f.create_dataset("features", data=feats)
    config_path = os.path.join(root, "serve_config.yml")
    config.dump(config_path)

    jax_ctx = jax_serve.ServingContext(_args(jax_serve, config_path, ckpt, features_h5))
    port_ctx = serve.ServingContext(_args(serve, config_path, ckpt, features_h5,
                                          "--device", "cpu"))
    jax_httpd, jax_base = _serve(jax_serve, jax_ctx)
    port_httpd, port_base = _serve(serve, port_ctx)
    try:
        yield dict(jax=jax_base, port=port_base, ctx=port_ctx, vocab=vocab, feats=feats,
                   config_path=config_path, ckpt=ckpt, features_h5=features_h5)
    finally:
        for httpd, ctx in ((jax_httpd, jax_ctx), (port_httpd, port_ctx)):
            httpd.shutdown()
            ctx.engine.stop()


def _post(base, payload, raw=None):
    req = urllib.request.Request(base + "/predict",
                                 raw if raw is not None else json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _payloads(vocab):
    rs = np.random.RandomState(5)
    tokens = rs.randint(4, vocab.get_vocab_size("questions"), (5, 9))
    tokens[2, 4:] = 0
    inline = rs.randn(5, 12, 6, 6).astype(np.float32)
    return {
        "text by image_index": {"question": "how many red cubes are there", "image_index": 2},
        "texts by image_indices": {
            "questions": ["is there a red sphere ?", "what color is the cube left of the sphere",
                          "how many unknownword things", "", "the same size ; shape"],
            "image_indices": [0, 3, 1, 2, 0]},
        "texts, one image_index": {"questions": ["what shape", "is there a cube"],
                                   "image_index": 1},
        "question_tokens and features": {"question_tokens": tokens.tolist(),
                                         "features": inline.tolist()},
        "one question, one inline image": {"question": "what color is it",
                                           "features": inline[0].tolist()},
    }


FORMS = ["text by image_index", "texts by image_indices", "texts, one image_index",
         "question_tokens and features", "one question, one inline image"]


@pytest.mark.parametrize("form", FORMS)
def test_every_request_form_answers_as_the_jax_cli(servers, form):
    payload = _payloads(servers["vocab"])[form]
    jax_status, jax_body = _post(servers["jax"], payload)
    status, body = _post(servers["port"], payload)
    assert status == jax_status == 200, (body, jax_body)
    assert body["answers"] == jax_body["answers"]
    assert "@@UNKNOWN@@" not in body["answers"]  # the scripted program ran
    assert body["latency_ms"] > 0


def test_answers_equal_the_engines_predict(servers):
    ctx = servers["ctx"]
    texts = ["how many red cubes are there", "is the sphere left of the cube"]
    status, body = _post(servers["port"], {"questions": texts, "image_indices": [2, 3]})
    assert status == 200
    ids, _ = tokenize_questions(texts, ctx.engine.vocabulary, max_len=12)
    assert body["answers"] == ctx.engine.predict(ids.astype(np.int64), servers["feats"][[2, 3]])
    # The answers depend on the features: sixteen images do not all agree.
    feats = np.random.RandomState(9).randn(16, 12, 6, 6) * np.linspace(0.1, 30, 16)[:, None, None, None]
    status, body = _post(servers["port"], {"questions": ["what"] * 16, "features": feats.tolist()})
    assert status == 200 and len(set(body["answers"])) > 1, body


MALFORMED = {
    "no question": {"image_index": 0},
    "image index past the end": {"question": "hi", "image_index": 10 ** 6},
    "negative image index": {"question": "hi", "image_index": -1},
    "features of another geometry": {"question": "hi",
                                     "features": np.zeros((1, 12, 7, 7)).tolist()},
    "a bare string is one question": {"questions": "how many cubes", "image_index": 0},
    "over-length text": {"question": " ".join(["red"] * 20), "image_index": 0},
    "over-length question_tokens": {"question_tokens": [[5] * 13],
                                    "features": np.zeros((1, 12, 6, 6)).tolist()},
    "questions not strings": {"questions": [1, 2], "image_index": 0},
    "image_indices not integers": {"questions": ["a", "b"], "image_indices": [0.5, 1]},
    "fewer images than questions": {"questions": ["a", "b"], "image_indices": [0]},
    "features not numbers": {"question": "a", "features": [["x"]]},
    "a list body": [1, 2],
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_payloads_get_the_jax_status_codes(servers, name):
    payload = MALFORMED[name]
    jax_status, _ = _post(servers["jax"], payload)
    status, body = _post(servers["port"], payload)
    assert status == jax_status, (name, body)
    if status == 400:
        assert "error" in body


def test_bad_json_and_unknown_paths(servers):
    for base in (servers["jax"], servers["port"]):
        assert _post(base, None, raw=b"{not json")[0] == 400
        assert _get(base, "/nowhere")[0] == 404
    assert _get(servers["port"], "/healthz") == (200, {"ok": True})
    assert _get(servers["jax"], "/healthz") == (200, {"ok": True})


def test_stats_carries_the_jax_keys(servers):
    payload = {"question": "how many red cubes are there", "image_index": 0}
    for base in (servers["jax"], servers["port"]):
        assert _post(base, payload)[0] == 200
    _, want = _get(servers["jax"], "/stats")
    status, got = _get(servers["port"], "/stats")
    assert status == 200
    assert set(want) <= set(got)
    assert got["queue_depth"] == 0 and got["requests"] >= 1 and got["batches"] >= 1
    assert np.isfinite(got["latency_p99"]) and got["latency_count"] >= 1


@pytest.mark.parametrize("flag", ["--num-devices", "--compilation-cache-dir"])
def test_flags_not_ported_raise(servers, flag, tmp_path, monkeypatch):
    r"""Both flags were once refused. ``--num-devices 2`` now shards each
    batch over two replicas (on the CPU, in turn) with the answers of one;
    ``--compilation-cache-dir`` roots the kernels' build cache, as
    ``InferenceEngine.from_checkpoint(compilation_cache_dir=)`` does."""
    from probnmn_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored after the test
    if flag == "--num-devices":
        args = _args(serve, servers["config_path"], servers["ckpt"], servers["features_h5"],
                     "--device", "cpu", flag, "2")
        ctx = serve.ServingContext(args)
        try:
            assert ctx.engine.num_devices == 2
            payload = {"questions": ["what color is the cube", "how many red spheres"],
                       "image_indices": [1, 3]}
            assert ctx.answer(*ctx.parse(payload))["answers"] == servers["ctx"].answer(
                *servers["ctx"].parse(payload))["answers"]
        finally:
            ctx.engine.stop()
        return
    cache = str(tmp_path / "kernels")
    args = _args(serve, servers["config_path"], servers["ckpt"], servers["features_h5"],
                 "--device", "cpu", flag, cache)
    ctx = serve.ServingContext(args)
    try:
        assert str(_build.BUILD_DIR) == cache and os.path.isdir(cache)
        assert ctx.engine.compute_dtype == torch.float32
    finally:
        ctx.engine.stop()
    engine_cache = str(tmp_path / "engine_kernels")
    from probnmn_tpu_torch.serving import InferenceEngine

    InferenceEngine.from_checkpoint(Config(servers["config_path"]), servers["ckpt"],
                                    device="cpu", compilation_cache_dir=engine_cache)
    assert str(_build.BUILD_DIR) == engine_cache and os.path.isdir(engine_cache)


def test_cuda_without_a_card_raises(servers):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    args = _args(serve, servers["config_path"], servers["ckpt"], servers["features_h5"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ServingContext(args)
