r"""
HTTP serving CLI of the PyTorch port (counterpart of ``scripts/serve.py``):
a JSON front end over :class:`probnmn_tpu_torch.serving.InferenceEngine`'s
micro-batching dispatcher. Text questions are tokenized, coalesced with
other requests into bucketed batches and answered with their latency.
Standard library only (``http.server``).

Endpoints:
  GET  /healthz         -> {"ok": true}
  GET  /stats           -> engine.stats() (q/s, batch counts, p50/p95/p99)
  POST /predict         -> one request or a batch:
      {"question": "how many red cubes ...", "image_index": 3}
      {"questions": [...], "image_indices": [...]}
      {"question_tokens": [[...]], "features": [[[...]]]}   # pre-encoded
    Answers: {"answers": ["2", ...], "latency_ms": 4.1}
  Client input that does not parse or validate gets 400; a failure inside
  the engine gets 500.

Image features come from ``--features-h5`` (default: the config's
DATA.TEST_FEATURES) by ``image_index``, or inline as ``features``; without
the file only inline ``features`` are served.

    python -m probnmn_tpu_torch.serve --config-yml configs/joint_training.yml \
        --checkpoint runs/joint/checkpoint_best.ckpt --port 8090

``--device`` is ``cuda`` (the default) or ``cpu``; the checkpoint may be the
port's, the JAX package's ``.ckpt`` or the reference's ``.pth``.
``--num-devices N`` shards each batch over N cards in this process, one
replica a card (default 1; 0: every card), and
``--compilation-cache-dir`` roots the kernels' build cache
(``utils/cli_flags.py``).
"""
import argparse
import json
import logging
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.data.preprocessing import tokenize_questions
from probnmn_tpu_torch.utils.cli_flags import add_shared_flags, apply_shared_flags

logger = logging.getLogger(__name__)

parser = argparse.ArgumentParser(
    description="Serve a joint_training checkpoint over HTTP (PyTorch/CUDA).")
parser.add_argument("--config-yml", required=True)
parser.add_argument("--config-override", nargs="*", default=[])
parser.add_argument("--checkpoint", required=True,
                    help="A checkpoint holding program_generator and nmn: the port's, the JAX "
                    "package's .ckpt or the reference's .pth (told apart by content).")
parser.add_argument("--host", default="127.0.0.1")
parser.add_argument("--port", type=int, default=8090)
parser.add_argument("--batch-size", type=int, default=0,
                    help="Largest device batch (0 = config OPTIM.BATCH_SIZE).")
parser.add_argument("--decoding", default="sampling", choices=["sampling", "greedy", "beam"])
parser.add_argument("--beam-size", type=int, default=1)
parser.add_argument("--compute-dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                    help="auto: bfloat16 on cuda, float32 on cpu (or the config's NMN dtype).")
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
parser.add_argument("--max-batch-delay", type=float, default=0.005,
                    help="Dispatcher coalescing window (seconds).")
parser.add_argument("--pipeline-depth", type=int, default=2,
                    help="Batches dispatched and not yet fetched: 2 overlaps batch N+1's "
                    "assembly and upload with batch N's device work; 1 = no overlap.")
parser.add_argument("--features-h5", default="",
                    help="H5 with a (N, C, H, W) 'features' dataset for image_index requests "
                    "(default: config DATA.TEST_FEATURES).")
parser.add_argument("--in-memory-features", action="store_true",
                    help="Load the whole features H5 into RAM.")
parser.add_argument("--max-question-length", type=int, default=45,
                    help="Token budget per question (reference question_reconstructor.py:34 "
                    "uses 45); fixes the question width of every batch.")
add_shared_flags(parser, gpu_ids=False, num_devices_default=None, cache_default=None)


class ServingContext:
    r"""Engine + feature store shared across handler threads."""

    def __init__(self, args):
        from probnmn_tpu_torch.serving import InferenceEngine

        apply_shared_flags(args)
        config = Config(args.config_yml, args.config_override)
        # Inline 'features' must have the NMN's feature geometry: any other
        # shape would fail the whole coalesced batch.
        self.feature_shape = tuple(config.NMN.IMAGE_FEATURE_SIZE)
        self.engine = InferenceEngine.from_checkpoint(
            config, args.checkpoint, batch_size=args.batch_size or None,
            compute_dtype=None if args.compute_dtype == "auto" else args.compute_dtype,
            decoding=args.decoding, beam_size=args.beam_size, device=args.device,
            num_devices=args.num_devices,
        )
        self.max_question_length = args.max_question_length
        features_path = args.features_h5 or config.DATA.TEST_FEATURES
        self.features = None
        if os.path.exists(features_path):
            from probnmn_tpu_torch.data.readers import ClevrImageFeaturesReader

            self.features = ClevrImageFeaturesReader(features_path,
                                                     in_memory=args.in_memory_features)
            logger.info("features: %s (%d images)", features_path, len(self.features))
        else:
            logger.warning("features H5 %s not found: only inline-'features' requests "
                           "will be served", features_path)
        self.engine.warmup(question_length=self.max_question_length)
        self.engine.start(max_batch_delay=args.max_batch_delay,
                          pipeline_depth=args.pipeline_depth)

    # ---------------------------------------------------------------- request
    def parse(self, payload: dict):
        r"""Validate the request up front (raises ValueError -> HTTP 400):
        nothing malformed may reach a shared dispatcher batch."""
        questions = self._questions_array(payload)
        images = self._features_array(payload, questions.shape[0])
        if questions.shape[0] != images.shape[0]:
            raise ValueError(f"{questions.shape[0]} questions vs {images.shape[0]} images")
        vocab = self.engine.vocabulary.get_vocab_size("questions")
        if questions.size and (questions.min() < 0 or questions.max() >= vocab):
            raise ValueError(f"question tokens must lie in [0, {vocab})")
        return questions, images

    def answer(self, questions, images) -> dict:
        t0 = time.monotonic()
        futures = self.engine.submit_many(questions, images)
        answers = [f.result() for f in futures]
        return {"answers": answers, "latency_ms": round(1e3 * (time.monotonic() - t0), 3)}

    def _questions_array(self, payload: dict) -> np.ndarray:
        if "question_tokens" in payload:
            rows = payload["question_tokens"]
            out = np.zeros((len(rows), self.max_question_length), np.int64)
            for i, row in enumerate(rows):
                if len(row) > self.max_question_length:
                    raise ValueError(f"question_tokens[{i}] longer than "
                                     f"--max-question-length={self.max_question_length}")
                out[i, :len(row)] = row
            return out
        texts = payload.get("questions")
        if texts is None:
            if "question" not in payload:
                raise ValueError("need 'question', 'questions', or 'question_tokens'")
            texts = [payload["question"]]
        if isinstance(texts, str):  # a bare string is one question, not its characters
            texts = [texts]
        if not all(isinstance(t, str) for t in texts):
            raise ValueError("'questions' must be a list of strings")
        ids, lengths = tokenize_questions(texts, self.engine.vocabulary,
                                          max_len=self.max_question_length)
        over = np.nonzero(lengths > self.max_question_length)[0]
        if over.size:  # as for question_tokens: no silent truncation
            raise ValueError(f"question {int(over[0])} has {int(lengths[over[0]])} tokens "
                             f"(> --max-question-length={self.max_question_length})")
        return ids.astype(np.int64)

    def _features_array(self, payload: dict, n: int) -> np.ndarray:
        if "features" in payload:
            try:
                feats = np.asarray(payload["features"], np.float32)
            except (ValueError, TypeError) as error:
                raise ValueError(f"malformed 'features': {error}")
            if feats.ndim == 3:  # one image for a single-question request
                feats = feats[None]
            if feats.shape[1:] != self.feature_shape:
                raise ValueError(f"'features' must be shaped (n,) + {self.feature_shape} "
                                 f"(the config's NMN.IMAGE_FEATURE_SIZE); got {feats.shape}")
            return feats
        indices = payload.get("image_indices")
        if indices is None:
            if "image_index" not in payload:
                raise ValueError("need 'image_index', 'image_indices', or inline 'features'")
            indices = [payload["image_index"]] * n
        if self.features is None:
            raise ValueError("no --features-h5 loaded; pass inline 'features'")
        idx = np.asarray(indices)
        if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
            raise ValueError("'image_indices' must be a flat list of integers")
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.features)):
            raise ValueError(f"image index out of range [0, {len(self.features)})")
        return np.asarray(self.features[idx.astype(np.int64)], np.float32)


def make_handler(ctx: ServingContext):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *httpargs):  # route through logging
            logger.debug("%s " + fmt, self.address_string(), *httpargs)

        def _reply(self, code: int, body: dict) -> None:
            raw = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, {"ok": True})
            if self.path == "/stats":
                return self._reply(200, ctx.engine.stats())
            return self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            # Client input that does not parse or validate: 400. Anything
            # raised once the request is in the engine is the server's: 500.
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("request body must be a JSON object")
                questions, images = ctx.parse(payload)
            except (ValueError, KeyError, TypeError) as error:
                return self._reply(400, {"error": str(error)})
            try:
                return self._reply(200, ctx.answer(questions, images))
            except Exception as error:
                logger.exception("predict failed")
                return self._reply(500, {"error": str(error)})

    return Handler


def main(args):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    ctx = ServingContext(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(ctx))
    logger.info("serving on http://%s:%d (batch=%d, decoding=%s, device=%s, cards=%d)",
                args.host, server.server_address[1], ctx.engine.batch_size, args.decoding,
                args.device, ctx.engine.num_devices)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        ctx.engine.stop()


if __name__ == "__main__":
    main(parser.parse_args())
