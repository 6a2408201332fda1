r"""
NeuralModuleNetwork: TbD-style module network executing CLEVR programs over
image features, as a batched register machine (counterpart of
``probnmn_tpu/models/nmn.py``; reference ``probnmn/models/nmn.py``).

Reference semantics (``nmn.py:139-275``):

- tokens execute in **reversed** program order with a single-slot register
  scheme: ``output`` starts as the stem features, ``saved_output`` starts
  empty; ``scene`` saves ``output`` and resets it to an all-ones attention;
  binary tokens (intersect/union/equal*/less_than/greater_than) consume
  ``(output, saved_output)``; other module tokens consume
  ``(stem_features, output)``;
- pad/@start@/@end@/unk/``unique`` are no-ops;
- *invalid programs* (what would raise in torch, or a final output that is an
  attention) give a zeroed classifier input, prediction @@UNKNOWN@@ and loss
  3.33 ≈ ln 28 (``nmn.py:194-196``, ``231-238``, ``249-269``).

Parameters are a plain dict in the JAX package's layout, except the stem's
3x3 convs, which are torch OIHW (``F.conv2d``); ``interop.nmn_from_jax``
converts. Module banks keep one slot per program-vocab token of their class.
:func:`nmn_forward` runs the plain register machine;
:func:`make_fast_inference_fn` is the serving path, which on CUDA runs the
interpreter kernel K2 (``ops/kernels/nmn_interpreter.py``);
:func:`nmn_forward_fast` is the training path (K5 forward, K6 backward) and
:func:`fast_forward_from_tables` the evaluators' K2 forward over prebuilt
banks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.ops import gconv
from probnmn_tpu_torch.ops.common import uniform
from probnmn_tpu_torch.ops.kernels.nmn_interpreter import (
    AND,
    ATTENTION,
    COMPARE,
    NOP,
    OR,
    QUERY,
    RELATE,
    SAME,
    SCENE,
    TAG_ATTN,
    TAG_FEAT,
    TAG_NONE,
    build_banks,
    build_tables,
    execute_programs_diff,
    execute_programs_kernel,
    execute_programs_plain,
)

__all__ = [
    "NOP", "SCENE", "AND", "OR", "ATTENTION", "QUERY", "RELATE", "SAME", "COMPARE",
    "TAG_NONE", "TAG_ATTN", "TAG_FEAT", "INVALID_LOSS", "NMNSpec", "classify_token",
    "make_spec", "init_nmn_params", "apply_stem", "training_stem", "apply_classifier",
    "execute_programs", "nmn_forward", "nmn_forward_fast", "fast_forward_from_tables",
    "make_fast_inference_fn", "resolve_compute_dtype",
]

_KIND_NAMES = [
    "nop", "scene", "and", "or", "attention", "query", "relate", "same", "compare",
]

INVALID_LOSS = 3.33  # ≈ ln(28), reference nmn.py:194-196

_NOOP_TOKENS = {"@@PADDING@@", "@start@", "@end@", "@@UNKNOWN@@", "unique"}


def classify_token(token: str) -> int:
    r"""Program-vocab token -> module kind (reference ``nmn.py:90-111``, ``219-229``)."""
    if token in _NOOP_TOKENS:
        return NOP
    if token == "scene":
        return SCENE
    if token == "intersect":
        return AND
    if token == "union":
        return OR
    if "equal" in token or token in {"less_than", "greater_than"}:
        return COMPARE
    if "query" in token or token in {"exist", "count"}:
        return QUERY
    if "relate" in token:
        return RELATE
    if "same" in token:
        return SAME
    return ATTENTION


@dataclass
class NMNSpec:
    r"""Static dispatch tables + architecture sizes (built once from the vocabulary)."""
    token_kind: np.ndarray          # (program_vocab,) int32 module kind per token
    token_bank: np.ndarray          # (program_vocab,) int32 slot in that kind's bank
    bank_sizes: Dict[str, int]      # kind name -> number of bank slots
    num_answers: int = 28
    unk_answer_index: int = 28
    feature_channels: int = 1024
    height: int = 14
    width: int = 14
    module_channels: int = 128
    class_projection_channels: int = 1024
    classifier_linear_size: int = 1024
    # "float32", "bfloat16" or "auto": bfloat16 on a CUDA device, float32 on
    # the CPU (see :func:`resolve_compute_dtype`). Answer logits are float32.
    compute_dtype: str = "auto"


def resolve_compute_dtype(name: Optional[str], device) -> torch.dtype:
    r"""``"auto"`` (or None) -> bfloat16 on CUDA, float32 on the CPU."""
    if name in (None, "auto"):
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def make_spec(vocabulary: Vocabulary, config=None) -> NMNSpec:
    tokens = vocabulary.get_index_to_token_vocabulary("programs")
    vocab_size = len(tokens)
    kind = np.zeros(vocab_size, np.int32)
    bank = np.zeros(vocab_size, np.int32)
    counters = {name: 0 for name in _KIND_NAMES}
    for index in range(vocab_size):
        k = classify_token(tokens[index])
        kind[index] = k
        name = _KIND_NAMES[k]
        if k in (ATTENTION, QUERY, RELATE, SAME, COMPARE):
            bank[index] = counters[name]
            counters[name] += 1
    bank_sizes = {n: max(counters[n], 1) for n in ("attention", "query", "relate", "same", "compare")}

    num_answers = vocabulary.get_vocab_size("answers") - 1  # exclude @@UNKNOWN@@
    kwargs: Dict[str, Any] = {}
    if config is not None:
        c = config.NMN
        kwargs = dict(
            feature_channels=c.IMAGE_FEATURE_SIZE[0],
            height=c.IMAGE_FEATURE_SIZE[1],
            width=c.IMAGE_FEATURE_SIZE[2],
            module_channels=c.MODULE_CHANNELS,
            class_projection_channels=c.CLASS_PROJECTION_CHANNELS,
            classifier_linear_size=c.CLASSIFIER_LINEAR_SIZE,
            compute_dtype=getattr(c, "COMPUTE_DTYPE", "auto"),
        )
    return NMNSpec(
        token_kind=kind,
        token_bank=bank,
        bank_sizes=bank_sizes,
        num_answers=num_answers,
        unk_answer_index=vocabulary.get_token_index("@@UNKNOWN@@", "answers"),
        **kwargs,
    )


# ------------------------------------------------------------------ init --------------
def _bank(gen, n, ksize, c_in, c_out, kaiming=True):
    r"""Conv bank: kaiming-normal weights (the reference modules' init), torch
    default uniform biases; ComparisonModule's projection keeps torch default
    uniform weights too."""
    fan_in = c_in * ksize * ksize
    shape = (n, c_in, c_out) if ksize == 1 else (n, ksize, ksize, c_in, c_out)
    bound = 1.0 / fan_in ** 0.5
    w = gconv.kaiming_normal(gen, shape, fan_in) if kaiming else uniform(gen, shape, bound)
    return {"w": w, "b": uniform(gen, (n, c_out), bound)}


def init_nmn_params(gen: torch.Generator, spec: NMNSpec) -> Dict[str, Any]:
    r"""Random parameters (drawn on the CPU from ``gen``) in the port's layout."""
    C = spec.module_channels
    F_in = spec.feature_channels
    P = spec.class_projection_channels
    flat = P * (spec.height // 2) * (spec.width // 2)
    nb = spec.bank_sizes

    def conv_default(shape, fan_in, c_out):
        bound = 1.0 / fan_in ** 0.5
        return uniform(gen, shape, bound), uniform(gen, (c_out,), bound)

    stem_w1, stem_b1 = conv_default((C, F_in, 3, 3), F_in * 9, C)
    stem_w2, stem_b2 = conv_default((C, C, 3, 3), C * 9, C)
    cls_w, cls_b = conv_default((C, P), C, P)
    lin1_w, lin1_b = conv_default((spec.classifier_linear_size, flat), flat,
                                  spec.classifier_linear_size)
    lin2_w, lin2_b = conv_default((spec.num_answers, spec.classifier_linear_size),
                                  spec.classifier_linear_size, spec.num_answers)
    return {
        "stem": {"w1": stem_w1, "b1": stem_b1, "w2": stem_w2, "b2": stem_b2},
        "classifier": {
            "proj_w": cls_w, "proj_b": cls_b,
            "lin1": {"w": lin1_w, "b": lin1_b},
            "lin2": {"w": lin2_w, "b": lin2_b},
        },
        "attention": {
            "conv1": _bank(gen, nb["attention"], 3, C, C),
            "conv2": _bank(gen, nb["attention"], 3, C, C),
            "conv3": _bank(gen, nb["attention"], 1, C, 1),
        },
        "query": {
            "conv1": _bank(gen, nb["query"], 3, C, C),
            "conv2": _bank(gen, nb["query"], 3, C, C),
        },
        "relate": {
            **{f"conv{i}": _bank(gen, nb["relate"], 3, C, C) for i in range(1, 6)},
            "conv6": _bank(gen, nb["relate"], 1, C, 1),
        },
        "same": {"conv": _bank(gen, nb["same"], 1, C + 1, 1)},
        "compare": {
            "projection": _bank(gen, nb["compare"], 1, 2 * C, C, kaiming=False),
            "conv1": _bank(gen, nb["compare"], 3, C, C),
            "conv2": _bank(gen, nb["compare"], 3, C, C),
        },
    }


def cast_params(tree, dtype: Optional[torch.dtype] = None, device=None):
    r"""The same nested dict/list of tensors, moved and/or cast."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_params(v, dtype, device) for v in tree)
    return tree.to(device=device, dtype=dtype)


# ------------------------------------------------------------------ stem / classifier -
def apply_stem(params: Dict[str, torch.Tensor], features: torch.Tensor) -> torch.Tensor:
    r"""Two 3x3 conv + ReLU layers. features: NHWC; returns NHWC."""
    out = torch.relu(gconv.conv3x3(features, params["w1"], params["b1"]))
    return torch.relu(gconv.conv3x3(out, params["w2"], params["b2"]))


_STEM_KEYS = ("w1", "b1", "w2", "b2")


class _DeterministicCudnn:
    r"""``torch.backends.cudnn.deterministic`` set for the block, then restored."""

    def __enter__(self):
        self.before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.before


class _TrainingStem(torch.autograd.Function):
    r""":func:`apply_stem` with its convs' forward and backward under
    ``cudnn.deterministic``: the backward runs the inner graph through
    ``torch.autograd.grad`` inside the flag, which a plain autograd call
    would leave to whatever the flag reads when ``backward()`` runs."""

    @staticmethod
    def forward(ctx, features, *weights):
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in (features, *weights)]
        with torch.enable_grad(), _DeterministicCudnn():
            out = apply_stem(dict(zip(_STEM_KEYS, leaves[1:])), leaves[0])
        ctx.leaves, ctx.out = leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        leaves, ctx.leaves = ctx.leaves, None
        wanted = [t for t in leaves if t.requires_grad]
        with _DeterministicCudnn():
            got = iter(torch.autograd.grad(ctx.out, wanted, grad))
        ctx.out = None
        return tuple(next(got) if t.requires_grad else None for t in leaves)


def training_stem(params: Dict[str, torch.Tensor], features: torch.Tensor) -> torch.Tensor:
    r"""The stem of the training forward (:func:`nmn_forward_fast`): :func:`apply_stem`
    with cuDNN's deterministic algorithms in its forward and backward, so
    that a float32 training step repeats bit for bit (cuDNN's default
    backward of these convs moves by ~1e-8 from run to run). Serving and the
    feature extractor keep cuDNN's default algorithms."""
    inputs = (features, *(params[k] for k in _STEM_KEYS))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _TrainingStem.apply(*inputs)
    with _DeterministicCudnn():
        return apply_stem(params, features)


def apply_classifier(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    out = torch.relu(gconv.conv1x1(x, params["proj_w"], params["proj_b"]))
    out = gconv.max_pool_2x2(out)
    out = out.reshape(out.shape[0], -1)  # NHWC flatten (interop permutes torch weights)
    out = torch.relu(out @ params["lin1"]["w"].T + params["lin1"]["b"])
    return out @ params["lin2"]["w"].T + params["lin2"]["b"]


# ------------------------------------------------------------------ interpreter -------
def execute_programs(
    params: Dict[str, Any], spec: NMNSpec, stem_feats: torch.Tensor, programs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""The plain register machine. Returns (final encodings (B,H,W,C), invalid (B,))."""
    banks = build_banks(params, spec, stem_feats.dtype)
    tables = build_tables(spec, stem_feats.device)
    return execute_programs_plain(banks, tables, spec, stem_feats, programs)


def _outputs_from_logits(
    logits: torch.Tensor,
    invalid: torch.Tensor,
    spec: NMNSpec,
    answers: Optional[torch.Tensor],
) -> Dict[str, Any]:
    r"""Shared output contract (reference ``nmn.py:244-275``): invalid programs
    predict @@UNKNOWN@@ at loss 3.33; valid ones get per-example CE with answers,
    else the negative max answer log-prob."""
    logprobs = torch.log_softmax(logits, dim=-1)
    pred_logprob, predictions = logprobs.max(dim=-1)
    predictions = torch.where(
        invalid, torch.full_like(predictions, spec.unk_answer_index), predictions
    )
    invalid_loss = torch.full_like(pred_logprob, INVALID_LOSS)
    if answers is not None:
        answers = answers.to(device=logits.device, dtype=torch.long)
        ce = -logprobs.gather(1, answers[:, None])[:, 0]
        loss = torch.where(invalid, invalid_loss, ce)
        accuracy = (predictions == answers).float().mean()
    else:
        loss = torch.where(invalid, invalid_loss, -pred_logprob)
        accuracy = torch.zeros((), device=logits.device)
    return {
        "predictions": predictions,
        "loss": loss,
        "answer_logits": logits,
        "invalid": invalid,
        "metrics": {"answer_accuracy": accuracy, "average_invalid": invalid.sum()},
    }


def nmn_forward(
    params: Dict[str, Any],
    spec: NMNSpec,
    features: torch.Tensor,
    programs: torch.Tensor,
    answers: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    r"""Full forward through the plain register machine. features: (B, H, W,
    feature_channels) NHWC; programs: (B, T).

    Returns {"predictions": (B,), "loss": (B,), "answer_logits", "invalid",
    "metrics": {answer_accuracy, average_invalid}}.
    """
    dtype = resolve_compute_dtype(spec.compute_dtype, features.device)
    if dtype != torch.float32:
        params = cast_params(params, dtype)
        features = features.to(dtype)
    stem_feats = apply_stem(params["stem"], features)
    final, invalid = execute_programs(params, spec, stem_feats, programs)
    logits = apply_classifier(params["classifier"], final).float()
    return _outputs_from_logits(logits, invalid, spec, answers)


def nmn_forward_fast(
    params: Dict[str, Any],
    spec: NMNSpec,
    features: torch.Tensor,
    programs: torch.Tensor,
    answers: Optional[torch.Tensor] = None,
    tables: Optional[Dict[str, torch.Tensor]] = None,
    replay: Optional[bool] = None,
) -> Dict[str, Any]:
    r"""The training forward, with the output contract of :func:`nmn_forward`
    (counterpart of the JAX package's ``nmn_forward_fast``): the banks are
    built from the live ``params`` each call, the stem runs ``F.conv2d`` with
    cuDNN's deterministic algorithms (:func:`training_stem`), the
    interpreter is :func:`execute_programs_diff` (K5 forward and K6 backward
    on CUDA, or K2 and K6's replay mode with ``replay`` or
    ``PROBNMN_NMN_REPLAY_BWD=1``; their plain versions on the CPU), then the
    classifier. Fully differentiable in ``params`` and ``features``.
    ``tables`` (from :func:`build_tables` on the features' device) saves
    rebuilding them."""
    dtype = resolve_compute_dtype(spec.compute_dtype, features.device)
    banks = build_banks(params, spec, dtype)
    if tables is None:
        tables = build_tables(spec, features.device)
    stem_feats = training_stem(cast_params(params["stem"], dtype), features.to(dtype))
    final, invalid = execute_programs_diff(banks, tables, spec, stem_feats.contiguous(), programs,
                                           replay=replay)
    logits = apply_classifier(cast_params(params["classifier"], dtype), final).float()
    return _outputs_from_logits(logits, invalid, spec, answers)


def fast_forward_from_tables(
    banks: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    spec: NMNSpec,
    stem_params: Dict[str, Any],
    classifier_params: Dict[str, Any],
    features: torch.Tensor,
    programs: torch.Tensor,
    answers: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    r"""The inference forward over prebuilt ``banks`` and ``tables``, in the
    banks' dtype: the stem, K2 (its plain version on the CPU) and the
    classifier, with the output contract of :func:`nmn_forward`. The
    evaluators rebuild the banks from the live params before each pass."""
    dtype = banks["w3"].dtype
    stem_feats = apply_stem(cast_params(stem_params, dtype), features.to(dtype))
    final, invalid = execute_programs_kernel(banks, tables, spec, stem_feats.contiguous(), programs)
    logits = apply_classifier(cast_params(classifier_params, dtype), final).float()
    return _outputs_from_logits(logits, invalid, spec, answers)


def make_fast_inference_fn(
    params: Dict[str, Any], spec: NMNSpec, device=None, dtype: Optional[torch.dtype] = None
):
    r"""Build the serving forward: banks and dispatch tables are built once on
    ``device`` (default: where ``params`` live) in ``dtype`` (default:
    ``spec.compute_dtype`` resolved for the device), and the returned
    ``forward(features, programs, answers=None)`` runs the stem, the
    interpreter kernel (its plain version on the CPU) and the classifier,
    with the same output contract as :func:`nmn_forward`."""
    device = torch.device(device) if device is not None else params["stem"]["w1"].device
    if dtype is None:
        dtype = resolve_compute_dtype(spec.compute_dtype, device)
    banks = build_banks(cast_params(params, device=device), spec, dtype)
    tables = build_tables(spec, device)
    stem_params = cast_params(params["stem"], dtype, device)
    classifier_params = cast_params(params["classifier"], dtype, device)

    def forward(features, programs, answers=None):
        return fast_forward_from_tables(banks, tables, spec, stem_params, classifier_params,
                                        features.to(device), programs, answers)

    return forward
