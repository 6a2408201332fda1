r"""
Kernel K1: the ProgramGenerator sampling forward on the card
(``probnmn_tpu_torch/csrc/seq2seq_decode.cu``), in L + 1 launches: one
encoder sweep a layer (:func:`sampling_encode`), then the decoder.

Replaces ``probnmn_tpu/ops/pallas/seq2seq_decode.py::_sampling_kernel`` (entry
``fused_sampling_forward``): boundary add, the zeroed-pad source embedding,
the masked 2-layer LSTM encoder over L+1 steps, the decoder initialized from
the top layer's final state, 26 attentive decode steps with Gumbel-max
sampling (pad, unk and start blocked; logprob from the unblocked
log-softmax), the @end@ trim quirk and the length-normalized loss.

What bounds it on an H100: not the 24.5 GFLOP of a batch of 256 (25 µs at
the bf16 tensor peak) but latency, since the 46 + 26 steps depend on each
other. The encoder: each layer is one persistent launch of thread-block
clusters (8 CTAs at H = 256) that own a few rows each for all steps, keep the
layer's weights in shared memory and exchange h through distributed shared
memory (:func:`encoder_plan` gives the plan). The decoder is one persistent
launch of the same kind (16 CTAs a cluster at H = 256, each 16 units' four
gates; :func:`decoder_plan`): each CTA keeps its columns of the decoder's
weights and, where they fit, its rows' encoder outputs and the projection in
shared memory, does the row-wise work (attention, projection, draw) of the
rows it owns, and meets the cluster twice a step (float32 three times), once
for the cell inputs and once for h. In bf16 the gate, score, context and
projection products run on the tensor cores (mma.sync), with the
embedding's part of the gates a (V, 4U) table computed once a launch; in
float32 the sums keep the fixed order of the kernel this one replaced, and
its bits. Matmul operands are rounded to the compute type and summed in
float32, as the TPU kernel did.

The TPU's hardware PRNG becomes Philox4x32-10 with counter (v // 4, step,
row_base + row, 0) and key ``seed``, so draws do not depend on the block
layout, and :func:`philox_gumbel` reproduces them on the host: the plain
version fed that noise samples the same tokens. ``row_base`` (0 by default)
lets a launch over rows [r, r + B) of a larger batch draw those rows of the
larger batch's stream: the serving engine's shards on several cards draw
what one card would. ``noise=`` (T, B, >=V) float32 drives both from
explicit noise instead, for token-for-token comparisons.

A training call (question_coding's and joint_training's z ~ q(z|x), the
JAX package's ``seq2seq_forward(..., train=True)``) passes the encoder's
inter-layer dropout masks, ``dropout_masks`` (L-1, B, L+1, H): after each
layer's sweep below the top, one elementwise launch (``k1_dropout``) drops
its outputs in place before the layer above reads them. The trainer hands
the same masks to K4's REINFORCE pass over the sampled z, since JAX computes
both from one encoder pass.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from probnmn_tpu_torch.models.seq2seq import SAMPLING, Seq2SeqSpec, _encode, seq2seq_forward
from probnmn_tpu_torch.ops.kernels import _build
from probnmn_tpu_torch.ops.rnn import keep_bytes

_PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = np.uint64(0xFFFFFFFF)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def philox_gumbel(seed: int, num_steps: int, batch: int, vocab: int,
                  row_base: int = 0) -> np.ndarray:
    r"""(num_steps, batch, vocab) float32 Gumbel noise: the kernel's Philox
    stream. Word ``v % 4`` of Philox4x32-10 at counter (v // 4, step,
    row_base + row, 0) with key (seed low, seed high) gives ``u = (bits >> 8)
    * 2**-24 + 1e-12`` and ``g = -log(-log(u))``, the TPU kernel's
    uniform-to-Gumbel map."""
    groups = -(-vocab // 4)
    c0 = np.broadcast_to(np.arange(groups, dtype=np.uint64)[None, None, :],
                         (num_steps, batch, groups))
    c1 = np.broadcast_to(np.arange(num_steps, dtype=np.uint64)[:, None, None], c0.shape)
    c2 = np.broadcast_to(np.arange(row_base, row_base + batch, dtype=np.uint64)[None, :, None],
                         c0.shape)
    c3 = np.zeros(c0.shape, np.uint64)
    k0, k1 = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    for _ in range(10):
        p0 = _PHILOX_M[0] * c0
        p1 = _PHILOX_M[1] * c2
        c0, c1, c2, c3 = (
            (p1 >> np.uint64(32)) ^ c1 ^ np.uint64(k0), p1 & _MASK32,
            (p0 >> np.uint64(32)) ^ c3 ^ np.uint64(k1), p0 & _MASK32,
        )
        k0 = (k0 + _PHILOX_W[0]) & 0xFFFFFFFF
        k1 = (k1 + _PHILOX_W[1]) & 0xFFFFFFFF
    bits = np.stack([c0, c1, c2, c3], axis=-1).reshape(num_steps, batch, 4 * groups)
    u = (bits[:, :, :vocab] >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)
    u = u + np.float32(1e-12)
    return (-np.log(-np.log(u))).astype(np.float32)


def sampling_forward_with_noise(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    source_tokens: torch.Tensor,
    noise: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    dropout_masks: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    r"""Plain PyTorch version of K1: Gumbel-max sampling on explicit noise
    (T, B, >=V), with the kernel's arithmetic (operands rounded to
    ``compute_dtype``, float32 sums). Counterpart of the JAX package's
    ``sampling_forward_with_noise_xla``."""
    out = seq2seq_forward(
        params, spec, source_tokens, SAMPLING, noise=noise, compute_dtype=compute_dtype,
        dropout_masks=dropout_masks,
    )
    return {k: out[k] for k in ("predictions", "loss", "logprobs")}


def pack_weights(
    params: Dict[str, Any], spec: Seq2SeqSpec, compute_dtype: torch.dtype,
    device: torch.device,
) -> Dict[str, torch.Tensor]:
    r"""The kernel's weight layout: matrices transposed to (in, 4H) / (H, V) so
    threads read neighbouring gate columns, in ``compute_dtype``; the encoder's
    layers flattened into one buffer; biases summed in float32."""
    def mat(w):
        return w.to(device=device, dtype=torch.float32).T.contiguous().to(compute_dtype)

    def f32(v):
        return v.to(device=device, dtype=torch.float32).contiguous()

    enc = params["encoder"]
    cell = params["decoder_cell"]
    proj = params["output_projection"]
    return {
        "src_emb": params["source_embedding"].to(device=device, dtype=compute_dtype).contiguous(),
        "tgt_emb": params["target_embedding"].to(device=device, dtype=compute_dtype).contiguous(),
        "enc_wih": torch.cat([mat(p["w_ih"]).reshape(-1) for p in enc]),
        "enc_whh": torch.stack([mat(p["w_hh"]) for p in enc]),
        "enc_bias": torch.stack([f32(p["b_ih"] + p["b_hh"]) for p in enc]),
        "dec_wih": mat(cell["w_ih"]),
        "dec_whh": mat(cell["w_hh"]),
        "dec_bias": f32(cell["b_ih"] + cell["b_hh"]),
        "proj_w": mat(proj["w"]),
        "proj_b": f32(proj["b"]),
    }


_PLAN_KEYS = ("cluster", "units", "rows", "threads", "clusters", "fit", "smem", "w_hh_resident",
              "w_ih_resident", "groups", "rows_per_thread", "registers")


def encoder_plan(batch: int, input_size: int, hidden: int,
                 compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    r"""The launch plan of an encoder layer's sweep with ``input_size``
    inputs (the first layer: the embedding width; above it: ``hidden``):
    cluster size, units a CTA, rows a cluster, threads a CTA, clusters, the
    clusters the card runs at once, shared memory bytes a CTA, whether W_hh
    and W_ih stay in shared memory (1) or are read from L2 (0), row groups,
    rows a thread and registers a thread. Needs the card."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    code = _build.library().probnmn_k1_encoder_plan(
        _DTYPE_CODES[compute_dtype], batch, input_size, hidden, out)
    _build.check(code, "K1 encoder sweep plan")
    return dict(zip(_PLAN_KEYS, out))


_DECODER_PLAN_KEYS = ("cluster", "units", "rows", "threads", "clusters", "fit", "smem",
                      "w_hh_resident", "w_ih_resident", "encoder_resident", "projection_resident",
                      "rows_per_cta", "fit_full_smem", "tiles", "registers")
# The decoder's constants in csrc/seq2seq_decode.cu and csrc/cluster_sweep.cuh.
DECODER_THREADS = 256
DECODER_MAX_ROWS = 48
DECODER_MAX_OWN = 4
RING_STAGES = 6
RING_ROWS = 16
MAX_SMEM = 232448


def decoder_plan(batch: int, raw_len: int, input_size: int, hidden: int, vocab: int,
                 compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    r"""The launch plan of the decoder (``seq2seq_sample_kernel``) for
    ``batch`` rows of ``raw_len`` source tokens: cluster size, units a CTA,
    rows a cluster, threads a CTA, clusters, the clusters the card runs at
    once, shared memory bytes a CTA, which of W_hh, W_ih (bf16: its context
    rows), the owned rows' encoder outputs and the projection stay in shared
    memory (1) or are read from L2 (0), rows a CTA owns, the clusters the
    card runs at once at the full shared memory, tiles (bf16: 16-row m-tiles;
    float32: rows a thread) and registers a thread. Needs the card;
    :func:`decoder_plan_twin` computes the rest from the card's two fits."""
    out = (ctypes.c_int * len(_DECODER_PLAN_KEYS))()
    code = _build.library().probnmn_k1_decoder_plan(
        _DTYPE_CODES[compute_dtype], batch, raw_len, input_size, hidden, vocab, out)
    _build.check(code, "K1 decoder plan")
    return dict(zip(_DECODER_PLAN_KEYS, out))


def decoder_units(hidden: int) -> int:
    r"""Hidden units a CTA of the decoder owns: 16 up to H = 256, else 32."""
    return 16 if hidden <= 256 else 32


def decoder_columns(hidden: int, rank: int) -> np.ndarray:
    r"""The gate columns (of the (in, 4H) packs) that CTA ``rank`` of a bf16
    decoder cluster keeps, in the order its products read them
    (``dec_column`` in the source): its column 8 p + 2 q + e is gate q of
    unit rank * U + 2 p + e, so an 8-column tile of the product holds one
    unit pair's four gates. float32 keeps the encoder sweep's order."""
    U = decoder_units(hidden)
    c = np.arange(4 * U)
    return (c >> 1 & 3) * hidden + rank * U + 2 * (c >> 3) + (c & 1)


def decoder_row_cap(hidden: int, compute_dtype: torch.dtype) -> int:
    r"""Rows a decoder cluster owns at most (``decoder_cap`` in the source):
    three 16-row m-tiles in bf16, three rows a thread in float32, and four
    rows a CTA."""
    U = decoder_units(hidden)
    cap = DECODER_MAX_ROWS if compute_dtype == torch.bfloat16 else 3 * (DECODER_THREADS // U)
    return min(cap, DECODER_MAX_OWN * (hidden // U))


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def decoder_smem(compute_dtype: torch.dtype, rows: int, raw_len: int, input_size: int,
                 hidden: int, vocab: int, w_hh: bool, w_ih: bool, encoder: bool,
                 projection: bool) -> Dict[str, int]:
    r"""A decoder CTA's shared memory, the byte offset of each part and the
    total (``dec_smem`` in the source): the resident W_hh and W_ih (bf16: the
    H context rows, with rows of 4U + 8 elements; float32: all H + D), the
    bf16 token table (V, 4U) float32, the cell inputs and h of the cluster's
    rows, the owned rows' encoder outputs (bf16: rows of H + 8 and S rounded
    up to 16), the projection (bf16: rows of round8(V) + 8), the float32 ring
    that a matrix not resident streams through (6 stages of 16 rows), and
    the owned rows' scores, logits, Gumbel noise, state, the rows' tokens and
    the owned rows' lengths."""
    bf = compute_dtype == torch.bfloat16
    sz = 2 if bf else 4
    D, H, V, S, R = input_size, hidden, vocab, raw_len + 1, rows
    U = decoder_units(H)
    own = -(-R // (H // U))
    ws = 4 * U + 8 if bf else 4 * U
    xs = H + 8 if bf else ((H + D + 3) // 4 * 4 + 4)
    hs = H + 8 if bf else H + 4
    sizes = [
        ("w_hh", sz * H * ws if w_hh else 0),
        ("w_ih", sz * (H if bf else H + D) * ws if w_ih else 0),
        ("table", 16 * V * U if bf else 0),
        ("xb", sz * R * xs),
        ("hb", sz * R * hs),
        ("encoder", sz * own * ((S + 15) // 16 * 16 if bf else S) * (H + 8 if bf else H)
         if encoder else 0),
        ("projection", sz * H * ((V + 7) // 8 * 8 + 8 if bf else V) if projection else 0),
        ("ring", 4 * RING_STAGES * RING_ROWS * 4 * U if not bf and not (w_hh and w_ih) else 0),
        ("att", 4 * own * S),
        ("logit", 4 * own * V),
        ("gumbel", 4 * own * V),
        ("rowf", 16 * own),
        ("toks", 4 * R),
        ("lens", 4 * own),
    ]
    out, at = {}, 0
    for name, size in sizes:
        out[name] = at
        at += _align16(size)
    out["total"] = at
    return out


def decoder_plan_twin(batch: int, raw_len: int, input_size: int, hidden: int, vocab: int,
                      compute_dtype: torch.dtype, fit_full_smem: int, fit: int) -> Dict[str, int]:
    r"""What :func:`decoder_plan` computes without the card, given the card's
    two fits: ``fit_full_smem``, the clusters it runs at once at the full
    shared memory, which sets the rows that decide what stays resident (W_hh,
    then W_ih, then the owned rows' encoder outputs, then the projection,
    each only if it still fits beside the others), and ``fit``, the clusters
    it runs at once at the plan's widest shared memory, which sets the rows
    a cluster (the fewest that run every cluster at once, up to what shared
    memory allows)."""
    U = decoder_units(hidden)
    n = hidden // U
    bf = compute_dtype == torch.bfloat16
    cap = decoder_row_cap(hidden, compute_dtype)
    rt = min(cap, -(-batch // fit_full_smem))

    def total(R, *flags):
        return decoder_smem(compute_dtype, R, raw_len, input_size, hidden, vocab, *flags)["total"]

    wh = total(rt, True, False, False, False) <= MAX_SMEM
    wx = total(rt, wh, True, False, False) <= MAX_SMEM
    enc = total(rt, wh, wx, True, False) <= MAX_SMEM
    proj = total(rt, wh, wx, enc, True) <= MAX_SMEM
    r_max = cap
    while r_max > 0 and total(r_max, wh, wx, enc, proj) > MAX_SMEM:
        r_max -= 1
    if r_max == 0:
        raise ValueError("no row of the decoder fits in shared memory")
    rows = min(-(-batch // fit), r_max)
    return {
        "cluster": n, "units": U, "rows": rows, "threads": DECODER_THREADS,
        "clusters": -(-batch // rows), "fit": fit,
        "smem": total(rows, wh, wx, enc, proj),
        "w_hh_resident": int(wh), "w_ih_resident": int(wx), "encoder_resident": int(enc),
        "projection_resident": int(proj), "rows_per_cta": -(-rows // n),
        "fit_full_smem": fit_full_smem,
        "tiles": -(-rows // 16) if bf else -(-rows // (DECODER_THREADS // U)),
        "r_max": r_max,
    }


def _check_kernel_shapes(spec: Seq2SeqSpec, compute_dtype: torch.dtype) -> None:
    if compute_dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported compute dtype {compute_dtype}")
    hidden = spec.hidden_size
    if hidden % 32 or not 128 <= hidden <= 512:
        raise ValueError(f"the kernel needs 128 <= hidden_size <= 512, a multiple of 32; got {hidden}")


def _packed(params, spec, compute_dtype, device, packed):
    if packed is None:
        packed = pack_weights(params, spec, compute_dtype, device)
    if packed["dec_wih"].dtype != compute_dtype:
        raise ValueError("packed weights are in another compute dtype")
    return packed


def sampling_encode(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    source_tokens: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    packed: Optional[Dict[str, torch.Tensor]] = None,
    dropout_masks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""K1's encoder: ``(outputs (B, L+1, H) in compute_dtype, the top
    layer's final hidden state (B, H) float32, not rounded)``, the decoder's
    attention memory and initial state.

    A CPU ``source_tokens`` runs the plain version, ``models/seq2seq.py``'s
    ``_encode``; a CUDA one launches one encoder sweep a layer, with one
    dropout pass before each layer above the first when ``dropout_masks``
    (L-1, B, L+1, H) are given (and raises if it cannot plan or launch one).
    """
    device = source_tokens.device
    if device.type == "cpu":
        outputs, _, hidden, _ = _encode(params, spec, source_tokens, compute_dtype,
                                        dropout_masks)
        return outputs.to(compute_dtype), hidden
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check_kernel_shapes(spec, compute_dtype)
    p = _packed(params, spec, compute_dtype, device, packed)
    batch, raw_len = source_tokens.shape
    hidden = spec.hidden_size
    keep = keep_bytes(dropout_masks, spec.num_layers, batch, raw_len + 1, hidden, device)
    if keep is not None and keep.shape[2] != raw_len + 1:
        raise ValueError(f"K1 takes dropout masks of exactly {raw_len + 1} steps, got "
                         f"{tuple(keep.shape)}")
    src = source_tokens.to(torch.int32).contiguous()
    outputs = torch.empty(batch, raw_len + 1, hidden, dtype=compute_dtype, device=device)
    below = torch.empty_like(outputs) if spec.num_layers > 1 else None
    final = torch.empty(batch, hidden, dtype=torch.float32, device=device)
    code = _build.library().probnmn_k1_encode(
        _DTYPE_CODES[compute_dtype], src.data_ptr(), batch, raw_len,
        p["src_emb"].data_ptr(), p["enc_wih"].data_ptr(), p["enc_whh"].data_ptr(),
        p["enc_bias"].data_ptr(), outputs.data_ptr(),
        below.data_ptr() if below is not None else None, final.data_ptr(),
        keep.data_ptr() if keep is not None else None, 1.0 / (1.0 - spec.dropout),
        spec.input_size, hidden, spec.num_layers, spec.pad_index, spec.end_index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "K1 encoder sweep")
    sampling_encode.launches += 1
    return outputs, final


sampling_encode.launches = 0


def fused_sampling_forward(
    params: Dict[str, Any],
    spec: Seq2SeqSpec,
    source_tokens: torch.Tensor,
    *,
    seed: Optional[int] = None,
    row_base: int = 0,
    noise: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    packed: Optional[Dict[str, torch.Tensor]] = None,
    dropout_masks: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    r"""The sampling forward: ``{"predictions": (B, T) int64 trimmed,
    "loss": (B,), "logprobs": (B, T)}``. The serving engine calls it
    directly: it is also the counterpart of the JAX package's
    ``models/seq2seq.py::sampling_forward_serving``.

    Noise comes from ``noise`` (T, B, >=V) float32 when given, else from
    rows ``row_base`` .. ``row_base + B`` of the Philox stream of ``seed``.
    ``dropout_masks`` (L-1, B, L+1, H): the encoder's inter-layer dropout
    of a training call. A CPU
    ``source_tokens`` runs the plain version; a CUDA one runs
    :func:`sampling_encode`'s sweeps, then the decoder kernel (and raises if
    it cannot).
    """
    if noise is None and seed is None:
        raise ValueError("pass a Philox seed or explicit noise")
    batch, raw_len = source_tokens.shape
    num_steps = spec.max_decoding_steps
    vocab = spec.target_vocab_size
    device = source_tokens.device
    if device.type == "cpu":
        if noise is None:
            noise = torch.from_numpy(philox_gumbel(seed, num_steps, batch, vocab, row_base))
        return sampling_forward_with_noise(params, spec, source_tokens, noise, compute_dtype,
                                           dropout_masks)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check_kernel_shapes(spec, compute_dtype)
    p = _packed(params, spec, compute_dtype, device, packed)
    if noise is not None:
        if noise.shape[:2] != (num_steps, batch) or noise.shape[2] < vocab:
            raise ValueError(f"noise must be ({num_steps}, {batch}, >={vocab}), got {tuple(noise.shape)}")
        noise = noise.to(device=device, dtype=torch.float32).contiguous()

    outputs, final = sampling_encode(params, spec, source_tokens, compute_dtype=compute_dtype,
                                     packed=p, dropout_masks=dropout_masks)
    src = source_tokens.to(torch.int32).contiguous()
    preds = torch.empty(batch, num_steps, dtype=torch.int32, device=device)
    loss = torch.empty(batch, dtype=torch.float32, device=device)
    logprobs = torch.empty(batch, num_steps, dtype=torch.float32, device=device)
    code = _build.library().probnmn_k1_decode(
        _DTYPE_CODES[compute_dtype],
        src.data_ptr(), batch, raw_len,
        noise.data_ptr() if noise is not None else None,
        noise.shape[2] if noise is not None else 0,
        (seed or 0) & 0xFFFFFFFFFFFFFFFF, row_base,
        p["tgt_emb"].data_ptr(),
        p["dec_wih"].data_ptr(), p["dec_whh"].data_ptr(), p["dec_bias"].data_ptr(),
        p["proj_w"].data_ptr(), p["proj_b"].data_ptr(),
        outputs.data_ptr(), final.data_ptr(),
        preds.data_ptr(), loss.data_ptr(), logprobs.data_ptr(),
        spec.input_size, spec.hidden_size, vocab, num_steps,
        spec.pad_index, spec.unk_index, spec.start_index, spec.end_index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "seq2seq sampling kernel")
    fused_sampling_forward.launches += 1
    return {"predictions": preds.long(), "loss": loss, "logprobs": logprobs}


fused_sampling_forward.launches = 0
