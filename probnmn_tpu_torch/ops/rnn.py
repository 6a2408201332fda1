r"""
Multi-layer LSTM primitives with PyTorch ``nn.LSTM`` semantics, as plain
functions on tensors (counterpart of ``probnmn_tpu/ops/rnn.py``):

- gate order (i, f, g, o), two bias vectors (``b_ih`` + ``b_hh``), uniform
  :math:`\pm 1/\sqrt{H}` init — torch's parameterization, so reference
  checkpoints port weight for weight;
- masked sequences behave like packed sequences: outputs at padded positions
  are zero and the state of each sequence freezes at its last valid step.

``compute_dtype`` rounds the matmul operands (inputs, hidden state, weights)
to that type while the state and the sums stay float32 — the arithmetic of
the sampling kernel in ``ops/kernels/seq2seq_decode.py``.

Inter-layer dropout (torch ``nn.LSTM(dropout=p)``, the JAX package's
``lstm_encode(dropout=p, dropout_rng=...)``) takes explicit keep masks,
``dropout_masks`` (L-1, B, T, H) bool, one per layer below the top: layer
``l``'s output ``y`` becomes ``(y * keep[l]) * (1 / (1 - p))`` before layer
``l + 1`` reads it. The JAX package draws them with ``jax.random.bernoulli``
from the training call's key; the trainers here draw them with
:func:`draw_dropout_masks` from a ``torch.Generator`` on their device, and the
kernels take the same masks, so a test can hand JAX's masks to both. Only
training forwards draw masks; evaluation, sampling for serving and frozen
models take none.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from probnmn_tpu_torch.ops.common import as_operand, uniform


def init_lstm_params(
    gen: torch.Generator, input_size: int, hidden_size: int, num_layers: int
) -> List[Dict[str, torch.Tensor]]:
    r"""Torch-style per-layer params: w_ih (4H, D), w_hh (4H, H), b_ih, b_hh (4H,)."""
    scale = 1.0 / (hidden_size ** 0.5)
    layers = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden_size
        layers.append(
            {
                "w_ih": uniform(gen, (4 * hidden_size, in_size), scale),
                "w_hh": uniform(gen, (4 * hidden_size, hidden_size), scale),
                "b_ih": uniform(gen, (4 * hidden_size,), scale),
                "b_hh": uniform(gen, (4 * hidden_size,), scale),
            }
        )
    return layers


def draw_dropout_masks(
    gen: Optional[torch.Generator], dropout: float, num_layers: int, batch: int, steps: int,
    hidden: int, device=None,
) -> Optional[torch.Tensor]:
    r"""Keep masks (L-1, B, T, H) bool, each element kept with probability
    ``1 - dropout``, drawn from ``gen`` (a generator on ``device``); None
    where nothing is dropped (``dropout`` 0, one layer or no rows), so that
    a run without dropout draws nothing and launches nothing more."""
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must lie in [0, 1), got {dropout}")
    if dropout == 0.0 or num_layers < 2 or batch == 0:
        return None
    shape = (num_layers - 1, batch, steps, hidden)
    return torch.rand(shape, generator=gen, device=device) < (1.0 - dropout)


def check_dropout_masks(masks: Optional[torch.Tensor], num_layers: int, batch: int,
                        steps: int, hidden: int) -> None:
    r"""Raise unless ``masks`` is None or (L-1, B, >= steps, H)."""
    if masks is None:
        return
    if (masks.dim() != 4 or tuple(masks.shape[:2]) != (num_layers - 1, batch)
            or masks.shape[2] < steps or masks.shape[3] != hidden):
        raise ValueError(f"dropout masks must be ({num_layers - 1}, {batch}, >={steps}, "
                         f"{hidden}), got {tuple(masks.shape)}")


def keep_bytes(masks: Optional[torch.Tensor], num_layers: int, batch: int, steps: int,
               hidden: int, device: torch.device) -> Optional[torch.Tensor]:
    r"""``masks`` as the kernels read them: (L-1, B, >= steps, H) contiguous
    bytes on ``device``, 1 to keep and 0 to drop (a bool tensor's own
    bytes); None for None. Raises on another shape or device."""
    if masks is None:
        return None
    check_dropout_masks(masks, num_layers, batch, steps, hidden)
    if masks.device != device or masks.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"dropout masks must be bool or uint8 on {device}, got {masks.dtype} "
                         f"on {masks.device}")
    return masks.contiguous().view(torch.uint8)


def init_lstm_cell_params(
    gen: torch.Generator, input_size: int, hidden_size: int
) -> Dict[str, torch.Tensor]:
    return init_lstm_params(gen, input_size, hidden_size, 1)[0]


def _gates(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    h: torch.Tensor,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    r"""x @ W_ih^T + h @ W_hh^T + (b_ih + b_hh) with operands rounded to
    ``compute_dtype``."""
    w_ih = as_operand(params["w_ih"], compute_dtype)
    w_hh = as_operand(params["w_hh"], compute_dtype)
    return (
        as_operand(x, compute_dtype) @ w_ih.T
        + as_operand(h, compute_dtype) @ w_hh.T
        + (params["b_ih"] + params["b_hh"])
    )


def _update(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    state: Tuple[torch.Tensor, torch.Tensor],
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""One torch-``LSTMCell`` step. x: (B, D); state: ((B, H), (B, H))."""
    h, c = state
    return _update(_gates(params, x, h, compute_dtype), c)


def lstm_encode(
    params: List[Dict[str, torch.Tensor]],
    x: torch.Tensor,
    mask: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    dropout_masks: Optional[torch.Tensor] = None,
    dropout: float = 0.0,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    r"""Multi-layer masked LSTM. x: (B, T, D); mask: (B, T) bool.

    Returns (top-layer outputs (B, T, H), per-layer final (h, c)). The state
    freezes at masked steps, so each final state is the state at the last
    *valid* step, and padded outputs are zero.

    ``dropout_masks`` (L-1, B, >= T, H) with the rate ``dropout``: layer l <
    L-1 emits ``(y * keep) * scale`` to the layer above, y first rounded to
    ``compute_dtype`` (the type the sampling kernel stores it in; float32
    leaves it as it is).
    """
    batch, seq_len, _ = x.shape
    hidden = params[0]["w_hh"].shape[1]
    check_dropout_masks(dropout_masks, len(params), batch, seq_len, hidden)
    scale = 1.0 / (1.0 - dropout)
    states = [
        (x.new_zeros(batch, hidden), x.new_zeros(batch, hidden)) for _ in params
    ]
    outputs = []
    for t in range(seq_len):
        m = mask[:, t].to(x.dtype)[:, None]
        out = x[:, t]
        for layer, layer_params in enumerate(params):
            h, c = states[layer]
            h_new, c_new = lstm_cell(layer_params, out, (h, c), compute_dtype)
            states[layer] = (m * h_new + (1.0 - m) * h, m * c_new + (1.0 - m) * c)
            out = h_new * m
            if dropout_masks is not None and layer + 1 < len(params):
                keep = dropout_masks[layer, :, t].to(out.dtype)
                out = (as_operand(out, compute_dtype) * keep) * scale
        outputs.append(out)
    return torch.stack(outputs, dim=1), states


def lstm_step_stacked(
    params: List[Dict[str, torch.Tensor]],
    x: torch.Tensor,
    hs: torch.Tensor,
    cs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""One time step through all layers (free-running decode, e.g. prior
    sampling). x: (B, D); hs, cs: (L, B, H). Returns (top output (B, H), new
    hs, new cs)."""
    new_hs, new_cs = [], []
    out = x
    for layer, layer_params in enumerate(params):
        h, c = lstm_cell(layer_params, out, (hs[layer], cs[layer]))
        new_hs.append(h)
        new_cs.append(c)
        out = h
    return out, torch.stack(new_hs), torch.stack(new_cs)
