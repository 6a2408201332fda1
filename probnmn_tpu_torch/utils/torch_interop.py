r"""
The reference's ``.pth`` checkpoints (kdexd/probnmn-clevr v1.0): its
``state_dict`` key maps, weight for weight (the port's copy of
``probnmn_tpu/utils/torch_interop.py``).

Each function takes one model's flat ``state_dict`` (dotted keys, tensors)
and returns numpy arrays in the JAX package's layout; ``interop.py``'s
``*_from_jax`` turn those into the port's params, so the port keeps one
layout change (the stem's HWIO -> OIHW) in one place.

- ProgramPrior (reference ``program_prior.py:50-62``):
  ``_embedder.token_embedder_programs.weight`` -> embedding (the tied
  ``_output_layer`` needs no copy), ``_encoder._module.{weight,bias}_{ih,hh}_l{k}``
  -> encoder layers, ``_projection_layer.weight`` -> projection.
- Seq2SeqBase (allennlp ``SimpleSeq2Seq``), for the ProgramGenerator and the
  QuestionReconstructor: source embedder, encoder LSTM,
  ``_target_embedder.weight``, ``_decoder_cell.*``, ``_output_projection_layer.*``.
- NeuralModuleNetwork (reference ``nmn.py:67-115``): the stem and classifier
  ``Sequential``s, and one module per program token (``filter_color[red].conv1.weight``)
  gathered into the stacked banks in ``make_spec``'s token -> slot order.
  Convs OIHW -> HWIO, 1x1 convs -> (C_in, C_out) matrices, and the
  classifier's first Linear permuted from torch's NCHW flatten to the NHWC
  flatten.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from probnmn_tpu_torch.data.vocabulary import Vocabulary
from probnmn_tpu_torch.models.nmn import ATTENTION, COMPARE, QUERY, RELATE, SAME, NMNSpec


def _np(state: Mapping[str, Any], key: str) -> np.ndarray:
    value = state[key]
    if hasattr(value, "numpy"):
        value = value.detach().cpu().float().numpy()
    return np.asarray(value, np.float32)


def _lstm_layers(state: Mapping[str, Any], prefix: str, num_layers: int):
    return [
        {
            "w_ih": _np(state, f"{prefix}.weight_ih_l{k}"),
            "w_hh": _np(state, f"{prefix}.weight_hh_l{k}"),
            "b_ih": _np(state, f"{prefix}.bias_ih_l{k}"),
            "b_hh": _np(state, f"{prefix}.bias_hh_l{k}"),
        }
        for k in range(num_layers)
    ]


def _conv_hwio(state, key):
    return _np(state, key).transpose(2, 3, 1, 0).copy()  # OIHW -> HWIO


def _conv_1x1(state, key):
    return _np(state, key)[:, :, 0, 0].T.copy()  # (O, I, 1, 1) -> (I, O)


def program_prior_from_state_dict(state: Mapping[str, Any], spec) -> Dict[str, Any]:
    return {
        "embedding": _np(state, "_embedder.token_embedder_programs.weight"),
        "encoder": _lstm_layers(state, "_encoder._module", spec.num_layers),
        "projection": _np(state, "_projection_layer.weight"),
    }


def seq2seq_from_state_dict(state: Mapping[str, Any], spec) -> Dict[str, Any]:
    return {
        "source_embedding": _np(state, "_source_embedder.token_embedder_tokens.weight"),
        "encoder": _lstm_layers(state, "_encoder._module", spec.num_layers),
        "target_embedding": _np(state, "_target_embedder.weight"),
        "decoder_cell": {
            "w_ih": _np(state, "_decoder_cell.weight_ih"),
            "w_hh": _np(state, "_decoder_cell.weight_hh"),
            "b_ih": _np(state, "_decoder_cell.bias_ih"),
            "b_hh": _np(state, "_decoder_cell.bias_hh"),
        },
        "output_projection": {
            "w": _np(state, "_output_projection_layer.weight"),
            "b": _np(state, "_output_projection_layer.bias"),
        },
    }


# The module classes and, for each, its convs: (name, 3x3 or 1x1, c_in, c_out)
# with C the module channels.
def _module_convs(C: int) -> Dict[int, tuple]:
    return {
        ATTENTION: ("attention", (("conv1", 3, C, C), ("conv2", 3, C, C), ("conv3", 1, C, 1))),
        QUERY: ("query", (("conv1", 3, C, C), ("conv2", 3, C, C))),
        RELATE: ("relate", tuple((f"conv{i}", 3, C, C) for i in range(1, 6))
                 + (("conv6", 1, C, 1),)),
        SAME: ("same", (("conv", 1, C + 1, 1),)),
        COMPARE: ("compare", (("projection", 1, 2 * C, C), ("conv1", 3, C, C),
                              ("conv2", 3, C, C))),
    }


def nmn_from_state_dict(state: Mapping[str, Any], spec: NMNSpec,
                        vocabulary: Vocabulary) -> Dict[str, Any]:
    C = spec.module_channels
    H2, W2 = spec.height // 2, spec.width // 2
    P = spec.class_projection_channels

    # Classifier's first Linear: torch flattens NCHW (channel-major), the JAX
    # package NHWC.
    lin1_w = _np(state, "classifier.4.weight")
    lin1_w = lin1_w.reshape(-1, P, H2, W2).transpose(0, 2, 3, 1).reshape(lin1_w.shape[0], -1)

    params: Dict[str, Any] = {
        "stem": {
            "w1": _conv_hwio(state, "stem.0.weight"),
            "b1": _np(state, "stem.0.bias"),
            "w2": _conv_hwio(state, "stem.2.weight"),
            "b2": _np(state, "stem.2.bias"),
        },
        "classifier": {
            "proj_w": _conv_1x1(state, "classifier.0.weight"),
            "proj_b": _np(state, "classifier.0.bias"),
            "lin1": {"w": np.ascontiguousarray(lin1_w), "b": _np(state, "classifier.4.bias")},
            "lin2": {"w": _np(state, "classifier.6.weight"), "b": _np(state, "classifier.6.bias")},
        },
    }

    # Per-token modules gathered into stacked banks; slots no token takes stay
    # zero, so the banks keep init_nmn_params' shapes.
    convs = _module_convs(C)
    for class_name, class_convs in convs.values():
        n = spec.bank_sizes[class_name]
        params[class_name] = {
            name: {"w": np.zeros((n, k, k, c_in, c_out) if k == 3 else (n, c_in, c_out),
                                 np.float32),
                   "b": np.zeros((n, c_out), np.float32)}
            for name, k, c_in, c_out in class_convs
        }
    index_to_token = vocabulary.get_index_to_token_vocabulary("programs")
    for index in range(len(index_to_token)):
        kind = int(spec.token_kind[index])
        if kind not in convs:
            continue
        token, slot = index_to_token[index], int(spec.token_bank[index])
        class_name, class_convs = convs[kind]
        for name, k, _, _ in class_convs:
            bank = params[class_name][name]
            convert = _conv_hwio if k == 3 else _conv_1x1
            bank["w"][slot] = convert(state, f"{token}.{name}.weight")
            bank["b"][slot] = _np(state, f"{token}.{name}.bias")
    return params


def model_from_state_dict(name: str, state: Mapping[str, Any], spec,
                          vocabulary: Vocabulary) -> Dict[str, Any]:
    r"""One model of a reference checkpoint in the JAX package's layout."""
    if name == "nmn":
        return nmn_from_state_dict(state, spec, vocabulary)
    if name == "program_prior":
        return program_prior_from_state_dict(state, spec)
    if name in ("program_generator", "question_reconstructor"):
        return seq2seq_from_state_dict(state, spec)
    raise ValueError(f"no reference key map for a model named {name!r}")


def is_reference_state(entry: Any) -> bool:
    r"""Whether a checkpoint entry is a reference ``state_dict``: a flat map of
    dotted names to tensors. The port's own entries are nested trees whose
    keys hold no dot."""
    return (isinstance(entry, Mapping) and len(entry) > 0
            and all(isinstance(k, str) and "." in k and hasattr(v, "shape")
                    for k, v in entry.items()))
