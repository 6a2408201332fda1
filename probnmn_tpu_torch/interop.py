r"""
Carry weights across from the JAX package and its checkpoints: its parameter
pytrees, as numpy arrays, become the port's parameter dicts of tensors
(``*_from_jax``) and back (``*_to_jax``); a checkpoint's models, in any of
the three formats ``utils/checkpointing.py`` reads, become the port's params
(:func:`models_from_payload`); the JAX package's optax Adam state becomes
``torch.optim.Adam``'s (:func:`adam_state_from_optax`) and back
(:func:`adam_state_to_optax`), a bfloat16 first moment included.

This is the one place where layouts change. The port keeps the JAX package's
layout everywhere (torch-style (out, in) matrices, per-slot HWIO module
banks, the classifier's NHWC flatten) except the NMN stem's two 3x3 convs,
which run ``F.conv2d`` and so take OIHW weights: HWIO -> OIHW here. The
reference's ``.pth`` goes through the JAX layout first
(``utils/torch_interop.py``), so it meets the same change. The ResNet
extractor's convs (:func:`resnet_params_from_jax`) change likewise.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from probnmn_tpu_torch.utils import torch_interop
from probnmn_tpu_torch.utils.checkpointing import MSGPACK


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, torch.float32, copy=True)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy().copy()


def program_generator_from_jax(params_np: Any, device="cpu") -> dict:
    r"""ProgramGenerator params: same layout, as float32 tensors on ``device``."""
    return _tree_to_torch(params_np, device)


def question_reconstructor_from_jax(params_np: Any, device="cpu") -> dict:
    r"""QuestionReconstructor params: the ProgramGenerator's seq2seq layout,
    as float32 tensors on ``device``."""
    return _tree_to_torch(params_np, device)


def program_prior_from_jax(params_np: Any, device="cpu") -> dict:
    r"""ProgramPrior params (``embedding`` (V, D), ``encoder`` as a list of
    ``{w_ih, w_hh, b_ih, b_hh}``, ``projection`` (D, H)): same layout, as
    float32 tensors on ``device``."""
    return _tree_to_torch(params_np, device)


_BANK_OF_CLASS = {
    "attention": "conv1", "query": "conv1", "relate": "conv1", "same": "conv",
    "compare": "conv1",
}


def nmn_from_jax(params_np: Any, spec, device="cpu") -> dict:
    r"""NMN params: same layout except the stem convs, HWIO -> OIHW. Both
    packages assign tokens to bank slots in the same ``make_spec`` order; the
    bank sizes are checked against ``spec``."""
    params = _tree_to_torch(params_np, device)
    for cls, conv in _BANK_OF_CLASS.items():
        slots = params[cls][conv]["w"].shape[0]
        if slots != spec.bank_sizes[cls]:
            raise ValueError(f"{cls} bank has {slots} slots, spec wants {spec.bank_sizes[cls]}")
    stem = params["stem"]
    for name in ("w1", "w2"):
        stem[name] = stem[name].permute(3, 2, 0, 1).contiguous()
    return params


def resnet_params_from_jax(params_np: Any, device="cpu") -> dict:
    r"""The JAX extractor's params (``probnmn_tpu/models/resnet.py``) as the
    port's ``models/resnet.py`` params: every conv HWIO -> OIHW, the folded
    batch norm's scale and shift as they are."""
    params = _tree_to_torch(params_np, device)
    convs = [params["conv1"]] + [block[name] for stage in params["layers"] for block in stage
                                 for name in ("conv1", "conv2", "conv3", "downsample")
                                 if name in block]
    for conv in convs:
        conv["w"] = conv["w"].permute(3, 2, 0, 1).contiguous()
    return params


def program_generator_to_jax(params: Any) -> dict:
    r"""The ProgramGenerator's params as numpy float32 arrays, the JAX layout."""
    return _tree_to_numpy(params)


def question_reconstructor_to_jax(params: Any) -> dict:
    return _tree_to_numpy(params)


def program_prior_to_jax(params: Any) -> dict:
    return _tree_to_numpy(params)


def nmn_to_jax(params: Any) -> dict:
    r"""The NMN's params in the JAX layout: the stem convs OIHW -> HWIO."""
    out = _tree_to_numpy(params)
    for name in ("w1", "w2"):
        out["stem"][name] = out["stem"][name].transpose(2, 3, 1, 0).copy()
    return out


_FROM_JAX = {
    "program_prior": program_prior_from_jax,
    "program_generator": program_generator_from_jax,
    "question_reconstructor": question_reconstructor_from_jax,
}


def model_from_jax(name: str, tree: Any, spec) -> dict:
    r"""The port's params of model ``name`` from its JAX-layout tree."""
    if name == "nmn":
        return nmn_from_jax(tree, spec)
    if name not in _FROM_JAX:
        raise ValueError(f"no model named {name!r}")
    return _FROM_JAX[name](tree)


_TO_JAX = {
    "program_prior": program_prior_to_jax,
    "program_generator": program_generator_to_jax,
    "question_reconstructor": question_reconstructor_to_jax,
    "nmn": nmn_to_jax,
}


def model_to_jax(name: str, tree: Any) -> dict:
    r"""Model ``name``'s params (or a tree of its shape, such as an Adam
    moment) in the JAX layout, as numpy float32 arrays."""
    if name not in _TO_JAX:
        raise ValueError(f"no model named {name!r}")
    return _TO_JAX[name](tree)


def _lists_from_maps(tree: Any) -> Any:
    r"""A flax state dict's ``{"0": ..., "1": ...}`` maps back into lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and sorted(tree) == [str(i) for i in range(len(tree))]:
        return [_lists_from_maps(tree[str(i)]) for i in range(len(tree))]
    return {k: _lists_from_maps(v) for k, v in tree.items()}


def model_from_flax(name: str, state: Any, spec) -> dict:
    r"""The port's params of model ``name`` from the flax state dict a JAX
    ``.ckpt`` holds (lists as ``{"0": ..., "1": ...}`` maps)."""
    return model_from_jax(name, _lists_from_maps(state), spec)


def models_from_payload(payload: Dict[str, Any], fmt: str, specs: Dict[str, Any],
                        vocabulary) -> Dict[str, Any]:
    r"""The port's params (float32 CPU tensors) of every model of ``specs``
    (name -> spec) that the checkpoint ``payload`` of format ``fmt`` holds:
    a flax state dict (the JAX package's ``.ckpt``), a reference
    ``state_dict`` (its ``.pth``; ``vocabulary`` places the NMN's modules) or
    the port's own tree."""
    out = {}
    for name, spec in specs.items():
        if name not in payload:
            continue
        entry = payload[name]
        if fmt == MSGPACK:
            out[name] = model_from_flax(name, entry, spec)
        elif torch_interop.is_reference_state(entry):
            out[name] = model_from_jax(
                name, torch_interop.model_from_state_dict(name, entry, spec, vocabulary), spec)
        else:
            out[name] = _tree_to_torch(entry, "cpu")
    return out


def _find_adam(state: Any):
    r"""optax's ``ScaleByAdamState`` inside a flax state dict of an optax
    chain, found by its fields: ``add_decayed_weights`` (weight decay) shifts
    its index in the chain."""
    if not isinstance(state, dict):
        return None
    if {"count", "mu", "nu"} <= set(state):
        return state
    for value in state.values():
        found = _find_adam(value)
        if found is not None:
            return found
    return None


def _leaves_like(template: Any, tree: Any, path: str = "") -> List[torch.Tensor]:
    r"""The tensors of ``tree`` in ``template``'s order, matched by key path."""
    if isinstance(template, torch.Tensor):
        if tuple(tree.shape) != tuple(template.shape):
            raise ValueError(f"{path}: shape {tuple(tree.shape)} for a parameter of "
                             f"{tuple(template.shape)}")
        return [tree]
    keys = list(template) if isinstance(template, dict) else range(len(template))
    return [leaf for k in keys for leaf in _leaves_like(template[k], tree[k], f"{path}/{k}")]


def adam_state_from_optax(opt_state: Dict[str, Any], params: Dict[str, Any],
                          specs: Dict[str, Any], template: Dict[str, Any]) -> Dict[str, Any]:
    r"""``torch.optim.Adam``'s ``state_dict`` from the flax state of the JAX
    package's optimizer (``optax.inject_hyperparams`` over clip, [weight
    decay], ``scale_by_adam``, the learning rate): per parameter, in the order
    of ``params`` (name -> the port's tree, as ``ClampedAdam`` holds them),
    ``step`` = ``count``, ``exp_avg`` = ``mu``, ``exp_avg_sq`` = ``nu``, the
    stem's moments permuted like its weights; the group's ``lr`` =
    ``hyperparams.learning_rate``. ``template`` is a fresh optimizer's
    ``state_dict`` (its param groups)."""
    adam = _find_adam(opt_state.get("inner_state"))
    if adam is None:
        raise ValueError("the optimizer state holds no Adam state (count, mu, nu)")
    # A bfloat16 mu (OPTIM.ADAM_MU_DTYPE = bfloat16) reads as float32, which
    # holds it exactly; ClampedAdam.load_state_dict stores it in its own
    # mu dtype.
    step = float(np.asarray(adam["count"]))
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, tree in params.items():
        if name not in adam["mu"]:
            raise ValueError(f"the optimizer state holds no moments of {name}")
        mu = _leaves_like(tree, model_from_flax(name, adam["mu"][name], specs[name]), name)
        nu = _leaves_like(tree, model_from_flax(name, adam["nu"][name], specs[name]), name)
        for m, v in zip(mu, nu):
            state[len(state)] = {"step": torch.tensor(step), "exp_avg": m, "exp_avg_sq": v}
    groups = [dict(group) for group in template["param_groups"]]
    groups[0]["lr"] = float(np.asarray(opt_state["hyperparams"]["learning_rate"]))
    return {"state": state, "param_groups": groups}


def _tree_like(template: Any, leaves: List[torch.Tensor]) -> Any:
    r"""``leaves`` (in ``template``'s order) as a tree of ``template``'s shape."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return [build(v) for v in node]

    return build(template)


def adam_state_to_optax(optimizer_state: Dict[str, Any], params: Dict[str, Any],
                        weight_decay: float = 0.0, mu_dtype: str = "float32") -> Dict[str, Any]:
    r"""The flax state of the JAX package's optimizer
    (``training/optim.py::make_optimizer(lr, weight_decay, mu_dtype)``:
    ``inject_hyperparams`` over clip, [weight decay], ``scale_by_adam`` and
    the learning rate) from ``ClampedAdam.state_dict()`` over ``params``
    (name -> the port's tree, in the optimizer's order): ``count`` = ``step``,
    ``mu`` = ``exp_avg`` (bfloat16 with ``mu_dtype`` bfloat16), ``nu`` =
    ``exp_avg_sq``, each in the JAX layout; ``learning_rate`` = the group's
    ``lr``. Inverse of :func:`adam_state_from_optax`."""
    state = optimizer_state["state"]
    index, steps = 0, set()
    mu, nu = {}, {}
    for name, tree in params.items():
        n = len(_flat_leaves(tree))
        entries = [state.get(i, {}) for i in range(index, index + n)]
        index += n
        steps |= {float(e["step"]) for e in entries if "step" in e}
        zeros = [torch.zeros_like(leaf) for leaf in _flat_leaves(tree)]
        moments = {key: [e[key].float() if key in e else z for e, z in zip(entries, zeros)]
                   for key in ("exp_avg", "exp_avg_sq")}
        mu[name] = model_to_jax(name, _tree_like(tree, moments["exp_avg"]))
        nu[name] = model_to_jax(name, _tree_like(tree, moments["exp_avg_sq"]))
        if mu_dtype == "bfloat16":  # bf16 values: the float32 round trip is exact
            mu[name] = _map_leaves(lambda a: torch.from_numpy(a).to(torch.bfloat16), mu[name])
    if len(steps) > 1:
        raise ValueError(f"parameters at different Adam steps: {sorted(steps)}")
    count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
    chain = [{}] + ([{}] if weight_decay else []) + [{"count": count, "mu": mu, "nu": nu}, {}]
    return {
        "count": count,
        "hyperparams": {"learning_rate": np.asarray(
            optimizer_state["param_groups"][0]["lr"], np.float32)},
        "hyperparams_states": {},
        "inner_state": {str(i): part for i, part in enumerate(chain)},
    }


def _map_leaves(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _flat_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flat_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flat_leaves(v)]
    return [tree]
