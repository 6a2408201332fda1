r"""
CheckpointManager: periodic serialization of named objects with best-checkpoint
tracking and *partial named restore* (counterpart of
``probnmn_tpu/utils/checkpointing.py``; reference
``probnmn/utils/checkpointing.py``).

The port writes one ``torch.save`` of ``{name: state, ..., "iteration": int}``,
to ``<path>.tmp`` renamed into place. Each state is a nested dict or list of
CPU tensors (parameters), a ``state_dict`` (optimizer, scheduler) or a
number. Partial loading restores only the names asked for; names in the file
that nobody asked for are logged, and asked-for names missing from the file
are reported back.

:func:`load_objects` reads three formats, told apart by their first bytes
and never by the file's suffix (:func:`checkpoint_format`):

- the port's own ``torch.save`` zip archive;
- a legacy (pre-1.6) ``torch.save`` pickle, which is what the reference's
  v1.0 ``.pth`` files are (it pins ``torch==1.4.0``). Its models are flat
  ``state_dict``s with dotted keys; ``utils/torch_interop.py`` maps them;
- the JAX package's ``.ckpt``, a flax msgpack blob
  (``utils/msgpack_format.py``), whose models are flax state dicts: numpy
  arrays, lists written as ``{"0": ..., "1": ...}`` maps.

Torch files load with ``weights_only=True``. :func:`save_objects_jax` writes
the JAX package's format, for its ``load_objects`` to restore.
"""
from __future__ import annotations

import logging
import os
import pathlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from probnmn_tpu_torch.utils import msgpack_format

logger = logging.getLogger(__name__)


def to_cpu(obj: Any) -> Any:
    r"""A copy of ``obj`` with every tensor detached and on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def save_objects(path: str, objects: Dict[str, Any], iteration: int = -1) -> None:
    payload = {name: to_cpu(obj) for name, obj in objects.items()}
    payload["iteration"] = iteration
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


TORCH, TORCH_LEGACY, MSGPACK = "torch", "torch_legacy", "msgpack"


def checkpoint_format(path: str) -> str:
    r"""``TORCH`` (a ``torch.save`` zip archive), ``TORCH_LEGACY`` (a pre-1.6
    ``torch.save`` pickle: protocol 2, then the magic number as a long) or
    ``MSGPACK`` (a msgpack map: the JAX package's ``.ckpt``), from the
    file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return TORCH
    if head[:3] == b"\x80\x02\x8a":
        return TORCH_LEGACY
    if head[:1] and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return MSGPACK
    raise ValueError(
        f"{path} is not a checkpoint: its first bytes {head!r} are none of a torch.save zip "
        "archive, a legacy torch.save pickle or the JAX package's msgpack .ckpt")


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], str]:
    r"""(the file's payload, its :func:`checkpoint_format`)."""
    fmt = checkpoint_format(path)
    if fmt == MSGPACK:
        with open(path, "rb") as f:
            payload = msgpack_format.unpackb(f.read())
        if not isinstance(payload, dict):
            raise ValueError(f"{path} holds a {type(payload).__name__}, not a map of objects")
        return payload, fmt
    return torch.load(path, map_location="cpu", weights_only=True), fmt


def load_objects(
    path: str, templates: Dict[str, Any]
) -> Tuple[Dict[str, Any], int, List[str]]:
    r"""Restore the named objects present in both ``templates`` and the file,
    as the file holds them (see the module's docstring for each format).

    Returns (restored dict: the file's object where found, else the
    template; iteration; names not found in the file).
    """
    payload, _ = read_checkpoint(path)
    iteration = int(payload.pop("iteration", -1))

    restored: Dict[str, Any] = {}
    not_found: List[str] = []
    for name, template in templates.items():
        if name in payload:
            logger.info("Loading %s from %s", name, path)
            restored[name] = payload[name]
        else:
            restored[name] = template
            not_found.append(name)
    for name in payload:
        if name not in templates:
            logger.info("%s not found in checkpointables.", name)
    if not_found:
        logger.info("Checkpointables not found in file: %s", not_found)
    return restored, iteration, not_found


def _flax_state(obj: Any) -> Any:
    r"""``flax.serialization.to_state_dict`` of the trees the port writes:
    lists and tuples become ``{"0": ..., "1": ...}`` maps, tensors numpy
    arrays (``bfloat16`` stays a tensor; the writer names it)."""
    if isinstance(obj, dict):
        return {str(k): _flax_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {str(i): _flax_state(v) for i, v in enumerate(obj)}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu()
        return obj if obj.dtype == torch.bfloat16 else obj.numpy()
    return obj


def save_objects_jax(path: str, objects: Dict[str, Any], iteration: int = -1) -> None:
    r"""Write ``{name: object, ..., "iteration": iteration}`` in the JAX
    package's ``.ckpt`` format, which its ``load_objects`` restores into its
    templates. Each object is in the JAX package's layout (``interop``'s
    ``*_to_jax``): a nested dict or list of arrays or tensors, or a number."""
    payload = {name: _flax_state(obj) for name, obj in objects.items()}
    payload["iteration"] = iteration
    data = msgpack_format.packb(payload)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class CheckpointManager:
    r"""
    Parameters
    ----------
    serialization_dir: str
        Directory for ``checkpoint_{iteration}.ckpt`` files and ``checkpoint_best.ckpt``.
    keep_recent: int
        Number of recent checkpoints kept on disk (best checkpoint always kept).
    """

    SUFFIX = ".ckpt"

    def __init__(self, serialization_dir: str, keep_recent: int = 10):
        self.serialization_dir = pathlib.Path(serialization_dir)
        self.serialization_dir.mkdir(parents=True, exist_ok=True)
        self.keep_recent = keep_recent
        self._best_metric = -1e-12
        self._recent_iterations: List[int] = []

    def step(
        self, iteration: int, objects: Dict[str, Any], metric: Optional[float] = None
    ) -> None:
        path = self.serialization_dir / f"checkpoint_{iteration}{self.SUFFIX}"
        save_objects(str(path), objects, iteration)

        if metric is not None and metric > self._best_metric:
            self._best_metric = metric
            save_objects(
                str(self.serialization_dir / f"checkpoint_best{self.SUFFIX}"),
                objects,
                iteration,
            )

        self._recent_iterations.append(iteration)
        while len(self._recent_iterations) > self.keep_recent:
            earliest = self._recent_iterations.pop(0)
            stale = self.serialization_dir / f"checkpoint_{earliest}{self.SUFFIX}"
            if stale.exists():
                stale.unlink()
