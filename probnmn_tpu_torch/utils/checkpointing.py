r"""
CheckpointManager: periodic serialization of named objects with best-checkpoint
tracking and *partial named restore* (counterpart of
``probnmn_tpu/utils/checkpointing.py``; reference
``probnmn/utils/checkpointing.py``).

A file is one ``torch.save`` of ``{name: state, ..., "iteration": int}``,
written to ``<path>.tmp`` and renamed into place. Each state is a nested dict
or list of CPU tensors (parameters), a ``state_dict`` (optimizer, scheduler)
or a number. Partial loading restores only the names asked for; names in
the file that nobody asked for are logged, and asked-for names missing from
the file are reported back.

Not ported yet: reading and writing the JAX package's msgpack ``.ckpt`` files
and the reference's ``.pth`` checkpoints (ROADMAP.md queue 1, checkpoint
interop).
"""
from __future__ import annotations

import logging
import os
import pathlib
from typing import Any, Dict, List, Optional, Tuple

import torch

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


def load_objects(
    path: str, templates: Dict[str, Any]
) -> Tuple[Dict[str, Any], int, List[str]]:
    r"""Restore the named objects present in both ``templates`` and the file.

    Returns (restored dict: the file's object where found, else the
    template; iteration; names not found in the file).
    """
    payload = torch.load(path, map_location="cpu", weights_only=True)
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

    def load(self, checkpoint_path: str, templates: Dict[str, Any]):
        logger.info("Loading checkpoint from %s", checkpoint_path)
        restored, iteration, _ = load_objects(checkpoint_path, templates)
        return restored, iteration
