r"""
Base training runtime (counterpart of ``probnmn_tpu/training/_trainer.py``;
reference ``probnmn/trainers/_trainer.py``).

The same contract as the JAX package's: one optimizer over the union of all
trainable models' parameters; ``step()`` runs one iteration and logs its
``{"loss", ...}`` scalars (nested dicts become ``add_scalars``);
``after_validation(val_metrics)`` takes a higher-is-better
``val_metrics["metric"]`` for best-checkpoint tracking and the plateau
scheduler; ``load_checkpoint`` restores params, optimizer, scheduler,
learning rate and iteration.

In PyTorch the step runs eagerly on ``device`` (``cuda`` unless the caller
asks for the CPU): forward, ``backward()``, clamp, Adam, each parameter
updated in place. Parameters are nested dicts and lists of float32 leaf
tensors. Scalars go to ``writer`` (anything with ``add_scalar`` and
``add_scalars``), by default a tensorboardX ``SummaryWriter``.

Not ported yet: the data-parallel mesh, reading the reference's ``.pth``
checkpoints and ``OPTIM.ADAM_MU_DTYPE = "bfloat16"`` (the JAX package's bf16
Adam first moment), which raises (ROADMAP.md queue 1).
"""
from __future__ import annotations

import logging
import zipfile
from typing import Any, Dict, List, Optional

import torch

from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.training.optim import ClampedAdam, ReduceLROnPlateau
from probnmn_tpu_torch.utils.checkpointing import CheckpointManager, load_objects
from probnmn_tpu_torch.utils.observability import StepTimer

logger = logging.getLogger(__name__)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    r"""The tensors of a nested dict/list, in a fixed order (dict insertion order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in tree_leaves(item)]


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


@torch.no_grad()
def copy_into(dst: Any, src: Any, path: str = "") -> None:
    r"""Copy every tensor of ``src`` into the tensor of ``dst`` at the same key
    path, in place; the two trees must have the same keys and shapes."""
    if isinstance(dst, torch.Tensor):
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} for a parameter of "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
        return
    keys = list(dst) if isinstance(dst, dict) else list(range(len(dst)))
    src_keys = list(src) if isinstance(src, dict) else list(range(len(src)))
    if sorted(map(str, keys)) != sorted(map(str, src_keys)):
        raise ValueError(f"{path}: keys {src_keys} for parameters {keys}")
    for key in keys:
        copy_into(dst[key], src[key], f"{path}/{key}")


def load_frozen(path: str, name: str, params: Any, device: torch.device, writer: str) -> Any:
    r"""The ``name`` params of a checkpoint written by the port's ``writer``
    trainer (a ``torch.save`` zip archive), copied into ``params`` (a tree of
    the right shapes), as float32 tensors on ``device`` that need no
    gradient. The JAX package's msgpack ``.ckpt`` and the reference's
    ``.pth`` raise: reading them is not ported."""
    if path.endswith(".pth") or not zipfile.is_zipfile(path):
        raise NotImplementedError(
            f"{path} is not a checkpoint of the port's {writer}; reading the JAX package's "
            "msgpack .ckpt and the reference's .pth is not ported (ROADMAP.md queue 1, "
            "checkpoint interop)"
        )
    restored, _, missing = load_objects(path, {name: None})
    if missing:
        raise ValueError(f"{path} holds no {name} params")
    copy_into(params, restored[name], name)
    return tree_map(lambda t: t.to(device, torch.float32), params)


def summary_writer(log_dir: str):
    r"""A tensorboardX ``SummaryWriter`` (imported here: a caller that passes
    its own writer does not need tensorboardX)."""
    from tensorboardX import SummaryWriter

    return SummaryWriter(log_dir=log_dir)


class _Trainer:
    r"""
    Parameters
    ----------
    config: Config
    batches: iterable of batches on ``device`` (cyclic).
    models: trainable parameter trees keyed by model name.
    serialization_dir: str
    device: ``"cuda"`` (default) or ``"cpu"``.
    writer: scalar writer; None builds :func:`summary_writer` over ``serialization_dir``.
    """

    def __init__(
        self,
        config: Config,
        batches,
        models: Dict[str, Any],
        serialization_dir: str,
        device="cuda",
        writer=None,
    ):
        self._C = config
        if config.OPTIM.ADAM_MU_DTYPE != "float32":
            raise NotImplementedError(
                f"OPTIM.ADAM_MU_DTYPE={config.OPTIM.ADAM_MU_DTYPE!r} is not ported (ROADMAP.md "
                "queue 1: 'bfloat16 Adam first moment'); use float32"
            )
        self._device = resolve_device(device)
        self._batch_source = batches  # kept for the per-stage pipeline timers
        self._batches = iter(batches)
        self._params = {
            name: tree_map(
                lambda t: t.detach().to(self._device, torch.float32).clone().requires_grad_(True),
                tree,
            )
            for name, tree in models.items()
        }
        self._optimizer = ClampedAdam(
            tree_leaves(self._params), self._C.OPTIM.LR_INITIAL, self._C.OPTIM.WEIGHT_DECAY
        )
        self._lr_scheduler = ReduceLROnPlateau(
            self._C.OPTIM.LR_INITIAL, self._C.OPTIM.LR_GAMMA, self._C.OPTIM.LR_PATIENCE
        )
        self._tensorboard_writer = writer if writer is not None else summary_writer(
            serialization_dir)
        self._checkpoint_manager = CheckpointManager(
            serialization_dir=serialization_dir, keep_recent=100
        )
        self._generator = torch.Generator().manual_seed(self._C.RANDOM_SEED)
        # REINFORCE moving-average baseline: a 0-dim float32 tensor on the
        # device, updated there without a host sync.
        self._baseline = torch.zeros((), dtype=torch.float32, device=self._device)
        self._iteration: int = -1
        self._step_timer = StepTimer(batch_size=self._C.OPTIM.BATCH_SIZE)

    # ------------------------------------------------------------------ step ----------
    def step(self, iteration: Optional[int] = None) -> Dict[str, Any]:
        r"""One training iteration; returns its logged scalars as host floats."""
        batch = next(self._batches)
        output_dict = _to_host(self._do_iteration(batch))
        self._iteration = iteration if iteration is not None else self._iteration + 1
        self._step_timer.tick()
        if self._iteration % 50 == 0 and self._iteration > 0:
            metrics = dict(self._step_timer.metrics())
            stage = getattr(self._batch_source, "stage_metrics", None)
            if stage is not None:
                metrics.update(stage())
            for name, value in metrics.items():
                self._tensorboard_writer.add_scalar(f"train/{name}", value, self._iteration)
        self._log_output(output_dict)
        return output_dict

    def _do_iteration(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def _log_output(self, output_dict: Dict[str, Any]) -> None:
        for key, value in output_dict.items():
            if isinstance(value, dict):
                if value:
                    self._tensorboard_writer.add_scalars(f"train/{key}", value, self._iteration)
            else:
                self._tensorboard_writer.add_scalar(f"train/{key}", value, self._iteration)

    # ------------------------------------------------------------------ validation ----
    def _checkpointables(self) -> Dict[str, Any]:
        objects: Dict[str, Any] = dict(self._params)
        objects["optimizer"] = self._optimizer.state_dict()
        objects["scheduler"] = self._lr_scheduler.state_dict()
        objects["reinforce_baseline"] = self._baseline
        return objects

    def after_validation(
        self, val_metrics: Dict[str, Any], iteration: Optional[int] = None
    ) -> None:
        if iteration is not None:
            self._iteration = iteration

        metric = val_metrics["metric"]
        self._checkpoint_manager.step(self._iteration, self._checkpointables(), metric)

        new_lr = self._lr_scheduler.step(metric)
        self._optimizer.set_learning_rate(new_lr)
        self._tensorboard_writer.add_scalar("train/lr", new_lr, self._iteration)

        val_metrics = {k: v for k, v in val_metrics.items() if k != "metric"}
        for model_name, metrics in val_metrics.items():
            if not isinstance(metrics, dict):
                continue
            for metric_name, value in metrics.items():
                self._tensorboard_writer.add_scalar(
                    f"val/metrics/{model_name}/{metric_name}", value, self._iteration
                )

    def load_checkpoint(self, checkpoint_path: str, iteration: Optional[int] = None):
        if checkpoint_path.endswith(".pth"):
            raise NotImplementedError(
                "reference .pth checkpoints are not ported (ROADMAP.md queue 1, checkpoint "
                "interop)"
            )
        restored, ckpt_iteration = self._checkpoint_manager.load(
            checkpoint_path, self._checkpointables())
        for name in self._params:
            copy_into(self._params[name], restored[name])
        self._optimizer.load_state_dict(restored["optimizer"])
        self._lr_scheduler.load_state_dict(restored["scheduler"])
        self._optimizer.set_learning_rate(self._lr_scheduler.lr)
        self._baseline = torch.as_tensor(restored["reinforce_baseline"]).to(
            self._device, torch.float32)
        self._iteration = iteration if iteration is not None else ckpt_iteration

    # ------------------------------------------------------------------ accessors -----
    @property
    def iteration(self) -> int:
        return self._iteration

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def params(self) -> Dict[str, Any]:
        return self._params

    @property
    def baseline(self) -> torch.Tensor:
        r"""The REINFORCE baseline, a 0-dim float32 tensor on ``device``."""
        return self._baseline

    @property
    def learning_rate(self) -> float:
        return self._optimizer.get_learning_rate()

    def next_rng(self) -> torch.Generator:
        r"""A fresh CPU generator seeded from the trainer's own (``RANDOM_SEED``)."""
        seed = int(torch.randint(2 ** 62, (1,), generator=self._generator))
        return torch.Generator().manual_seed(seed)


def _to_host(output_dict: Dict[str, Any]) -> Dict[str, Any]:
    r"""Scalars of ``output_dict`` as Python floats (this waits for the card)."""
    out = {}
    for key, value in output_dict.items():
        if isinstance(value, dict):
            out[key] = {k: float(v) for k, v in value.items() if _is_scalar(v)}
        elif _is_scalar(value):
            out[key] = float(value)
    return out


def _is_scalar(value) -> bool:
    return not isinstance(value, torch.Tensor) or value.dim() == 0
