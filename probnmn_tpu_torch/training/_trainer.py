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

Checkpoints (``load_checkpoint``, and :func:`load_frozen` for the frozen
models of the later phases) are read in any of three formats, told apart by
their content (``utils/checkpointing.py``): the port's own; the JAX
package's ``.ckpt`` (params, Adam state, scheduler, baseline and iteration,
as the JAX trainer restores them); and the reference's ``.pth`` (weights
only, with a fresh optimizer and iteration -1, as the JAX trainer does).

In PyTorch the step runs eagerly on ``device`` (``cuda`` unless the caller
asks for the CPU): forward, ``backward()``, clamp, Adam, each parameter
updated in place. Parameters are nested dicts and lists of float32 leaf
tensors. Scalars go to ``writer`` (anything with ``add_scalar`` and
``add_scalars``), by default a tensorboardX ``SummaryWriter``.

``OPTIM.ADAM_MU_DTYPE = "bfloat16"`` keeps Adam's first moment in
bfloat16 as the JAX package does (``training/optim.py``), in the port's
checkpoints and through a JAX ``.ckpt`` both ways: :meth:`_Trainer.load_checkpoint`
reads its bfloat16 ``mu`` and :meth:`_Trainer.save_checkpoint_jax` writes a
``.ckpt`` the JAX trainer resumes. A config with ``DROPOUT > 0`` trains
with inter-layer LSTM dropout: the phase trainers draw each training pass's
keep masks from ``dropout_generator``, a generator on the trainer's device
seeded from ``RANDOM_SEED`` that nothing else draws from.

``parallel`` (a ``parallel/mesh.py`` ``DataParallel``; None is one process)
makes the trainer one rank of a data-parallel run: its batches are the
rank's rows of each global batch, the phase trainers all-reduce the
gradients before Adam's step (:meth:`_apply_gradients`: their mean where the loss is a mean over equal
shards, their sum where each rank's loss is its rows' share of the global
batch's means, as in question_coding and joint_training; the clamp then
acts on the global gradient, as the JAX package's does) and the logged
values as sums over the global batch, rank 0's parameters are broadcast before the
first step, the trainer's generators are seeded by (``RANDOM_SEED``, data index),
and rank 0 alone writes checkpoints, scalars and the JAX ``.ckpt``. Every
rank reads a checkpoint it resumes from and runs the plateau scheduler on
the same all-reduced validation metric, so every rank keeps the same
learning rate.

Over a model axis (``parallel.model_size`` M above 1; ``parallel/mesh.py``)
a rank keeps each leaf that ``model_shard_spec`` splits as its own 1/M rows
of axis 0, and ``ClampedAdam``'s moments (float32 or bfloat16) hold those
rows alone: ``params`` are the rank's stored leaves. Each step starts with
:meth:`_Trainer.full_params`, one all-gather in the model group that
rebuilds the full leaves as autograd leaves for the forward; after the
backward each rank keeps its rows of each full gradient and reduces them
over its data group, and the replicated leaves are reduced so that every
rank ends with the same bits. The generators are seeded by the data index,
so the ranks of a model group draw the same programs and masks. Rank 0
writes full leaves and full Adam moments, gathered from its model group,
the file an ``M = 1`` run writes; a rank resuming reads the full leaves and
keeps its rows, so checkpoints pass between any M, and to and from the JAX
trainer at any ``model_parallel``. The frozen models (the prior, and the
generator in module_training) stay whole on every rank: no frozen tree has
a key the rule splits.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from probnmn_tpu_torch import interop
from probnmn_tpu_torch.config import Config
from probnmn_tpu_torch.device import resolve_device
from probnmn_tpu_torch.parallel.mesh import rank_seed, split_leaves, tree_paths
from probnmn_tpu_torch.training.optim import ClampedAdam, ReduceLROnPlateau
from probnmn_tpu_torch.utils.checkpointing import (
    MSGPACK,
    CheckpointManager,
    checkpoint_format,
    load_objects,
    read_checkpoint,
    save_objects_jax,
)
from probnmn_tpu_torch.utils.observability import NullWriter, StepTimer
from probnmn_tpu_torch.utils.torch_interop import is_reference_state

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


def tree_like(template: Any, leaves: Sequence[Any]) -> Any:
    r"""``leaves`` (in :func:`tree_leaves` order) as a tree of ``template``'s keys."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


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


def load_models(path: str, specs: Dict[str, Any], vocabulary) -> Dict[str, Any]:
    r"""The params of every model of ``specs`` (name -> spec) from a
    checkpoint in any of the three formats, as float32 CPU tensors in the
    port's layout; a model the file lacks raises."""
    restored, _, missing = load_objects(path, {name: None for name in specs})
    if missing:
        raise ValueError(f"{path} holds no {', '.join(missing)} params")
    return interop.models_from_payload(restored, checkpoint_format(path), specs, vocabulary)


def load_frozen(path: str, name: str, params: Any, device: torch.device, spec,
                vocabulary) -> Any:
    r"""The ``name`` params of a checkpoint (the port's, the JAX package's
    ``.ckpt`` or the reference's ``.pth``), copied into ``params`` (a tree of
    the right shapes), as float32 tensors on ``device`` that need no
    gradient."""
    copy_into(params, load_models(path, {name: spec}, vocabulary)[name], name)
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
    writer: scalar writer; None builds :func:`summary_writer` over
        ``serialization_dir``. A rank other than 0 writes nothing.
    parallel: the rank's ``DataParallel`` handle, or None for one process.
    """

    def __init__(
        self,
        config: Config,
        batches,
        models: Dict[str, Any],
        serialization_dir: str,
        device="cuda",
        writer=None,
        parallel=None,
    ):
        self._C = config
        self._device = resolve_device(device)
        self._parallel = parallel
        self._synced = parallel is None
        self._batch_source = batches  # kept for the per-stage pipeline timers
        self._batches = iter(batches)
        full = {name: tree_map(lambda t: t.detach().to(self._device, torch.float32).clone(), tree)
                for name, tree in models.items()}
        # Over a model axis: which leaves are split, and every leaf's full shape.
        self._split = (split_leaves(full, parallel.model_size)
                       if parallel is not None and parallel.model_size > 1 else None)
        self._shapes = [tuple(t.shape) for t in tree_leaves(full)]
        self._params = tree_map(lambda t: t.requires_grad_(True), self._own(full))
        # The full leaves of the step's forward; the stored ones at M = 1.
        self._live = self._params if self._split is None else None
        self._optimizer = ClampedAdam(
            tree_leaves(self._params), self._C.OPTIM.LR_INITIAL, self._C.OPTIM.WEIGHT_DECAY,
            mu_dtype=self._C.OPTIM.ADAM_MU_DTYPE,
        )
        self._lr_scheduler = ReduceLROnPlateau(
            self._C.OPTIM.LR_INITIAL, self._C.OPTIM.LR_GAMMA, self._C.OPTIM.LR_PATIENCE
        )
        if not self.is_writer:
            writer = NullWriter()
        self._tensorboard_writer = writer if writer is not None else summary_writer(
            serialization_dir)
        self._checkpoint_manager = CheckpointManager(
            serialization_dir=serialization_dir, keep_recent=100
        )
        seed = rank_seed(self._C.RANDOM_SEED, parallel.data_rank if parallel is not None else 0)
        self._generator = torch.Generator().manual_seed(seed)
        # The inter-layer dropout masks, drawn where they are used (drawn
        # only when a model's DROPOUT > 0).
        self.dropout_generator = torch.Generator(device=self._device).manual_seed(seed)
        # REINFORCE moving-average baseline: a 0-dim float32 tensor on the
        # device, updated there without a host sync.
        self._baseline = torch.zeros((), dtype=torch.float32, device=self._device)
        self._iteration: int = -1
        self._step_timer = StepTimer(batch_size=self._C.OPTIM.BATCH_SIZE)

    # ------------------------------------------------------------------ step ----------
    def step(self, iteration: Optional[int] = None) -> Dict[str, Any]:
        r"""One training iteration; returns its logged scalars as host floats."""
        live = self.full_params()
        if not self._synced:
            # Every rank starts from rank 0's parameters (its full leaves).
            self._parallel.broadcast_params(tree_leaves(live))
            if self._split is not None:
                copy_into(self._params, self._own(live))
            self._synced = True
        self._live = live
        batch = next(self._batches)
        output_dict = _to_host(self._do_iteration(batch))
        if self._split is not None:
            self._live = None  # the full leaves live for the step alone
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

    def _apply_gradients(self, loss: torch.Tensor, average: bool = True) -> None:
        r"""``backward()`` of ``loss`` through the step's full leaves, the
        gradients' mean (``average``) or sum over the data ranks where there
        are several (over a model axis, each rank's rows of the split
        leaves' gradients), then the clamp and Adam's step. A ``loss`` that
        needs no gradient (a rank whose rows feed no trainable pass) skips
        the backward and still joins the all-reduces, with zeros."""
        self._optimizer.zero_grad()
        if loss.requires_grad:
            loss.backward()
        if self._split is not None:
            self._parallel.reduce_split_grads(tree_leaves(self._live), tree_leaves(self._params),
                                              self._split, average=average)
        elif self._parallel is not None:
            self._parallel.all_reduce_grads(tree_leaves(self._params), average=average)
        self._optimizer.step()

    # ------------------------------------------------------------------ the model axis
    def _own(self, full: Dict[str, Any]) -> Dict[str, Any]:
        r"""``full`` (full trees keyed by model name) with each leaf that the
        model axis splits cut to this rank's rows (a copy); ``full`` itself
        with no model axis."""
        if self._split is None:
            return full
        flags = split_leaves(full, self._parallel.model_size)
        return tree_like(full, [self._parallel.own_rows(t.detach()).clone() if split else t
                                for t, split in zip(tree_leaves(full), flags)])

    def set_params(self, models: Dict[str, Any]) -> None:
        r"""Copy full trees (model name -> tree of the model's shapes) into
        the trainable leaves; over a model axis each rank keeps its rows."""
        for name, params in models.items():
            copy_into(self._params[name], self._own({name: params})[name], name)

    def full_params(self) -> Dict[str, Any]:
        r"""Every trainable model's full leaves: the stored tree itself with no
        model axis; over one, each split leaf gathered from the model group
        (one all-gather, which every rank of the group must call) as a fresh
        tensor that autograd takes as a leaf, each replicated leaf the
        stored tensor itself."""
        if self._split is None:
            return self._params
        leaves = tree_leaves(self._params)
        gathered = iter(self._parallel.gather_rows(
            [t.detach() for t, split in zip(leaves, self._split) if split],
            [shape for shape, split in zip(self._shapes, self._split) if split]))
        return tree_like(self._params, [next(gathered).requires_grad_(True) if split else t
                                        for t, split in zip(leaves, self._split)])

    def full_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        r"""(every trainable model's full leaves, the optimizer's
        ``state_dict`` with full moments): over a model axis the split
        leaves and their moments gathered from the model group (two
        all-gathers, which every rank of the group must call)."""
        state = self._optimizer.state_dict()
        if self._split is None:
            return self._params, state
        params = tree_map(lambda t: t.detach(), self.full_params())
        entries = {i: dict(entry) for i, entry in state["state"].items()}
        keys = [(i, key) for key in ("exp_avg", "exp_avg_sq")
                for i, split in enumerate(self._split) if split and key in entries.get(i, {})]
        full = self._parallel.gather_rows([entries[i][key].float() for i, key in keys],
                                          [self._shapes[i] for i, _ in keys])
        for (i, key), moment in zip(keys, full):
            entries[i][key] = moment.to(entries[i][key].dtype)
        return params, {"state": entries, "param_groups": state["param_groups"]}

    def _own_optimizer_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        r"""A ``state_dict`` with full moments (a file's) with each split
        leaf's moments cut to this rank's rows."""
        if self._split is None:
            return state
        entries = {}
        for i, entry in state["state"].items():
            entries[i] = dict(entry)
            if self._split[int(i)]:
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in entry:
                        entries[i][key] = self._parallel.own_rows(entry[key]).clone()
        return {"state": entries, "param_groups": state["param_groups"]}

    def resident_bytes(self, names: Optional[Sequence[str]] = None) -> int:
        r"""Bytes this rank keeps of the parameters of the models ``names``
        (None: every trainable model) and of their Adam moments."""
        state = self._optimizer.state_dict()["state"]
        total = 0
        for index, (path, leaf) in enumerate(tree_paths(self._params)):
            if names is not None and path[0] not in names:
                continue
            total += leaf.numel() * leaf.element_size()
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state.get(index, {}):
                    total += state[index][key].numel() * state[index][key].element_size()
        return total

    def _log_output(self, output_dict: Dict[str, Any]) -> None:
        for key, value in output_dict.items():
            if isinstance(value, dict):
                if value:
                    self._tensorboard_writer.add_scalars(f"train/{key}", value, self._iteration)
            else:
                self._tensorboard_writer.add_scalar(f"train/{key}", value, self._iteration)

    # ------------------------------------------------------------------ validation ----
    def _checkpointables(self) -> Dict[str, Any]:
        params, optimizer = self.full_state()
        objects: Dict[str, Any] = dict(params)
        objects["optimizer"] = optimizer
        objects["scheduler"] = self._lr_scheduler.state_dict()
        objects["reinforce_baseline"] = self._baseline
        return objects

    def jax_checkpointables(self) -> Dict[str, Any]:
        r"""What the JAX trainer checkpoints, in its layout: every model's
        params (``interop.model_to_jax``), the optax state of its optimizer
        (``interop.adam_state_to_optax``; a bfloat16 ``mu`` stays bfloat16),
        the scheduler and the baseline (full leaves and moments: over a model
        axis a collective of the model group, :meth:`full_state`)."""
        params, optimizer = self.full_state()
        objects: Dict[str, Any] = {name: interop.model_to_jax(name, tree)
                                   for name, tree in params.items()}
        objects["optimizer"] = interop.adam_state_to_optax(
            optimizer, params, self._C.OPTIM.WEIGHT_DECAY, self._optimizer.mu_dtype)
        objects["scheduler"] = self._lr_scheduler.state_dict()
        objects["reinforce_baseline"] = np.asarray(float(self._baseline), np.float32)
        return objects

    def save_checkpoint_jax(self, path: str) -> None:
        r"""Write the trainer's state as the JAX package's ``.ckpt``, which
        its trainer's ``load_checkpoint`` resumes (rank 0 alone writes; over
        a model axis every rank gathers)."""
        if self._split is None and not self.is_writer:
            return
        objects = self.jax_checkpointables()
        if self.is_writer:
            save_objects_jax(path, objects, self._iteration)

    def after_validation(
        self, val_metrics: Dict[str, Any], iteration: Optional[int] = None
    ) -> None:
        if iteration is not None:
            self._iteration = iteration

        metric = val_metrics["metric"]
        if self.is_writer or self._split is not None:  # over a model axis every rank gathers
            objects = self._checkpointables()
            if self.is_writer:
                self._checkpoint_manager.step(self._iteration, objects, metric)

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

    def close_writer(self) -> None:
        r"""Flush and close the scalar writer, where it has files to close
        (tensorboardX's writes from a thread of its own)."""
        close = getattr(self._tensorboard_writer, "close", None)
        if close is not None:
            close()

    def model_specs(self) -> Dict[str, Any]:
        r"""Model name -> spec of every trainable model, for reading the JAX
        package's and the reference's checkpoints. Phase trainers override."""
        raise NotImplementedError

    def load_checkpoint(self, checkpoint_path: str, iteration: Optional[int] = None):
        r"""Restore from a checkpoint of the port, of the JAX package (its
        ``.ckpt``) or of the reference (its ``.pth``: weights only); what the
        file lacks keeps its current state. Over a model axis each rank
        reads the full leaves and moments and keeps its rows."""
        logger.info("Loading checkpoint from %s", checkpoint_path)
        payload, fmt = read_checkpoint(checkpoint_path)
        ckpt_iteration = int(payload.pop("iteration", -1))
        models = interop.models_from_payload(payload, fmt, self.model_specs(), self._vocabulary)
        self.set_params(models)
        missing = [name for name in (*self._params, "optimizer", "scheduler", "reinforce_baseline")
                   if name not in payload]
        if missing:
            logger.info("Checkpointables not found in file: %s", missing)
        if fmt != MSGPACK and any(is_reference_state(payload.get(n)) for n in self._params):
            # The reference's optimizer and scheduler state is torch 1.4's and
            # its iteration another run's: start both afresh, as the JAX
            # trainer does.
            self._iteration = iteration if iteration is not None else -1
            return
        if "optimizer" in payload:
            optimizer = payload["optimizer"]
            if fmt == MSGPACK:
                # The moments' template: every leaf at its full shape.
                template = tree_like(self._params, [torch.empty(shape, device="meta")
                                                    for shape in self._shapes])
                optimizer = interop.adam_state_from_optax(
                    optimizer, template, self.model_specs(), self._optimizer.state_dict())
            self._optimizer.load_state_dict(self._own_optimizer_state(optimizer))
        if "scheduler" in payload:
            # Numbers in both files; load_state_dict makes each a float or an int.
            self._lr_scheduler.load_state_dict(payload["scheduler"])
        self._optimizer.set_learning_rate(self._lr_scheduler.lr)
        if "reinforce_baseline" in payload:
            self._baseline = torch.as_tensor(payload["reinforce_baseline"]).to(
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
    def parallel(self):
        r"""The rank's ``DataParallel`` handle, or None for one process."""
        return self._parallel

    @property
    def world_size(self) -> int:
        r"""The ranks of the run: 1 for one process."""
        return 1 if self._parallel is None else self._parallel.world_size

    @property
    def data_size(self) -> int:
        r"""The data ranks of the run, over which each global batch splits: 1
        for one process."""
        return 1 if self._parallel is None else self._parallel.data_size

    @property
    def is_writer(self) -> bool:
        r"""True where this trainer writes files: one process, or rank 0."""
        return self._parallel is None or self._parallel.is_writer

    @property
    def params(self) -> Dict[str, Any]:
        r"""The trainable leaves this rank keeps: over a model axis each split
        leaf is the rank's rows (:meth:`full_params` gathers them)."""
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
