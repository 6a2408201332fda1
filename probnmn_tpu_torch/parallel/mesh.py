r"""
The mesh (counterpart of ``probnmn_tpu/parallel/mesh.py``): one process a
card over ``torch.distributed``, its ranks laid out as a (data x model)
grid.

The JAX package shards each batch over a mesh's ``data`` axis and places
each parameter leaf by ``shard_params``: replicated, or split on axis 0 over
the ``model`` axis; under jit, GSPMD inserts the collectives. Here each rank
is a process of its own. Rank r sits at data index ``r // M`` and model
index ``r % M`` (``make_mesh``'s device order, M the model axis's size). A
rank gathers the contiguous rows ``[d * B / D, (d + 1) * B / D)`` of every
global batch (``data/pipeline.py``; d its data index, D the data axis's
size), so the M ranks of one data index see the same rows; it runs the
kernels on them with whole banks, as the JAX package's ``shard_map``
wrappers take the banks replicated. In program_prior and module_training
the losses are means over equal shards, so the mean of the data ranks'
gradients is the gradient of the global batch, up to the order of the sums.
In question_coding and joint_training the means are over subsets (the
supervised rows, the unsupervised ones) whose counts differ from rank to
rank: each rank divides its rows' sums by the global batch's counts, and the
data ranks' gradients are summed.

The model axis shards storage, not compute. With M above 1 a rank keeps each
leaf that :func:`model_shard_spec` splits (the NMN's module banks and its
classifier's matrices, where M divides the leaf's first dimension) as its
own 1/M rows, with their Adam moments (``training/_trainer.py``). Before
each forward one all-gather in the rank's model group rebuilds the full
leaves (:meth:`DataParallel.gather_rows`); after the backward each rank
keeps its rows of the full gradient and reduces them over its data group
(:meth:`DataParallel.reduce_split_grads`). The ranks of a model group hold
the same rows, so no sum runs over the model axis.

Every value the ranks of a model group must hold bit for bit (the
replicated leaves' gradients, the logged sums, the REINFORCE baseline's
centered reward, the evaluators' counters) is summed in one all-reduce over
the whole world to which only the ranks at model index 0 contribute: the
sum over one data group, the same bits on every rank. Separate reductions
would part the replicas, since cuDNN's float32 backward does not repeat
bit for bit from run to run. At M = 1 every rank is at model index 0 and
the all-reduce is the data-parallel one.

- :func:`auto_world` keeps ``auto_mesh``'s policy: None or 1 gives one
  process, 0 every device, N ``min(N, available)``; M is used only if it
  divides that count (else 1, logged); then the data count drops to the
  largest that divides the batch size.
- :func:`model_shard_spec` is ``_param_spec`` with ``shard_params``'s
  fall-back to replication.
- :class:`DataParallel` is a rank's handle: its ``rank``, ``world_size``,
  ``data_rank``, ``data_size``, ``model_rank``, ``model_size`` and
  ``device``, its data and model groups, the gradient reductions, sums of
  logged values, a broadcast of rank 0's parameters, and ``is_writer``
  (rank 0 alone writes checkpoints, scalars and traces).
- :func:`launch` spawns the ranks (``start_method="spawn"``), meets them at
  a ``file://`` rendezvous in a fresh directory, and fails with a rank's
  traceback if one raises, after the others are torn down.

The backend is stated, never guessed: ``nccl`` when each rank has a card of
its own, ``gloo`` on the CPU and ``gloo`` for ranks that share one card
(``share_card=True``; NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import datetime
import logging
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# Seconds a collective may wait for the other ranks before it fails.
COLLECTIVE_TIMEOUT = 1800.0
DATA_AXIS, MODEL_AXIS = "data", "model"
# The NMN's module banks: their leaves' axis 0 is the module instance.
BANKS = ("attention", "query", "relate", "same", "compare")


def auto_world(num_devices: Optional[int], batch_size: Optional[int], available: int,
               model_parallel: Optional[int] = None) -> Union[int, Tuple[int, int]]:
    r"""The ranks for ``--num-devices`` and ``--model-parallel``, by
    ``auto_mesh``'s policy: None or 1 gives 1, 0 gives ``available``, N gives
    ``min(N, available)``; ``model_parallel`` M is used where M > 0 divides
    that count and the count is above 1, else it falls back to 1 (logged at
    INFO; the JAX package falls back without a word); then the data count
    drops to the largest that divides ``batch_size``, so that every rank
    holds as many rows. Returns the data count where ``model_parallel`` is
    None, else (data, model)."""
    n = available if num_devices == 0 else (num_devices or 1)
    n = min(n, available)
    mp = 1
    if model_parallel is not None:
        if n > 1 and model_parallel > 0 and n % model_parallel == 0:
            mp = model_parallel
        elif model_parallel != 1:
            logger.info("--model-parallel %d does not divide %d devices: the model axis is 1",
                        model_parallel, n)
    data = max(n // mp, 1)
    if batch_size is not None:
        while data > 1 and batch_size % data != 0:
            data -= 1
    return data if model_parallel is None else (data, mp)


def available_devices(device_type: str, num_devices: Optional[int]) -> int:
    r"""What ``--num-devices`` may take: the cards on ``cuda``; on the CPU,
    where the ranks are processes, the number asked for (0, every device,
    has no meaning there and raises)."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    if num_devices == 0:
        raise ValueError("--num-devices 0 takes every card; on the CPU give the number of ranks")
    return num_devices or 1


def rank_seed(seed: int, rank: int) -> int:
    r"""The seed of a rank's generators: ``seed`` itself on rank 0, so one
    process draws what it always drew, and on the others a 63-bit number
    fixed by (``seed``, ``rank``) and distinct across ranks (the
    counterpart of JAX's per-shard ``fold_in``). The trainers pass the data
    index, so the ranks of a model group draw alike."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def model_shard_spec(path: Sequence[Any], leaf: Any, model_parallel: int) -> tuple:
    r"""The ``PartitionSpec`` (as a tuple) that the JAX package's
    ``shard_params`` gives the leaf at key ``path`` on a model axis of
    ``model_parallel``: ``("model",)`` for a leaf under a module bank
    (:data:`BANKS`) whose first dimension is above 1, ``("model", None)`` for
    a 2-D leaf under ``classifier``, else ``()`` (replicated); and ``()``
    where ``model_parallel`` does not divide the split dimension."""
    names = [str(key) for key in path]
    shape = tuple(getattr(leaf, "shape", ()))
    if any(name in BANKS for name in names):
        spec = (MODEL_AXIS,) if shape and shape[0] > 1 else ()
    elif "classifier" in names and len(shape) == 2:
        spec = (MODEL_AXIS, None)
    else:
        spec = ()
    if spec and shape[0] % model_parallel != 0:
        spec = ()
    return spec


def tree_paths(tree: Any, path: tuple = ()) -> Iterator[Tuple[tuple, Any]]:
    r"""(key path, leaf) of every leaf of a nested dict/list, in the order of
    ``training/_trainer.py::tree_leaves`` (dict insertion order)."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from tree_paths(value, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for index, value in enumerate(tree):
            yield from tree_paths(value, path + (index,))
    else:
        yield path, tree


def split_leaves(tree: Any, model_parallel: int) -> List[bool]:
    r"""For every leaf of ``tree`` (full leaves, keyed from the model names
    down), in order, whether it is split over the model axis."""
    return [bool(model_shard_spec(path, leaf, model_parallel)) for path, leaf in tree_paths(tree)]


def global_sum_vector(parallel: Optional["DataParallel"], values: Sequence[Any],
                      device: torch.device) -> torch.Tensor:
    r"""``values`` (0-dim tensors or numbers) summed over the data ranks, as
    one float64 tensor with no host sync, the same bits on every rank: one
    all-reduce under ``parallel`` (on the rank's device), the values
    themselves on ``device`` in one process (None)."""
    if parallel is not None:
        return parallel.all_reduce_sums(values)
    return torch.stack([torch.as_tensor(v, dtype=torch.float64, device=device) for v in values])


def global_sums(parallel: Optional["DataParallel"], values: Sequence[Any]) -> List[float]:
    r"""``values`` summed over the data ranks as host floats (:func:`global_sum_vector`)."""
    return global_sum_vector(parallel, values, torch.device("cpu")).tolist()


def shard_of(parallel: Optional["DataParallel"]) -> dict:
    r"""The ``rank`` and ``world_size`` keywords of the batch iterators: the
    data index and the data axis's size."""
    if parallel is None:
        return {"rank": 0, "world_size": 1}
    return {"rank": parallel.data_rank, "world_size": parallel.data_size}


class DataParallel:
    r"""One rank of a process group: ``rank``, ``world_size`` and the
    ``device`` its tensors live on (``cuda:{index}`` after
    ``torch.cuda.set_device``, or the CPU); over a model axis of
    ``model_size`` M, its place (``data_rank``, ``model_rank``) =
    ``divmod(rank, M)`` on the (``data_size``, M) grid.

    Over a model axis every rank makes every group, in the same order (a
    group made only on its members deadlocks): the data groups first, one a
    model index, then the model groups, one a data index. ``gathers``
    counts the all-gathers of :meth:`gather_rows`."""

    def __init__(self, rank: int, world_size: int, device: torch.device, model_size: int = 1):
        if world_size % model_size != 0:
            raise ValueError(f"{world_size} ranks do not split over a model axis of {model_size}")
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.model_size = model_size
        self.data_size = world_size // model_size
        self.data_rank, self.model_rank = divmod(rank, model_size)
        self.data_group = self.model_group = None
        self.gathers = 0
        if model_size > 1:
            for m in range(model_size):
                group = dist.new_group([d * model_size + m for d in range(self.data_size)])
                if m == self.model_rank:
                    self.data_group = group
            for d in range(self.data_size):
                group = dist.new_group([d * model_size + m for m in range(model_size)])
                if d == self.data_rank:
                    self.model_group = group

    @property
    def is_writer(self) -> bool:
        r"""True on rank 0, the one rank that writes files."""
        return self.rank == 0

    @torch.no_grad()
    def all_reduce_grads(self, params: Sequence[torch.Tensor], average: bool = True) -> None:
        r"""Every parameter's ``.grad`` becomes the mean over the data ranks
        (``average``; the losses are means over equal shards) or their sum
        (``average=False``; each rank's loss is its rows' sums over the
        global batch's counts): one all-reduce of all gradients flattened
        into one buffer, to which the ranks at model index 0 alone
        contribute. A parameter without a gradient takes part as zeros
        (the optimizer steps on zeros there, as under ``jax.grad``)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        if self.model_rank != 0:
            flat.zero_()
        dist.all_reduce(flat)
        if average:
            flat.div_(self.data_size)
        offset = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n

    def own_rows(self, leaf: torch.Tensor) -> torch.Tensor:
        r"""This rank's rows of a split ``leaf``: the model index's 1/M of
        axis 0 (a view)."""
        rows = leaf.shape[0] // self.model_size
        return leaf[self.model_rank * rows:(self.model_rank + 1) * rows]

    @torch.no_grad()
    def gather_rows(self, parts: Sequence[torch.Tensor],
                    shapes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        r"""The full tensors of ``shapes`` from every model rank's ``parts``
        (its rows, :meth:`own_rows`; one dtype): one all-gather of the parts
        flattened into one buffer within the model group. Each result is a
        fresh tensor, which autograd can take as a leaf."""
        if not parts:
            return []
        flat = torch.cat([p.reshape(-1) for p in parts])
        out = [torch.empty_like(flat) for _ in range(self.model_size)]
        dist.all_gather(out, flat, group=self.model_group)
        self.gathers += 1
        full, offset = [], 0
        for part, shape in zip(parts, shapes):
            n = part.numel()
            full.append(torch.cat([o[offset:offset + n] for o in out]).view(*shape))
            offset += n
        return full

    @torch.no_grad()
    def reduce_split_grads(self, full: Sequence[torch.Tensor], owned: Sequence[torch.Tensor],
                           split: Sequence[bool], average: bool = True) -> None:
        r"""The gradients of ``owned`` (the leaves a rank keeps: its rows of
        a split leaf, the tensor itself of a replicated one) from those of
        ``full`` (the leaves the forward used), reduced as
        :meth:`all_reduce_grads` reduces them: the replicated leaves' in
        one all-reduce over the world from the ranks at model index 0, so
        that the replicas stay equal bit for bit; each split leaf's rows of
        its full gradient in one all-reduce over the data group, where the
        ranks hold the same rows."""
        def grad(t):
            return t.grad if t.grad is not None else torch.zeros_like(t)

        self.all_reduce_grads([o for o, s in zip(owned, split) if not s], average)
        pairs = [(f, o) for f, o, s in zip(full, owned, split) if s]
        if not pairs:
            return
        flat = torch.cat([self.own_rows(grad(f)).reshape(-1) for f, _ in pairs])
        if self.data_size > 1:
            dist.all_reduce(flat, group=self.data_group)
        if average:
            flat.div_(self.data_size)
        offset = 0
        for _, o in pairs:
            n = o.numel()
            o.grad = flat[offset:offset + n].view_as(o)
            offset += n

    @torch.no_grad()
    def broadcast_params(self, params: Sequence[torch.Tensor]) -> None:
        r"""Copy rank 0's values of ``params`` into every rank's, in place."""
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        dist.broadcast(flat, src=0)
        offset = 0
        for p in params:
            n = p.numel()
            p.copy_(flat[offset:offset + n].view_as(p))
            offset += n

    @torch.no_grad()
    def all_reduce_sums(self, values: Sequence[Any]) -> torch.Tensor:
        r"""The sums over the data ranks of ``values`` (0-dim tensors or
        numbers), as one float64 tensor on the rank's device, the same bits
        on every rank: one all-reduce over the world, to which the ranks at
        model index 0 alone contribute."""
        stacked = torch.stack([torch.as_tensor(v, dtype=torch.float64).to(self.device)
                               for v in values])
        if self.model_rank != 0:
            stacked.zero_()
        dist.all_reduce(stacked)
        return stacked

    def barrier(self) -> None:
        dist.barrier()


def launch(fn: Callable, world_size: int, device_type: str, run_dir: str, args: tuple = (),
           share_card: bool = False, timeout: Optional[float] = None,
           collective_timeout: float = COLLECTIVE_TIMEOUT, model_parallel: int = 1) -> List[Any]:
    r"""Run ``fn(parallel, *args)`` in ``world_size`` spawned processes, one
    a rank, and return what each returned (``None`` for a rank that returned
    nothing), by rank.

    ``fn`` must be a module-level function (spawn imports it by name) and
    ``args`` picklable: a tensor in shared memory (``share_memory_()``)
    reaches every rank as the same pages. ``device_type`` ``"cuda"`` gives
    rank r card r over ``nccl`` (``world_size`` cards at least), or with
    ``share_card`` card 0 for every rank over ``gloo``, each rank with
    its share of the host's cores as intra-op threads; ``"cpu"`` runs
    ``gloo`` with one intra-op thread a rank. The rendezvous and the ranks'
    results go to a fresh directory under ``run_dir``, removed at the end.
    A rank that raises fails the launch with its traceback
    (``torch.multiprocessing.ProcessRaisedException``; the rank that raised
    first, not a peer whose collective then lost it) once the other ranks
    are killed; so does a launch still running after ``timeout`` seconds
    (``TimeoutError``; None waits as long as the ranks run). A collective
    that waits more than ``collective_timeout`` seconds for the other ranks
    raises in its rank. ``model_parallel`` M lays the ranks out as a
    (``world_size`` / M, M) grid of data and model indices
    (:class:`DataParallel`)."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device_type!r}")
    if world_size % model_parallel != 0:
        raise ValueError(f"{world_size} ranks do not split over a model axis of {model_parallel}")
    if device_type == "cuda" and not share_card and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks over nccl need {world_size} cards; "
                         f"{torch.cuda.device_count()} found")
    os.makedirs(run_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ranks_", dir=run_dir)
    backend = "nccl" if device_type == "cuda" and not share_card else "gloo"
    logger.info("Launching %d ranks (data %d x model %d) over %s on %s", world_size,
                world_size // model_parallel, model_parallel, backend, device_type)
    context = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, args, world_size, device_type, share_card, backend, work,
                          collective_timeout, model_parallel),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        try:
            while not context.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running after {timeout} s")
        except torch.multiprocessing.ProcessRaisedException as error:
            first = _first_failure(work, world_size)
            if first is None:
                raise
            rank, text = first
            raise torch.multiprocessing.ProcessRaisedException(
                f"\n\n-- rank {rank} raised first:\n{text}", rank,
                context.processes[rank].pid) from error
        results = []
        for rank in range(world_size):
            path = os.path.join(work, f"result_{rank}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results.append(pickle.load(f))
            else:
                results.append(None)
        return results
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
            process.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)


def _first_failure(work: str, world_size: int):
    r"""(rank, traceback) of the rank whose exception came first, or None."""
    failures = []
    for rank in range(world_size):
        path = os.path.join(work, f"error_{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                stamp, text = f.read().split("\n", 1)
            failures.append((float(stamp), rank, text))
    return min(failures)[1:] if failures else None


def _rank_main(rank: int, fn: Callable, args: tuple, world_size: int, device_type: str,
               share_card: bool, backend: str, work: str, collective_timeout: float,
               model_parallel: int) -> None:
    if device_type == "cuda":
        index = 0 if share_card else rank
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
        # The ranks gather and pin their rows on one host: each takes its
        # share of the cores rather than a pool as large as the host.
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world_size))
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{os.path.join(work, 'rendezvous')}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=collective_timeout))
    try:
        try:
            result = fn(DataParallel(rank, world_size, device, model_parallel), *args)
        except BaseException:
            # When and why, for the launcher: a peer's collective then fails
            # too, and the first failure is the one to report.
            with open(os.path.join(work, f"error_{rank}.txt"), "w") as f:
                f.write(f"{time.time()!r}\n{traceback.format_exc()}")
            raise
        if result is not None:
            with open(os.path.join(work, f"result_{rank}.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
