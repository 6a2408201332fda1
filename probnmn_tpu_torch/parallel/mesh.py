r"""
The data-parallel mesh (counterpart of ``probnmn_tpu/parallel/mesh.py``'s
``data`` axis): one process a card over ``torch.distributed``.

The JAX package shards each batch over a mesh's ``data`` axis and replicates
the parameters; under jit, GSPMD inserts the gradient all-reduce. Here each
rank is a process of its own that holds the parameters, gathers the
contiguous rows ``[rank * B / n, (rank + 1) * B / n)`` of every global batch
(``data/pipeline.py``), runs the kernels on them, and joins the others in
one all-reduce of every gradient before the optimizer's step. In
program_prior and module_training the losses are means over equal shards,
so the mean of the ranks' gradients is the gradient of the global batch, up
to the order of the sums. In question_coding and joint_training the means
are over subsets (the supervised rows, the unsupervised ones) whose counts
differ from rank to rank: each rank divides its rows' sums by the global
batch's counts, and the ranks' gradients are summed.

- :func:`auto_world` keeps ``auto_mesh``'s policy: None or 1 gives one
  process, 0 every device, N ``min(N, available)``; then the count drops to
  the largest that divides the batch size.
- :class:`DataParallel` is a rank's handle: its ``rank``, ``world_size`` and
  ``device``, the gradient all-reduce, sums of logged values, a broadcast of
  rank 0's parameters, and ``is_writer`` (rank 0 alone writes checkpoints,
  scalars and traces).
- :func:`launch` spawns the ranks (``start_method="spawn"``), meets them at
  a ``file://`` rendezvous in a fresh directory, and fails with a rank's
  traceback if one raises, after the others are torn down.

The backend is stated, never guessed: ``nccl`` when each rank has a card of
its own, ``gloo`` on the CPU and ``gloo`` for ranks that share one card
(``share_card=True``; NCCL refuses two ranks on one device). The JAX
package's ``model`` axis (``--model-parallel``) is not ported.
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
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# Seconds a collective may wait for the other ranks before it fails.
COLLECTIVE_TIMEOUT = 1800.0


def auto_world(num_devices: Optional[int], batch_size: Optional[int], available: int) -> int:
    r"""The number of ranks for ``--num-devices`` (``auto_mesh``'s policy at
    ``model_parallel`` 1): None or 1 gives 1, 0 gives ``available``, N gives
    ``min(N, available)``; then the largest count that divides
    ``batch_size``, so that every rank holds as many rows."""
    n = available if num_devices == 0 else (num_devices or 1)
    n = min(n, available)
    if batch_size is not None:
        while n > 1 and batch_size % n != 0:
            n -= 1
    return max(n, 1)


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
    counterpart of JAX's per-shard ``fold_in``)."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def global_sum_vector(parallel: Optional["DataParallel"], values: Sequence[Any],
                      device: torch.device) -> torch.Tensor:
    r"""``values`` (0-dim tensors or numbers) summed over the ranks, as one
    float64 tensor with no host sync: one all-reduce under ``parallel`` (on
    the rank's device), the values themselves on ``device`` in one process
    (None)."""
    if parallel is not None:
        return parallel.all_reduce_sums(values)
    return torch.stack([torch.as_tensor(v, dtype=torch.float64, device=device) for v in values])


def global_sums(parallel: Optional["DataParallel"], values: Sequence[Any]) -> List[float]:
    r"""``values`` summed over the ranks as host floats (:func:`global_sum_vector`)."""
    return global_sum_vector(parallel, values, torch.device("cpu")).tolist()


def shard_of(parallel: Optional["DataParallel"]) -> dict:
    r"""The ``rank`` and ``world_size`` keywords of the batch iterators."""
    if parallel is None:
        return {"rank": 0, "world_size": 1}
    return {"rank": parallel.rank, "world_size": parallel.world_size}


class DataParallel:
    r"""One rank of a process group: ``rank``, ``world_size`` and the
    ``device`` its tensors live on (``cuda:{index}`` after
    ``torch.cuda.set_device``, or the CPU)."""

    def __init__(self, rank: int, world_size: int, device: torch.device):
        self.rank = rank
        self.world_size = world_size
        self.device = device

    @property
    def is_writer(self) -> bool:
        r"""True on rank 0, the one rank that writes files."""
        return self.rank == 0

    @torch.no_grad()
    def all_reduce_grads(self, params: Sequence[torch.Tensor], average: bool = True) -> None:
        r"""Every parameter's ``.grad`` becomes the mean over the ranks
        (``average``; the losses are means over equal shards) or their sum
        (``average=False``; each rank's loss is its rows' sums over the
        global batch's counts): one all-reduce of all gradients flattened
        into one buffer. A parameter without a gradient takes part as zeros
        (the optimizer steps on zeros there, as under ``jax.grad``)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        if average:
            flat.div_(self.world_size)
        offset = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[offset:offset + n].view_as(p)
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
        r"""The sums over the ranks of ``values`` (0-dim tensors or numbers),
        as one float64 tensor on the rank's device: one all-reduce."""
        stacked = torch.stack([torch.as_tensor(v, dtype=torch.float64).to(self.device)
                               for v in values])
        dist.all_reduce(stacked)
        return stacked

    def barrier(self) -> None:
        dist.barrier()


def launch(fn: Callable, world_size: int, device_type: str, run_dir: str, args: tuple = (),
           share_card: bool = False, timeout: Optional[float] = None,
           collective_timeout: float = COLLECTIVE_TIMEOUT) -> List[Any]:
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
    raises in its rank."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device_type!r}")
    if device_type == "cuda" and not share_card and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks over nccl need {world_size} cards; "
                         f"{torch.cuda.device_count()} found")
    os.makedirs(run_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="ranks_", dir=run_dir)
    backend = "nccl" if device_type == "cuda" and not share_card else "gloo"
    logger.info("Launching %d ranks over %s on %s", world_size, backend, device_type)
    context = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, args, world_size, device_type, share_card, backend, work,
                          collective_timeout),
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
               share_card: bool, backend: str, work: str, collective_timeout: float) -> None:
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
            result = fn(DataParallel(rank, world_size, device), *args)
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
