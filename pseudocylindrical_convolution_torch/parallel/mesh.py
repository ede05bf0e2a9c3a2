"""Process groups and the data-parallel training step.

The port of the JAX package's ``parallel/mesh.py``. The reference trains
with single-node DDP over NCCL (trainDDP_Full.py:83-86); JAX runs one SPMD
program over a ('data',) mesh. Here each rank is one process, with one
card (or the CPU), the parameters replicated and the batch split over the
ranks. ``make_mesh`` returns the process group they share, and
``shard_train_step`` hands each rank its slice of the micro-batch axis
for a step built with ``make_train_step(..., group=...)``.

A caller names the backend ("nccl" for one card per rank, "gloo" for the
CPU or for ranks that share one card: NCCL refuses two ranks of one
communicator on one device); nothing here picks one by trying another.
"""

from __future__ import annotations

import datetime
import socket
import time

import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["make_mesh", "shard_train_step", "free_port", "spawn_ranks"]

TIMEOUT = datetime.timedelta(minutes=10)


def make_mesh(n_devices: int | None = None, backend: str | None = None,
              rank: int = 0, init_method: str | None = None,
              timeout: datetime.timedelta = TIMEOUT):
    """The default process group of ``n_devices`` ranks, one per card.

    In a process that has one already, return it (its size must be
    ``n_devices`` when that is given); else start it as rank ``rank`` of
    ``n_devices`` (default 1) with ``backend`` at ``init_method``
    (default: ``tcp://localhost:<free port>``, which serves one rank
    only), every collective bounded by ``timeout``."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"the process group has {world} ranks, "
                             f"{n_devices} were asked for")
        return dist.group.WORLD
    n = 1 if n_devices is None else n_devices
    if backend is None:
        raise ValueError("name the backend ('nccl' or 'gloo') to start a "
                         "process group")
    if init_method is None:
        if n != 1:
            raise ValueError("ranks of a group need a shared init_method")
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank, timeout=timeout)
    return dist.group.WORLD


def shard_train_step(step_fn, group, train_ent: bool):
    """Wrap a train step (made with ``group``) into this rank's step.

    batch layout: (acc_batch, micro_batch, 3, H, W), the same on every
    rank; rank r trains on micro-batch rows [r*m, (r+1)*m), m =
    micro_batch // world. Returns call(state, batch) -> (state,
    metrics)."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def call(state, batch):
        if batch.shape[1] % world:
            raise ValueError(f"micro-batch {batch.shape[1]} does not split "
                             f"over {world} ranks")
        m = batch.shape[1] // world
        return step_fn(state, batch[:, rank * m:(rank + 1) * m], train_ent)

    return call


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, nprocs: int, args: tuple = (),
                timeout: float | None = 600.0):
    """Run fn(rank, *args) in ``nprocs`` fresh processes (spawn) and wait
    at most ``timeout`` seconds (None: no deadline) for all of them; a
    rank that raises or dies ends the others, and the failure is raised
    here, as is the deadline. Each rank builds its own process group
    (``make_mesh`` with a shared ``init_method``)."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=None if deadline is None else max(
                0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks did not end within "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
