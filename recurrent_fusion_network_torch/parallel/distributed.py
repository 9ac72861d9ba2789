"""Multi-process plumbing over ``torch.distributed``.

Counterpart of ``recurrent_fusion_network_tpu/parallel/distributed.py``.
The JAX package runs data parallelism as one program over a 'dp' mesh: one
process on one host, or ``jax.distributed.initialize`` and a global mesh
across hosts. The torch idiom is one process per device, each a rank of
one process group: ``python -m torch.distributed.run --nproc_per_node N``
starts them with the rendezvous in the environment, ``spawn_local`` does
the same from inside a CLI.

  initialize(backend, device, mp)
                               join the group the launcher's environment
                               names (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
                               RANK, LOCAL_RANK), as the JAX package reads
                               JAX_COORDINATOR_ADDRESS and its siblings,
                               and lay its ranks out as dp x mp once: rank
                               r is dp index r // mp and mp index r % mp
                               (JAX's reshape(dp, mp)), with a dp group per
                               mp index and an mp group per dp index
  rank()                       this process's rank (0 alone)
  host_shard()                 (dp index, dp) for the DataLoader: the mp
                               ranks of one dp index load the same rows
  host_mean(value, weight)     count-weighted mean of a host scalar
  all_hosts_agree(flag)        AND of a host flag (early stop, fleet stop)
  any_host(flag)               OR of a host flag (the preemption agreement)
  barrier()                    every rank past this point
  spawn_local(n, fn, *args)    n local ranks on a loopback rendezvous

The backend is NCCL on CUDA and gloo on the CPU unless the caller names
one. Beside an NCCL group a gloo group carries the host scalars, as the JAX
package gathers them on the host (``process_allgather``). Without a group
every helper is the identity of one process. Every rank must call each
collective helper the same number of times: the training loops do, since
their boundaries run in lockstep.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import socket
import threading
from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.distributed as dist

# the launcher's environment (torch.distributed.run's names; LOCAL_RANK,
# which picks the card, defaults to RANK)
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@dataclass(frozen=True)
class Cluster:
    """This process's place in the group: its rank among ``world``, its
    device, the backend of the default group and the gloo group of the host
    collectives (the default group itself under gloo); the layout of the
    ranks as a dp x mp grid, fixed when the group is joined, with this
    rank's dp group (the ranks of its mp index; None: the default group)
    and mp group (the ranks of its dp index; None at mp 1)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    host_group: object
    mp: int = 1
    dp_group: object = None
    mp_group: object = None

    @property
    def dp(self) -> int:
        return self.world // self.mp

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp


# the group this process joined (torch.distributed's default group is
# process-wide state; this records what initialize made of it)
_cluster: Optional[Cluster] = None


def launched() -> bool:
    """Whether a launcher's environment gives this process a rank."""
    return all(k in os.environ for k in ENV)


def cluster() -> Optional[Cluster]:
    """The group ``initialize`` joined, or None."""
    return _cluster


def initialize(backend: Optional[str] = None, *, device=None, mp: int = 1) -> Cluster:
    """Join the process group of the launcher's environment.

    ``device``: this rank's device; None or "cuda" -> ``cuda:LOCAL_RANK``,
    "cpu" -> the CPU, an indexed CUDA device as given (two ranks may share
    one card under gloo); CPU ranks split the host's threads between the
    local ranks. ``backend``: NCCL on CUDA and gloo on the CPU unless
    named; a named backend is used or refused, never swapped. ``mp``: the
    ranks' layout, dp = world / mp, for the life of the group (JAX
    ``make_mesh_2d``'s ``reshape(dp, mp)``): an mp group is a run of mp
    consecutive ranks, and every rank makes every group, in one order.
    ``mp`` 1 is the data-parallel layout (the default group is the dp
    group). Raises ValueError, before joining, where the world does not
    divide by ``mp``."""
    global _cluster
    if _cluster is not None:
        raise RuntimeError("this process has already joined a process group")
    if not launched():
        raise RuntimeError("no launcher environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, "
                           "RANK): start the ranks with python -m torch.distributed.run or "
                           "spawn_local")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if mp < 1 or world % mp:
        raise ValueError(f"the {world} rank(s) do not make a dp x mp grid with mp {mp}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (--device cpu) to "
                               "run the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} asks for {dev}, but {torch.cuda.device_count()} "
                             "CUDA device(s) are visible")
        torch.cuda.set_device(dev)
    else:
        # the local ranks share the host's cores (each would take them all)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        torch.set_num_threads(max(1, torch.get_num_threads() // local_world))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    host = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    _cluster = Cluster(rank, world, dev, backend, host)
    if mp > 1:
        dp = world // mp
        dp_groups = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
        mp_groups = [dist.new_group(list(range(d * mp, (d + 1) * mp))) for d in range(dp)]
        _cluster = replace(_cluster, mp=mp, dp_group=dp_groups[rank % mp],
                           mp_group=mp_groups[rank // mp])
    return _cluster


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _cluster
    if _cluster is not None:
        _cluster = None
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank in the group; 0 alone."""
    return 0 if _cluster is None else _cluster.rank


def host_shard():
    """(dp index, dp): the DataLoader's ``host_shard``, so the mp ranks of
    one dp index load the same rows; (0, 1) alone."""
    c = _cluster
    return (0, 1) if c is None else (c.dp_index, c.dp)


def _host_reduce(values, dtype, op):
    t = torch.tensor(values, dtype=dtype)
    dist.all_reduce(t, op=op, group=_cluster.host_group)
    return t


def host_mean(value: float, weight: float = 1.0) -> float:
    """Count-weighted mean of a per-rank scalar over the ranks (0.0 where
    every weight is 0). A data-parallel eval scores each rank's slice of
    the val stream, and the budget may leave ranks unequal (even empty)
    slices: each rank passes its scored-image count as ``weight``, so the
    best-checkpoint verdict is one global number on every rank (a diverging
    verdict would make the ranks save a different number of times)."""
    if _cluster is None or _cluster.world == 1:
        return float(value) if weight else 0.0
    total = _host_reduce([float(value) * weight if weight else 0.0, float(weight)],
                         torch.float64, dist.ReduceOp.SUM)
    return float(total[0] / total[1]) if total[1] else 0.0


def all_hosts_agree(flag: bool) -> bool:
    """True only where every rank says True (a loop exit taken on one
    rank's verdict would leave the others in the next collective)."""
    if _cluster is None or _cluster.world == 1:
        return bool(flag)
    return bool(_host_reduce([int(bool(flag))], torch.int32, dist.ReduceOp.MIN)[0])


def any_host(flag: bool) -> bool:
    """True on every rank once any rank says True."""
    if _cluster is None or _cluster.world == 1:
        return bool(flag)
    return bool(_host_reduce([int(bool(flag))], torch.int32, dist.ReduceOp.MAX)[0])


def barrier() -> None:
    """Every rank waits here for the others (over the host group)."""
    if _cluster is not None and _cluster.world > 1:
        dist.barrier(group=_cluster.host_group)


# ------------------------------------------------------------ local ranks


def free_port() -> int:
    """A loopback port free at the time of asking."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(env: dict, fn, args) -> None:
    os.environ.update(env)
    fn(*args)


def spawn_local(n: int, fn, *args) -> None:
    """Run ``fn(*args)`` in ``n`` new processes (start method spawn), the
    ranks 0..n-1 of one group on a loopback rendezvous at a free port: each
    finds torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, LOCAL_RANK = RANK, LOCAL_WORLD_SIZE) and joins with
    ``initialize``. ``fn`` must be importable by name. A SIGTERM to this
    process goes on to every rank. Raises RuntimeError when a rank fails
    (the others are terminated); every rank has exited on return."""
    ctx = multiprocessing.get_context("spawn")
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": str(n),
           "LOCAL_WORLD_SIZE": str(n)}
    procs = [ctx.Process(target=_run_rank, name=f"rank{r}",
                         args=(dict(env, RANK=str(r), LOCAL_RANK=str(r)), fn, args))
             for r in range(n)]
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    main_thread = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, forward) if main_thread else None
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank(s) {failed} of {n} failed: exit codes {codes}")
            if all(c == 0 for c in codes):
                return
            procs[codes.index(None)].join(0.1)
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, old)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
