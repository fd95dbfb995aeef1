"""The rank grid of a multi-process run: which device and backend each
rank uses, its data and vocab process groups, and how ranks are started.

Mirrors `src/repro/launch/mesh.py::make_debug_mesh` (:41),
`make_vocab_mesh` (:46), `mesh_dp_tp` (:36) and `mesh_vp` (:48) for the
port's one-process-per-shard layout. A run of dp x vp ranks lays them out
as `jax.make_mesh((data, vocab))` does, data outer and vocab inner: world
rank w is data rank w // vp and vocab rank w % vp. Each rank joins the
vocab group of its data row (the vp ranks that share its batch rows) and
the data group of its vocab column (the dp ranks that hold the same rows
of the class table), both `torch.distributed.new_group`s.

Rank w's device is explicit, `cuda:{w % device_count}`, so that ranks
share the card when there is one (or run on the CPU when asked). The
backend is the caller's choice: NCCL when every rank has its own card,
gloo (which takes CUDA tensors through host staging) when ranks share one
or run on the CPU; NCCL with ranks sharing a card is refused, not
switched. The group is rendezvoused through a `FileStore` in a temporary
directory, so ranks need no free TCP port.

  spawn_ranks(fn, 2, args, device="cuda")          # vp 2: fn(grid, *args)
  spawn_ranks(fn, 1, args, dp=2, device="cuda")    # dp 2
  spawn_ranks(fn, 2, args, dp=2, device="cuda")    # dp 2 x vp 2
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """One rank's place on the dp x vp grid. `rank`, `size` and `pg` are
    its vocab group's (its vocab rank, vp, the process group the
    vocab-parallel collectives take; None: the default group), the names
    the vocab-parallel code reads; `data_rank`, `dp` and `data_pg` its data
    group's."""
    rank: int
    size: int
    device: torch.device
    backend: str
    pg: object = None
    dp: int = 1
    data_rank: int = 0
    data_pg: object = None

    @property
    def world_rank(self) -> int:
        return self.data_rank * self.size + self.rank

    @property
    def world_size(self) -> int:
        return self.dp * self.size


def mesh_dp(grid: Optional[RankGrid]) -> int:
    """Data-parallel degree (1 without a grid; reference `mesh_dp_tp`)."""
    return 1 if grid is None else grid.dp


def mesh_vp(grid: Optional[RankGrid]) -> int:
    """Vocab-parallel degree (1 without a grid; reference `mesh_vp`)."""
    return 1 if grid is None else grid.size


def rank_device(rank: int, device=None) -> torch.device:
    """Rank `rank`'s device: the CPU when asked, else
    cuda:{rank % device_count} (raises without a card)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the ranks of a grid run on CUDA devices by "
                           "default and none is available; pass "
                           "device='cpu' (CLI: --device cpu)")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(size: int, device: torch.device,
                   backend: Optional[str] = None) -> str:
    """gloo where ranks share a card or run on the CPU, NCCL where each
    has its own card; an explicit NCCL that cannot hold is refused."""
    shared = device.type == "cpu" or size > torch.cuda.device_count()
    if backend is None:
        return "gloo" if shared else "nccl"
    if backend == "nccl" and shared:
        raise ValueError(f"NCCL needs one card per rank: {size} ranks on "
                         f"{device.type} "
                         f"({torch.cuda.device_count()} cards); use gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def make_rank_grid(dp: int, vp: int, world_rank: int, store_path: str, *,
                   device=None, backend: Optional[str] = None) -> RankGrid:
    """Join the dp x vp grid as `world_rank`, rendezvousing through a
    FileStore at `store_path` (every rank gives the same path). Every rank
    creates every row's and column's group, in one order, as
    `new_group` requires."""
    size = dp * vp
    dev = rank_device(world_rank, device)
    be = choose_backend(size, dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(be, store=dist.FileStore(store_path, size),
                            rank=world_rank, world_size=size)
    d, v = divmod(world_rank, vp)
    vocab_pg = data_pg = None
    if dp > 1:
        for row in range(dp):
            pg = dist.new_group([row * vp + c for c in range(vp)])
            if row == d:
                vocab_pg = pg
        for col in range(vp):
            pg = dist.new_group([r * vp + col for r in range(dp)])
            if col == v:
                data_pg = pg
    else:
        # data degree 1: the vocab group is the world; the data group is
        # this rank alone
        for r in range(vp):
            pg = dist.new_group([r])
            if r == world_rank:
                data_pg = pg
    return RankGrid(v, vp, dev, be, vocab_pg, dp, d, data_pg)


def close_rank_grid() -> None:
    """Leave the grid (this process's default process group)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(world_rank: int, fn: Callable, dp: int, vp: int,
               store_path: str, device, backend, threads: int,
               args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    grid = make_rank_grid(dp, vp, world_rank, store_path, device=device,
                          backend=backend)
    try:
        fn(grid, *args)
    finally:
        close_rank_grid()


def spawn_ranks(fn: Callable, size: int, args: tuple = (), *, dp: int = 1,
                device=None, backend: Optional[str] = None,
                threads: int = 0) -> None:
    """Run fn(grid, *args) in dp x `size` new processes (spawned, so `fn`
    must be importable at module level), one rank each, `size` the vocab
    degree, and wait for all of them; a rank that fails fails the call.
    threads > 0 caps each rank's torch intra-op threads."""
    if dp < 1 or size < 1:
        raise ValueError(f"the grid needs dp >= 1 and vp >= 1, got dp={dp} "
                         f"vp={size}")
    with tempfile.TemporaryDirectory(prefix="rank-grid-") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, dp, size, os.path.join(tmp, "store"),
                              device, backend, threads, args),
            nprocs=dp * size, join=True, start_method="spawn")
