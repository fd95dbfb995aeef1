"""The rank grid of a multi-process run: which device and backend each
rank uses, its data, model and vocab process groups, and how ranks are
started; and the production meshes as descriptions.

Mirrors `src/repro/launch/mesh.py::make_production_mesh` (:7),
`make_debug_mesh` (:41), `make_vocab_mesh` (:46), `mesh_dp_tp` (:36) and
`mesh_vp` (:48) for the port's one-process-per-shard layout. A run of
dp x tp ranks lays them out as `jax.make_mesh((data, model))` does, data
outer and model inner: world rank w is data rank w // tp and model rank
w % tp; a dp x vp run likewise with the vocab axis inner. Each rank joins
the model (or vocab) group of its data row and the data group of its
column, all `torch.distributed.new_group`s. dp x tp x vp is not a grid
here: the reference carves `vocab` out of `model`, and the plan
(`launch.dryrun`) models that by sizes alone.

`make_production_mesh` / `mesh_dp_tp` describe the reference's 16 x 16
and 2 x 16 x 16 meshes (axis names and sizes, no processes) for the plan.

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
  spawn_ranks(fn, 1, args, dp=2, tp=2, device="cuda")   # dp 2 x tp 2
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
    """One rank's place on the dp x tp (or dp x vp) grid. `rank`, `size`
    and `pg` are its vocab group's (its vocab rank, vp, the process group
    the vocab-parallel collectives take; None: the default group), the
    names the vocab-parallel code reads; `data_rank`, `dp` and `data_pg`
    its data group's; `model_rank`, `tp` and `model_pg` its model
    group's (a group of its own even where it is the world)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    pg: object = None
    dp: int = 1
    data_rank: int = 0
    data_pg: object = None
    tp: int = 1
    model_rank: int = 0
    model_pg: object = None

    @property
    def world_rank(self) -> int:
        return ((self.data_rank * self.tp + self.model_rank) * self.size
                + self.rank)

    @property
    def world_size(self) -> int:
        return self.dp * self.tp * self.size


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """A mesh by its axis names and sizes (no devices, no processes)."""
    axis_names: tuple
    shape: tuple

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False,
                         vocab_parallel: int = 1) -> MeshDesc:
    """16 x 16 chips a pod, 2 pods when multi_pod (reference :7);
    vocab_parallel > 1 carves a `vocab` axis out of the 16-chip model
    axis: (16 // vocab_parallel) model x vocab_parallel vocab."""
    if vocab_parallel > 1:
        if 16 % vocab_parallel:
            raise ValueError(f"vocab_parallel {vocab_parallel} must divide "
                             f"the 16-chip inner mesh dim")
        model = 16 // vocab_parallel
        if multi_pod:
            return MeshDesc(("pod", "data", "model", "vocab"),
                            (2, 16, model, vocab_parallel))
        return MeshDesc(("data", "model", "vocab"),
                        (16, model, vocab_parallel))
    if multi_pod:
        return MeshDesc(("pod", "data", "model"), (2, 16, 16))
    return MeshDesc(("data", "model"), (16, 16))


def mesh_dp_tp(mesh) -> tuple[int, int]:
    """(data-parallel degree incl. the pod axis, tensor-parallel degree)
    of a `MeshDesc` or a `RankGrid` (reference :36)."""
    if isinstance(mesh, RankGrid):
        return mesh.dp, mesh.tp
    sizes = mesh.sizes
    return sizes.get("data", 1) * sizes.get("pod", 1), sizes.get("model", 1)


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
                   device=None, backend: Optional[str] = None,
                   tp: int = 1) -> RankGrid:
    """Join the dp x vp (or dp x tp) grid as `world_rank`, rendezvousing
    through a FileStore at `store_path` (every rank gives the same path).
    Every rank creates every row's and column's group, in one order, as
    `new_group` requires."""
    if tp > 1 and vp > 1:
        raise ValueError(f"a grid has a model axis or a vocab axis, not "
                         f"both (tp={tp}, vp={vp})")
    size = dp * vp * tp
    dev = rank_device(world_rank, device)
    be = choose_backend(size, dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(be, store=dist.FileStore(store_path, size),
                            rank=world_rank, world_size=size)
    if tp > 1:
        d, m = divmod(world_rank, tp)
        model_pg = data_pg = vocab_pg = None
        for row in range(dp):
            pg = dist.new_group([row * tp + c for c in range(tp)])
            if row == d:
                model_pg = pg
        for col in range(tp):
            pg = dist.new_group([r * tp + col for r in range(dp)])
            if col == m:
                data_pg = pg
        for r in range(size):
            pg = dist.new_group([r])
            if r == world_rank:
                vocab_pg = pg
        return RankGrid(0, 1, dev, be, vocab_pg, dp, d, data_pg, tp, m,
                        model_pg)
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
               args: tuple, tp: int) -> None:
    if threads:
        torch.set_num_threads(threads)
    grid = make_rank_grid(dp, vp, world_rank, store_path, device=device,
                          backend=backend, tp=tp)
    try:
        fn(grid, *args)
    finally:
        close_rank_grid()


def spawn_ranks(fn: Callable, size: int, args: tuple = (), *, dp: int = 1,
                tp: int = 1, device=None, backend: Optional[str] = None,
                threads: int = 0) -> None:
    """Run fn(grid, *args) in dp x tp x `size` new processes (spawned, so
    `fn` must be importable at module level), one rank each, `size` the
    vocab degree and `tp` the model degree (not both above 1), and wait
    for all of them; a rank that fails fails the call. threads > 0 caps
    each rank's torch intra-op threads."""
    if dp < 1 or size < 1 or tp < 1:
        raise ValueError(f"the grid needs dp, tp and vp >= 1, got dp={dp} "
                         f"tp={tp} vp={size}")
    if tp > 1 and size > 1:
        raise ValueError(f"a grid has a model axis or a vocab axis, not "
                         f"both (tp={tp}, vp={size})")
    with tempfile.TemporaryDirectory(prefix="rank-grid-") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, dp, size, os.path.join(tmp, "store"),
                              device, backend, threads, args, tp),
            nprocs=dp * size * tp, join=True, start_method="spawn")
