"""The vocab-parallel process group: which device and backend each rank
uses, and how ranks are started.

Mirrors `src/repro/launch/mesh.py::make_vocab_mesh` (:36) and `mesh_vp`
(:48) for the port's one-process-per-shard layout. Rank r's device is
explicit, `cuda:{r % device_count}`, so that R ranks share the card when
there is one (or run on the CPU when asked). The backend is the caller's
choice: NCCL when every rank has its own card, gloo (which takes CUDA
tensors through host staging) when ranks share one or run on the CPU;
NCCL with ranks sharing a card is refused, not switched. The group is
rendezvoused through a `FileStore` in a temporary directory, so ranks need
no free TCP port.

  spawn_ranks(fn, 2, args, device="cuda")    # fn(group, *args) per rank
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class VocabGroup:
    """One rank's view of the vocab-parallel group. `pg` is the
    torch.distributed process group its collectives take (None: the
    default group)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    pg: object = None


def rank_device(rank: int, device=None) -> torch.device:
    """Rank `rank`'s device: the CPU when asked, else
    cuda:{rank % device_count} (raises without a card)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("vocab-parallel ranks run on CUDA devices by "
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


def make_vocab_group(size: int, rank: int, store_path: str, *, device=None,
                     backend: Optional[str] = None) -> VocabGroup:
    """Join the `size`-rank group as `rank`, rendezvousing through a
    FileStore at `store_path` (every rank gives the same path)."""
    dev = rank_device(rank, device)
    be = choose_backend(size, dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(be, store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size)
    return VocabGroup(rank, size, dev, be)


def close_vocab_group() -> None:
    """Leave the group (this process's default process group)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, size: int, store_path: str, device,
               backend, threads: int, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    group = make_vocab_group(size, rank, store_path, device=device,
                             backend=backend)
    try:
        fn(group, *args)
    finally:
        close_vocab_group()


def spawn_ranks(fn: Callable, size: int, args: tuple = (), *, device=None,
                backend: Optional[str] = None, threads: int = 0) -> None:
    """Run fn(group, *args) in `size` new processes (spawned, so `fn` must
    be importable at module level), one rank each, and wait for all of
    them; a rank that fails fails the call. threads > 0 caps each rank's
    torch intra-op threads."""
    with tempfile.TemporaryDirectory(prefix="vocab-group-") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, size, os.path.join(tmp, "store"), device,
                              backend, threads, args),
            nprocs=size, join=True, start_method="spawn")
