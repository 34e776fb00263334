"""Device meshes, placement helpers and the process group (port of
musicfpaugment_tpu/parallel/mesh.py).

A mesh is a 1-D list of ``torch.device`` on the ``data`` axis. Batches are
split over it along their leading axis, and what is replicated is put once
on each distinct device (a mesh may name one device twice). Within one
process this serves the matchers and the sharded augmenter; training across
processes goes through ``torch.distributed`` (:func:`init_multihost`) and
``DistributedDataParallel`` in the trainer, one process per device.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from musicfpaugment_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
Mesh = List[torch.device]


def init_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: DeviceLike = None,
    timeout: datetime.timedelta = datetime.timedelta(minutes=5),
) -> int:
    """Join a process group (``--multihost`` in the train CLI) and return
    this process's rank.

    The arguments default to the ``torchrun`` variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``init_method`` ``tcp://ADDR:PORT``), ``WORLD_SIZE`` and
    ``RANK``. The backend is NCCL for CUDA (``device`` ``None``; each
    process then takes the card ``LOCAL_RANK``, default ``RANK`` modulo the
    card count) and gloo for ``device="cpu"``. Joining again returns the
    rank of the group already joined."""
    if dist.is_initialized():
        return dist.get_rank()
    dev = resolve_device(device)
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError("pass init_method or set MASTER_ADDR and MASTER_PORT")
        init_method = f"tcp://{addr}:{port}"
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or rank is None:
        raise ValueError("pass world_size and rank or set WORLD_SIZE and RANK")
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank, timeout=timeout,
    )
    return dist.get_rank()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def canonical_device(d: DeviceLike) -> torch.device:
    """A device with its index (``cuda`` is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A 1-D data mesh over ``devices`` (default: every CUDA device; raises
    without one), cut to the first ``num_devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=['cpu', ...] for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [canonical_device(d) for d in devices]
    return mesh[:num_devices] if num_devices is not None else mesh


def distinct(mesh: Sequence[DeviceLike]) -> List[torch.device]:
    """The mesh's devices, each once, in mesh order."""
    out: List[torch.device] = []
    for d in mesh:
        d = canonical_device(d)
        if d not in out:
            out.append(d)
    return out


def shard_bounds(batch: int, mesh: Sequence[DeviceLike]) -> List[Tuple[int, int]]:
    """(start, stop) of each mesh position's slice of a batch; raises
    ValueError unless the mesh size divides the batch."""
    n = len(mesh)
    if n == 0 or batch % n:
        raise ValueError(f"batch {batch} not divisible by mesh size {n}")
    b = batch // n
    return [(i * b, (i + 1) * b) for i in range(n)]


@dataclass(frozen=True)
class Sharding:
    """How a value lies on a mesh: its leading axis split over the devices
    (``split``), or one copy on each."""

    mesh: Tuple[torch.device, ...]
    split: bool

    def place(self, x) -> List[Any]:
        """``x`` (tensor or array) -> one tensor per mesh position."""
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if not self.split:
            copies = {d: t.to(d) for d in distinct(self.mesh)}
            return [copies[d] for d in self.mesh]
        return [t[lo:hi].to(d) for (lo, hi), d in zip(shard_bounds(t.shape[0], self.mesh), self.mesh)]


def batch_sharding(mesh: Sequence[DeviceLike]) -> Sharding:
    """Leading (batch) axis split over the data axis."""
    return Sharding(tuple(canonical_device(d) for d in mesh), True)


def replicated(mesh: Sequence[DeviceLike]) -> Sharding:
    return Sharding(tuple(canonical_device(d) for d in mesh), False)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Sequence[DeviceLike]) -> Any:
    """Every leaf of a tree of tensors or arrays as its list of per-device
    slices."""
    return _tree_map(batch_sharding(mesh).place, batch)


def replicate(tree: Any, mesh: Sequence[DeviceLike]) -> Any:
    """Every leaf as one copy per mesh position (positions on one device
    share it)."""
    return _tree_map(replicated(mesh).place, tree)
