"""Process group, rank/world description and batch split of the port.

Port of ``gantrack_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a 1-D device mesh and lets ``shard_map`` place the
collectives; the port runs one process per device, as the reference
does (``train_mi_multimodal.py:27-49``), and calls ``torch.distributed``
where the JAX step has its ``pmean``/``psum``:

* :func:`initialize_distributed` joins the process group of a torchrun
  launch (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``): NCCL on ``cuda``, gloo on ``cpu``.  A failed NCCL
  init raises; gloo is never taken on the card.
* :class:`Mesh` says which rank of how many this process is;
  :func:`create_mesh` describes the running group, or, before a launch,
  the one to start (all visible GPUs by default, as JAX's
  ``create_mesh(None)`` takes all devices).
* :func:`shard_batch` is a rank's rows of a global batch, and
  :func:`replicate` broadcasts tensors from rank 0 (the state after
  build or resume), where JAX places them with ``replicated``.
* :func:`all_mean` and :func:`all_sum` reduce a list of tensors of one
  dtype in one collective (flattened); :func:`batch_mean` is the
  differentiable global mean of the path-length phase.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

# Longest a collective may wait for the other ranks before it raises.
TIMEOUT = timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Rank ``rank`` of ``world`` processes, one device each;
    ``distributed`` when a process group is up (its collectives run even
    at world 1)."""

    world: int = 1
    rank: int = 0
    distributed: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def launched() -> bool:
    """Whether the environment names a multi-process launch (torchrun)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize_distributed(device_type: str) -> bool:
    """Join the process group that the environment describes, once.
    Returns True if this call started it.  ``device_type`` is the device
    the caller trains on: NCCL for ``cuda`` (each rank on
    ``cuda:LOCAL_RANK``), gloo for ``cpu``."""
    if dist.is_initialized() or not launched():
        return False
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA launch found no CUDA device")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device_type!r}")
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT)
    return True


def default_devices(device_type: str) -> int:
    """Devices a run takes when not told: every visible GPU, or one CPU."""
    return max(torch.cuda.device_count(), 1) if device_type == "cuda" else 1


def create_mesh(num_devices: Optional[int] = None, device_type: str = "cuda") -> Mesh:
    """The running process group as a :class:`Mesh`; without one, the
    group of ``num_devices`` (default: :func:`default_devices`) that a
    launch would start, seen from rank 0."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_devices not in (None, world):
            raise ValueError(f"{num_devices} devices asked for in a group of {world} processes")
        return Mesh(world=world, rank=dist.get_rank(), distributed=True)
    return Mesh(world=num_devices or default_devices(device_type))


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Rank ``mesh.rank``'s rows of a global batch (contiguous blocks)."""
    if x.shape[0] % mesh.world:
        raise ValueError(f"batch {x.shape[0]} is not divisible by {mesh.world} ranks")
    n = x.shape[0] // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite ``tensors`` in place with rank 0's values."""
    if not mesh.distributed:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def _reduce(tensors: List[torch.Tensor], scale: Optional[float]) -> List[torch.Tensor]:
    """Sum ``tensors`` (of one dtype) over ranks in one collective, then
    divide by ``scale``; returns new tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    if scale is not None:
        flat = flat / scale
    return [piece.view(t.shape) for piece, t in zip(flat.split([t.numel() for t in tensors]),
                                                    tensors)]


def all_mean(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Mean over ranks of each tensor (the JAX step's ``pmean``); the
    tensors unchanged without a process group."""
    if not mesh.distributed or not tensors:
        return tensors
    return _reduce(tensors, float(mesh.world))


def all_sum(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over ranks of each tensor (the JAX step's ``psum``)."""
    if not mesh.distributed or not tensors:
        return tensors
    return _reduce(tensors, None)


class _AllMean(torch.autograd.Function):
    """Mean over ranks whose backward is the mean of the cotangents, the
    transpose JAX gives ``pmean`` inside ``shard_map``."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        y = x.clone()
        dist.all_reduce(y)
        return y / world

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g / ctx.world, None


def batch_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch mean of ``x`` (each rank holding an equal share),
    differentiable; ``x.mean()`` without a process group."""
    m = x.mean()
    if not mesh.distributed:
        return m
    return _AllMean.apply(m, float(mesh.world))
