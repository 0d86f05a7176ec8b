"""Meshes that span processes (port of the JAX reference's
dist/multihost.py, over `torch.distributed`).

Every process runs the same prover script: `init_multihost` joins the
process group, and a mesh built with `global_mesh` or `hybrid_mesh` holds
this process's devices as its slice of the global shard order (process r
holds shards r L .. (r + 1) L - 1).  The sharded functions (dist/ntt.py,
dist/msm.py, dist/scan.py) take such a mesh unchanged: their exchanges
then cross processes, as one `all_to_all_single` or `all_gather` per
exchange.

Nothing here discovers a cluster: the caller names the rendezvous
(`init_method`, e.g. "tcp://localhost:29500" or "file:///tmp/rdv"), the
world size and the rank.  The backend defaults to nccl with CUDA and gloo
on the CPU; under gloo the chunks of CUDA slabs go through host memory.
With nccl each process makes its own card current before it starts
(`torch.cuda.set_device`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .._build import resolve_device
from .mesh import ROW_AXIS, Mesh, gather_rows, replicate, shard_rows


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Join (or create) the process group: `backend` "nccl" with CUDA and
    "gloo" on the CPU unless named; with no init_method the rendezvous
    comes from the MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    environment."""
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def _local_devices(devices: Optional[Sequence]) -> list:
    """`devices`, or else this process's current card: with no card
    visible that raises, and the CPU is had only by naming it
    (devices=["cpu"] * n)."""
    if devices is not None:
        return list(devices)
    resolve_device("cuda")
    return [torch.device("cuda", torch.cuda.current_device())]


def global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every process's devices (this process's `devices`,
    by default its current card), each process's shards contiguous in the
    global order."""
    import torch.distributed as dist
    return Mesh(_local_devices(devices), group=dist.group.WORLD)


def hybrid_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """2-D (processes, local devices) mesh; the sharded functions shard
    over both axes jointly, so an exchange stays within a process except at
    process boundaries."""
    import torch.distributed as dist
    devs = _local_devices(devices)
    return Mesh(devs, ("hosts", ROW_AXIS), (dist.get_world_size(), len(devs)),
                group=dist.group.WORLD)


def put_replicated(mesh: Mesh, arr) -> list:
    """Host data -> a copy on every local shard (every process passes the
    same value)."""
    return replicate(mesh, torch.as_tensor(arr))


def put_row_sharded(mesh: Mesh, arr) -> list:
    """Host data (the full value, the same in every process) -> this
    process's row slabs."""
    return shard_rows(mesh, torch.as_tensor(arr))


def allgather_rows(mesh: Mesh, slabs: list, device=None):
    """Row slabs -> the full tensor in every process."""
    return gather_rows(mesh, slabs, device)
