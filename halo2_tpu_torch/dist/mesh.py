"""Device meshes for multi-device proving (port of the JAX reference's
dist/mesh.py).

The reference shards global arrays over a `jax.sharding.Mesh` and lets
GSPMD insert the collectives.  Here a mesh is an ordered list of torch
devices, one per shard, and a row-sharded tensor is the list of this
process's slabs, slab i on mesh.devices[i].  Every sharded function is
written against two collectives, `all_gather` and `all_to_all`: inside a
process they are device-to-device copies; across the processes of a
`torch.distributed` group they are one collective call per exchange, with
the chunks staged in host memory under gloo and on the device otherwise.

A device may appear more than once (`Mesh([cuda:0] * 4)` is four shards on
one card, `make_mesh(n, "cpu")` n shards on the CPU), so no shard may hold
a view of another's memory: every slab these helpers return is a copy.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

ROW_AXIS = "rows"


def _indexed(d: torch.device) -> torch.device:
    """"cuda" as the current card's index, the way tensors name it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Shards numbered row-major over `shape` (so a 2-D (hosts, rows) mesh
    shards over both axes jointly).  `devices` are this process's shards;
    with a process group of P processes, process r holds shards r L ..
    (r + 1) L - 1 (L = len(devices), the same in every process)."""

    def __init__(self, devices: Sequence, axis_names=(ROW_AXIS,),
                 shape: Optional[Sequence[int]] = None, group=None):
        import torch.distributed as dist
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        self.group = group
        if group is None:
            self.procs, self.rank, self.backend = 1, 0, None
        else:
            self.procs = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = dist.get_backend(group)
        self.size = len(self.devices) * self.procs
        if shape is None:
            shape = ((self.size,) if len(self.axis_names) == 1
                     else (self.procs, len(self.devices)))
        shape = tuple(int(s) for s in shape)
        total = 1
        for s in shape:
            total *= s
        if len(shape) != len(self.axis_names) or total != self.size:
            raise ValueError(f"mesh shape {shape} over axes "
                             f"{self.axis_names} does not hold {self.size} "
                             f"shards")
        self.shape = dict(zip(self.axis_names, shape))

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def staging(self) -> torch.device:
        """Where chunks meet the process group: host memory under gloo
        (it has no CUDA all-to-all), the first local device otherwise."""
        return (torch.device("cpu") if self.backend == "gloo"
                else self.devices[0])

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}"
                f", procs={self.procs})")


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh of n devices of one process: cuda:0 .. cuda:n-1 (all
    visible cards when n is None), or n shards on the CPU.  Raises when
    fewer cards are visible than asked for: it never builds a smaller mesh
    and never drops to the CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"no mesh of {device} devices")
    have = torch.cuda.device_count()
    n = n_devices or have
    if n < 1 or have < n:
        raise ValueError(f"make_mesh({n_devices}) needs {n or 1} CUDA "
                         f"devices but {have} are visible")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def on_device(device: torch.device):
    """The context a shard's kernels launch in: its card made current (the
    kernels launch on the current card), nothing on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of t on `device`, never t itself."""
    return t.to(device, non_blocking=device.type == "cuda",
                copy=True).contiguous()


def shard_rows(mesh: Mesh, a: torch.Tensor, dim: int = 0) -> list:
    """This process's slabs of `a` (the same full value in every process),
    split into mesh.size equal slabs along `dim`."""
    dim = dim % a.dim()
    n = a.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards")
    m = n // mesh.size
    return [_copy_to(a.narrow(dim, (mesh.first_shard + i) * m, m), d)
            for i, d in enumerate(mesh.devices)]


def shard_columns(mesh: Mesh, a: torch.Tensor, axis_in_array: int = 1):
    """Slabs of a (cols, n, 8) column matrix, its rows sharded."""
    return shard_rows(mesh, a, axis_in_array)


def replicate(mesh: Mesh, a: torch.Tensor) -> list:
    """A copy of `a` on every local shard."""
    return [_copy_to(a, d) for d in mesh.devices]


def _across(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every process's `local` (same shape), stacked in rank order on the
    staging device: (procs, *local.shape)."""
    import torch.distributed as dist
    local = local.to(mesh.staging).contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.procs)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.stack(parts)


def gather_rows(mesh: Mesh, slabs: list, device=None, dim: int = 0):
    """The full tensor of row-sharded `slabs` on `device` (the first
    slab's by default), in every process."""
    device = torch.device(device) if device is not None else slabs[0].device
    dim = dim % slabs[0].dim()
    local = torch.cat([s.to(device) for s in slabs], dim)
    if mesh.group is None:
        return local
    parts = _across(mesh, local).to(device)
    return torch.cat(parts.unbind(0), dim)


def all_gather(mesh: Mesh, per_shard: list) -> list:
    """Every shard's value, for every local shard: per_shard holds one
    tensor a local shard, all of one shape; shard i gets (mesh.size,
    *shape) on its device, in global shard order."""
    local = torch.stack([t.to(mesh.staging) for t in per_shard])
    if mesh.group is not None:
        local = _across(mesh, local).flatten(0, 1)
    return [_copy_to(local, d) for d in mesh.devices]


def all_to_all(mesh: Mesh, slabs: list, split_dim: int,
               concat_dim: int) -> list:
    """The tiled all-to-all of `jax.lax.all_to_all(x, axes, split_dim,
    concat_dim, tiled=True)`: every shard splits its slab into mesh.size
    equal chunks along split_dim and sends chunk j to shard j; each shard
    concatenates what it receives along concat_dim in source order."""
    D, L = mesh.size, len(mesh.devices)
    nd = slabs[0].dim()
    split_dim, concat_dim = split_dim % nd, concat_dim % nd
    if slabs[0].shape[split_dim] % D:
        raise ValueError(f"dim {split_dim} of {tuple(slabs[0].shape)} does "
                         f"not split over {D} shards")
    chunks = [s.chunk(D, split_dim) for s in slabs]
    if mesh.group is None:
        return [torch.cat([chunks[s][t].to(dev) for s in range(L)],
                          concat_dim) for t, dev in enumerate(mesh.devices)]
    import torch.distributed as dist
    P = mesh.procs
    # send[q, s, t]: from local shard s to shard t of process q
    send = torch.stack([chunks[s][q * L + t].to(mesh.staging)
                        for q in range(P) for s in range(L)
                        for t in range(L)]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    # recv[q, s, t]: from shard s of process q to local shard t
    recv = recv.reshape((P * L, L) + tuple(chunks[0][0].shape))
    return [torch.cat([recv[g, t].to(dev) for g in range(P * L)],
                      concat_dim) for t, dev in enumerate(mesh.devices)]
