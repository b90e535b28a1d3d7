"""Device mesh construction and its collectives.

The reference (pg_strom_tpu/parallel/mesh.py) builds a jax `Mesh` and runs
one `shard_map` step over it: one process plans the query and every
local device runs the same program on its shard.  The port keeps that
single controller.  A `Mesh` here is a list of `torch.device`s, one per
mesh position, and a step is host code that runs each shard's work on its
device and moves blocks between shards with the two collectives below —
plain functions over the list of per-shard tensors, along one named axis,
with the semantics of `lax.all_to_all(x, ax, 0, 0, tiled=False)` and
`lax.all_gather(x, ax, tiled=...)`.  A block moves with
`.to(devices[i], non_blocking=True)`: a peer copy over NVLink between
GPUs, a same-device copy on a virtual mesh.

Axis naming conventions (as the reference):

  dp              — flat data/shuffle parallelism across all shards
  hosts x chips   — 2D hierarchical mesh: the shuffle exchange runs in two
                    stages, all_to_all over "chips" then over "hosts", so
                    only the host-mismatched fraction of rows crosses the
                    slow inter-host fabric.

`pg_strom.dist_mesh_hosts` > 1 selects the 2D shape; the tests run it as
(2, 4) over 8 shards.  The shard count is `config.mesh_shards`: 0 gives one
shard per visible device (`torch.cuda.device_count()` on "cuda", 1 on
"cpu"); N > 0 gives N shards, round-robin over the visible devices — the
port's analog of the reference rig's
`--xla_force_host_platform_device_count=8`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch


class Mesh:
    """`devices` row-major over `shape`, one torch.device per position."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_names: tuple, dims: tuple):
        if len(axis_names) != len(dims):
            raise ValueError("one size per mesh axis")
        n = 1
        for d in dims:
            n *= d
        if n != len(devices):
            raise ValueError(f"{len(devices)} devices for a {dims} mesh")
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.dims = tuple(dims)
        self.shape = dict(zip(self.axis_names, self.dims))

    @property
    def ndev(self) -> int:
        return len(self.devices)

    def peers(self, s: int, axis: str) -> list[int]:
        """The shards along `axis` through shard s, in axis order."""
        k = self.axis_names.index(axis)
        stride = 1
        for d in self.dims[k + 1:]:
            stride *= d
        pos = (s // stride) % self.dims[k]
        base = s - pos * stride
        return [base + j * stride for j in range(self.dims[k])]

    def index(self, s: int, axis: str) -> int:
        """Shard s's position along `axis`."""
        return self.peers(s, axis).index(s)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices]})")


def on(dev: torch.device):
    """Context that makes `dev` the current CUDA device (the ctypes kernel
    wrappers launch on the current device and stream); a no-op on the
    CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def per_shard(mesh: Mesh, fn: Callable, *shard_args) -> list:
    """[fn(s, *(a[s] for a in shard_args)) for each shard s], each on its
    shard's device."""
    out = []
    for s, dev in enumerate(mesh.devices):
        with on(dev):
            out.append(fn(s, *(a[s] for a in shard_args)))
    return out


def all_to_all(xs: Sequence[torch.Tensor], mesh: Mesh,
               axis: str) -> list[torch.Tensor]:
    """`lax.all_to_all(x, axis, 0, 0, tiled=False)`: every shard's x has a
    leading dimension of the axis size; out[s][j] is the block x[s_pos]
    that peer j along the axis holds, where s_pos is s's own position."""
    out = []
    for s, dev in enumerate(mesh.devices):
        me = mesh.index(s, axis)
        out.append(torch.stack([xs[p][me].to(dev, non_blocking=True)
                                for p in mesh.peers(s, axis)]))
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               tiled: bool = False) -> list[torch.Tensor]:
    """`lax.all_gather(x, axis, tiled=...)`: every shard receives its
    peers' blocks along the axis, in axis order, stacked on a new leading
    dimension (or concatenated on dimension 0 when tiled)."""
    join = torch.cat if tiled else torch.stack
    return [join([xs[p].to(dev, non_blocking=True)
                  for p in mesh.peers(s, axis)])
            for s, dev in enumerate(mesh.devices)]


def _devices(n: int | None = None) -> list[torch.device]:
    """The mesh positions: config.mesh_shards shards (0 = one per visible
    device) on config.device, round-robin over its visible devices; the
    first n of them when n is given."""
    from ..config import config
    from ..exec.devcache import device
    dev = device()
    if dev.type == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [dev]
    k = int(getattr(config, "mesh_shards", 0) or 0)
    k = k if k > 0 else len(visible)
    devs = [visible[i % len(visible)] for i in range(k)]
    if n is not None:
        if len(devs) < n:
            raise RuntimeError(
                f"need {n} mesh shards, have {len(devs)} "
                f"(set pg_strom.mesh_shards = N for N shards over the "
                f"visible devices)")
        devs = devs[:n]
    return devs


def mesh_size() -> int:
    """How many shards the configured mesh has (the reference's
    len(jax.devices()))."""
    return len(_devices())


def get_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """Flat 1D mesh over all (or the first n) shards."""
    devs = _devices(n_devices)
    return Mesh(devs, (axis,), (len(devs),))


def get_mesh2(n_hosts: int, n_chips: int | None = None) -> Mesh:
    """2D ("hosts", "chips") mesh: n_hosts rows of n_chips shards each."""
    devs = _devices(None)
    if n_chips is None:
        if len(devs) % n_hosts:
            raise RuntimeError(
                f"{len(devs)} devices not divisible by {n_hosts} hosts")
        n_chips = len(devs) // n_hosts
    need = n_hosts * n_chips
    if len(devs) < need:
        raise RuntimeError(f"need {need} devices, have {len(devs)}")
    return Mesh(devs[:need], ("hosts", "chips"), (n_hosts, n_chips))


def mesh_for_config(n_devices: int | None = None) -> Mesh:
    """Mesh per the GUCs: dist_mesh_hosts > 1 -> 2D, else flat.

    A hosts setting the shard count can't honor (fewer shards than hosts,
    or not divisible) degrades to the flat mesh instead of failing the
    query — the GUC is a layout hint (the reference's rule)."""
    from ..config import config
    h = int(getattr(config, "dist_mesh_hosts", 1) or 1)
    if h > 1:
        devs = _devices(n_devices)
        if len(devs) >= h and len(devs) % h == 0:
            return Mesh(devs, ("hosts", "chips"), (h, len(devs) // h))
    return get_mesh(n_devices)
