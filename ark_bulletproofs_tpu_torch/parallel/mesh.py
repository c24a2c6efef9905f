"""Device meshes of the port (counterpart of
ark_bulletproofs_tpu/parallel/mesh.py).

A `Mesh` is an ordered tuple of torch devices on one (data) axis:
points and protocol vectors are cut into D contiguous blocks along their
last (point) axis, block d on mesh.devices[d], and every device works on
its own block. A device may repeat: `make_mesh(devices=["cuda:0"] * 4)`
runs four shards on one card, and `["cpu"] * 8` is the CPU counterpart
of the JAX suite's eight virtual CPU devices. `make_mesh()` with no
devices named builds over every CUDA card and raises where there is none;
a CPU mesh is only ever built from devices named "cpu".

A sharded vector is a `Pieces`: the consecutive pieces of one logical
(..., n) tensor's last axis, each a tensor on its own device.
`shard_rows` cuts a tensor into the mesh's D equal blocks (the JAX
package's `data_sharding`), `replicate` puts a copy on every device (its
`replicated`). `narrow`, `pad`, `take` and `gather` work on a Pieces and
on a plain tensor alike: `take(x, dev, lo, size)` brings columns [lo, lo +
size) to dev and moves only the pieces that lie elsewhere, as GSPMD moves
the part of a sharded operand that a shard reads. `shard_numpy` carries
the JAX package's (m, 16) tables across as sharded blocks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """D devices on the data axis. Across processes (parallel/multihost.py)
    the devices are every rank's, rank-major, and this process owns the
    `local_devices` block of them."""

    devices: tuple
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_devices(self) -> tuple:
        per = self.size // self.process_count
        return self.devices[self.process_index * per:
                            (self.process_index + 1) * per]


def _device(d) -> torch.device:
    """A mesh device: "cpu" (an index is kept: tests name "cpu:d" to
    tell the blocks apart), or a CUDA card that exists, with its index."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d} requested but "
                               "torch.cuda.is_available() is False")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {d}: only "
                             f"{torch.cuda.device_count()} cards")
    elif d.type != "cpu":
        raise ValueError(f"unsupported mesh device {d}")
    return d


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over `devices` (names or torch devices; repeats allowed),
    or with none named over the CUDA cards; the first n_devices of them
    when given. Raises when no card is there and no device is named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card (torch.cuda.is_available() is "
                "False); name the devices, e.g. devices=['cpu'] * 8, to "
                "build a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f"make_mesh: {n_devices} of {len(devs)} "
                             "devices")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"make_mesh: mixed device types {devs}")
    return Mesh(devs)


class Pieces:
    """One logical (..., n) tensor as the consecutive pieces of its last
    axis, each a tensor on its own device (leading axes alike)."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)
        if not self.parts:
            raise ValueError("Pieces: no parts")
        lead = self.parts[0].shape[:-1]
        if any(p.shape[:-1] != lead for p in self.parts):
            raise ValueError("Pieces: leading axes differ")

    @property
    def shape(self) -> tuple:
        return (*self.parts[0].shape[:-1],
                sum(p.shape[-1] for p in self.parts))

    @property
    def device(self) -> torch.device:
        """The first piece's device, where a gathered copy goes."""
        return self.parts[0].device


def parts(x) -> tuple:
    """A Pieces' pieces, or a tensor alone."""
    return x.parts if isinstance(x, Pieces) else (x,)


def width(x) -> int:
    return x.shape[-1]


def narrow(x, lo: int, size: int):
    """Columns [lo, lo + size) of a tensor (a view) or of a Pieces (the
    overlapping pieces, cut; nothing moves)."""
    if isinstance(x, torch.Tensor):
        return x[..., lo:lo + size]
    out, off = [], 0
    for p in x.parts:
        w = p.shape[-1]
        a, b = max(lo, off), min(lo + size, off + w)
        if a < b:
            out.append(p[..., a - off:b - off])
        off += w
    return Pieces(out)


def pad(x, extra: int, value=0):
    """x with `extra` columns of `value` appended (on the last piece's
    device)."""
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.pad(x, (0, extra), value=value)
    last = x.parts[-1]
    return Pieces([*x.parts, torch.full((*last.shape[:-1], extra), value,
                                        dtype=last.dtype,
                                        device=last.device)])


def take(x, dev, lo: int, size: int) -> torch.Tensor:
    """Columns [lo, lo + size) of x as one contiguous tensor on dev: a
    piece already there is read in place, the others are copied."""
    moved = [p.to(dev) for p in parts(narrow(x, lo, size))]
    out = moved[0] if len(moved) == 1 else torch.cat(moved, dim=-1)
    return out.contiguous()


def gather(x, dev) -> torch.Tensor:
    """All of x on dev."""
    return take(x, dev, 0, width(x))


def shard_rows(mesh: Mesh, t) -> Pieces:
    """Cut the last axis of a (..., n) tensor (or Pieces) into the mesh's
    D contiguous blocks, block d on mesh.devices[d]; D must divide n."""
    D, n = mesh.size, width(t)
    if n % D:
        raise ValueError(f"shard_rows: {n} columns over {D} devices")
    b = n // D
    return Pieces([take(t, dev, d * b, b)
                   for d, dev in enumerate(mesh.devices)])


def replicate(mesh: Mesh, t: torch.Tensor) -> tuple:
    """A copy of t on every device of the mesh (one for a repeated
    device)."""
    return tuple(t.to(dev) for dev in mesh.devices)


def shard_numpy(mesh: Mesh, X: np.ndarray, Y: np.ndarray, inf: np.ndarray):
    """The JAX package's table layout ((m, 16) uint32 Montgomery limbs X,
    Y and an (m,) identity mask, as its ops/curve.py::affine_to_device
    gives them) -> the port's (16, m) int32 X, Y and (m,) bool inf, each
    a Pieces of the mesh's blocks; each block goes from the host straight
    to its device."""
    from ..ops.cache import from_numpy

    return tuple(shard_rows(mesh, t) for t in from_numpy(X, Y, inf, "cpu"))
