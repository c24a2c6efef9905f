"""MSM router, ragged driver and sharded MSM (counterpart of
parallel/msm.py).

`msm_device_maybe_sharded` is the JAX package's router of the same name.
On one device: the v2 MSM (ops/msm2.py) takes one
scalar set of at least V2_SINGLE_MIN terms, B sets of at least
V2_BATCH_MIN, base_map batches of at least V2_MAPPED_BATCH_MIN (or one
base_map set of V2_SINGLE_MIN); every other MSM runs the v1 Pippenger
(ops/msm.py::msm_impl). Widths are powers of two; the v2 branch pads to
msm2.V2_MIN_N where a base_map batch is narrower. Both engines' sums
leave the router in one system, the port's device coordinates
(ops/curve.py): RCB projective on a short-Weierstrass curve, where v1's
Jacobian points are converted (`proj.from_jacobian`), and extended on a
twisted-Edwards one. The JAX router returns Jacobian points from both
engines instead; the affine points are the same.

`msm_device_ragged` splits an arbitrary-length base axis into its binary
decomposition exactly as ark_bulletproofs_tpu/parallel/msm.py does:
largest power-of-two chunk first while the rest stays >= _RAGGED_MIN,
then the remainder padded to a power of two, at least _RAGGED_MIN once a
chunk exists (so no sum mixes partials of the two engines: every piece of
a chunked MSM is v2-wide). Each piece goes through the router. The
partials are added with the add kernel of the curve's model in the device
coordinates: `rcb_double_k_add` (k = 0) on a short-Weierstrass curve,
where the JAX path summed Jacobian partials with its `sw_add_tiled`
kernel instead, and `te_double_k_add` (k = 0) on a twisted-Edwards one,
as the JAX path's `te_add_tiled`.

The sharded half (the JAX package's shard_map programs): under an engine
mesh (parallel/mesh.py) the router's mesh branch takes an MSM without a
base_map whose n terms split evenly over the D > 1 devices into shards of
at least SHARD_MIN. Each device runs the one-device router on its block
of points and scalars (`msm_one_device`: `uses_v2` picks v2 or v1 by the
shard's width, on every curve; `sharded_msm_fn` forces v1,
`sharded_msm2_device_fn` v2, `sharded_msm_serial_fn` the bit-serial MSM
of ops/msm_serial.py), and `_reduce_partials` moves the D (NC, 16, B)
partials to mesh.devices[0] and adds them there in shard order 0..D-1
(the JAX fori_loop's), so every run returns identical limbs. Inputs may
be plain tensors or Pieces of any layout: a shard reads its block where
it lies and copies only what lies elsewhere (`mesh.take`). The ragged
driver shards each chunk by itself, so the verifiers' mega-MSMs and the
batch verifier ride the mesh with no code of their own.

`msm_device_mapped` is the base_map route: B scalar sets, each over its
own selection of rows of one table.

Scalars are (16, n) int32 canonical limbs for one set or (B, 16, n) for B
sets; one set is routed as the JAX package routes a 2-D scalar array, B
sets (B = 1 too) as a batch. Every function returns the sums as an (NC,
16, B) point tensor, B = 1 for one set.
"""

from __future__ import annotations

import torch

from .. import engine
from ..util import next_power_of_two

from ..ops import kernels as kk
from ..ops import msm as v1
from ..ops import msm2
from ..ops import proj
from . import mesh as pmesh

# Below this a chunk is cheaper absorbed into the padded remainder.
_RAGGED_MIN = 1024
# The JAX package's single-device routing thresholds (its
# parallel/msm.py::msm_device_maybe_sharded): the v2 MSM from these
# widths, the v1 Pippenger below them.
V2_SINGLE_MIN = 1024
V2_BATCH_MIN = 256
V2_MAPPED_BATCH_MIN = 128
# The mesh branch's smallest shard (the JAX package's ABTPU_SHARD_MIN
# default).
SHARD_MIN = 256


def uses_v2(n: int, batched: bool, mapped: bool) -> bool:
    """Whether the router sends an n-term MSM to the v2 MSM: `batched` for
    a (B, 16, n) scalar array, `mapped` with a base_map."""
    if n < 1 or n & (n - 1):
        return False
    wide = V2_MAPPED_BATCH_MIN if mapped else V2_BATCH_MIN
    return n >= V2_SINGLE_MIN or (batched and n >= wide)


def msm_device_maybe_sharded(spec, X, Y, inf, scal,
                             base_map=None) -> torch.Tensor:
    """One power-of-two-wide MSM on the engine the JAX package's router
    picks. X, Y: (16, m) int32 affine Montgomery limbs; inf: (m,) bool;
    scal: (16, n) or (B, 16, n) int32 canonical limbs; base_map (B, n),
    optional, as in msm2.msm2_impl. Returns (NC, 16, B) in the device
    coordinates. Under an engine mesh the mesh branch may take it
    (`shard_width`); X, Y, inf and scal may then be Pieces, which the
    one-device branch gathers on X's (first) device."""
    if base_map is None:
        mesh = engine.active_mesh()
        if shard_width(mesh, pmesh.width(scal)):
            return msm_sharded_device(spec, mesh, X, Y, inf, scal)
    if any(isinstance(t, pmesh.Pieces) for t in (X, Y, inf, scal)):
        X, Y, inf, scal = (pmesh.gather(t, X.device)
                           for t in (X, Y, inf, scal))
    return msm_one_device(spec, X, Y, inf, scal, base_map)


def msm_one_device(spec, X, Y, inf, scal, base_map=None) -> torch.Tensor:
    """The router's one-device branch (tensors on one device): the v2 MSM
    where `uses_v2`, else v1; (NC, 16, B) in the device coordinates."""
    batched = scal.dim() == 3
    sets = _sets(scal)
    if uses_v2(sets.shape[-1], batched, base_map is not None):
        return msm_v2(spec, X, Y, inf, sets, base_map)
    out = msm_v1(spec, X, Y, inf, sets, base_map)
    return proj.from_jacobian(spec, out).to(torch.int32)


def _sets(scal: torch.Tensor) -> torch.Tensor:
    """(16, n) or (B, 16, n) scalars as (B, 16, n)."""
    return scal if scal.dim() == 3 else scal.unsqueeze(0)


def msm_v2(spec, X, Y, inf, scal, base_map=None) -> torch.Tensor:
    """The v2 MSM at its window size, B = scal.shape[0] sets padded with
    zero scalars (on row 0) to at least msm2.V2_MIN_N terms; (NC, 16, B)
    in the device coordinates."""
    n = scal.shape[-1]
    m = max(n, msm2.V2_MIN_N)
    if m != n:
        scal = torch.nn.functional.pad(scal, (0, m - n))
        if base_map is not None:
            base_map = torch.nn.functional.pad(base_map, (0, m - n))
    return msm2.msm2_impl(spec, msm2.window_bits(m), X, Y, inf, scal,
                          base_map)


def msm_v1(spec, X, Y, inf, scal, base_map=None) -> torch.Tensor:
    """The v1 Pippenger at its window size; (NC, 16, B) in the model
    coordinates (Jacobian on a short-Weierstrass curve)."""
    return v1.msm_impl(spec, v1._window_bits(scal.shape[-1]), X, Y, inf,
                       scal, base_map)


def msm_device_ragged(spec, X, Y, inf, scal) -> torch.Tensor:
    """X, Y: (16, n) int32 affine Montgomery limbs; inf: (n,) bool;
    scal: (16, n) or (B, 16, n) int32 canonical scalar limbs (each a
    tensor or, under a mesh, a Pieces). Returns the sums as an (NC, 16, B)
    point tensor (ops/curve.py)."""
    n = pmesh.width(X)
    chunks = []
    off = 0
    while n - off >= _RAGGED_MIN:
        size = 1 << ((n - off).bit_length() - 1)
        chunks.append((off, size))
        off += size
    rem = n - off
    if rem:
        m = next_power_of_two(rem)
        if chunks:
            m = max(m, _RAGGED_MIN)
        chunks.append((off, m))
    acc = None
    for o, size in chunks:
        w = min(size, n - o)
        part = msm_device_maybe_sharded(spec, *(
            pmesh.pad(pmesh.narrow(t, o, w), size - w, fill)
            if size > w else pmesh.narrow(t, o, w)
            for t, fill in ((X, 0), (Y, 0), (inf, True), (scal, 0))))
        acc = part if acc is None else kk.add(spec, acc,
                                              part.to(acc.device))
    return acc


def msm_device_mapped(spec, X, Y, inf, scal, base_map) -> torch.Tensor:
    """B MSMs over per-set selections of table rows: scalar j of set b
    multiplies row base_map[b, j] of (X, Y, inf). scal: (B, 16, n) int32
    canonical limbs; base_map: (B, n) integer rows. The scalar axis pads to
    a power of two with zero scalars on row 0, then the router picks the
    engine. Returns the B sums as an (NC, 16, B) point tensor."""
    n = scal.shape[-1]
    m = next_power_of_two(n)
    if m != n:
        scal = torch.nn.functional.pad(scal, (0, m - n))
        base_map = torch.nn.functional.pad(base_map, (0, m - n))
    return msm_device_maybe_sharded(spec, X, Y, inf, scal, base_map)


# --- the sharded MSM (mesh branch) ------------------------------------------


def shard_width(mesh, n: int) -> int:
    """n / D where the mesh branch takes an n-term MSM (D > 1 devices, D
    divides n, shards of at least SHARD_MIN terms), else 0."""
    if mesh is None or mesh.size < 2 or n % mesh.size:
        return 0
    b = n // mesh.size
    return b if b >= SHARD_MIN else 0


def _local_v1(spec, X, Y, inf, scal) -> torch.Tensor:
    return proj.from_jacobian(spec, msm_v1(spec, X, Y, inf, _sets(scal))).to(
        torch.int32)


def _local_v2(spec, X, Y, inf, scal) -> torch.Tensor:
    sets = _sets(scal)
    return msm2.msm2_impl(spec, msm2.window_bits(sets.shape[-1]), X, Y, inf,
                          sets)


def _local_serial(spec, X, Y, inf, scal) -> torch.Tensor:
    from ..ops import msm_serial

    return msm_serial.msm_serial_impl(spec, X, Y, inf, _sets(scal))


def _reduce_partials(spec, mesh, parts: list) -> torch.Tensor:
    """The D shards' (NC, 16, B) partials moved to mesh.devices[0] and
    added there in shard order (one `kk.add` launch each): one reduce
    order, so every rank and every run returns identical limbs."""
    root = mesh.devices[0]
    acc = parts[0].to(root)
    for p in parts[1:]:
        acc = kk.add(spec, acc, p.to(root))
    return acc


def msm_sharded_device(spec, mesh, X, Y, inf, scal,
                       local=msm_one_device) -> torch.Tensor:
    """The n-term MSM over the mesh: shard d takes columns [d b, (d + 1)
    b) of X, Y, inf and scal (tensors or Pieces; b = n / D) to
    mesh.devices[d] and runs `local` there; the partials are reduced on
    mesh.devices[0]. scal (16, n) or (B, 16, n); (NC, 16, B) out."""
    D, n = mesh.size, pmesh.width(X)
    if n % D or pmesh.width(scal) != n:
        raise ValueError(f"sharded msm: {n} points, {pmesh.width(scal)} "
                         f"scalars over {D} devices")
    b = n // D
    parts = []
    for d, dev in enumerate(mesh.devices):
        Xd, Yd, Id, Sd = (pmesh.take(t, dev, d * b, b)
                          for t in (X, Y, inf, scal))
        kk.same_device(Xd, Yd, Id, Sd)
        parts.append(local(spec, Xd, Yd, Id, Sd))
    return _reduce_partials(spec, mesh, parts)


def sharded_msm_fn(spec, mesh):
    """(X, Y, inf, scal) -> the sum over the mesh, the v1 Pippenger on
    every shard (the JAX `sharded_msm_fn` and `sharded_msm_device_fn`:
    torch reads one set or B sets from scal's rank)."""
    return lambda X, Y, inf, scal: msm_sharded_device(
        spec, mesh, X, Y, inf, scal, _local_v1)


def sharded_msm2_device_fn(spec, mesh):
    """The same with the v2 MSM on every shard (shards of a power of two
    >= msm2.V2_MIN_N terms)."""
    return lambda X, Y, inf, scal: msm_sharded_device(
        spec, mesh, X, Y, inf, scal, _local_v2)


def sharded_msm_serial_fn(spec, mesh):
    """The same with the bit-serial MSM (ops/msm_serial.py) on every
    shard."""
    return lambda X, Y, inf, scal: msm_sharded_device(
        spec, mesh, X, Y, inf, scal, _local_serial)


def _prepare(curve, bases: list, scalars: list[int], mesh):
    """Host points and scalars -> (spec, X, Y, inf, scal) as Pieces of
    the mesh's blocks, padded with identities and zero scalars to D times
    a power of two; each block goes from the host to its device."""
    from ..ops.curve import affine_to_device, spec_for
    from ..ops.limbs import ints_to_limbs

    D, n = mesh.size, len(bases)
    m = D * next_power_of_two(-(-max(n, D) // D))
    p = curve.fr.p
    X, Y, inf = affine_to_device(curve, list(bases) + [None] * (m - n),
                                 "cpu")
    scal = ints_to_limbs([s % p for s in scalars] + [0] * (m - n))
    return (spec_for(curve),
            *(pmesh.shard_rows(mesh, t) for t in (X, Y, inf, scal)))


def msm_sharded(curve, bases: list, scalars: list[int], mesh):
    """Host-facing MSM over the mesh, v1 on every shard (affine int points
    in and out)."""
    from ..ops.curve import point_to_host

    if not bases:
        return curve.zero()
    spec, *args = _prepare(curve, bases, scalars, mesh)
    return point_to_host(curve, sharded_msm_fn(spec, mesh)(*args))


def msm_sharded_serial(curve, bases: list, scalars: list[int], mesh):
    """Host-facing MSM over the mesh, the bit-serial MSM on every shard."""
    from ..ops.curve import point_to_host

    if not bases:
        return curve.zero()
    spec, *args = _prepare(curve, bases, scalars, mesh)
    return point_to_host(curve, sharded_msm_serial_fn(spec, mesh)(*args))
