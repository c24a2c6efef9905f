"""MSM router and ragged driver, one device (counterpart of
parallel/msm.py).

`msm_device_maybe_sharded` is the single-device branch of the JAX
package's router of the same name: the v2 MSM (ops/msm2.py) takes one
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
as the JAX path's `te_add_tiled`. The multi-device paths come later.

`msm_device_mapped` is the base_map route: B scalar sets, each over its
own selection of rows of one table.

Scalars are (16, n) int32 canonical limbs for one set or (B, 16, n) for B
sets; one set is routed as the JAX package routes a 2-D scalar array, B
sets (B = 1 too) as a batch. Every function returns the sums as an (NC,
16, B) point tensor, B = 1 for one set.
"""

from __future__ import annotations

import torch

from ..util import next_power_of_two

from ..ops import kernels as kk
from ..ops import msm as v1
from ..ops import msm2
from ..ops import proj

# Below this a chunk is cheaper absorbed into the padded remainder.
_RAGGED_MIN = 1024
# The JAX package's single-device routing thresholds (its
# parallel/msm.py::msm_device_maybe_sharded): the v2 MSM from these
# widths, the v1 Pippenger below them.
V2_SINGLE_MIN = 1024
V2_BATCH_MIN = 256
V2_MAPPED_BATCH_MIN = 128


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
    coordinates."""
    batched = scal.dim() == 3
    sets = scal if batched else scal.unsqueeze(0)
    if uses_v2(sets.shape[-1], batched, base_map is not None):
        return msm_v2(spec, X, Y, inf, sets, base_map)
    out = msm_v1(spec, X, Y, inf, sets, base_map)
    return proj.from_jacobian(spec, out).to(torch.int32)


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
    scal: (16, n) or (B, 16, n) int32 canonical scalar limbs. Returns the
    sums as an (NC, 16, B) point tensor (ops/curve.py)."""
    n = X.shape[-1]
    chunks = []
    off = 0
    while n - off >= _RAGGED_MIN:
        size = 1 << ((n - off).bit_length() - 1)
        chunks.append((off, size))
        off += size
    acc = None
    for o, size in chunks:
        part = msm_device_maybe_sharded(
            spec, X[:, o:o + size], Y[:, o:o + size], inf[o:o + size],
            scal[..., o:o + size])
        acc = part if acc is None else kk.add(spec, acc, part)
    rem = n - off
    if rem:
        m = next_power_of_two(rem)
        if chunks:
            m = max(m, _RAGGED_MIN)
        pad = m - rem
        part = msm_device_maybe_sharded(
            spec,
            torch.nn.functional.pad(X[:, off:], (0, pad)),
            torch.nn.functional.pad(Y[:, off:], (0, pad)),
            torch.nn.functional.pad(inf[off:], (0, pad), value=True),
            torch.nn.functional.pad(scal[..., off:], (0, pad)),
        )
        acc = part if acc is None else kk.add(spec, acc, part)
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
