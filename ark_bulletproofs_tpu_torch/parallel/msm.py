"""Ragged MSM driver, one device (counterpart of parallel/msm.py).

`msm_device_ragged` splits an arbitrary-length base axis into its binary
decomposition exactly as ark_bulletproofs_tpu/parallel/msm.py does:
largest power-of-two chunk first while the rest stays >= _RAGGED_MIN,
then the remainder padded to a power of two (at least _RAGGED_MIN once
a chunk exists, at least V2_MIN_N always). Each chunk runs the v2 MSM.
The chunk partials are added with the add kernel of the curve's model and
stay in the device coordinates: `rcb_double_k_add` (k = 0) on a
short-Weierstrass curve, where the JAX path converted them to Jacobian and
summed with its `sw_add_tiled` kernel instead, and `te_double_k_add`
(k = 0) on a twisted-Edwards one, as the JAX path's `te_add_tiled`. The multi-device paths come later.

`msm_device_mapped` is the base_map route of the JAX package's
`msm_device_maybe_sharded`: B scalar sets, each over its own selection of
rows of one table.
"""

from __future__ import annotations

import torch

from ..util import next_power_of_two

from ..ops import kernels as kk
from ..ops import msm2

# Below this a chunk is cheaper absorbed into the padded remainder.
_RAGGED_MIN = 1024


def msm_device_ragged(spec, X, Y, inf, scal) -> torch.Tensor:
    """X, Y: (16, n) int32 affine Montgomery limbs; inf: (n,) bool;
    scal: (B, 16, n) int32 canonical scalar limbs. Returns the B sums as an
    (NC, 16, B) point tensor (ops/curve.py)."""
    n = X.shape[-1]
    chunks = []
    off = 0
    while n - off >= _RAGGED_MIN:
        size = 1 << ((n - off).bit_length() - 1)
        chunks.append((off, size))
        off += size
    acc = None
    for o, size in chunks:
        part = msm2.msm2_impl(
            spec, msm2.window_bits(size), X[:, o:o + size],
            Y[:, o:o + size], inf[o:o + size], scal[..., o:o + size],
        )
        acc = part if acc is None else kk.add(spec, acc, part)
    rem = n - off
    if rem:
        m = max(next_power_of_two(rem), msm2.V2_MIN_N)
        if chunks:
            m = max(m, _RAGGED_MIN)
        pad = m - rem
        part = msm2.msm2_impl(
            spec, msm2.window_bits(m),
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
    canonical limbs; base_map: (B, n) integer rows. The scalar axis pads
    to a power of two of at least V2_MIN_N with zero scalars on row 0 (the
    JAX package sends widths below that to its v1 Pippenger, which the
    port does not have). Returns the B sums as an (NC, 16, B) point
    tensor."""
    n = scal.shape[-1]
    m = max(next_power_of_two(n), msm2.V2_MIN_N)
    if m != n:
        scal = torch.nn.functional.pad(scal, (0, m - n))
        base_map = torch.nn.functional.pad(base_map, (0, m - n))
    return msm2.msm2_impl(spec, msm2.window_bits(m), X, Y, inf, scal,
                          base_map)
