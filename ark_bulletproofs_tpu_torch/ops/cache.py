"""Device-resident generator tables (counterpart of ops/cache.py).

Generator tables are deterministic and reused across proofs, so their
points are converted to Montgomery limbs and moved to the device once
per (table, curve, size, device), keyed weakly on the table object; so is
the 2^i B | 2^i B_blinding table of a twisted-Edwards PedersenGens. The
device IPA's [G | H] tables (for its prover and the device IPA verifier)
and the batch IPA's 2^i B table are kept by value (`keyed`: the
generator vectors themselves, or the point) in a small LRU of
KEYED_SIZE entries. Every key holds the content that the entry was made
from, never an object's id, which Python reuses.
`from_numpy` takes tables in the JAX package's numpy layout
(ark_bulletproofs_tpu/ops/curve.py::affine_to_device: (m, 16) uint32
Montgomery limbs and an (m,) identity mask) to the port's layout.
"""

from __future__ import annotations

import collections
import weakref

import numpy as np
import torch

from . import kernels as kk
from .curve import affine_to_device, spec_for
from .limbs import N_LIMBS, ints_to_limbs, limbs_from_numpy

_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_BY_KEY: "collections.OrderedDict" = collections.OrderedDict()
KEYED_SIZE = 16


def from_numpy(X: np.ndarray, Y: np.ndarray, inf: np.ndarray, device):
    """(m, 16) uint32 X, Y and (m,) bool inf -> the port's (16, m) int32
    X, Y and (m,) bool inf on `device`."""
    return (
        limbs_from_numpy(X, device),
        limbs_from_numpy(Y, device),
        torch.from_numpy(np.asarray(inf, dtype=bool)).to(device),
    )


def _cached(owner, key, make):
    per = _CACHE.setdefault(owner, {})
    hit = per.get(key)
    if hit is None:
        hit = make()
        per[key] = hit
    return hit


def keyed(key, make):
    """make(), kept under a hashable key; the least recently used entry
    goes past KEYED_SIZE."""
    hit = _BY_KEY.get(key)
    if hit is None:
        hit = _BY_KEY[key] = make()
        while len(_BY_KEY) > KEYED_SIZE:
            _BY_KEY.popitem(last=False)
    else:
        _BY_KEY.move_to_end(key)
    return hit


def ipa_table(curve, G_vec, H_vec, device):
    """(X, Y, inf) of [G | H] for the device IPA (2n points), kept by the
    vectors' content."""
    key = ("ipa", curve.name, tuple(G_vec), tuple(H_vec), str(device))
    return keyed(key, lambda: affine_to_device(
        curve, list(G_vec) + list(H_vec), device))


def bp_table(bp_gens, curve, n: int, device):
    """(X, Y, inf) for share 0's [G(n) | H(n)] (2n points)."""

    def make():
        gens = bp_gens.share(0)
        return affine_to_device(curve, gens.G(n) + gens.H(n), device)

    return _cached(bp_gens, (curve.name, n, str(device)), make)


def pc_pair(pc_gens, curve, device):
    """(X, Y, inf) for [B, B_blinding]."""
    return _cached(
        pc_gens, (curve.name, "pc", str(device)),
        lambda: affine_to_device(curve, [pc_gens.B, pc_gens.B_blinding],
                                 device),
    )


def full_table(bp_gens, pc_gens, curve, device):
    """(X, Y, inf, cap) for [G(cap) | H(cap) | B | B_blinding] at cap =
    bp_gens.gens_capacity: one cached upload that serves every prover
    phase MSM through base_map row indices (the phase bases are always
    slices of this table)."""
    cap = bp_gens.gens_capacity

    def make():
        gens = bp_gens.share(0)
        pts = gens.G(cap) + gens.H(cap) + [pc_gens.B, pc_gens.B_blinding]
        return (*affine_to_device(curve, pts, device), cap)

    return _cached(bp_gens, (curve.name, "full", cap, pc_gens.B,
                             pc_gens.B_blinding, str(device)), make)


def commit_table(pc_gens, device):
    """(4, 16, 512) extended points for the device Pedersen batch of a
    twisted-Edwards curve (ops/prove.py): lane i holds 2^i B, lane 256 + i
    2^i B_blinding (i < 256). One `te_double` launch of 255 steps on two
    lanes and one copy into that layout, once per (pc_gens, device) (the
    JAX package's `_q_doubles` scan)."""
    curve = pc_gens.curve

    def make():
        spec, f = spec_for(curve), curve.fq
        ext = [curve.to_proj(P) for P in (pc_gens.B, pc_gens.B_blinding)]
        P = torch.stack([ints_to_limbs([e[c] * f.R % f.p for e in ext],
                                       device) for c in range(4)])
        rows = kk.te_double(spec, P, 255)  # (4, 16, 256, 2)
        return rows.transpose(-1, -2).reshape(4, N_LIMBS, 512)

    return _cached(pc_gens, (curve.name, "commit", str(device)), make)
