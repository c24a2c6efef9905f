"""Pedersen commitment bases and Bulletproofs generator tables.

Behavioral equivalent of reference src/generators.rs:
- `PedersenGens.default(curve)`: B = curve generator; B_blinding =
  G::rand(ChaCha(SHA3-512(serialize_uncompressed(B))[..32]))
  (reference src/generators.rs:47-66).
- `GeneratorsChain(label)`: ChaCha seeded with
  SHA3-512(b"GeneratorsChain" || label)[..32]; each item is G::rand
  (reference src/generators.rs:78-101).
- `BulletproofGens`: per-party G/H tables with labels [b'G', u32-LE party]
  and [b'H', ...], resumable `increase_capacity`, aggregated party-major
  iterators, per-party `share` views (reference src/generators.rs:149-304).

Generator tables are deterministic, precomputable artifacts; `save`/`load`
persist them (the checkpoint/resume analog, SURVEY.md §5). The device MSM
path caches limb-decomposed copies of these tables on the card (ops/cache.py).

The port's copy of the JAX package's generators.py: host branches, the
generator farm (GeneratorsChain on ops/gens.py) and the device Pedersen
batch of a twisted-Edwards curve (ops/prove.py).
"""

from __future__ import annotations

import math

from .hashes.chacha import ChaChaRng
from .hashes.keccak import sha3_512


class PedersenGens:
    """A pair of commitment bases (B, B_blinding)."""

    def __init__(self, curve, B=None, B_blinding=None):
        self.curve = curve
        if B is None or B_blinding is None:
            B = curve.gen
            seed = sha3_512(curve.serialize_uncompressed(B))[:32]
            B_blinding = curve.rand(ChaChaRng(seed))
        self.B = B
        self.B_blinding = B_blinding

    @classmethod
    def default(cls, curve) -> "PedersenGens":
        return cls(curve)

    def commit(self, value: int, blinding: int):
        """value*B + blinding*B_blinding (reference src/generators.rs:39-44)."""
        c = self.curve
        return c.add(c.mul_bigint(self.B, value % c.fr.p),
                     c.mul_bigint(self.B_blinding, blinding % c.fr.p))

    def commit_many(self, values: list[int], blinds: list[int]) -> list:
        """[commit(v_i, r_i)] as one batch.

        The protocol layer commits every witness value up front (the
        reference loops prover.commit, src/r1cs/prover.rs:327-341); the
        pure-Python double-and-add costs ~8 ms/commitment, so at shuffle
        k=1024 scale the 2048 commitments dominate proof creation. The
        native fixed-base window path (csrc/abtpu_msm_cpu.cpp) computes
        the batch in ~20 us/commitment; Jacobian results are normalized
        with ONE modular inversion (Montgomery's trick). Bit-identical
        to the sequential path (tests/test_torch_host.py)."""
        c = self.curve
        if not values:
            return []
        from . import native

        if len(values) >= 2 and native.set_curve_native(c):
            jacs = native.commit_many_native(
                self.B, self.B_blinding, values, blinds, c.fr.p
            )
            if jacs is not None:
                p = c.fq.p
                # batched inversion of the Z coordinates
                zs = [J[2] for J in jacs]
                prefix = [1] * (len(zs) + 1)
                for i, z in enumerate(zs):
                    prefix[i + 1] = prefix[i] * z % p if z else prefix[i]
                inv_all = pow(prefix[-1], -1, p)
                out = [None] * len(zs)
                for i in range(len(zs) - 1, -1, -1):
                    X, Y, Z = jacs[i]
                    if Z == 0:
                        out[i] = None
                        continue
                    zi = inv_all * prefix[i] % p
                    inv_all = inv_all * Z % p
                    zi2 = zi * zi % p
                    out[i] = (X * zi2 % p, Y * zi2 % p * zi % p)
                return out
        # No native backend for a twisted-Edwards curve: a batch of 64 or
        # more goes to the device above the engine's threshold (as in the
        # JAX package; the host double-and-add costs milliseconds per
        # commitment), the rest to the sequential host path.
        if len(values) >= 64 and not hasattr(c, "b"):
            from . import engine

            if engine.use_device(len(values)):
                from .ops.prove import pedersen_commit_many_dev

                return pedersen_commit_many_dev(self, values, blinds,
                                                engine.torch_device())
        return [self.commit(v, r) for v, r in zip(values, blinds)]


class GeneratorsChain:
    """Deterministic unbounded generator stream for one label
    (reference src/generators.rs:78-121).

    Requests of `_DEVICE_MIN` generators or more on a short-Weierstrass
    curve of cofactor 1 over a field of more than 240 bits go through the
    generator farm on `engine.torch_device()` (ops/gens.py: the card's
    gen_candidates kernel, or its plain version where the engine's device
    is the CPU; a CUDA device without a card raises). The farm draws the
    ChaCha attempt stream in bulk, nine words an attempt, evaluates a
    chunk of attempts in one launch, and rewinds the stream to just after
    the attempt that yields the n-th point, so interleaved take and
    fast_forward calls stay bit-identical to the sequential path.

    The fixed framing holds only while no x of the chunk is >= p (an
    `Fp::rand` redraw shifts every later attempt): where one is, the chain
    restores the chunk's snapshot and finishes the request sequentially on
    the host, counted in `GeneratorsChain.replays`. That happens with
    probability about 2^-128 an attempt on secq256k1, whose p is just below
    2^256, and about 1/2 on zorro, whose p is just above 2^255: there the
    first chunk replays and the farm gives no speed, only the same points.
    """

    # The JAX package's crossover (set there by XLA compile cost); moving
    # it needs a measured cell.
    _DEVICE_MIN = 4096
    # Attempts a chunk at most: 4,194,304, so one chunk carries a 2^20
    # request (about 2^21 attempts). On the card a chunk holds its 36 bytes
    # of words and 65 of results an attempt: 151 MB in and 273 MB out at
    # the cap; the host holds the words and the accepted points.
    _DEVICE_CHUNK = 1 << 22
    replays = 0

    def __init__(self, curve, label: bytes):
        self.curve = curve
        seed = sha3_512(b"GeneratorsChain" + label)[:32]
        self._rng = ChaChaRng(seed)

    def fast_forward(self, n: int) -> "GeneratorsChain":
        if self._device_ok(n):
            self._batched(n, keep=False)
            return self
        for _ in range(n):
            self.curve.rand(self._rng)
        return self

    def take(self, n: int) -> list:
        if self._device_ok(n):
            return self._batched(n, keep=True)
        return [self.curve.rand(self._rng) for _ in range(n)]

    # --- the generator farm ----------------------------------------------

    def _device_ok(self, n: int) -> bool:
        c = self.curve
        return (n >= self._DEVICE_MIN
                and hasattr(c, "b")  # short-Weierstrass
                and c.cofactor == 1
                and c.fq.num_bits > 240)  # framing assumes 4 x u64 draws

    def _batched(self, n: int, keep: bool):
        import numpy as np

        from . import engine
        from .ops.gens import candidate_points
        from .utils.profiling import phase

        dev = engine.torch_device()
        c = self.curve
        p = c.fq.p
        mask64 = ((1 << 64) - 1) >> (64 * 4 - c.fq.num_bits)
        p_words = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        out: list = []
        got = 0
        rng = self._rng
        while got < n:
            todo = n - got
            # successes are binomial at about 1/2 an attempt: 8 standard
            # deviations of margin, so one chunk nearly always suffices
            m = min(2 * todo + 8 * math.isqrt(2 * todo) + 256,
                    self._DEVICE_CHUNK)
            snap = rng.state_snapshot()
            with phase("gens:chacha"):
                words = rng.next_u32_array(9 * m).reshape(m, 9)
            with phase("gens:frame"):
                words[:, 6] &= np.uint32(mask64 & 0xFFFFFFFF)
                words[:, 7] &= np.uint32(mask64 >> 32)
                rejected = _any_at_least(words[:, :8], p_words)
            if rejected:
                # an Fp::rand redraw breaks the fixed framing: finish the
                # request sequentially from this chunk's start
                GeneratorsChain.replays += 1
                rng.state_restore(snap)
                rest = [c.rand(rng) for _ in range(n - got)]
                return out + rest if keep else None
            with phase("gens:h2d"):  # the copy, and the launch queued
                xy, ok_dev = candidate_points(c, words, dev)
            with phase("gens:kernel"):
                ok = ok_dev.cpu().numpy()  # waits for the launch
            seen = np.cumsum(ok)
            done = int(seen[-1]) >= todo
            # attempts used: through the todo-th success, or all of them
            used = int(np.searchsorted(seen, todo)) + 1 if done else m
            if keep:
                with phase("gens:d2h"):
                    acc = xy[:used][ok_dev[:used]].cpu().numpy()
                with phase("gens:ints"):
                    out.extend(zip(_ints(acc[:, :8]), _ints(acc[:, 8:])))
            got += min(int(seen[-1]), todo)
            if done:
                rng.state_restore(snap)
                rng.skip_words(9 * used)
        return out if keep else None


def _any_at_least(xw, p_words: list[int]) -> bool:
    """Whether any row of xw (m, 8) uint32, little-endian words, is >= p:
    compared from the top word down."""
    import numpy as np

    gt = np.zeros(xw.shape[0], dtype=bool)
    eq = np.ones(xw.shape[0], dtype=bool)
    for i in range(7, -1, -1):
        col, pw = xw[:, i], np.uint32(p_words[i])
        gt |= eq & (col > pw)
        eq &= col == pw
    return bool((gt | eq).any())


def _ints(words) -> list[int]:
    """(k, 8) 32-bit little-endian words -> k ints."""
    import numpy as np

    b = np.ascontiguousarray(words).view("<u4").tobytes()
    return [int.from_bytes(b[i:i + 32], "little")
            for i in range(0, len(b), 32)]


def _party_label(prefix: bytes, party: int) -> bytes:
    return prefix + party.to_bytes(4, "little")


class BulletproofGens:
    """Per-party generator tables for vector commitments."""

    def __init__(self, curve, gens_capacity: int, party_capacity: int = 1):
        self.curve = curve
        self.gens_capacity = 0
        self.party_capacity = party_capacity
        self.G_vec: list[list] = [[] for _ in range(party_capacity)]
        self.H_vec: list[list] = [[] for _ in range(party_capacity)]
        self.increase_capacity(gens_capacity)

    def increase_capacity(self, new_capacity: int) -> None:
        """Extend all chains without recomputing existing entries
        (resumable via fast_forward, reference src/generators.rs:196-221)."""
        if self.gens_capacity >= new_capacity:
            return
        extra = new_capacity - self.gens_capacity
        for i in range(self.party_capacity):
            chain = GeneratorsChain(self.curve, _party_label(b"G", i))
            chain.fast_forward(self.gens_capacity)
            self.G_vec[i].extend(chain.take(extra))
            chain = GeneratorsChain(self.curve, _party_label(b"H", i))
            chain.fast_forward(self.gens_capacity)
            self.H_vec[i].extend(chain.take(extra))
        self.gens_capacity = new_capacity

    def share(self, j: int) -> "BulletproofGensShare":
        return BulletproofGensShare(self, j)

    def G(self, n: int, m: int) -> list:
        """Aggregated party-major iteration: party 0's first n, then party 1's
        first n, ... (reference src/generators.rs:224-276)."""
        return [g for j in range(m) for g in self.G_vec[j][:n]]

    def H(self, n: int, m: int) -> list:
        return [h for j in range(m) for h in self.H_vec[j][:n]]

    # --- persistence (generator tables are cacheable artifacts) ---------

    def save(self, path: str) -> None:
        import json

        data = {
            "curve": self.curve.name,
            "gens_capacity": self.gens_capacity,
            "party_capacity": self.party_capacity,
            "G": [[self.curve.serialize_compressed(g).hex() for g in row]
                  for row in self.G_vec],
            "H": [[self.curve.serialize_compressed(h).hex() for h in row]
                  for row in self.H_vec],
        }
        with open(path, "w") as f:
            json.dump(data, f)

    @classmethod
    def load(cls, path: str, curve) -> "BulletproofGens":
        import json

        with open(path) as f:
            data = json.load(f)
        if data["curve"] != curve.name:
            raise ValueError("generator table curve mismatch")
        self = cls.__new__(cls)
        self.curve = curve
        self.gens_capacity = data["gens_capacity"]
        self.party_capacity = data["party_capacity"]
        self.G_vec = [[curve.deserialize_compressed(bytes.fromhex(s), validate=False)
                       for s in row] for row in data["G"]]
        self.H_vec = [[curve.deserialize_compressed(bytes.fromhex(s), validate=False)
                       for s in row] for row in data["H"]]
        return self


class BulletproofGensShare:
    """One party's view of the generator table."""

    def __init__(self, gens: BulletproofGens, share: int):
        self.gens = gens
        self.share = share

    def G(self, n: int) -> list:
        return self.gens.G_vec[self.share][:n]

    def H(self, n: int) -> list:
        return self.gens.H_vec[self.share][:n]
