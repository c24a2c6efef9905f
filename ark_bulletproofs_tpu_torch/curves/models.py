"""Host curve models: short-Weierstrass and twisted-Edwards group law.

Affine points are `(x, y)` int tuples; `None` is the identity (for SW) and
`(0, 1)` is the identity for TE. Internal projective representations:
Jacobian `(X, Y, Z)` for SW, extended `(X, Y, T, Z)` for TE.

arkworks-0.4 parity notes (behavioral, see SURVEY.md §2b):
- `rand`: x (SW) / y (TE) sampled via Fp::rand, a `greatest` bool from the
  top bit of the next u32, sqrt, pick the lexicographically larger root iff
  `greatest`, multiply by the cofactor.
- compressed encoding: SW stores x with 2 flag bits (infinity -> bit 6,
  y lexicographically-larger -> bit 7); TE stores y with 1 flag bit
  (x lexicographically-larger -> bit 7).
- uncompressed encoding: SW stores x plain then y with flags; TE stores
  x plain then y plain.

The device group law of the port lives in `ark_bulletproofs_tpu_torch.ops`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields import Field

Affine = tuple[int, int] | None


@dataclass(frozen=True)
class CurveBase:
    name: str
    fq: Field
    fr: Field
    cofactor: int
    gen: tuple[int, int]
    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    # --- generic helpers built on the model-specific primitives --------

    def mul(self, P, k: int):
        """Scalar multiplication (affine in, affine out). k is reduced mod fr."""
        k %= self.fr.p
        if k == 0 or self.is_zero(P):
            return self.zero()
        acc = self.proj_zero()
        Pp = self.to_proj(P)
        for bit in bin(k)[2:]:
            acc = self.proj_double(acc)
            if bit == "1":
                acc = self.proj_add(acc, Pp)
        return self.to_affine(acc)

    def mul_bigint(self, P, k: int):
        """Scalar multiplication by an arbitrary non-negative integer
        (arkworks `mul_bigint` does NOT reduce modulo the group order)."""
        if k == 0 or self.is_zero(P):
            return self.zero()
        acc = self.proj_zero()
        Pp = self.to_proj(P)
        for bit in bin(k)[2:]:
            acc = self.proj_double(acc)
            if bit == "1":
                acc = self.proj_add(acc, Pp)
        return self.to_affine(acc)

    def add(self, P, Q):
        return self.to_affine(self.proj_add(self.to_proj(P), self.to_proj(Q)))

    def double(self, P):
        return self.to_affine(self.proj_double(self.to_proj(P)))

    def sub(self, P, Q):
        return self.add(P, self.neg(Q))

    def msm(self, points: list, scalars: list[int]):
        """Host Pippenger multi-scalar multiplication (affine in/out).

        Equivalent of ark_ec::VariableBaseMSM::msm (reference hot primitive,
        e.g. src/inner_product_proof.rs:104). The device path replaces this
        for large n via ops.msm.
        """
        assert len(points) == len(scalars)
        n = len(points)
        if n == 0:
            return self.zero()
        ks = [s % self.fr.p for s in scalars]
        # Native single-core C++ Pippenger when available, bit-identical
        # to the pure-Python window loop below; set_curve_native rejects
        # TE-model / wide-field curves and the call falls through.
        if n >= 2:
            from .. import native

            if native.set_curve_native(self):
                jac = native.cpu_pippenger_native(points, ks, curve=self)
                if jac is not None:
                    return self.to_affine(jac)
        return self.msm_python(points, ks)

    def msm_python(self, points: list, scalars: list[int]):
        """The exact pure-Python Pippenger (oracle for the native path;
        every measured host MSM routes through `msm` above)."""
        n = len(points)
        if n == 0:
            return self.zero()
        ks = [s % self.fr.p for s in scalars]
        nbits = self.fr.p.bit_length()
        c = 3 if n < 32 else max(3, n.bit_length() - 3)
        num_windows = (nbits + c - 1) // c
        window_sums = []
        for w in range(num_windows):
            shift = w * c
            buckets = [None] * ((1 << c) - 1)
            for P, k in zip(points, ks):
                digit = (k >> shift) & ((1 << c) - 1)
                if digit == 0 or self.is_zero(P):
                    continue
                cur = buckets[digit - 1]
                buckets[digit - 1] = (
                    self.to_proj(P) if cur is None
                    else self.proj_add(cur, self.to_proj(P))
                )
            running = self.proj_zero()
            acc = self.proj_zero()
            for b in reversed(buckets):
                if b is not None:
                    running = self.proj_add(running, b)
                acc = self.proj_add(acc, running)
            window_sums.append(acc)
        total = self.proj_zero()
        for ws in reversed(window_sums):
            for _ in range(c):
                total = self.proj_double(total)
            total = self.proj_add(total, ws)
        return self.to_affine(total)

    def rand(self, rng):
        """arkworks `Affine::rand` = `Projective::rand(rng).into_affine()`."""
        raise NotImplementedError


class SWCurve(CurveBase):
    """y^2 = x^3 + a*x + b, Jacobian internal coordinates."""

    def __init__(self, name, fq, fr, a, b, cofactor, gen):
        object.__setattr__(self, "a", a)
        object.__setattr__(self, "b", b)
        super().__init__(name=name, fq=fq, fr=fr, cofactor=cofactor, gen=gen)

    # --- representation -------------------------------------------------

    def zero(self) -> Affine:
        return None

    def is_zero(self, P: Affine) -> bool:
        return P is None

    def neg(self, P: Affine) -> Affine:
        if P is None:
            return None
        return (P[0], self.fq.neg(P[1]))

    def eq(self, P: Affine, Q: Affine) -> bool:
        return P == Q

    def proj_zero(self):
        return (1, 1, 0)

    def to_proj(self, P: Affine):
        if P is None:
            return (1, 1, 0)
        return (P[0], P[1], 1)

    def to_affine(self, P) -> Affine:
        X, Y, Z = P
        if Z == 0:
            return None
        p = self.fq.p
        zi = pow(Z, -1, p)
        zi2 = zi * zi % p
        return (X * zi2 % p, Y * zi2 % p * zi % p)

    def batch_to_affine(self, Ps) -> list[Affine]:
        p = self.fq.p
        zs = [P[2] for P in Ps]
        zinvs = self.fq.batch_inversion(zs)
        out = []
        for (X, Y, Z), zi in zip(Ps, zinvs):
            if Z == 0:
                out.append(None)
            else:
                zi2 = zi * zi % p
                out.append((X * zi2 % p, Y * zi2 % p * zi % p))
        return out

    # --- Jacobian group law ---------------------------------------------

    def proj_double(self, P):
        X1, Y1, Z1 = P
        if Z1 == 0:
            return P
        if Y1 == 0:
            return (1, 1, 0)
        p = self.fq.p
        XX = X1 * X1 % p
        YY = Y1 * Y1 % p
        YYYY = YY * YY % p
        ZZ = Z1 * Z1 % p
        S = 2 * ((X1 + YY) * (X1 + YY) % p - XX - YYYY) % p
        M = (3 * XX + self.a * (ZZ * ZZ % p)) % p
        X3 = (M * M - 2 * S) % p
        Y3 = (M * (S - X3) - 8 * YYYY) % p
        Z3 = ((Y1 + Z1) * (Y1 + Z1) % p - YY - ZZ) % p
        return (X3, Y3, Z3)

    def proj_add(self, P, Q):
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        if Z1 == 0:
            return Q
        if Z2 == 0:
            return P
        p = self.fq.p
        Z1Z1 = Z1 * Z1 % p
        Z2Z2 = Z2 * Z2 % p
        U1 = X1 * Z2Z2 % p
        U2 = X2 * Z1Z1 % p
        S1 = Y1 * Z2 % p * Z2Z2 % p
        S2 = Y2 * Z1 % p * Z1Z1 % p
        if U1 == U2:
            if S1 != S2:
                return (1, 1, 0)
            return self.proj_double(P)
        H = (U2 - U1) % p
        I = 4 * H * H % p
        J = H * I % p
        r = 2 * (S2 - S1) % p
        V = U1 * I % p
        X3 = (r * r - J - 2 * V) % p
        Y3 = (r * (V - X3) - 2 * S1 * J) % p
        Z3 = ((Z1 + Z2) * (Z1 + Z2) % p - Z1Z1 - Z2Z2) % p * H % p
        return (X3, Y3, Z3)

    # --- curve predicates ------------------------------------------------

    def is_on_curve(self, P: Affine) -> bool:
        if P is None:
            return True
        x, y = P
        p = self.fq.p
        return y * y % p == (x * x % p * x + self.a * x + self.b) % p

    def subgroup_check(self, P: Affine) -> bool:
        if self.cofactor == 1:
            return True
        return self.mul_bigint(P, self.fr.p) is None

    # --- arkworks-compatible sampling and encoding -----------------------

    def get_ys_from_x(self, x: int):
        """(smaller_y, larger_y) in canonical order, or None if not on curve."""
        p = self.fq.p
        rhs = (x * x % p * x + self.a * x + self.b) % p
        y = self.fq.sqrt(rhs)
        if y is None:
            return None
        ny = self.fq.neg(y)
        return (y, ny) if y <= ny else (ny, y)

    def get_point_from_x(self, x: int, greatest: bool) -> Affine | None:
        ys = self.get_ys_from_x(x)
        if ys is None:
            return None
        return (x, ys[1] if greatest else ys[0])

    def rand(self, rng) -> Affine:
        while True:
            x = self.fq.rand(rng)
            greatest = rng.next_bool()
            P = self.get_point_from_x(x, greatest)
            if P is not None:
                if self.cofactor == 1:
                    return P
                return self.mul_bigint(P, self.cofactor)

    def serialize_compressed(self, P: Affine) -> bytes:
        if P is None:
            return self.fq.to_bytes(0, flags=1 << 6, flag_bits=2)
        x, y = P
        neg = not self.fq.is_less_than_neg(y)  # y > -y
        return self.fq.to_bytes(x, flags=(1 << 7) if neg else 0, flag_bits=2)

    def serialize_uncompressed(self, P: Affine) -> bytes:
        if P is None:
            return self.fq.to_bytes(0) + self.fq.to_bytes(0, flags=1 << 6, flag_bits=2)
        x, y = P
        neg = not self.fq.is_less_than_neg(y)
        return self.fq.to_bytes(x) + self.fq.to_bytes(
            y, flags=(1 << 7) if neg else 0, flag_bits=2
        )

    def deserialize_compressed(self, data: bytes, validate: bool = True) -> Affine:
        expected = self.fq.flagged_byte_size
        if len(data) != expected:
            raise ValueError("bad point encoding length")
        x, flags = self.fq.from_bytes(data, flag_mask=0b11 << 6)
        if flags & (1 << 6):
            return None
        P = self.get_point_from_x(x, greatest=bool(flags & (1 << 7)))
        if P is None:
            raise ValueError("x is not on the curve")
        if validate and not self.subgroup_check(P):
            raise ValueError("point not in the prime-order subgroup")
        return P


class TECurve(CurveBase):
    """a*x^2 + y^2 = 1 + d*x^2*y^2, extended internal coordinates."""

    def __init__(self, name, fq, fr, a, d, cofactor, gen):
        object.__setattr__(self, "a", a)
        object.__setattr__(self, "d", d)
        super().__init__(name=name, fq=fq, fr=fr, cofactor=cofactor, gen=gen)

    def zero(self) -> Affine:
        return (0, 1)

    def is_zero(self, P: Affine) -> bool:
        return P == (0, 1)

    def neg(self, P: Affine) -> Affine:
        return (self.fq.neg(P[0]), P[1])

    def eq(self, P: Affine, Q: Affine) -> bool:
        return P == Q

    def proj_zero(self):
        return (0, 1, 0, 1)

    def to_proj(self, P: Affine):
        x, y = P
        return (x, y, x * y % self.fq.p, 1)

    def to_affine(self, P) -> Affine:
        X, Y, _T, Z = P
        p = self.fq.p
        zi = pow(Z, -1, p)
        return (X * zi % p, Y * zi % p)

    def batch_to_affine(self, Ps) -> list[Affine]:
        p = self.fq.p
        zinvs = self.fq.batch_inversion([P[3] for P in Ps])
        return [(X * zi % p, Y * zi % p) for (X, Y, _T, _Z), zi in zip(Ps, zinvs)]

    def proj_add(self, P, Q):
        """Unified extended addition (Hisil-Wong-Carter-Dawson)."""
        p = self.fq.p
        X1, Y1, T1, Z1 = P
        X2, Y2, T2, Z2 = Q
        A = X1 * X2 % p
        B = Y1 * Y2 % p
        C = self.d * T1 % p * T2 % p
        D = Z1 * Z2 % p
        E = ((X1 + Y1) * (X2 + Y2) - A - B) % p
        F = (D - C) % p
        G = (D + C) % p
        H = (B - self.a * A) % p
        return (E * F % p, G * H % p, E * H % p, F * G % p)

    def proj_double(self, P):
        return self.proj_add(P, P)

    def is_on_curve(self, P: Affine) -> bool:
        x, y = P
        p = self.fq.p
        return (self.a * x % p * x + y * y) % p == (1 + self.d * x % p * x % p * y % p * y) % p

    def subgroup_check(self, P: Affine) -> bool:
        return self.is_zero(self.mul_bigint(P, self.fr.p))

    def get_xs_from_y(self, y: int):
        """(smaller_x, larger_x) or None."""
        p = self.fq.p
        num = (y * y - 1) % p
        den = (self.d * y % p * y - self.a) % p
        if den == 0:
            return None
        x2 = num * pow(den, -1, p) % p
        x = self.fq.sqrt(x2)
        if x is None:
            return None
        nx = self.fq.neg(x)
        return (x, nx) if x <= nx else (nx, x)

    def get_point_from_y(self, y: int, greatest: bool) -> Affine | None:
        xs = self.get_xs_from_y(y)
        if xs is None:
            return None
        return (xs[1] if greatest else xs[0], y)

    def rand(self, rng) -> Affine:
        while True:
            y = self.fq.rand(rng)
            greatest = rng.next_bool()
            P = self.get_point_from_y(y, greatest)
            if P is not None:
                if self.cofactor == 1:
                    return P
                return self.mul_bigint(P, self.cofactor)

    def serialize_compressed(self, P: Affine) -> bytes:
        x, y = P
        neg = not self.fq.is_less_than_neg(x)  # x > -x
        size_bits = 1
        return self.fq.to_bytes(y, flags=(1 << 7) if neg else 0, flag_bits=size_bits)

    def serialize_uncompressed(self, P: Affine) -> bytes:
        x, y = P
        return self.fq.to_bytes(x) + self.fq.to_bytes(y)

    def deserialize_compressed(self, data: bytes, validate: bool = True) -> Affine:
        expected = (self.fq.num_bits + 1 + 7) // 8
        if len(data) != expected:
            raise ValueError("bad point encoding length")
        y, flags = self.fq.from_bytes(data, flag_mask=1 << 7)
        P = self.get_point_from_y(y, greatest=bool(flags))
        if P is None:
            raise ValueError("y is not on the curve")
        if validate and not self.subgroup_check(P):
            raise ValueError("point not in the prime-order subgroup")
        return P
