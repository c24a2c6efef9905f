"""Inner-product argument (IPA) on the port (counterpart of
ark_bulletproofs_tpu/ipp.py).

Produces transcripts and proofs equivalent to the reference
(src/inner_product_proof.rs), but with a device-first prover structure:

The reference folds the generator vectors explicitly each round — n
two-point MSMs per round (src/inner_product_proof.rs:143-155,216-225),
which on an accelerator would serialize into per-element scalar
multiplications. Here every round's L/R commitment is instead computed as
one large MSM over the ORIGINAL (fixed) generator arrays, with per-element
weights that accumulate the fold challenges:

  after r rounds, the current generator at position i is
      G^(r)_i = sum_{t ≡ i (mod n_r)} (prod_k u_k^{±1}) * Ghat_t,
  where Ghat_t = G_factors[t] * G_t and the sign of u_k follows the k-th
  top bit of t. Maintaining the per-t products costs O(n) field muls per
  round, and the L/R MSMs become fixed-base-array MSMs of size ~n — large,
  batched, and cacheable on device. Mathematically identical outputs, so
  the Fiat-Shamir transcript (and proof bytes) match the folded version.

`create` takes the device route from n >= DEVICE_MIN_N when the engine
puts the 2n + 1-term MSM on the device, or whenever a and b arrive as
device tensors (the prover's device vector phase). On a device whose type
is in IPA_FS, and for n <= FS_MAX_N, the whole IPA runs with its
Fiat-Shamir step on the card (ops/ipa.py::ipa_prove_fs, one fetch a
proof); otherwise, and after the ~2^-128 case in which the card's
`Fp::rand` finds no candidate, the per-round route (IpaDeviceProver: one
round trip and a host Fiat-Shamir step per round). `create_batch` proves
P transcripts in lockstep (ipa_prove_fs_batch or IpaBatchProver). Every
route gives the same bytes. `verify` takes the device route from n >=
VERIFY_DEVICE_MIN_N on a short-Weierstrass curve when the engine puts
the 2n-term MSM on the device: the g/h scalars and their MSM over [G | H]
on the card (ops/verify.py::ipa_gh_msm), the [Q | L | R] tail on the
host; below that the host assembles the whole MSM.

Under an engine mesh (engine.set_mesh) the routes that keep a proof on
one device stand aside, as in the JAX package: no on-device Fiat-Shamir
route (`create`, `create_batch`) and no device verify; the per-round
provers shard their rounds (ops/ipa.py) and the verify's MSM shards
through the router.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import engine
from .errors import VerificationError
from .transcript import protocol
from .transcript.merlin import Transcript
from .util import inner_product

# Smallest IPA the device route takes (the JAX package's value).
DEVICE_MIN_N = 64
# Device types on which the device route runs the on-device Fiat-Shamir
# IPA (the JAX package's ABTPU_IPA_FS, on by default on the TPU); () keeps
# every device IPA on the per-round route.
IPA_FS = ("cuda",)
# Largest n of the on-device Fiat-Shamir IPA (ABTPU_IPA_FS_MAX_N).
FS_MAX_N = 65536
# Smallest n whose verification takes the device route (the JAX
# package's gate).
VERIFY_DEVICE_MIN_N = 1024


@dataclass
class InnerProductProof:
    """Log-size proof that P = <a,G> + <b,H'> + <a,b>Q
    (reference src/inner_product_proof.rs:17-23)."""

    L_vec: list
    R_vec: list
    a: int
    b: int

    # --- serialization (arkworks CanonicalSerialize layout) ------------

    def to_bytes(self, curve, compressed: bool = True) -> bytes:
        assert compressed, "only compressed proof encoding is supported"
        out = bytearray()
        out += len(self.L_vec).to_bytes(8, "little")
        for P in self.L_vec:
            out += curve.serialize_compressed(P)
        out += len(self.R_vec).to_bytes(8, "little")
        for P in self.R_vec:
            out += curve.serialize_compressed(P)
        out += curve.fr.to_bytes(self.a)
        out += curve.fr.to_bytes(self.b)
        return bytes(out)

    @classmethod
    def from_bytes(cls, curve, data: bytes) -> tuple["InnerProductProof", int]:
        """Parse; returns (proof, bytes_consumed)."""
        psize = len(curve.serialize_compressed(curve.gen))
        ssize = curve.fr.byte_size
        off = 0

        def take(n):
            nonlocal off
            chunk = data[off: off + n]
            if len(chunk) != n:
                raise ValueError("truncated proof")
            off += n
            return chunk

        nl = int.from_bytes(take(8), "little")
        L = [curve.deserialize_compressed(take(psize)) for _ in range(nl)]
        nr = int.from_bytes(take(8), "little")
        R = [curve.deserialize_compressed(take(psize)) for _ in range(nr)]
        a, _ = curve.fr.from_bytes(take(ssize))
        b, _ = curve.fr.from_bytes(take(ssize))
        return cls(L, R, a, b), off

    # --- creation --------------------------------------------------------

    @classmethod
    def create(
        cls,
        transcript: Transcript,
        curve,
        Q,
        G_factors: list[int],
        H_factors: list[int],
        G_vec: list,
        H_vec: list,
        a_vec: list[int],
        b_vec: list[int],
    ) -> "InnerProductProof":
        f = curve.fr
        p = f.p
        n = len(G_vec)
        assert n >= 1 and (n & (n - 1)) == 0, "length must be a power of two"
        # a, b: int lists, or (16, n) device tensors from the vector phase
        device_lr = not isinstance(a_vec, (list, tuple))
        lens = [v.shape[-1] if device_lr else len(v) for v in (a_vec, b_vec)]
        assert len(H_vec) == lens[0] == lens[1] == n
        assert len(G_factors) == len(H_factors) == n

        protocol.innerproduct_domain_sep(transcript, n)

        if device_lr or (n >= DEVICE_MIN_N and engine.use_device(2 * n + 1)):
            return cls._create_device(
                transcript, curve, Q, G_factors, H_factors,
                G_vec, H_vec, a_vec, b_vec,
            )

        a = [x % p for x in a_vec]
        b = [x % p for x in b_vec]
        # Per-original-index fold coefficients; factors pre-applied
        # (the reference folds factors into the first round's scalars;
        # here they enter the weight vectors from the start).
        g_mult = [x % p for x in G_factors]
        h_mult = [x % p for x in H_factors]

        N = n
        L_vec, R_vec = [], []
        cur = n
        while cur != 1:
            m = cur // 2
            a_L, a_R = a[:m], a[m:]
            b_L, b_R = b[:m], b[m:]

            c_L = inner_product(f, a_L, b_R)
            c_R = inner_product(f, a_R, b_L)

            # L = <a_L, Gcur_R> + <b_R, Hcur_L> + c_L * Q over ORIGINAL bases:
            # original index t maps to current slot i = t mod cur.
            gw_L = [0] * N
            hw_L = [0] * N
            gw_R = [0] * N
            hw_R = [0] * N
            for t in range(N):
                i = t % cur
                if i >= m:  # slot in current right half
                    gw_L[t] = a_L[i - m] * g_mult[t] % p
                    hw_R[t] = b_L[i - m] * h_mult[t] % p
                else:  # slot in current left half
                    hw_L[t] = b_R[i] * h_mult[t] % p
                    gw_R[t] = a_R[i] * g_mult[t] % p

            L = engine.msm(curve, G_vec + H_vec + [Q], gw_L + hw_L + [c_L])
            R = engine.msm(curve, G_vec + H_vec + [Q], gw_R + hw_R + [c_R])

            L_vec.append(L)
            R_vec.append(R)
            protocol.append_point(transcript, curve, b"L", L)
            protocol.append_point(transcript, curve, b"R", R)

            u = protocol.challenge_scalar(transcript, curve, b"u")
            u_inv = f.inv(u)

            a = [(al * u + u_inv * ar) % p for al, ar in zip(a_L, a_R)]
            b = [(bl * u_inv + u * br) % p for bl, br in zip(b_L, b_R)]
            # Generator fold becomes a weight update: the top bit of t's
            # residue decides u vs u_inv (G) and the opposite for H.
            for t in range(N):
                if t % cur >= m:
                    g_mult[t] = g_mult[t] * u % p
                    h_mult[t] = h_mult[t] * u_inv % p
                else:
                    g_mult[t] = g_mult[t] * u_inv % p
                    h_mult[t] = h_mult[t] * u % p
            cur = m

        return cls(L_vec, R_vec, a[0], b[0])

    @classmethod
    def _create_device(
        cls, transcript, curve, Q, G_factors, H_factors,
        G_vec, H_vec, a_vec, b_vec,
    ) -> "InnerProductProof":
        """Device-resident creation (ops/ipa.py): the O(n) state stays on
        the device between rounds; the Fiat-Shamir chain runs on the card
        (IPA_FS) or on the host. Transcript operations are those of the
        host path, so proofs and challenges match byte for byte."""
        from .ops.ipa import IpaDeviceProver, ipa_prove_fs

        dev = engine.torch_device()
        if (dev.type in IPA_FS and len(G_vec) <= FS_MAX_N
                and engine.active_mesh() is None):
            res = ipa_prove_fs(transcript, curve, Q, G_factors, H_factors,
                               G_vec, H_vec, a_vec, b_vec, dev)
            if res is not None:
                return cls(*res)
        f = curve.fr
        st = IpaDeviceProver(
            curve, Q, G_vec, H_vec, G_factors, H_factors, a_vec, b_vec, dev,
        )
        L_vec, R_vec = [], []
        cur = len(G_vec)
        while cur != 1:
            L, R = st.round_commit(cur)
            L_vec.append(L)
            R_vec.append(R)
            protocol.append_point(transcript, curve, b"L", L)
            protocol.append_point(transcript, curve, b"R", R)
            u = protocol.challenge_scalar(transcript, curve, b"u")
            st.fold(cur, u, f.inv(u))
            cur //= 2
        a0, b0 = st.final_ab()
        return cls(L_vec, R_vec, a0, b0)

    @classmethod
    def create_batch(cls, transcripts: list, curve, base_B, ws: list[int],
                     G_factors_list, H_factors_list, G_vec: list,
                     H_vec: list, a_list, b_list) -> list:
        """P proofs in lockstep, one per transcript, over shared generator
        vectors with Q_b = ws[b] * base_B (the R1CS shape, reference
        src/r1cs/prover.rs:777-779). Each proof equals the one `create`
        makes on the same transcript. From n >= DEVICE_MIN_N with the
        2n + 1-term MSM on the device, every round's 2P MSMs run as one
        batched device MSM (ops/ipa.py); below that, `create` per proof."""
        n = len(G_vec)
        P = len(a_list)
        assert P == len(transcripts) == len(ws) > 0
        assert n >= 1 and (n & (n - 1)) == 0, "length must be a power of two"
        if not (n >= DEVICE_MIN_N and engine.use_device(2 * n + 1)):
            return [
                cls.create(transcripts[b], curve, curve.mul(base_B, ws[b]),
                           G_factors_list[b], H_factors_list[b],
                           list(G_vec), list(H_vec), a_list[b], b_list[b])
                for b in range(P)
            ]
        from .ops.ipa import IpaBatchProver, ipa_prove_fs_batch

        for t in transcripts:
            protocol.innerproduct_domain_sep(t, n)
        dev = engine.torch_device()
        if (dev.type in IPA_FS and n <= FS_MAX_N
                and engine.active_mesh() is None):
            res = ipa_prove_fs_batch(transcripts, curve, base_B, ws,
                                     G_factors_list, H_factors_list, G_vec,
                                     H_vec, a_list, b_list, dev)
            if res is not None:
                return [cls(*r) for r in res]
        f = curve.fr
        st = IpaBatchProver(curve, base_B, ws, G_vec, H_vec, G_factors_list,
                            H_factors_list, a_list, b_list, dev)
        L_vecs = [[] for _ in range(P)]
        R_vecs = [[] for _ in range(P)]
        cur = n
        while cur != 1:
            us = []
            for b, (L, R) in enumerate(st.round_commit(cur)):
                L_vecs[b].append(L)
                R_vecs[b].append(R)
                t = transcripts[b]
                protocol.append_point(t, curve, b"L", L)
                protocol.append_point(t, curve, b"R", R)
                us.append(protocol.challenge_scalar(t, curve, b"u"))
            st.fold(cur, us, [f.inv(u) for u in us])
            cur //= 2
        return [cls(L_vecs[b], R_vecs[b], *ab)
                for b, ab in enumerate(st.final_ab())]

    # --- verification ------------------------------------------------------

    def verification_challenges(
        self, n: int, transcript: Transcript, curve
    ) -> tuple[list[int], list[int], int]:
        """Replay the transcript; (u_sq, u_inv_sq, allinv) — the O(lg n)
        part of verification_scalars, without the O(n) s-vector (which
        the JAX package's device path rebuilds on-chip)."""
        f = curve.fr
        p = f.p
        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise VerificationError("proof too large")
        if n != (1 << lg_n):
            raise VerificationError("length mismatch")

        protocol.innerproduct_domain_sep(transcript, n)

        challenges = []
        for L, R in zip(self.L_vec, self.R_vec):
            protocol.validate_and_append_point(transcript, curve, b"L", L)
            protocol.validate_and_append_point(transcript, curve, b"R", R)
            challenges.append(protocol.challenge_scalar(transcript, curve, b"u"))

        challenges_inv = f.batch_inversion(list(challenges))
        allinv = 1
        for ci in challenges_inv:
            if ci != 0:
                allinv = allinv * ci % p

        u_sq = [c * c % p for c in challenges]
        u_inv_sq = [c * c % p for c in challenges_inv]
        return u_sq, u_inv_sq, allinv

    def verification_scalars(
        self, n: int, transcript: Transcript, curve
    ) -> tuple[list[int], list[int], list[int]]:
        """(u_sq, u_inv_sq, s) for the caller's combined MSM
        (reference src/inner_product_proof.rs:244-313)."""
        p = curve.fr.p
        lg_n = len(self.L_vec)
        u_sq, u_inv_sq, allinv = self.verification_challenges(
            n, transcript, curve
        )
        # s-vector via the inductive recurrence s[i] = s[i - 2^lg(i)] * u_{lg(i)}^2.
        s = [0] * n
        s[0] = allinv
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            s[i] = s[i - k] * u_sq[(lg_n - 1) - lg_i] % p
        return u_sq, u_inv_sq, s

    def verify(
        self,
        n: int,
        transcript: Transcript,
        curve,
        G_factors: list[int],
        H_factors: list[int],
        P,
        Q,
        G_vec: list,
        H_vec: list,
    ) -> None:
        """Standalone verification via one (2n + 2 lg n + 1)-term MSM
        (reference src/inner_product_proof.rs:321-382). Raises on failure.

        Device route (short-Weierstrass curves, n >= VERIFY_DEVICE_MIN_N,
        the 2n-term MSM above the engine threshold): the s-vector and the
        g/h scalars are made on the device from the lg n challenges and
        summed there over the cached [G | H] table
        (ops/verify.py::ipa_gh_msm); only the [Q | L | R] tail runs
        through the host Pippenger. Otherwise the host assembles every
        scalar and the engine runs the MSM."""
        f = curve.fr
        p = f.p

        if (n >= VERIFY_DEVICE_MIN_N and hasattr(curve, "b")
                and engine.active_mesh() is None
                and engine.use_device(2 * n)):
            from .ops.verify import ipa_gh_msm

            u_sq, u_inv_sq, allinv = self.verification_challenges(
                n, transcript, curve)
            big = ipa_gh_msm(curve, n, self.a, self.b, u_sq, allinv,
                             G_factors, H_factors, G_vec, H_vec)
            tail = curve.msm(
                [Q] + list(self.L_vec) + list(self.R_vec),
                [self.a * self.b % p] + [p - x if x else 0 for x in u_sq]
                + [p - x if x else 0 for x in u_inv_sq])
            if not curve.eq(curve.add(big, tail), P):
                raise VerificationError("inner product proof failed")
            return

        u_sq, u_inv_sq, s = self.verification_scalars(n, transcript, curve)

        g_scalars = [self.a * si % p * gi % p for si, gi in zip(s, G_factors)]
        h_scalars = [
            self.b * si % p * hi % p for si, hi in zip(reversed(s), H_factors)
        ]
        neg_u_sq = [p - x if x else 0 for x in u_sq]
        neg_u_inv_sq = [p - x if x else 0 for x in u_inv_sq]

        bases = [Q] + list(G_vec) + list(H_vec) + list(self.L_vec) + list(self.R_vec)
        scalars = (
            [self.a * self.b % p]
            + g_scalars
            + h_scalars
            + neg_u_sq
            + neg_u_inv_sq
        )
        expect_P = engine.msm(curve, bases, scalars)
        if not curve.eq(expect_P, P):
            raise VerificationError("inner product proof failed")
