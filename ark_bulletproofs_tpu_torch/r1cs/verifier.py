"""R1CS verifier and batch verification on the port (reference
src/r1cs/verifier.rs; counterpart of ark_bulletproofs_tpu/r1cs/verifier.py).

The verifier is a symbolic constraint system (no witness); verification
collapses to a single mega-MSM == identity check whose scalar vector is
assembled in a documented order (reference verifier.rs:379-393):

  B, B_blinding, G(padded_n), H(padded_n), A_I1, A_O1, S1, A_I2, A_O2, S2,
  V..., T_1, T_3, T_4, T_5, T_6, L..., R...

`batch_verify` takes a random linear combination of per-proof scalar
vectors, sharing the B/B_blinding/G/H columns so the generator work is paid
once for the whole batch (reference verifier.rs:604-691).

The mega-MSM runs on the port's device path above the engine threshold,
with the generator columns from the device cache (ops/cache.py). From
padded_n >= DEVICE_SCALARS_MIN_N (with the 2 padded_n-term MSM on the
device), the O(n) g/h scalar vectors are made on the device as well
(ops/verify.py: `gh_scalars` for one proof, `_gh_scalars_batch_accum`
for each size group of a batch, alpha-scaled and summed there) and feed
the mega-MSM with no host round trip, as the JAX package's
`_verify_device` and `_batch_verify_device` do. Below that gate the host
assembles them (`_assemble_host_scalars`), which is also the oracle of
the tests; both routes accept and reject the same proofs.
"""

from __future__ import annotations

import torch

from .. import engine
from ..errors import (
    R1CSInvalidGeneratorsLength,
    R1CSVerificationError,
    VerificationError,
)
from ..generators import BulletproofGens, PedersenGens
from ..ops import cache as dcache
from ..ops import field as dfield
from ..ops import verify as dverify
from ..ops.curve import affine_to_device, point_to_host, spec_for
from ..ops.limbs import ints_to_limbs
from ..ops.msm import scalars_to_device
from ..parallel.mesh import Pieces
from ..parallel.mesh import parts as pieces_of
from ..parallel.msm import msm_device_ragged
from ..transcript import protocol
from ..transcript.merlin import Transcript
from ..util import exp_vec, inner_product, next_power_of_two
from ..utils.profiling import phase
from .constraint_system import (
    RandomizableConstraintSystem,
    RandomizedConstraintSystem,
)
from .linear_combination import LinearCombination, Variable
from .proof import R1CSProof


# Smallest padded_n whose g/h scalars are made on the device (the JAX
# package's gate of `_verify_device` and `_batch_verify_device`).
DEVICE_SCALARS_MIN_N = 256


def _mega_msm(curve, pc_gens, bp_gens, n_gens: int, extras: list,
              scalars: list[int]):
    """sum of scalars times [B, B_blinding] + G(n_gens) + H(n_gens) +
    extras, affine out."""
    n = 2 + 2 * n_gens + len(extras)
    if len(scalars) != n:
        raise ValueError(f"mega-MSM: {len(scalars)} scalars for {n} bases")
    if not engine.use_device(n):
        gens = bp_gens.share(0)
        bases = ([pc_gens.B, pc_gens.B_blinding] + gens.G(n_gens)
                 + gens.H(n_gens) + extras)
        return curve.msm(bases, scalars)
    dev = engine.torch_device()
    return _device_mega_msm(curve, pc_gens, bp_gens, n_gens, extras,
                            scalars_to_device(curve, [scalars], dev)[0])


def _device_mega_msm(curve, pc_gens, bp_gens, n_gens: int, extras: list,
                     scal):
    """The mega-MSM on the device over (16, 2 + 2 n_gens + len(extras))
    canonical scalar limbs on it, or a mesh's Pieces of them (one scalar
    set through the ragged driver); affine out."""
    dev = scal.device
    Xp, Yp, Ip = dcache.pc_pair(pc_gens, curve, dev)
    Xt, Yt, It = dcache.bp_table(bp_gens, curve, n_gens, dev)
    Xe, Ye, Ie = affine_to_device(curve, extras, dev)
    X = torch.cat([Xp, Xt, Xe], dim=1)
    Y = torch.cat([Yp, Yt, Ye], dim=1)
    inf = torch.cat([Ip, It, Ie])
    return point_to_host(curve, msm_device_ragged(spec_for(curve), X, Y,
                                                  inf, scal))


def _scalar_limbs(head: list[int], g, h, tail: list[int]):
    """[head | g | h | tail] as (16, total) canonical limbs on g's
    (first) device: the mega-MSM's scalar order. Sharded g and h (a
    mesh's Pieces) stay where they are: the result is then a Pieces."""
    dev = g.device
    parts = [ints_to_limbs(head, dev),
             *(p.to(torch.int32) for p in pieces_of(g)),
             *(p.to(torch.int32) for p in pieces_of(h)),
             ints_to_limbs(tail, dev)]
    if isinstance(g, Pieces):
        return Pieces(parts)
    return torch.cat(parts, dim=1)


class Verifier(RandomizableConstraintSystem):
    def __init__(self, curve, transcript: Transcript):
        self.curve = curve
        self._transcript = transcript
        protocol.r1cs_domain_sep(transcript)
        self.num_vars = 0
        self.V: list = []
        self.constraints: list[LinearCombination] = []
        self.deferred_constraints = []
        self.pending_multiplier: int | None = None

    # --- ConstraintSystem --------------------------------------------------

    def transcript(self) -> Transcript:
        return self._transcript

    def _lc(self, value) -> LinearCombination:
        return LinearCombination.from_value(self.curve.fr, value)

    def multiply(self, left, right):
        left = self._lc(left)
        right = self._lc(right)
        fr = self.curve.fr
        i = self.num_vars
        self.num_vars += 1
        l_var = Variable(Variable.MUL_LEFT, i, fr)
        r_var = Variable(Variable.MUL_RIGHT, i, fr)
        o_var = Variable(Variable.MUL_OUT, i, fr)
        self.constrain(left - l_var)
        self.constrain(right - r_var)
        return l_var, r_var, o_var

    def allocate(self, assignment=None):
        fr = self.curve.fr
        if self.pending_multiplier is None:
            i = self.num_vars
            self.num_vars += 1
            self.pending_multiplier = i
            return Variable(Variable.MUL_LEFT, i, fr)
        i = self.pending_multiplier
        self.pending_multiplier = None
        return Variable(Variable.MUL_RIGHT, i, fr)

    def allocate_multiplier(self, input_assignments=None):
        fr = self.curve.fr
        i = self.num_vars
        self.num_vars += 1
        return (
            Variable(Variable.MUL_LEFT, i, fr),
            Variable(Variable.MUL_RIGHT, i, fr),
            Variable(Variable.MUL_OUT, i, fr),
        )

    def multipliers_len(self) -> int:
        return self.num_vars

    def constrain(self, lc) -> None:
        self.constraints.append(self._lc(lc))

    def specify_randomized_constraints(self, callback) -> None:
        self.deferred_constraints.append(callback)

    # --- protocol ------------------------------------------------------------

    def commit(self, commitment):
        i = len(self.V)
        self.V.append(commitment)
        protocol.append_point(self._transcript, self.curve, b"V", commitment)
        return Variable(Variable.COMMITTED, i, self.curve.fr)

    def commit_many(self, commitments: list):
        """Batched `commit` — same transcript appends in the same order
        (one bulk STROBE absorb; mirrors Prover.commit_many)."""
        self._transcript.append_messages(
            b"V",
            [self.curve.serialize_uncompressed(V) for V in commitments],
        )
        out = []
        for V in commitments:
            i = len(self.V)
            self.V.append(V)
            out.append(Variable(Variable.COMMITTED, i, self.curve.fr))
        return out

    def flattened_constraints(self, z: int):
        """Like the prover's, plus the constant term wc
        (reference verifier.rs:304-349)."""
        p = self.curve.fr.p
        n = self.num_vars
        m = len(self.V)
        wL = [0] * n
        wR = [0] * n
        wO = [0] * n
        wV = [0] * m
        wc = 0
        exp_z = z
        for lc in self.constraints:
            for var, coeff in lc.terms:
                if var.kind == Variable.MUL_LEFT:
                    wL[var.index] = (wL[var.index] + exp_z * coeff) % p
                elif var.kind == Variable.MUL_RIGHT:
                    wR[var.index] = (wR[var.index] + exp_z * coeff) % p
                elif var.kind == Variable.MUL_OUT:
                    wO[var.index] = (wO[var.index] + exp_z * coeff) % p
                elif var.kind == Variable.COMMITTED:
                    wV[var.index] = (wV[var.index] - exp_z * coeff) % p
                elif var.kind == Variable.ONE:
                    wc = (wc - exp_z * coeff) % p
            exp_z = exp_z * z % p
        return wL, wR, wO, wV, wc

    def _create_randomized_constraints(self):
        self.pending_multiplier = None
        if not self.deferred_constraints:
            protocol.r1cs_1phase_domain_sep(self._transcript)
            return
        protocol.r1cs_2phase_domain_sep(self._transcript)
        callbacks = self.deferred_constraints
        self.deferred_constraints = []
        wrapper = RandomizingVerifier(self)
        for cb in callbacks:
            cb(wrapper)

    def _verification_ingredients(self, proof, bp_gens) -> dict:
        """Transcript replay + flattening: the O(Q + lg n) host part of
        scalar assembly; the O(n) vectors (s, y^-i, g/h) follow in
        `_assemble_host_scalars`."""
        curve = self.curve
        fr = curve.fr
        p = fr.p
        t = self._transcript

        t.append_u64(b"m", len(self.V))

        n1 = self.num_vars
        try:
            protocol.validate_and_append_point(t, curve, b"A_I1", proof.A_I1)
            protocol.validate_and_append_point(t, curve, b"A_O1", proof.A_O1)
            protocol.validate_and_append_point(t, curve, b"S1", proof.S1)
        except VerificationError as e:
            raise R1CSVerificationError(str(e)) from e

        self._create_randomized_constraints()

        n = self.num_vars
        n2 = n - n1
        padded_n = next_power_of_two(n)
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise R1CSInvalidGeneratorsLength()

        # Identity in the 1-phase case — appended without validation.
        protocol.append_point(t, curve, b"A_I2", proof.A_I2)
        protocol.append_point(t, curve, b"A_O2", proof.A_O2)
        protocol.append_point(t, curve, b"S2", proof.S2)

        y = protocol.challenge_scalar(t, curve, b"y")
        z = protocol.challenge_scalar(t, curve, b"z")

        try:
            protocol.validate_and_append_point(t, curve, b"T_1", proof.T_1)
            protocol.validate_and_append_point(t, curve, b"T_3", proof.T_3)
            protocol.validate_and_append_point(t, curve, b"T_4", proof.T_4)
            protocol.validate_and_append_point(t, curve, b"T_5", proof.T_5)
            protocol.validate_and_append_point(t, curve, b"T_6", proof.T_6)
        except VerificationError as e:
            raise R1CSVerificationError(str(e)) from e

        u = protocol.challenge_scalar(t, curve, b"u")
        x = protocol.challenge_scalar(t, curve, b"x")

        protocol.append_scalar(t, curve, b"t_x", proof.t_x)
        protocol.append_scalar(t, curve, b"t_x_blinding", proof.t_x_blinding)
        protocol.append_scalar(t, curve, b"e_blinding", proof.e_blinding)

        w = protocol.challenge_scalar(t, curve, b"w")

        wL, wR, wO, wV, wc = self.flattened_constraints(z)

        try:
            u_sq, u_inv_sq, allinv = proof.ipp_proof.verification_challenges(
                padded_n, t, curve
            )
        except VerificationError as e:
            raise R1CSVerificationError(str(e)) from e

        # Batching challenge r squeezed from a CLONE so the main transcript
        # state stays batch-compatible (reference verifier.rs:516-519).
        r = protocol.challenge_scalar(t.clone(), curve, b"r")

        return dict(
            y=y, z=z, u=u, x=x, w=w, r=r,
            wL=wL, wR=wR, wO=wO, wV=wV, wc=wc,
            u_sq=u_sq, u_inv_sq=u_inv_sq, allinv=allinv,
            a=proof.ipp_proof.a, b=proof.ipp_proof.b,
            n1=n1, n=n, n2=n2, padded_n=padded_n, pad=pad,
        )

    @staticmethod
    def _head_tail_scalars(ing: dict, proof, p: int, delta: int):
        """The ~20 non-vector scalars around g/h (reference
        verifier.rs:526-540): ([B, B_blinding], [A.., V.., T.., u_sq,
        u_inv_sq]) coefficients."""
        a, b = ing["a"], ing["b"]
        u, x, w, r = ing["u"], ing["x"], ing["w"], ing["r"]
        xx = x * x % p
        rxx = r * xx % p
        xxx = x * xx % p
        T_scalars = [
            r * x % p,
            rxx * x % p,
            rxx * xx % p,
            rxx * xxx % p,
            rxx * xx % p * xx % p,
        ]
        head = [
            (w * (proof.t_x - a * b)
             + r * (xx * (ing["wc"] + delta) - proof.t_x)) % p,
            (-proof.e_blinding - r * proof.t_x_blinding) % p,
        ]
        tail = [x, xx, xxx, u * x % p, u * xx % p, u * xxx % p]
        tail += [wVi * rxx % p for wVi in ing["wV"]]
        tail += T_scalars
        tail += ing["u_sq"]
        tail += ing["u_inv_sq"]
        return head, tail

    def verification_scalars(
        self, proof: R1CSProof, bp_gens: BulletproofGens
    ) -> list[int]:
        """Replay the transcript and assemble the mega-MSM scalar vector
        (reference verifier.rs:394-541). Host path: all vectors as ints."""
        ing = self._verification_ingredients(proof, bp_gens)
        return self._assemble_host_scalars(ing, proof)

    def _assemble_host_scalars(self, ing: dict, proof) -> list[int]:
        curve = self.curve
        fr = curve.fr
        p = fr.p
        n, n1, n2 = ing["n"], ing["n1"], ing["n2"]
        padded_n, pad = ing["padded_n"], ing["pad"]
        wL, wR, wO = ing["wL"], ing["wR"], ing["wO"]
        u_sq, allinv = ing["u_sq"], ing["allinv"]
        a, b, u, x, y = ing["a"], ing["b"], ing["u"], ing["x"], ing["y"]
        lg_n = padded_n.bit_length() - 1

        # s-vector (reference inner_product_proof.rs:302-311)
        s = [0] * padded_n
        s[0] = allinv
        for i in range(1, padded_n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            s[i] = s[i - k] * u_sq[(lg_n - 1) - lg_i] % p

        y_inv = fr.inv(y)
        y_inv_vec = exp_vec(fr, y_inv, padded_n)
        yneg_wR = [wRi * yi % p for wRi, yi in zip(wR, y_inv_vec)] + [0] * pad

        delta = inner_product(fr, yneg_wR[:n], wL)

        u_for_gh = [1] * n1 + [u] * (n2 + pad)

        g_scalars = [
            u_or_1 * (x * ywr - a * si) % p
            for ywr, u_or_1, si in zip(yneg_wR, u_for_gh, s[:padded_n])
        ]
        wL_pad = wL + [0] * pad
        wO_pad = wO + [0] * pad
        s_rev = s[::-1]
        h_scalars = [
            u_or_1 * (yi * (x * wLi + wOi - b * s_inv) - 1) % p
            for yi, u_or_1, s_inv, wLi, wOi in zip(
                y_inv_vec, u_for_gh, s_rev[:padded_n], wL_pad, wO_pad
            )
        ]

        head, tail = self._head_tail_scalars(ing, proof, p, delta)
        return head + g_scalars + h_scalars + tail

    def verify(
        self,
        proof: R1CSProof,
        pc_gens: PedersenGens,
        bp_gens: BulletproofGens,
    ) -> None:
        """Single mega-MSM == 0 check (reference verifier.rs:549-600).
        Raises R1CSVerificationError on failure."""
        self.verify_and_return_transcript(proof, pc_gens, bp_gens)

    def verify_and_return_transcript(self, proof, pc_gens, bp_gens) -> Transcript:
        # NOTE: phase-2 multipliers are allocated during the transcript
        # replay, so padded_n is only known after ingredients are built.
        with phase("verify:replay"):
            ing = self._verification_ingredients(proof, bp_gens)
        padded_n = ing["padded_n"]
        if (padded_n >= DEVICE_SCALARS_MIN_N
                and engine.use_device(2 * padded_n)):
            return self._verify_device(ing, proof, pc_gens, bp_gens)
        with phase("verify:scalars"):
            scalars = self._assemble_host_scalars(ing, proof)
        with phase("verify:msm"):
            check = _mega_msm(self.curve, pc_gens, bp_gens,
                              ing["padded_n"], self._extra_bases(proof),
                              scalars)
        if not self.curve.is_zero(check):
            raise R1CSVerificationError("mega-MSM check failed")
        return self._transcript

    def _verify_device(self, ing, proof, pc_gens, bp_gens) -> Transcript:
        """The g/h scalar vectors made on the device (ops/verify.py) and
        fed to the device mega-MSM with no host round trip; delta comes
        from host ints (a device fetch would synchronise)."""
        curve = self.curve
        fr = curve.fr
        p = fr.p
        padded_n = ing["padded_n"]
        with phase("verify:scalars"):
            g, h, delta = dverify.gh_scalars(
                curve, padded_n, ing["wL"], ing["wR"], ing["wO"],
                fr.inv(ing["y"]), ing["u"], ing["x"], ing["a"], ing["b"],
                ing["u_sq"], ing["allinv"], ing["n1"], delta_host=True,
                device=engine.torch_device())
            head, tail = self._head_tail_scalars(ing, proof, p, delta)
            scal = _scalar_limbs(head, g, h, tail)
        with phase("verify:msm"):
            check = _device_mega_msm(curve, pc_gens, bp_gens, padded_n,
                                     self._extra_bases(proof), scal)
        if not curve.is_zero(check):
            raise R1CSVerificationError("mega-MSM check failed")
        return self._transcript

    def _extra_bases(self, proof) -> list:
        return (
            [proof.A_I1, proof.A_O1, proof.S1, proof.A_I2, proof.A_O2, proof.S2]
            + self.V
            + [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6]
            + proof.ipp_proof.L_vec
            + proof.ipp_proof.R_vec
        )


class RandomizingVerifier(RandomizedConstraintSystem):
    """Phase-two verifier view (reference verifier.rs:65-67, 166-224)."""

    def __init__(self, verifier: Verifier):
        self.verifier = verifier

    def transcript(self):
        return self.verifier.transcript()

    def multiply(self, left, right):
        return self.verifier.multiply(left, right)

    def allocate(self, assignment=None):
        return self.verifier.allocate(assignment)

    def allocate_multiplier(self, input_assignments=None):
        return self.verifier.allocate_multiplier(input_assignments)

    def multipliers_len(self):
        return self.verifier.multipliers_len()

    def constrain(self, lc):
        self.verifier.constrain(lc)

    def specify_randomized_constraints(self, callback):
        raise RuntimeError("already in the randomizing phase")

    def challenge_scalar(self, label: bytes) -> int:
        return protocol.challenge_scalar(
            self.verifier._transcript, self.verifier.curve, label
        )


def batch_verify(
    prng,
    instances: list[tuple[Verifier, R1CSProof]],
    pc_gens: PedersenGens,
    bp_gens: BulletproofGens,
) -> None:
    """Aggregated verification of many proofs with one giant MSM
    (reference verifier.rs:604-691). Each proof's scalar vector is scaled by
    a fresh random alpha; shared B/B_blinding/G/H columns accumulate across
    proofs. Raises R1CSVerificationError if the batch fails."""
    curve = pc_gens.curve
    fr = curve.fr
    p = fr.p
    ings = [v._verification_ingredients(proof, bp_gens)
            for v, proof in instances]
    max_padded = max(ing["padded_n"] for ing in ings)
    if (max_padded >= DEVICE_SCALARS_MIN_N
            and engine.use_device(2 * max_padded)):
        return _batch_verify_device(prng, instances, ings, pc_gens, bp_gens,
                                    max_padded)
    max_n = max_padded
    with phase("verify:scalars"):
        vecs = [v._assemble_host_scalars(ing, proof)
                for (v, proof), ing in zip(instances, ings)]
        all_scalars = [0] * (2 * max_n + 2)
        extras: list = []
        for (verifier, proof), scalars in zip(instances, vecs):
            alpha = fr.rand(prng)
            scaled = [alpha * s % p for s in scalars]
            padded_n = next_power_of_two(verifier.num_vars)
            all_scalars[0] = (all_scalars[0] + scaled[0]) % p
            all_scalars[1] = (all_scalars[1] + scaled[1]) % p
            for i, s in enumerate(scaled[2: 2 + padded_n]):
                all_scalars[i + 2] = (all_scalars[i + 2] + s) % p
            for i, s in enumerate(scaled[2 + padded_n: 2 + 2 * padded_n]):
                j = 2 + max_n + i
                all_scalars[j] = (all_scalars[j] + s) % p
            all_scalars.extend(scaled[2 + 2 * padded_n:])
            extras.extend(verifier._extra_bases(proof))
    with phase("verify:msm"):
        check = _mega_msm(curve, pc_gens, bp_gens, max_n, extras,
                          all_scalars)
    if not curve.is_zero(check):
        raise R1CSVerificationError("batch verification failed")


def _batch_verify_device(prng, instances, ings, pc_gens, bp_gens,
                         max_padded: int) -> None:
    """Batch verification with the g/h vectors on the device: each size
    group of proofs (by padded_n) builds, alpha-scales and sums its
    vectors in one batched pass (`_gh_scalars_batch_accum`); the groups
    are added into the shared G/H columns there, and one device mega-MSM
    closes the batch. The host draws the alphas in instance order, as the
    host route does, and computes each delta and the head/tail scalars."""
    curve = pc_gens.curve
    fr = curve.fr
    p = fr.p
    frs = dfield.spec_for(fr)
    dev = engine.torch_device()
    with phase("verify:scalars"):
        head_acc = [0, 0]
        tails: list[int] = []
        extras: list = []
        alphas: list[int] = []
        for (verifier, proof), ing in zip(instances, ings):
            delta = dverify.compute_delta_host(p, ing["wL"], ing["wR"],
                                               fr.inv(ing["y"]))
            head, tail = verifier._head_tail_scalars(ing, proof, p, delta)
            alpha = fr.rand(prng)
            alphas.append(alpha)
            head_acc = [(acc + alpha * v) % p for acc, v in zip(head_acc,
                                                               head)]
            tails.extend(v * alpha % p for v in tail)
            extras.extend(verifier._extra_bases(proof))
        groups: dict[int, list[int]] = {}
        for i, ing in enumerate(ings):
            groups.setdefault(ing["padded_n"], []).append(i)
        acc = None
        for padded_n, idxs in groups.items():
            lg_n = padded_n.bit_length() - 1
            sub = [ings[i] for i in idxs]
            cols = dverify._rows(
                [[fr.inv(g["y"]), g["u"], g["x"], g["a"], g["b"],
                  g["allinv"]] for g in sub], 6, dev)  # (B, 16, 6)
            g_sum, h_sum = dverify._gh_scalars_batch_accum(
                frs, padded_n, lg_n,
                *(dverify._rows([g[k] for g in sub], padded_n, dev)
                  for k in ("wL", "wR", "wO")),
                *(cols[..., j:j + 1] for j in range(5)),
                dverify._rows([g["u_sq"] for g in sub], lg_n, dev),
                cols[..., 5:6], [g["n1"] for g in sub],
                dverify._rows([[alphas[i] * fr.R % p] for i in idxs], 1,
                              dev))
            gh = torch.nn.functional.pad(torch.stack([g_sum, h_sum]),
                                         (0, max_padded - padded_n))
            acc = gh if acc is None else dfield.add(frs, acc, gh)
        g_can, h_can = dfield.from_mont(frs, acc).unbind(0)
        scal = _scalar_limbs(head_acc, g_can, h_can, tails)
    with phase("verify:msm"):
        check = _device_mega_msm(curve, pc_gens, bp_gens, max_padded, extras,
                                 scal)
    if not curve.is_zero(check):
        raise R1CSVerificationError("batch verification failed")
