"""R1CS prover on the port (reference src/r1cs/prover.rs; counterpart of
ark_bulletproofs_tpu/r1cs/prover.py).

Two-phase randomized constraint-system prover. Phase 1 commits the witness
wires; deferred constraint callbacks run in phase 2 against challenges
bound to the phase-1 commitments; the blinded vector polynomials l(x), r(x)
reduce the whole system to one inner-product argument.

All proof randomness is drawn from a Merlin TranscriptRng rekeyed with the
v_blinding witness bytes (reference prover.rs:483-494), so proofs are
deterministic given (witness, transcript history, external entropy).

Hot paths are routed through the engine for device offload, with the
JAX package's size thresholds:

- each phase's three commitment MSMs: one 3-set base_map MSM over the
  cached [G | H | B | B_blinding] device table (ops/cache.py::full_table)
  once the phase has 2 n_phase + 1 >= engine.config.msm_device_threshold
  terms. The JAX package gates the phase-2 table route on the phase-1
  width; the port gates each phase on its own, so a circuit whose
  multipliers are all in phase 2 (the shuffle) takes the table route.
  Under an engine mesh they run as `engine.msm_many`, which the router
  shards (the base_map would read across the mesh's blocks), as in the
  JAX package;
- the l/r polynomials and t(x): the device vector phase (ops/prove.py)
  from padded_n >= VECTOR_MIN_N;
- the IPA: ipp.py's device route from n >= ipp.DEVICE_MIN_N.

Every route gives the same proof bytes: randomness is drawn in one order
and the transcript sees the same appends.
"""

from __future__ import annotations

from .. import engine
from ..utils.profiling import phase
from ..errors import MissingAssignment, R1CSInvalidGeneratorsLength
from ..generators import BulletproofGens, PedersenGens
from ..ipp import InnerProductProof
from ..transcript import protocol
from ..transcript.merlin import Transcript
from ..util import VecPoly3, Poly6, exp_vec, next_power_of_two
from .constraint_system import (
    RandomizableConstraintSystem,
    RandomizedConstraintSystem,
)
from .linear_combination import LinearCombination, Variable
from .proof import R1CSProof

# Smallest padded_n for the device vector phase (the JAX package's value).
VECTOR_MIN_N = 256


class Prover(RandomizableConstraintSystem):
    def __init__(self, pc_gens: PedersenGens, transcript: Transcript):
        self.curve = pc_gens.curve
        self.pc_gens = pc_gens
        self._transcript = transcript
        protocol.r1cs_domain_sep(transcript)

        # witness ("secrets" in the reference, prover.rs:49-60)
        self.a_L: list[int] = []
        self.a_R: list[int] = []
        self.a_O: list[int] = []
        self.v: list[int] = []
        self.v_blinding: list[int] = []

        self.constraints: list[LinearCombination] = []
        self.deferred_constraints = []
        self.pending_multiplier: int | None = None

    # --- ConstraintSystem ------------------------------------------------

    def transcript(self) -> Transcript:
        return self._transcript

    def _lc(self, value) -> LinearCombination:
        return LinearCombination.from_value(self.curve.fr, value)

    def eval(self, lc: LinearCombination) -> int:
        p = self.curve.fr.p
        total = 0
        for var, coeff in lc.terms:
            if var.kind == Variable.MUL_LEFT:
                val = self.a_L[var.index]
            elif var.kind == Variable.MUL_RIGHT:
                val = self.a_R[var.index]
            elif var.kind == Variable.MUL_OUT:
                val = self.a_O[var.index]
            elif var.kind == Variable.COMMITTED:
                val = self.v[var.index]
            elif var.kind == Variable.ONE:
                val = 1
            else:
                val = 0
            total += coeff * val
        return total % p

    def multiply(self, left, right):
        left = self._lc(left)
        right = self._lc(right)
        l = self.eval(left)
        r = self.eval(right)
        o = l * r % self.curve.fr.p

        i = len(self.a_L)
        fr = self.curve.fr
        l_var = Variable(Variable.MUL_LEFT, i, fr)
        r_var = Variable(Variable.MUL_RIGHT, i, fr)
        o_var = Variable(Variable.MUL_OUT, i, fr)
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(o)

        self.constrain(left - l_var)
        self.constrain(right - r_var)
        return l_var, r_var, o_var

    def allocate(self, assignment=None):
        if assignment is None:
            raise MissingAssignment("prover requires an assignment")
        scalar = int(assignment) % self.curve.fr.p
        fr = self.curve.fr
        if self.pending_multiplier is None:
            i = len(self.a_L)
            self.pending_multiplier = i
            self.a_L.append(scalar)
            self.a_R.append(0)
            self.a_O.append(0)
            return Variable(Variable.MUL_LEFT, i, fr)
        i = self.pending_multiplier
        self.pending_multiplier = None
        self.a_R[i] = scalar
        self.a_O[i] = self.a_L[i] * scalar % fr.p
        return Variable(Variable.MUL_RIGHT, i, fr)

    def allocate_multiplier(self, input_assignments=None):
        if input_assignments is None:
            raise MissingAssignment("prover requires assignments")
        l, r = input_assignments
        fr = self.curve.fr
        l %= fr.p
        r %= fr.p
        i = len(self.a_L)
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(l * r % fr.p)
        return (
            Variable(Variable.MUL_LEFT, i, fr),
            Variable(Variable.MUL_RIGHT, i, fr),
            Variable(Variable.MUL_OUT, i, fr),
        )

    def multipliers_len(self) -> int:
        return len(self.a_L)

    def constrain(self, lc) -> None:
        self.constraints.append(self._lc(lc))

    def specify_randomized_constraints(self, callback) -> None:
        self.deferred_constraints.append(callback)

    # --- protocol ----------------------------------------------------------

    def commit(self, v: int, v_blinding: int):
        """Pedersen-commit a high-level variable; returns (point, Variable)."""
        fr = self.curve.fr
        i = len(self.v)
        self.v.append(int(v) % fr.p)
        self.v_blinding.append(int(v_blinding) % fr.p)
        V = self.pc_gens.commit(v, v_blinding)
        protocol.append_point(self._transcript, self.curve, b"V", V)
        return V, Variable(Variable.COMMITTED, i, fr)

    def commit_many(self, values: list[int], blinds: list[int]):
        """Batched `commit` — same transcript appends in the same order,
        with the Pedersen math done as one fixed-base batch
        (PedersenGens.commit_many; bit-identical to the loop)."""
        fr = self.curve.fr
        with phase("commit:pedersen-math"):
            pts = self.pc_gens.commit_many(values, blinds)
        out = []
        with phase("commit:appends"):
            # One bulk transcript absorb (same per-point byte framing;
            # Transcript.append_messages).
            self._transcript.append_messages(
                b"V",
                [self.curve.serialize_uncompressed(V) for V in pts],
            )
            for v, r, V in zip(values, blinds, pts):
                i = len(self.v)
                self.v.append(int(v) % fr.p)
                self.v_blinding.append(int(r) % fr.p)
                out.append((V, Variable(Variable.COMMITTED, i, fr)))
        return out

    def flattened_constraints(self, z: int):
        """Per-wire weights via powers of z (reference prover.rs:354-397)."""
        p = self.curve.fr.p
        n = len(self.a_L)
        m = len(self.v)
        wL = [0] * n
        wR = [0] * n
        wO = [0] * n
        wV = [0] * m
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
                # ONE terms are not needed by the prover
            exp_z = exp_z * z % p
        return wL, wR, wO, wV

    def _create_randomized_constraints(self):
        self.pending_multiplier = None
        if not self.deferred_constraints:
            protocol.r1cs_1phase_domain_sep(self._transcript)
            return
        protocol.r1cs_2phase_domain_sep(self._transcript)
        callbacks = self.deferred_constraints
        self.deferred_constraints = []
        wrapper = RandomizingProver(self)
        for cb in callbacks:
            cb(wrapper)

    @staticmethod
    def _tabled(terms: int) -> bool:
        """Whether a phase's commitments take the cached table route: on
        the device, and on one device (no mesh)."""
        return engine.use_device(terms) and engine.active_mesh() is None

    def _tabled_msm(self, bp_gens, rows, lo: int, hi: int) -> list:
        """The three commitments of the phase over multipliers [lo, hi):
        rows[b] = [blinding] + scalars for G[lo:hi] and H[lo:hi]. The
        G/H terms run as one 3-set base_map MSM over the cached device
        table; the blinding terms go through the native fixed-base path
        on the host (the table's B_blinding row would widen the MSM past
        a power of two)."""
        from ..ops import cache as dcache
        from ..ops.msm import msm_many_tabled

        curve = self.curve
        if bp_gens.gens_capacity < hi:
            raise R1CSInvalidGeneratorsLength()
        blinds = self.pc_gens.commit_many([0, 0, 0], [r[0] for r in rows])
        if hi == lo:  # no multipliers in this phase: only the blindings
            return blinds
        tab = dcache.full_table(bp_gens, self.pc_gens, curve,
                                engine.torch_device())
        cap = tab[3]
        idx = list(range(lo, hi)) + list(range(cap + lo, cap + hi))
        parts = msm_many_tabled(curve, tab, [r[1:] for r in rows], idx)
        return [curve.add(P, Bl) for P, Bl in zip(parts, blinds)]

    def prove(self, prng, bp_gens: BulletproofGens) -> R1CSProof:
        proof, _t = self.prove_and_return_transcript(prng, bp_gens)
        return proof

    def prove_and_return_transcript(self, prng, bp_gens: BulletproofGens):
        curve = self.curve
        fr = curve.fr
        p = fr.p
        t = self._transcript

        # Length suffix for the number of high-level variables.
        t.append_u64(b"m", len(self.v))

        # Witness-bound RNG (reference prover.rs:483-494).
        with phase("prove:rng"):
            builder = t.build_rng().rekey_with_witness_many(
                b"v_blinding",
                [fr.to_bytes(v_b) for v_b in self.v_blinding],
            )
            rng = builder.finalize(prng)

        n1 = len(self.a_L)
        if bp_gens.gens_capacity < n1:
            raise R1CSInvalidGeneratorsLength()

        gens = bp_gens.share(0)

        # One bulk draw, sliced in the sequential order of the per-call
        # path (bit-identical; fields.rand_many) — the ~4k per-call
        # draws were the largest host item of a k=1024 prove.
        draws1 = fr.rand_many(rng, 3 + 2 * n1)
        i_blinding1, o_blinding1, s_blinding1 = draws1[:3]
        s_L1 = draws1[3:3 + n1]
        s_R1 = draws1[3 + n1:]

        Bb = self.pc_gens.B_blinding
        G1 = gens.G(n1)
        H1 = gens.H(n1)
        # A_I1 = <a_L, G> + <a_R, H> + i_blinding * B_blinding
        # A_O1 = <a_O, G> + o_blinding * B_blinding
        # S1 = <s_L1, G> + <s_R1, H> + s_blinding * B_blinding
        # One batched-scalar-set MSM (A_O1's H half rides as zeros), so
        # the three phase commitments share one device run and one fetch
        # (reference prover.rs:516-532 issues three).
        zeros1 = [0] * n1
        with phase("prove:phase1_msm"):
            rows1 = [
                [i_blinding1] + self.a_L + self.a_R,
                [o_blinding1] + self.a_O + zeros1,
                [s_blinding1] + s_L1 + s_R1,
            ]
            if self._tabled(2 * n1 + 1):
                A_I1, A_O1, S1 = self._tabled_msm(bp_gens, rows1, 0, n1)
            else:
                A_I1, A_O1, S1 = engine.msm_many(
                    curve, [Bb] + G1 + H1, rows1
                )

            protocol.append_point(t, curve, b"A_I1", A_I1)
            protocol.append_point(t, curve, b"A_O1", A_O1)
            protocol.append_point(t, curve, b"S1", S1)

        # Phase 2: run deferred constraints against fresh challenges.
        with phase("prove:phase2_constraints"):
            self._create_randomized_constraints()

        n = len(self.a_L)
        n2 = n - n1
        padded_n = next_power_of_two(n)
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise R1CSInvalidGeneratorsLength()

        has_phase2 = n2 > 0
        if has_phase2:
            draws2 = fr.rand_many(rng, 3 + 2 * n2)
            i_blinding2, o_blinding2, s_blinding2 = draws2[:3]
            s_L2 = draws2[3:3 + n2]
            s_R2 = draws2[3 + n2:]
        else:
            i_blinding2 = o_blinding2 = s_blinding2 = 0
            s_L2, s_R2 = [], []

        with phase("prove:phase2_msm"):
            if has_phase2:
                zeros2 = [0] * n2
                rows2 = [
                    [i_blinding2] + self.a_L[n1:] + self.a_R[n1:],
                    [o_blinding2] + self.a_O[n1:] + zeros2,
                    [s_blinding2] + s_L2 + s_R2,
                ]
                if self._tabled(2 * n2 + 1):
                    A_I2, A_O2, S2 = self._tabled_msm(bp_gens, rows2, n1, n)
                else:
                    G2 = gens.G(n)[n1:]
                    H2 = gens.H(n)[n1:]
                    A_I2, A_O2, S2 = engine.msm_many(
                        curve, [Bb] + G2 + H2, rows2
                    )
            else:
                A_I2 = A_O2 = S2 = curve.zero()

            protocol.append_point(t, curve, b"A_I2", A_I2)
            protocol.append_point(t, curve, b"A_O2", A_O2)
            protocol.append_point(t, curve, b"S2", S2)

        y = protocol.challenge_scalar(t, curve, b"y")
        z = protocol.challenge_scalar(t, curve, b"z")

        with phase("prove:flatten"):
            wL, wR, wO, wV = self.flattened_constraints(z)

        # Blinded vector polynomials l(x), r(x) (reference prover.rs:671-701).
        y_inv = fr.inv(y)
        exp_y_inv = exp_vec(fr, y_inv, padded_n)
        s_L = s_L1 + s_L2
        s_R = s_R1 + s_R2

        device_vectors = padded_n >= VECTOR_MIN_N and engine.use_device(
            2 * padded_n
        )
        if device_vectors:
            # Device vector phase (ops/prove.py): l/r coefficients and
            # the t-polynomial on the device; l(x), r(x) stay there and
            # feed the device IPA directly.
            from ..ops.prove import ProverVectorPhase

            with phase("prove:vectors"):
                pv = ProverVectorPhase(
                    curve, padded_n, self.a_L, self.a_R, self.a_O,
                    s_L, s_R, wL, wR, wO, y, y_inv, engine.torch_device(),
                )
                t_poly = Poly6(fr, *pv.t)
            l_poly = r_poly = None
        else:
            l_poly = VecPoly3(fr, n)
            r_poly = VecPoly3(fr, n)
            exp_y = 1
            for i in range(n):
                l_poly.c1[i] = (self.a_L[i] + exp_y_inv[i] * wR[i]) % p
                l_poly.c2[i] = self.a_O[i]
                l_poly.c3[i] = s_L[i]
                r_poly.c0[i] = (wO[i] - exp_y) % p
                r_poly.c1[i] = (exp_y * self.a_R[i] + wL[i]) % p
                r_poly.c3[i] = exp_y * s_R[i] % p
                exp_y = exp_y * y % p
            t_poly = VecPoly3.special_inner_product(l_poly, r_poly)

        t_1_blinding = fr.rand(rng)
        t_3_blinding = fr.rand(rng)
        t_4_blinding = fr.rand(rng)
        t_5_blinding = fr.rand(rng)
        t_6_blinding = fr.rand(rng)

        with phase("prove:T_commits"):
            T_1, T_3, T_4, T_5, T_6 = self.pc_gens.commit_many(
                [t_poly.t1, t_poly.t3, t_poly.t4, t_poly.t5, t_poly.t6],
                [t_1_blinding, t_3_blinding, t_4_blinding, t_5_blinding,
                 t_6_blinding],
            )

        protocol.append_point(t, curve, b"T_1", T_1)
        protocol.append_point(t, curve, b"T_3", T_3)
        protocol.append_point(t, curve, b"T_4", T_4)
        protocol.append_point(t, curve, b"T_5", T_5)
        protocol.append_point(t, curve, b"T_6", T_6)

        u = protocol.challenge_scalar(t, curve, b"u")
        x = protocol.challenge_scalar(t, curve, b"x")

        # t_2's commitment is folded into the V term: its blinding is
        # <wV, v_blinding> (reference prover.rs:727-733).
        t_2_blinding = sum(c * vb for c, vb in zip(wV, self.v_blinding)) % p

        t_blinding_poly = Poly6(
            fr, t_1_blinding, t_2_blinding, t_3_blinding,
            t_4_blinding, t_5_blinding, t_6_blinding,
        )

        t_x = t_poly.eval(x)
        t_x_blinding = t_blinding_poly.eval(x)
        if device_vectors:
            # Device evaluation; padding with -y^i is implicit (the
            # padded formulas degenerate to r[i] = -y^i, l[i] = 0).
            with phase("prove:eval_lr"):
                l_vec, r_vec = pv.eval_lr(x)
        else:
            l_vec = l_poly.eval(x) + [0] * pad
            r_vec = r_poly.eval(x) + [0] * pad
            # Padding of r carries -y^i so <l, r> stays consistent with
            # t(x) (reference prover.rs:753-756); exp_y == y^n here.
            exp_y = fr.pow(y, n)
            for i in range(n, padded_n):
                r_vec[i] = (p - exp_y) % p
                exp_y = exp_y * y % p

        i_blinding = (i_blinding1 + u * i_blinding2) % p
        o_blinding = (o_blinding1 + u * o_blinding2) % p
        s_blinding = (s_blinding1 + u * s_blinding2) % p
        e_blinding = x * (i_blinding + x * (o_blinding + x * s_blinding)) % p

        protocol.append_scalar(t, curve, b"t_x", t_x)
        protocol.append_scalar(t, curve, b"t_x_blinding", t_x_blinding)
        protocol.append_scalar(t, curve, b"e_blinding", e_blinding)

        w = protocol.challenge_scalar(t, curve, b"w")
        Q = curve.mul_bigint(self.pc_gens.B, w)

        G_factors = [1] * n1 + [u] * (n2 + pad)
        H_factors = [yi * gf % p for yi, gf in zip(exp_y_inv, G_factors)]

        with phase("prove:ipa"):
            ipp_proof = InnerProductProof.create(
                t, curve, Q, G_factors, H_factors,
                gens.G(padded_n), gens.H(padded_n), l_vec, r_vec,
            )

        # Secret hygiene (best effort; see util.VecPoly3.clear docstring).
        if l_poly is not None:
            l_poly.clear()
            r_poly.clear()
        s_L1[:] = [0] * len(s_L1)
        s_R1[:] = [0] * len(s_R1)
        s_L2[:] = [0] * len(s_L2)
        s_R2[:] = [0] * len(s_R2)

        proof = R1CSProof(
            A_I1=A_I1, A_O1=A_O1, S1=S1, A_I2=A_I2, A_O2=A_O2, S2=S2,
            T_1=T_1, T_3=T_3, T_4=T_4, T_5=T_5, T_6=T_6,
            t_x=t_x, t_x_blinding=t_x_blinding, e_blinding=e_blinding,
            ipp_proof=ipp_proof,
        )
        return proof, t


class RandomizingProver(RandomizedConstraintSystem):
    """Phase-two prover view (reference prover.rs:69-71, 210-268)."""

    def __init__(self, prover: Prover):
        self.prover = prover

    def transcript(self):
        return self.prover.transcript()

    def multiply(self, left, right):
        return self.prover.multiply(left, right)

    def allocate(self, assignment=None):
        return self.prover.allocate(assignment)

    def allocate_multiplier(self, input_assignments=None):
        return self.prover.allocate_multiplier(input_assignments)

    def multipliers_len(self):
        return self.prover.multipliers_len()

    def constrain(self, lc):
        self.prover.constrain(lc)

    def specify_randomized_constraints(self, callback):
        raise RuntimeError("already in the randomizing phase")

    def challenge_scalar(self, label: bytes) -> int:
        return protocol.challenge_scalar(
            self.prover._transcript, self.prover.curve, label
        )


def prove_batch(provers: list, prngs: list,
                bp_gens: BulletproofGens) -> list:
    """Proofs of P constraint systems of one shape, made in lockstep.

    Each proof equals `provers[b].prove(prngs[b], bp_gens)` byte for byte:
    every prover keeps its own transcript and RNG, and the phases run in
    the same order within each proof. Across the batch, the three
    commitments of each phase for all P provers are one `engine.msm_many`
    call (3P scalar sets over [B_blinding | G | H]), and the IPA is
    `InnerProductProof.create_batch` (one batched device MSM a round with
    the Fiat-Shamir steps of all P proofs together). The l and r
    polynomials run on the host, per proof, as in the JAX package's
    `prove_batch` (reference src/r1cs/prover.rs:444 proves one at a
    time). Requires equal n1 and, after phase 2, equal n."""
    P = len(provers)
    assert P == len(prngs) and P > 0
    curve = provers[0].curve
    fr = curve.fr
    p = fr.p

    rngs, states = [], []
    for prover, prng in zip(provers, prngs):
        t = prover._transcript
        t.append_u64(b"m", len(prover.v))
        builder = t.build_rng().rekey_with_witness_many(
            b"v_blinding", [fr.to_bytes(v_b) for v_b in prover.v_blinding])
        rngs.append(builder.finalize(prng))

    n1 = len(provers[0].a_L)
    if any(len(pr.a_L) != n1 for pr in provers):
        raise ValueError("prove_batch requires equal phase-1 shapes")
    if bp_gens.gens_capacity < n1:
        raise R1CSInvalidGeneratorsLength()
    gens = bp_gens.share(0)
    Bb = provers[0].pc_gens.B_blinding

    for rng in rngs:
        d = fr.rand_many(rng, 3 + 2 * n1)
        states.append({"i1": d[0], "o1": d[1], "s1": d[2],
                       "s_L1": d[3:3 + n1], "s_R1": d[3 + n1:]})

    with phase("prove_batch:phase1_msm"):
        sets = []
        for prover, st in zip(provers, states):
            sets.append([st["i1"]] + prover.a_L + prover.a_R)
            sets.append([st["o1"]] + prover.a_O + [0] * n1)
            sets.append([st["s1"]] + st["s_L1"] + st["s_R1"])
        pts = engine.msm_many(curve, [Bb] + gens.G(n1) + gens.H(n1), sets)

    for b, (prover, st) in enumerate(zip(provers, states)):
        st["A_I1"], st["A_O1"], st["S1"] = pts[3 * b: 3 * b + 3]
        t = prover._transcript
        protocol.append_point(t, curve, b"A_I1", st["A_I1"])
        protocol.append_point(t, curve, b"A_O1", st["A_O1"])
        protocol.append_point(t, curve, b"S1", st["S1"])
        prover._create_randomized_constraints()

    n = len(provers[0].a_L)
    if any(len(pr.a_L) != n for pr in provers):
        raise ValueError("prove_batch requires equal phase-2 shapes")
    n2 = n - n1
    padded_n = next_power_of_two(n)
    pad = padded_n - n
    if bp_gens.gens_capacity < padded_n:
        raise R1CSInvalidGeneratorsLength()

    for st, rng in zip(states, rngs):
        if n2:
            d = fr.rand_many(rng, 3 + 2 * n2)
            st["i2"], st["o2"], st["s2"] = d[0], d[1], d[2]
            st["s_L2"], st["s_R2"] = d[3:3 + n2], d[3 + n2:]
        else:
            st["i2"] = st["o2"] = st["s2"] = 0
            st["s_L2"], st["s_R2"] = [], []

    with phase("prove_batch:phase2_msm"):
        if n2:
            sets = []
            for prover, st in zip(provers, states):
                sets.append([st["i2"]] + prover.a_L[n1:] + prover.a_R[n1:])
                sets.append([st["o2"]] + prover.a_O[n1:] + [0] * n2)
                sets.append([st["s2"]] + st["s_L2"] + st["s_R2"])
            pts = engine.msm_many(
                curve, [Bb] + gens.G(n)[n1:] + gens.H(n)[n1:], sets)
        else:
            pts = [curve.zero()] * (3 * P)

    ipa_in = []  # (transcript, w, G_factors, H_factors, l, r) per proof
    partial = []
    with phase("prove_batch:polynomials"):
        for b, (prover, st, rng) in enumerate(zip(provers, states, rngs)):
            t = prover._transcript
            A_I2, A_O2, S2 = pts[3 * b: 3 * b + 3]
            protocol.append_point(t, curve, b"A_I2", A_I2)
            protocol.append_point(t, curve, b"A_O2", A_O2)
            protocol.append_point(t, curve, b"S2", S2)
            y = protocol.challenge_scalar(t, curve, b"y")
            z = protocol.challenge_scalar(t, curve, b"z")
            wL, wR, wO, wV = prover.flattened_constraints(z)
            exp_y_inv = exp_vec(fr, fr.inv(y), padded_n)
            s_L = st["s_L1"] + st["s_L2"]
            s_R = st["s_R1"] + st["s_R2"]
            l_poly = VecPoly3(fr, n)
            r_poly = VecPoly3(fr, n)
            exp_y = 1
            for i in range(n):
                l_poly.c1[i] = (prover.a_L[i] + exp_y_inv[i] * wR[i]) % p
                l_poly.c2[i] = prover.a_O[i]
                l_poly.c3[i] = s_L[i]
                r_poly.c0[i] = (wO[i] - exp_y) % p
                r_poly.c1[i] = (exp_y * prover.a_R[i] + wL[i]) % p
                r_poly.c3[i] = exp_y * s_R[i] % p
                exp_y = exp_y * y % p
            t_poly = VecPoly3.special_inner_product(l_poly, r_poly)
            tb = [fr.rand(rng) for _ in range(5)]  # t_1, t_3 .. t_6 blindings
            Ts = prover.pc_gens.commit_many(
                [t_poly.t1, t_poly.t3, t_poly.t4, t_poly.t5, t_poly.t6], tb)
            for label, T in zip((b"T_1", b"T_3", b"T_4", b"T_5", b"T_6"),
                                Ts):
                protocol.append_point(t, curve, label, T)
            u = protocol.challenge_scalar(t, curve, b"u")
            x = protocol.challenge_scalar(t, curve, b"x")
            t_2_blinding = sum(c * vb for c, vb in
                               zip(wV, prover.v_blinding)) % p
            t_x = t_poly.eval(x)
            t_x_blinding = Poly6(fr, tb[0], t_2_blinding, *tb[1:]).eval(x)
            l_vec = l_poly.eval(x) + [0] * pad
            r_vec = r_poly.eval(x) + [0] * pad
            exp_y = fr.pow(y, n)
            for i in range(n, padded_n):
                r_vec[i] = (p - exp_y) % p
                exp_y = exp_y * y % p
            i_blinding = (st["i1"] + u * st["i2"]) % p
            o_blinding = (st["o1"] + u * st["o2"]) % p
            s_blinding = (st["s1"] + u * st["s2"]) % p
            e_blinding = x * (i_blinding + x * (o_blinding
                                                + x * s_blinding)) % p
            protocol.append_scalar(t, curve, b"t_x", t_x)
            protocol.append_scalar(t, curve, b"t_x_blinding", t_x_blinding)
            protocol.append_scalar(t, curve, b"e_blinding", e_blinding)
            w = protocol.challenge_scalar(t, curve, b"w")
            G_factors = [1] * n1 + [u] * (n2 + pad)
            H_factors = [yi * gf % p for yi, gf in zip(exp_y_inv, G_factors)]
            ipa_in.append((t, w, G_factors, H_factors, l_vec, r_vec))
            partial.append(dict(
                A_I1=st["A_I1"], A_O1=st["A_O1"], S1=st["S1"], A_I2=A_I2,
                A_O2=A_O2, S2=S2, T_1=Ts[0], T_3=Ts[1], T_4=Ts[2], T_5=Ts[3],
                T_6=Ts[4], t_x=t_x, t_x_blinding=t_x_blinding,
                e_blinding=e_blinding))
            l_poly.clear()
            r_poly.clear()
            for key in ("s_L1", "s_R1", "s_L2", "s_R2"):
                st[key][:] = [0] * len(st[key])

    with phase("prove_batch:ipa"):
        ts, ws, gfs, hfs, ls, rs = zip(*ipa_in)
        ipa_proofs = InnerProductProof.create_batch(
            list(ts), curve, provers[0].pc_gens.B, list(ws), list(gfs),
            list(hfs), gens.G(padded_n), gens.H(padded_n), list(ls),
            list(rs))
    return [R1CSProof(ipp_proof=ip, **kw)
            for kw, ip in zip(partial, ipa_proofs)]
