"""Elementwise group-law kernels (CUDA, csrc/msm_kernels.cu and, on Jacobian
points, csrc/jac_kernels.cu).

  rcb_double_k_add <- ark_bulletproofs_tpu/ops/kernels.py::
      rcb_double_k_add_tiled (the JAX v2 MSM's stage-G Horner step; the
      port's runs as one `horner_windows` launch, ops/kernels2.py) and,
      with k = 0, ::rcb_add_tiled (the complete adds of the MSM glue and
      of the ragged MSM's chunk sum), short-Weierstrass curves;
  te_double_k_add  <- ::te_double_k_add_tiled and, with k = 0,
      ::te_add_tiled: the same steps on a twisted-Edwards curve, and the
      device Pedersen batch's halving tree (ops/prove.py);
      both: a group of 8 threads a lane (csrc/group.cuh), of 4 from the
      model's first band edge (DKA_BANDS), one thread a lane from its
      second (a throughput kernel without the doubling code at k = 0);
  te_double        <- ::te_double_tiled: 2P, or with `steps` a chain of
      doublings in one launch (a group of 8 threads a lane), the 2^i B
      table of that batch (ops/cache.py) and the on-device Fiat-Shamir
      IPA's 2^i Q table (ops/ipa.py);
  rcb_double       <- ::rcb_double_tiled: complete RCB doubling (Alg 9
      for a = 0, Alg 3 otherwise), the doubling chain at one step: a
      group of 4 (a = 0) or 8 threads a lane, one thread a lane from the
      model's DBL_BANDS edge; as in the JAX package, only `double` reaches
      it and no path of the port calls that;
  jac_double_k_add <- ::sw_add_tiled (k = 0) and ::sw_double_k_add_tiled:
      Jacobian points (csrc/jac.cuh), the on-device Fiat-Shamir IPA's
      c * Q tree and S = MSM + c * Q on short-Weierstrass curves, and the
      v1 Pippenger's adds; bands as above (DKA_BANDS["jac"]);
  jac_double       <- ::sw_double_tiled: 2P, or with `steps` a chain of
      doublings in one launch, that IPA's 2^i Q table (the JAX package's
      255-step scan; a group of 4 threads a lane);
  jac_madd         <- ::sw_madd_tiled: Jacobian P + affine Q, or over R
      rows of Q their suffix sums in one launch: the row scan of the v1
      Pippenger (ops/msm.py; the JAX package's lax.scan of the kernel) on
      short-Weierstrass curves (a group of 4 threads a lane, of 2 from
      MADD_BANDS["jac"][0] lanes, one thread a lane from its [1]);
  te_madd          <- ::te_madd_tiled: the same mixed add, and over R
      rows the same row scan in one launch, on a twisted-Edwards curve
      (a group of 4 threads a lane, of 2 from MADD_BANDS["te"][0] lanes,
      one thread a lane from its [1]).

The v1 Pippenger and the on-device Fiat-Shamir IPA keep their points in
the model coordinates of the JAX package's group law (Jacobian on a
short-Weierstrass curve, extended on a twisted-Edwards one):
`madd_scan` and `model_double_k_add` pick the Jacobian or TE kernel by
the spec's type.

`k` is a runtime argument, so one kernel serves both the Horner step and
the add. `double_k_add` and `add` pick the RCB or TE wrapper by the
spec's type. The wrappers take points in the boundary layout, (NC, 16, m)
int32 (coordinate, limb, lane; NC = 3 for SW, 4 for TE). On a CPU tensor
each runs its plain version below; on a CUDA tensor it launches its
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import proj
from .curve import _sw_add, _sw_add_mixed, _sw_double, is_te, n_coords
from .limbs import N_LIMBS


def check_tensor(t: torch.Tensor, shape: tuple, name: str) -> None:
    """Raise unless t is a contiguous int32 tensor of `shape` on the CPU
    or a CUDA device."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


def launch(name: str, spec, dev: torch.device, *args) -> None:
    """Launch kernel `name` (abtpu_<name> of csrc/*.cu) on `dev`'s current
    stream with the constants of `spec` (a CurveSpec, or a FieldSpec for
    the field kernels; None for a kernel that takes none); raise on a CUDA
    error."""
    fn = getattr(_build.lib(), f"abtpu_{name}")
    if spec is not None:
        words = _build.curve_words(spec)
        args = (*args, words.ctypes.data_as(ctypes.c_void_p))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    _build.check(err, name)


# The bands of the double-k-add launcher (csrc/point_kernels.cuh), a pair
# per point model (M::DKA_GROUP4_MIN_LANES, M::DKA_ONE_THREAD_MIN_LANES):
# the lane counts from which a group of 4 threads a lane runs instead of
# 8, and one thread a lane (the H100's crossovers, PERF.md;
# tests/test_torch_msm_plan.py ties them to the models).
DKA_BANDS = {"jac": (4096, 24576), "rcb a=0": (8192, 16384),
             "rcb a": (8192, 16384), "te": (4096, 16384)}


# The bands of the row scan (csrc/point_kernels.cuh's launch_madd_scan),
# a pair per point model (M::MADD_GROUP2_MIN_LANES,
# M::MADD_ONE_THREAD_MIN_LANES: the lane counts from which a group of 2
# threads a lane runs instead of 4, and one thread a lane), measured on
# the H100 (PERF.md; the same test ties them to the models).
MADD_BANDS = {"jac": (8192, 65536), "te": (16384, 65536)}

# The edge of rcb_double's band (RcbModel::DBL_ONE_THREAD_MIN_LANES, the
# doubling chain's launcher): from this many lanes one thread a lane runs
# instead of a group (the same test ties them).
DBL_BANDS = {"rcb a=0": 16384, "rcb a": 16384}


def dka_model(spec) -> str:
    """The DKA_BANDS key of rcb_double_k_add or te_double_k_add on
    `spec`'s curve."""
    if is_te(spec):
        return "te"
    return "rcb a=0" if spec.is_a_zero else "rcb a"

# Lanes per call of the plain versions on a CPU: lanes are independent,
# and slices of this width keep the int64 temporaries of a stacked group
# operation in cache (twice the speed of one wide call). On a card one
# call takes all lanes: there the cost is per launch, not per element.
PLAIN_CPU_LANES = 1024


def lane_slices(L: int, device: torch.device) -> list[slice]:
    step = PLAIN_CPU_LANES if device.type == "cpu" else max(L, 1)
    return [slice(o, min(o + step, L)) for o in range(0, L, step)]


def _by_lanes(fn, *points) -> torch.Tensor:
    """fn over lane slices of the points, int32 out."""
    return torch.cat([
        fn(*(P[..., sl] for P in points))
        for sl in lane_slices(points[0].shape[-1], points[0].device)
    ], dim=-1).to(torch.int32)


def double_k_add_plain(spec, P: torch.Tensor, Q: torch.Tensor,
                       k: int) -> torch.Tensor:
    """The plain version of the RCB and TE double-k-add kernels
    (proj.double_k_add dispatches on the spec)."""
    return _by_lanes(lambda p, q: proj.double_k_add(spec, p, q, k), P, Q)


def jac_double_k_add_plain(spec, P: torch.Tensor, Q: torch.Tensor,
                           k: int) -> torch.Tensor:
    """The plain version of `jac_double_k_add`: k Jacobian doublings,
    then the complete Jacobian add."""

    def f(p, q):
        for _ in range(k):
            p = _sw_double(spec, p)
        return _sw_add(spec, p, q)

    return _by_lanes(f, P, Q)


def _check_model(name: str, spec, te: bool) -> None:
    if is_te(spec) != te:
        raise TypeError(f"{name}: {spec.name} is not a "
                        f"{'twisted-Edwards' if te else 'short-Weierstrass'}"
                        " curve")


def _double_k_add(wrapper, plain, spec, P, Q, k: int):
    """Checks, then the plain version (CPU) or the wrapper's kernel
    (CUDA), counted on the wrapper: `launches`, and `doubling_launches`
    for the launches with k > 0."""
    name = wrapper.__name__
    m = P.shape[-1]
    nc = n_coords(spec)
    check_tensor(P, (nc, N_LIMBS, m), f"{name} P")
    check_tensor(Q, (nc, N_LIMBS, m), f"{name} Q")
    if not 0 <= k < (1 << 31):
        raise ValueError(f"{name}: k={k} out of range")
    dev = same_device(P, Q)
    if dev.type == "cpu":
        return plain(spec, P, Q, k)
    if m == 0:
        raise ValueError(f"{name}: empty input")
    out = torch.empty_like(P)
    launch(name, spec, dev, P.data_ptr(), Q.data_ptr(), out.data_ptr(), m, k)
    wrapper.launches += 1
    wrapper.doubling_launches += k > 0
    return out


def rcb_double_k_add(spec, P: torch.Tensor, Q: torch.Tensor,
                     k: int) -> torch.Tensor:
    """2^k * P + Q lane-wise on a short-Weierstrass curve; P, Q: (3, 16,
    m) int32."""
    _check_model("rcb_double_k_add", spec, te=False)
    return _double_k_add(rcb_double_k_add, double_k_add_plain, spec, P, Q, k)


def te_double_k_add(spec, P: torch.Tensor, Q: torch.Tensor,
                    k: int) -> torch.Tensor:
    """2^k * P + Q lane-wise on a twisted-Edwards curve; P, Q: (4, 16, m)
    int32 extended points."""
    _check_model("te_double_k_add", spec, te=True)
    return _double_k_add(te_double_k_add, double_k_add_plain, spec, P, Q, k)


def jac_double_k_add(spec, P: torch.Tensor, Q: torch.Tensor,
                     k: int) -> torch.Tensor:
    """2^k * P + Q lane-wise on Jacobian short-Weierstrass points; P, Q:
    (3, 16, m) int32, identity Z = 0."""
    _check_model("jac_double_k_add", spec, te=False)
    return _double_k_add(jac_double_k_add, jac_double_k_add_plain, spec, P,
                         Q, k)


def _chain_plain(dbl, P: torch.Tensor, steps: int) -> torch.Tensor:
    """`steps` loops of the doubling `dbl` over lane slices: 2P for one
    step, else the rows P, 2P, ..., 2^steps P stacked as (NC, 16, steps +
    1, m)."""

    def f(p):
        rows = [p.long()]
        for _ in range(steps):
            rows.append(dbl(rows[-1]))
        return rows[1] if steps == 1 else torch.stack(rows, dim=-2)

    return _by_lanes(f, P)


def te_double_plain(spec, P: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """The plain version of `te_double`: `steps` loops of
    ops/proj.py::double (the HWCD add of P and P)."""
    return _chain_plain(lambda p: proj.double(spec, p), P, steps)


def rcb_double_plain(spec, P: torch.Tensor) -> torch.Tensor:
    """The plain version of `rcb_double` (ops/proj.py::_rcb_double)."""
    return _by_lanes(lambda p: proj._rcb_double(spec, p), P)


def jac_double_plain(spec, P: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """The plain version of `jac_double`: `steps` loops of
    ops/curve.py::_sw_double."""
    return _chain_plain(lambda p: _sw_double(spec, p), P, steps)


def _double_chain(wrapper, plain, spec, P, steps: int):
    """Checks, then the plain version (CPU) or one launch of the
    wrapper's doubling chain (CUDA), counted on the wrapper."""
    name = wrapper.__name__
    nc = n_coords(spec)
    m = P.shape[-1]
    check_tensor(P, (nc, N_LIMBS, m), f"{name} P")
    if not 1 <= steps < (1 << 31) - 1:
        raise ValueError(f"{name}: steps={steps} out of range")
    if P.device.type == "cpu":
        return plain(spec, P, steps)
    if m == 0:
        raise ValueError(f"{name}: empty input")
    keep = int(steps > 1)
    out = torch.empty((nc, N_LIMBS, m) if steps == 1 else
                      (nc, N_LIMBS, steps + 1, m), dtype=torch.int32,
                      device=P.device)
    launch(name, spec, P.device, P.data_ptr(), out.data_ptr(), m, steps,
           keep)
    wrapper.launches += 1
    return out


def te_double(spec, P: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """2P lane-wise on a twisted-Edwards curve; P: (4, 16, m) int32. With
    steps = s > 1, the s + 1 rows P, 2P, ..., 2^s P of every lane from one
    launch, as (4, 16, s + 1, m): the 2^i Q table of the on-device
    Fiat-Shamir IPA (m = 1) and the commit table (m = 2)."""
    _check_model("te_double", spec, te=True)
    return _double_chain(te_double, te_double_plain, spec, P, steps)


def jac_double(spec, P: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """2P lane-wise on Jacobian short-Weierstrass points; P: (3, 16, m)
    int32. With steps = s > 1, the s + 1 rows P, 2P, ..., 2^s P of every
    lane from one launch, as (3, 16, s + 1, m): at m = 1 the (3, 16,
    s + 1) table of the on-device Fiat-Shamir IPA without a copy."""
    _check_model("jac_double", spec, te=False)
    return _double_chain(jac_double, jac_double_plain, spec, P, steps)


def rcb_double(spec, P: torch.Tensor) -> torch.Tensor:
    """Complete 2P lane-wise on RCB projective short-Weierstrass points
    (Alg 9 for a = 0, Alg 3 otherwise); P: (3, 16, m) int32."""
    _check_model("rcb_double", spec, te=False)
    m = P.shape[-1]
    check_tensor(P, (3, N_LIMBS, m), "rcb_double P")
    if P.device.type == "cpu":
        return rcb_double_plain(spec, P)
    if m == 0:
        raise ValueError("rcb_double: empty input")
    out = torch.empty_like(P)
    launch("rcb_double", spec, P.device, P.data_ptr(), out.data_ptr(), m)
    rcb_double.launches += 1
    return out


def jac_madd_plain(spec, P: torch.Tensor, Qx: torch.Tensor,
                   Qy: torch.Tensor, q_inf: torch.Tensor) -> torch.Tensor:
    """The plain version of `jac_madd` (ops/curve.py::_sw_add_mixed), over
    the rows of (R, 16, m) Qx and Qy from the last up."""
    if Qx.dim() == 3:
        return _madd_rows_plain(jac_madd_plain, spec, P, Qx, Qy, q_inf)
    return _by_lanes(lambda p, x, y, i: _sw_add_mixed(spec, p, x, y, i),
                     P, Qx, Qy, q_inf)


def _madd_rows_plain(one, spec, P, Qx, Qy, q_inf) -> torch.Tensor:
    """The one-row mixed add `one` over the rows of (R, 16, m) Qx and Qy
    from the last up: (NC, R, 16, m), row r = P + sum_{j >= r} Q_j."""
    out = torch.empty((P.shape[0], *Qx.shape), dtype=torch.int32,
                      device=P.device)
    acc = P
    for r in range(Qx.shape[0] - 1, -1, -1):
        acc = one(spec, acc, Qx[r], Qy[r], q_inf[r])
        out[:, r] = acc
    return out


def te_madd_plain(spec, P: torch.Tensor, Qx: torch.Tensor,
                  Qy: torch.Tensor, q_inf: torch.Tensor) -> torch.Tensor:
    """The plain version of `te_madd` (ops/proj.py::_te_add_mixed), over
    the rows of (R, 16, m) Qx and Qy from the last up."""
    if Qx.dim() == 3:
        return _madd_rows_plain(te_madd_plain, spec, P, Qx, Qy, q_inf)
    return _by_lanes(lambda p, x, y, i: proj._te_add_mixed(spec, p, x, y, i),
                     P, Qx, Qy, q_inf)


def _check_madd(name: str, spec, P, Qx, Qy, q_inf, rows: tuple) -> None:
    """Raise unless P is (NC, 16, m), Qx and Qy (*rows, 16, m) int32 and
    q_inf a contiguous (*rows, m) bool tensor, all on one device."""
    m = P.shape[-1]
    check_tensor(P, (n_coords(spec), N_LIMBS, m), f"{name} P")
    check_tensor(Qx, (*rows, N_LIMBS, m), f"{name} Qx")
    check_tensor(Qy, (*rows, N_LIMBS, m), f"{name} Qy")
    if q_inf.dtype != torch.bool or tuple(q_inf.shape) != (*rows, m):
        raise ValueError(f"{name} q_inf: expected a bool {(*rows, m)} "
                         f"tensor")
    if not q_inf.is_contiguous():
        raise ValueError(f"{name} q_inf: tensor must be contiguous")
    same_device(P, Qx, Qy, q_inf)


def _madd(wrapper, plain, spec, P, Qx, Qy, q_inf):
    """Checks, then the plain version (CPU) or one launch of the wrapper's
    row scan (CUDA; one row for (16, m) Qx), counted on the wrapper."""
    name = wrapper.__name__
    R = Qx.shape[0] if Qx.dim() == 3 else None
    rows = () if R is None else (R,)
    _check_madd(name, spec, P, Qx, Qy, q_inf, rows)
    m = P.shape[-1]
    if P.device.type == "cpu":
        return plain(spec, P, Qx, Qy, q_inf)
    if m == 0 or R == 0:
        raise ValueError(f"{name}: empty input")
    out = torch.empty((P.shape[0], *rows, N_LIMBS, m), dtype=torch.int32,
                      device=P.device)
    launch(name, spec, P.device, P.data_ptr(), Qx.data_ptr(),
           Qy.data_ptr(), q_inf.data_ptr(), out.data_ptr(), R or 1, m)
    wrapper.launches += 1
    return out


def jac_madd(spec, P: torch.Tensor, Qx: torch.Tensor, Qy: torch.Tensor,
             q_inf: torch.Tensor) -> torch.Tensor:
    """Complete P + affine (Qx, Qy) lane-wise on Jacobian short-Weierstrass
    points; P: (3, 16, m) int32, Qx, Qy: (16, m) int32 Montgomery, q_inf:
    (m,) bool (those lanes add the identity). With R rows, Qx, Qy: (R, 16,
    m) and q_inf (R, m), the row scan in one launch: (3, R, 16, m) with
    out[:, r] = P + sum_{j >= r} Q_j, added from row R - 1 down to 0."""
    _check_model("jac_madd", spec, te=False)
    return _madd(jac_madd, jac_madd_plain, spec, P, Qx, Qy, q_inf)


def te_madd(spec, P: torch.Tensor, Qx: torch.Tensor, Qy: torch.Tensor,
            q_inf: torch.Tensor) -> torch.Tensor:
    """Complete P + affine (Qx, Qy) lane-wise on twisted-Edwards extended
    points; P: (4, 16, m) int32; q_inf lanes pass P through. With R rows,
    Qx, Qy: (R, 16, m) and q_inf (R, m), the row scan in one launch: (4, R,
    16, m), as `jac_madd`'s."""
    _check_model("te_madd", spec, te=True)
    return _madd(te_madd, te_madd_plain, spec, P, Qx, Qy, q_inf)


rcb_double_k_add.launches = rcb_double_k_add.doubling_launches = 0
te_double_k_add.launches = te_double_k_add.doubling_launches = 0
te_double.launches = 0
rcb_double.launches = 0
jac_double_k_add.launches = jac_double_k_add.doubling_launches = 0
jac_double.launches = 0
jac_madd.launches = 0
te_madd.launches = 0


def double_k_add(spec, P: torch.Tensor, Q: torch.Tensor,
                 k: int) -> torch.Tensor:
    """2^k * P + Q through the kernel of the spec's model."""
    if is_te(spec):
        return te_double_k_add(spec, P, Q, k)
    return rcb_double_k_add(spec, P, Q, k)


def add(spec, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Complete P + Q: the k = 0 case of `double_k_add`."""
    return double_k_add(spec, P, Q, 0)


def double(spec, P: torch.Tensor) -> torch.Tensor:
    """Complete 2P through the kernel of the spec's model: `rcb_double`, or
    `te_double` on a twisted-Edwards curve (the kernel branch of the JAX
    package's ops/proj.py::double). No path of the port calls it: its
    double-k-add kernels double in registers."""
    if is_te(spec):
        return te_double(spec, P)
    return rcb_double(spec, P)


def model_double_k_add(spec, P: torch.Tensor, Q: torch.Tensor,
                       k: int) -> torch.Tensor:
    """2^k * P + Q in the model coordinates: `jac_double_k_add`, or
    `te_double_k_add` on a twisted-Edwards curve."""
    if is_te(spec):
        return te_double_k_add(spec, P, Q, k)
    return jac_double_k_add(spec, P, Q, k)


def madd_scan(spec, P: torch.Tensor, Qx: torch.Tensor, Qy: torch.Tensor,
              q_inf: torch.Tensor) -> torch.Tensor:
    """The suffix sums P + sum_{j >= r} Q_j of (R, 16, m) affine rows, from
    the last row up, in the model coordinates: (NC, R, 16, m). One
    `jac_madd` launch on a short-Weierstrass curve, one `te_madd` launch
    on a twisted-Edwards one."""
    if is_te(spec):
        return te_madd(spec, P, Qx, Qy, q_inf)
    return jac_madd(spec, P, Qx, Qy, q_inf)
