"""Multi-process execution on torch.distributed (counterpart of
ark_bulletproofs_tpu/parallel/multihost.py).

Every process runs the same program and calls `initialize()` once (the
coordinator's host:port, the world size and this process's rank, from
the arguments or ABTPU_COORDINATOR / ABTPU_NUM_PROCESSES /
ABTPU_PROCESS_ID); it joins a gloo process group with a finite timeout,
so a rank whose peer never comes, or dies, fails within it instead of
hanging. gloo carries host tensors: the ranks exchange only their
partial sums, an (NC, 16, B) int32 tensor of about 200 bytes each (the
JAX docstring's "O(devices) partials"), and NCCL could not put two ranks
on one card anyway.

`global_mesh()` is the mesh over every rank's devices, rank-major (a
rank's devices are one contiguous block, as the JAX package's
process-major mesh); each rank computes only its own block of rows
("owner computes": `_host_range` gives it, and
`GeneratorsChain.fast_forward` draws exactly that block of a generator
table). `msm_multihost` runs the sharded MSM of parallel/msm.py over the
rank's own devices, all-gathers the ranks' partials, and every rank adds
them in rank order on its own device, so each returns the same affine
point.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, Pieces, make_mesh, shard_rows

# Seconds a rank waits for its peers (rendezvous and every collective).
TIMEOUT_S = 120.0


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float | None = None) -> bool:
    """Join (or form) the process group; idempotent. Returns False, and
    does nothing, when neither a coordinator nor a process count is given
    (one process)."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("ABTPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("ABTPU_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("ABTPU_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize: need the coordinator, the process "
                         "count and this process's id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(
            seconds=TIMEOUT_S if timeout_s is None else timeout_s))
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(local_devices=None) -> Mesh:
    """The mesh over every rank's devices, rank-major; this rank's are
    `local_devices` (its CUDA cards when none are named). Every rank must
    bring as many devices."""
    local = make_mesh(devices=local_devices).devices
    rank, world = _world()
    if world == 1:
        return Mesh(local)
    names = [None] * world
    dist.all_gather_object(names, [str(d) for d in local])
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"global_mesh: ranks bring {names} devices")
    devs = tuple(torch.device(d) for n in names for d in n)
    return Mesh(devs, process_index=rank, process_count=world)


def _host_range(global_n: int) -> tuple[int, int]:
    """[start, stop) of the rows this rank owns (contiguous blocks)."""
    rank, world = _world()
    if global_n % world:
        raise ValueError(f"{global_n} rows over {world} ranks")
    per = global_n // world
    return rank * per, (rank + 1) * per


def shard_host_data(mesh: Mesh, local_rows: torch.Tensor,
                    global_rows: int) -> Pieces:
    """This rank's contiguous block of a global_rows-long (..., n) array
    (the columns `_host_range` gives), cut over the rank's own devices;
    no rank ever holds the whole array."""
    if local_rows.shape[-1] * mesh.process_count != global_rows:
        raise ValueError(f"{local_rows.shape[-1]} local rows of "
                         f"{global_rows} over {mesh.process_count} ranks")
    return shard_rows(Mesh(mesh.local_devices), local_rows)


def msm_multihost(curve, local_pts, local_ks, global_n: int,
                  mesh: Mesh | None = None, kind: str = "pippenger"):
    """The global_n-term MSM, each rank contributing its contiguous slice
    (local_pts: its global_n / ranks affine points, None the identity;
    local_ks its scalars). kind "pippenger": the v1 Pippenger on each of
    the rank's devices (the JAX package's), "serial": the bit-serial MSM.
    Returns the affine sum, the same on every rank."""
    from ..ops import kernels as kk
    from ..ops.curve import affine_to_device, point_to_host, spec_for
    from ..ops.limbs import ints_to_limbs
    from . import msm as pmsm

    if mesh is None:
        mesh = global_mesh()
    if global_n % mesh.size:
        raise ValueError(f"{global_n} terms over {mesh.size} devices")
    fns = {"pippenger": pmsm.sharded_msm_fn,
           "serial": pmsm.sharded_msm_serial_fn}
    spec = spec_for(curve)
    p = curve.fr.p
    X, Y, inf = affine_to_device(curve, local_pts, "cpu")
    scal = ints_to_limbs([k % p for k in local_ks])
    args = [shard_host_data(mesh, t, global_n) for t in (X, Y, inf, scal)]
    local = Mesh(mesh.local_devices)
    part = fns[kind](spec, local)(*args)
    root = local.devices[0]
    if mesh.process_count > 1:
        host = part.cpu()
        parts = [torch.empty_like(host) for _ in range(mesh.process_count)]
        dist.all_gather(parts, host)
        part = parts[0].to(root)
        for q in parts[1:]:
            part = kk.add(spec, part, q.to(root))
    return point_to_host(curve, part)
