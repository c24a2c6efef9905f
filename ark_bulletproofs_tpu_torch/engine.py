"""Compute-engine dispatch of the port: host exact path vs torch device.

Counterpart of ark_bulletproofs_tpu/engine.py. MSMs below
`msm_device_threshold` terms run the host Pippenger (`curve.msm`, native
C++); larger ones, and the prover's vector phase and inner-product
argument above their own sizes (r1cs/prover.py, ipp.py), run on
`config.device`.

The device is "cuda" unless the caller asks for "cpu": a CUDA request
where there is no card raises and never carries on on the CPU. On the CPU
every kernel wrapper runs its plain PyTorch version (the tests do this).

`set_mesh` installs a device mesh (parallel/mesh.py): large MSMs, the
prover's vector phase, the per-round IPA and the verifier's g/h scalars
then shard their point axis across it, and the routes that need one
device (the on-device Fiat-Shamir IPA, the tabled phase MSMs, the device
IPA verify) stand aside. ABTPU_MESH=auto builds one over the CUDA cards
when there are more than one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch


@dataclass
class EngineConfig:
    # torch device of the device path: "cuda", "cuda:N" or "cpu" (the CPU
    # runs the kernels' plain PyTorch versions).
    device: str = "cuda"
    # Minimum MSM size for the device path (the JAX engine's value).
    msm_device_threshold: int = int(
        os.environ.get("ABTPU_MSM_THRESHOLD", "512")
    )


config = EngineConfig()


def torch_device() -> torch.device:
    """The configured device; raises if it is CUDA and there is no card."""
    dev = torch.device(config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"engine device {config.device!r} requested but "
            "torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported engine device {config.device!r}")
    return dev


def use_device(n: int) -> bool:
    return n >= config.msm_device_threshold


def msm(curve, bases: list, scalars: list[int]):
    """sum_i scalars[i] * bases[i], affine out."""
    if use_device(len(bases)):
        from .ops import msm as device_msm

        return device_msm.msm(curve, bases, scalars)
    return curve.msm(bases, scalars)


def msm_many(curve, bases: list, scalar_sets: list[list[int]]):
    """B MSMs over shared bases (one batched device run above the
    threshold)."""
    if scalar_sets and use_device(len(bases)):
        from .ops import msm as device_msm

        return device_msm.msm_many(curve, bases, scalar_sets)
    return [curve.msm(bases, ks) for ks in scalar_sets]


# --- device mesh (parallel/mesh.py) ----------------------------------------

_mesh = None


def set_mesh(mesh) -> None:
    """Install a parallel.mesh.Mesh; None goes back to one device."""
    global _mesh
    _mesh = mesh


def active_mesh():
    """The installed mesh, or with ABTPU_MESH=auto one over every CUDA
    card when there are more than one; None (one card, the CPU, or no
    mesh set) keeps every path on one device."""
    global _mesh
    if (_mesh is None and os.environ.get("ABTPU_MESH", "") == "auto"
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        from .parallel.mesh import make_mesh

        _mesh = make_mesh()
    return _mesh
