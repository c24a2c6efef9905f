"""Compute-engine dispatch of the port: host exact path vs torch device.

Counterpart of ark_bulletproofs_tpu/engine.py. MSMs below
`msm_device_threshold` terms run the host Pippenger (`curve.msm`, native
C++); larger ones, and the prover's vector phase and inner-product
argument above their own sizes (r1cs/prover.py, ipp.py), run on
`config.device`.

The device is "cuda" unless the caller asks for "cpu": a CUDA request
where there is no card raises and never carries on on the CPU. On the CPU
every kernel wrapper runs its plain PyTorch version (the tests do this).
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
