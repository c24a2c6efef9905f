"""Guards of the port's boundary.

- No module of ark_bulletproofs_tpu_torch (nor chip_smoke.py) imports jax
  or the JAX package's jax-bound modules; a process in which `jax` cannot
  be imported runs the port.
- Asking the port for a CUDA device where there is none raises; a CUDA
  request never carries on on the CPU.
- The port pins the shared engine to its host path only inside its own
  calls and restores it afterwards.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from ark_bulletproofs_tpu import curves
from ark_bulletproofs_tpu import engine as shared_engine
from ark_bulletproofs_tpu_torch import engine, msm
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import kernels as kk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ark_bulletproofs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ark_bulletproofs_tpu.ops",
             "ark_bulletproofs_tpu.parallel",
             "ark_bulletproofs_tpu.utils.profiling")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_port_module_imports_jax():
    files = _port_files()
    assert len(files) >= 15
    for path in files:
        for name in _imports(path):
            assert not any(name == f or name.startswith(f + ".")
                           for f in FORBIDDEN), (path, name)


_NO_JAX = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is blocked")
sys.meta_path.insert(0, Block())
import random
import torch
import ark_bulletproofs_tpu_torch as port
from ark_bulletproofs_tpu import BulletproofGens, PedersenGens, Transcript
from ark_bulletproofs_tpu import curves
from ark_bulletproofs_tpu.rand import seeded_rng
curve = curves.secq256k1
with port.engine.host_backend():
    pc, bp = PedersenGens.default(curve), BulletproofGens(curve, 16, 1)
sp, ic, oc = port.ShuffleProof.prove(seeded_rng(1), pc, bp,
                                     Transcript(b"t"), [3, 1, 2], [1, 2, 3])
port.ShuffleProof(sp.proof).verify(pc, bp, Transcript(b"t"), ic, oc)
from ark_bulletproofs_tpu_torch.ops import curve as tc, kernels as kk
P = torch.zeros(3, 16, 2, dtype=torch.int32)
kk.rcb_double_k_add(tc.spec_for(curve), P, P, 1)
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
print("OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cuda")
    if torch.cuda.is_available():
        assert engine.torch_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        engine.torch_device()
    curve = curves.secq256k1
    with pytest.raises(RuntimeError):
        msm(curve, [curve.gen] * 600, [1] * 600)
    monkeypatch.setattr(engine.config, "device", "mps")
    with pytest.raises(ValueError):
        engine.torch_device()


def test_wrappers_take_plain_versions_only_for_cpu_tensors():
    spec = tc.spec_for(curves.secq256k1)
    P = torch.zeros(3, 16, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        kk.rcb_double_k_add(spec, P, P, 0)


def test_shared_backend_restored():
    before = shared_engine.config.backend
    with pytest.raises(KeyError):
        with engine.host_backend():
            assert shared_engine.config.backend == "host"
            raise KeyError("inside")
    assert shared_engine.config.backend == before
