"""Guards of the port's boundary.

- No module of ark_bulletproofs_tpu_torch, nor chip_smoke.py, nor
  tests/test_torch_cuda.py imports jax or anything of the JAX package
  ark_bulletproofs_tpu; a process in which neither can be imported proves
  and verifies a shuffle through the port.
- The engine's device is "cuda" unless the caller asks for the CPU; asking
  for a CUDA device where there is none raises and never carries on on
  the CPU.
- Kernel wrappers take their plain versions only for CPU tensors.
- A mesh is built over the CUDA cards unless its devices are named:
  `make_mesh()` without a card raises. On a card (marker `cuda`), the
  router's mesh branch, the sharded vector phase and the sharded g/h
  scalars over a mesh of CUDA devices launch their kernels on every shard
  and never hand a CUDA tensor to a plain version.
"""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

from ark_bulletproofs_tpu_torch import curves, engine, msm
from ark_bulletproofs_tpu_torch.ops import _build
from ark_bulletproofs_tpu_torch.ops import curve as tc
from ark_bulletproofs_tpu_torch.ops import field as df
from ark_bulletproofs_tpu_torch.ops import gather
from ark_bulletproofs_tpu_torch.ops import kernels as kk
from ark_bulletproofs_tpu_torch.ops import kernels2 as k2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ark_bulletproofs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ark_bulletproofs_tpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(engine.config, "device", "cpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tests", "test_torch_cuda.py")]
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


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_port_module_imports_jax():
    files = _port_files()
    assert len(files) >= 30
    for path in files:
        for name in _imports(path):
            assert not _forbidden(name), (path, name)
    assert not _forbidden("ark_bulletproofs_tpu_torch.ops")
    assert _forbidden("ark_bulletproofs_tpu.fields")


def test_port_sources_are_seen_and_include_only_their_own():
    """The guard above reads every module of the port, the modules of the
    on-device Fiat-Shamir IPA among them; the CUDA and host C++ sources
    include only system headers and the port's own csrc files."""
    files = {os.path.relpath(p, PKG) for p in _port_files()}
    for mod in ("ops/fs.py", "ops/ipa.py", "ops/kernels.py", "ipp.py",
                "r1cs/prover.py", "ops/kernels2.py", "ops/gather.py",
                "ops/gens.py", "generators.py", "parallel/mesh.py",
                "parallel/multihost.py", "parallel/dryrun.py",
                "parallel/msm.py", "ops/msm_serial.py"):
        assert mod in files, mod
    csrc = os.path.join(PKG, "csrc")
    sources = {}
    for d, _, names in os.walk(csrc):
        for n in names:
            if n.endswith((".cu", ".cuh", ".cpp", ".h")):
                sources[os.path.relpath(os.path.join(d, n), csrc)] = \
                    open(os.path.join(d, n)).read()
    for name in ("jac.cuh", "fs.cuh", "fs_kernels.cu", "msm_kernels.cu",
                 "gather_kernels.cu", "gens_kernels.cu"):
        assert name in sources, name
    own = {os.path.basename(n) for n in sources}
    for name, text in sources.items():
        for line in text.splitlines():
            if line.startswith("#include"):
                inc = line.split(None, 1)[1].strip()
                if inc.startswith('"'):
                    assert inc.strip('"') in own, (name, inc)
                assert "jax" not in inc and "ark_bulletproofs_tpu" not in inc


def test_every_bound_launcher_is_defined_and_launched_by_name():
    """Each entry point that ops/_build.py binds is an extern "C" function
    of csrc/*.cu, and each kernel name a port module launches is bound."""
    cu = "".join(open(p).read() for p in _build._sources())
    defined = set(re.findall(r'extern "C" int (abtpu_\w+)\(', cu))
    assert set(_build._SIGNATURES) == defined
    launched = set()
    for path in _port_files():
        launched |= set(re.findall(r'launch\(\s*"(\w+)"', open(path).read()))
        # kernels2's Horner wrappers name their launcher to _horner
        launched |= set(re.findall(r'_horner\(\w+, \w+,\s*"(\w+)"',
                                   open(path).read()))
    for name in ("rcb_double", "te_double", "jac_double", "rcb_double_k_add",
                 "te_double_k_add", "jac_double_k_add", "jac_madd",
                 "te_madd"):  # kernels.py launches by the wrapper's name
        assert callable(getattr(kk, name))
        launched.add(name)
    assert {f"abtpu_{n}" for n in launched} == defined


_NO_JAX = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        for f in ("jax", "ark_bulletproofs_tpu"):
            if name == f or name.startswith(f + "."):
                raise ImportError(f"{f} is blocked")
sys.meta_path.insert(0, Block())
import torch
import ark_bulletproofs_tpu_torch as port
from ark_bulletproofs_tpu_torch.ops import curve as tc, kernels as kk
port.engine.config.device = "cpu"
curve = port.curves.secq256k1
pc, bp = port.PedersenGens.default(curve), port.BulletproofGens(curve, 16, 1)
sp, ic, oc = port.ShuffleProof.prove(port.seeded_rng(1), pc, bp,
                                     port.Transcript(b"t"), [3, 1, 2],
                                     [1, 2, 3])
port.ShuffleProof(sp.proof).verify(pc, bp, port.Transcript(b"t"), ic, oc)
P = torch.zeros(3, 16, 2, dtype=torch.int32)
kk.rcb_double_k_add(tc.spec_for(curve), P, P, 1)
assert not [m for m in sys.modules
            if m in ("jax", "ark_bulletproofs_tpu")
            or m.startswith(("jax.", "ark_bulletproofs_tpu."))]
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
    fs = df.spec_for(curves.secq256k1.fr)
    a = torch.zeros(16, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        df.mont_mul(fs, a, a)
    before = df.mont_mul.launches
    df.mont_mul(fs, torch.ones(16, 2, dtype=torch.int32),
                torch.ones(16, 1, dtype=torch.int32))
    assert df.mont_mul.launches == before  # the plain version ran
    with pytest.raises(ValueError, match="device"):
        kk.rcb_double(spec, P)
    with pytest.raises(ValueError, match="device"):
        k2.horner_windows(spec, P.reshape(3, 16, 1, 2), 4)
    tbl = torch.zeros(8, 16, dtype=torch.int32)
    idx = torch.tensor([7, 0, 3])
    with pytest.raises(ValueError, match="device"):
        gather.row_gather(tbl.to("meta"), idx.to("meta"))
    before = gather.row_gather.launches
    assert torch.equal(gather.row_gather(tbl, idx), tbl[idx])
    assert gather.row_gather.launches == before  # the plain version ran


def test_generator_farm_asks_for_the_card():
    """From _DEVICE_MIN generators the chain takes the farm on the engine's
    device: a CUDA request without a card raises before any work, and the
    farm's wrapper runs its plain version only on CPU tensors."""
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops import gens

    curve = curves.secq256k1
    chain = GeneratorsChain(curve, b"guard")
    n = GeneratorsChain._DEVICE_MIN
    assert chain._device_ok(n) and not chain._device_ok(n - 1)
    assert not GeneratorsChain(curves.curve25519, b"guard")._device_ok(n)
    if not torch.cuda.is_available():
        engine.config.device = "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            chain.take(n)
        engine.config.device = "cpu"
    spec, sq = tc.spec_for(curve), gens.sqrt_spec_for(curve.fq)
    with pytest.raises(ValueError, match="device"):
        gens.gen_candidates(spec, sq, torch.zeros(2, 9, dtype=torch.int32,
                                                  device="meta"))
    before = gens.gen_candidates.launches
    xy, ok = gens.gen_candidates(spec, sq, torch.zeros(2, 9,
                                                       dtype=torch.int32))
    assert gens.gen_candidates.launches == before  # the plain version ran
    assert ok.tolist() == [False, False]  # 7 is no square mod p
    assert not xy[:, :8].any()


def test_default_device_is_cuda():
    """The engine asks for the card unless told otherwise: a fresh config
    says "cuda" whether or not a card is present."""
    assert engine.EngineConfig().device == "cuda"
    assert engine.config.device == "cpu"  # this file's fixture asked


def test_mesh_without_named_devices_needs_a_card(monkeypatch):
    """make_mesh() builds over the CUDA cards: with none it raises (never a
    silent CPU mesh); "cpu" devices must be named, and a CUDA device named
    without a card raises too. ABTPU_MESH=auto builds nothing without two
    cards."""
    from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(engine, "_mesh", None)
    monkeypatch.setenv("ABTPU_MESH", "auto")
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in pmesh.make_mesh().devices)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        pmesh.make_mesh(devices=["cuda:0"] * 2)
    assert pmesh.make_mesh(devices=["cpu"] * 2).size == 2
    assert engine.active_mesh() is None


@pytest.mark.cuda
def test_mesh_branch_on_the_card_runs_no_plain_version(monkeypatch):
    """On a mesh of 2 shards of cuda:0 the router's mesh branch (one set:
    v1 shards; two sets: v2 shards), the sharded vector phase and the
    sharded g/h scalars launch their kernels on every shard and equal the
    one-device results, and no plain version of a kernel (any `*_plain`
    function of ops/) ever gets a CUDA tensor."""
    import importlib
    import pkgutil
    import random

    from ark_bulletproofs_tpu_torch import ops
    from ark_bulletproofs_tpu_torch.generators import GeneratorsChain
    from ark_bulletproofs_tpu_torch.ops import prove, verify
    from ark_bulletproofs_tpu_torch.ops.msm import scalars_to_device
    from ark_bulletproofs_tpu_torch.parallel import mesh as pmesh
    from ark_bulletproofs_tpu_torch.parallel import msm as pmsm

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    fired = []

    def on_card(xs) -> bool:
        return any(x.is_cuda if isinstance(x, torch.Tensor)
                   else isinstance(x, (list, tuple)) and on_card(x)
                   for x in xs)

    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, fn in list(vars(mod).items()):
            if name.endswith("_plain") and callable(fn):
                def spy(*a, fn=fn, name=name, **k):
                    if on_card(a) or on_card(tuple(k.values())):
                        fired.append(name)
                    return fn(*a, **k)
                monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(engine.config, "device", "cuda")
    D = 2
    mesh = pmesh.make_mesh(devices=["cuda:0"] * D)
    curve = curves.secq256k1
    spec, p = tc.spec_for(curve), curve.fr.p
    n = D * pmsm.SHARD_MIN
    rng = random.Random(16)
    pts = GeneratorsChain(curve, b"guard mesh").take(n)
    ks = [[rng.randrange(p) for _ in range(n)] for _ in range(2)]
    X, Y, inf = tc.affine_to_device(curve, pts, "cuda")
    scal = scalars_to_device(curve, ks, "cuda")

    def horners():
        return k2.horner_windows.launches + k2.jac_horner_windows.launches

    monkeypatch.setattr(engine, "_mesh", mesh)
    for sets in (scal[0], scal):
        before = horners()
        out = pmsm.msm_device_maybe_sharded(spec, X, Y, inf, sets)
        assert horners() - before == D  # stage G (v2) or v1's, per shard
        assert out.device.type == "cuda"
        assert tc.point_batch_to_host(curve, out) == [
            curve.msm(pts, k) for k in ks[:out.shape[-1]]]

    vecs = [[rng.randrange(p) for _ in range(n)] for _ in range(8)]
    y = rng.randrange(1, p)
    args = (curve, n, *vecs, y, pow(y, -1, p), "cuda")
    before = df.mont_mul.launches
    pv = prove.ProverVectorPhase(*args)
    assert pv.devices == mesh.devices
    assert df.mont_mul.launches - before >= D
    padded_n = verify.GH_SHARD_MIN_N
    wv = [rng.randrange(p) for _ in range(padded_n)]
    gh_args = (curve, padded_n, wv, wv[::-1], wv, 3, 5, 7, 11, 13,
               [17 + i for i in range(padded_n.bit_length() - 1)], 19, 10)
    before = df.mont_mul.launches
    g, h, d = verify.gh_scalars(*gh_args)
    assert isinstance(g, pmesh.Pieces) and len(g.parts) == D
    assert all(t.is_cuda for t in g.parts + h.parts)
    assert df.mont_mul.launches - before >= D
    assert fired == []

    monkeypatch.setattr(engine, "_mesh", None)
    assert prove.ProverVectorPhase(*args).t == pv.t
    g0, h0, d0 = verify.gh_scalars(*gh_args)
    assert torch.equal(pmesh.gather(g, g0.device), g0)
    assert torch.equal(pmesh.gather(h, h0.device), h0) and d == d0
