"""The port stands alone and hides neither the card nor a kernel.

``repro_torch`` imports no JAX and nothing of ``repro``; its entry points
raise without a GPU unless the CPU is asked for; every kernel wrapper runs
its plain version for CPU tensors only, a CUDA launcher refuses anything
else, and the build raises where ``nvcc`` is missing.
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import repro_torch  # noqa: E402
from repro_torch.core import operator as T  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.poisson import poisson_local_cuda  # noqa: E402
from repro_torch.kernels.poisson_fused import poisson_assembled_fused_cuda  # noqa: E402
from repro_torch.kernels.streams import fused_axpy_dot_cuda  # noqa: E402

PKG = pathlib.Path(repro_torch.__file__).resolve().parent
SRC = PKG.parent


def test_import_leaves_no_jax_and_no_repro():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_source_imports_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    offenders = [
        f"{path.relative_to(SRC)}: {m.group(0).strip()}"
        for path in files
        for m in pattern.finditer(path.read_text())
    ]
    assert offenders == []


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.build_problem(1, (1, 1, 1))
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    assert T.build_problem(1, (1, 1, 1), device="cpu").device == torch.device("cpu")


@pytest.fixture
def small(rng):
    prob = T.build_problem(3, (2, 1, 1), lam=1.3, deform=0.15, dtype=torch.float64,
                           device="cpu")
    x = torch.from_numpy(rng.standard_normal(prob.n_global))
    return prob, x


def test_wrappers_take_plain_versions_on_cpu(small):
    prob, x = small
    ops.reset_launch_counts()
    x_l = x[prob.l2g.long()]
    w, lam = prob.w_local, prob.lam
    assert torch.equal(
        ops.poisson_local(x_l, prob.g, w, prob.d, lam=lam),
        ref.poisson_local_ref(x_l, prob.g, w, prob.d, lam=lam),
    )
    assert torch.equal(
        ops.poisson_assembled_fused(x, prob.l2g, prob.g, w, prob.d, lam=lam),
        ref.poisson_assembled_fused_ref(x, prob.l2g, prob.g, w, prob.d, lam=lam),
    )
    alpha = torch.tensor(0.25, dtype=torch.float64)
    ap = x.flip(0)
    got, want = ops.fused_axpy_dot(x, ap, alpha), ref.fused_axpy_dot_ref(x, ap, alpha)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.launch_counts() == {
        "poisson_local": 0, "poisson_assembled_fused": 0, "fused_axpy_dot": 0
    }


def test_cuda_launchers_refuse_cpu_tensors(small):
    """No launcher hands a tensor to a plain version: off the card it raises."""
    prob, x = small
    x_l = x[prob.l2g.long()]
    with pytest.raises(ValueError, match="not a CUDA device"):
        poisson_local_cuda(x_l, prob.g, prob.w_local, prob.d, lam=1.0)
    with pytest.raises(ValueError, match="not a CUDA device"):
        poisson_assembled_fused_cuda(x, prob.l2g, prob.g, prob.w_local, prob.d, lam=1.0)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fused_axpy_dot_cuda(x, x, torch.tensor(0.5, dtype=torch.float64))


def test_should_fuse_streams_only_for_fp32_on_the_card():
    assert ops.should_fuse_streams(torch.float32, "cuda")
    assert not ops.should_fuse_streams(torch.float64, "cuda")
    assert not ops.should_fuse_streams(torch.float32, "cpu")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("poisson")


def test_sources_named_by_build_exist():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
