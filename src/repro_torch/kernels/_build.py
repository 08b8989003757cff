"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
``sm_90a`` into ``build/repro_torch/`` at the root of the checkout.  A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing is
built when a module is imported: the first launch on a CUDA tensor builds
what it needs, and :func:`build` builds every source at once, one ``nvcc``
process per source, all started together.

There is no fallback: without ``nvcc``, or when a build fails, these
functions raise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = [
    "CSRC",
    "SOURCES",
    "build",
    "build_dir",
    "check",
    "find_nvcc",
    "load",
    "validate",
]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("poisson", "poisson_fused", "streams")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# where the CUDA toolkit is looked for after $CUDA_HOME, $CUDA_PATH and $PATH
CUDA_ROOTS = ("/usr/local/cuda",)

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout (listed in .gitignore)."""
    return CSRC.parents[2] / "build" / "repro_torch"


def find_nvcc() -> str | None:
    """Path of ``nvcc``, or None when no CUDA toolkit is found."""
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    for root in roots:
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    for root in CUDA_ROOTS:
        if os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def _lib_path(name: str, out_dir: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return out_dir / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet.

    Returns ``{name: library path}``.  The compiler's report for each
    library (``-Xptxas=-v``: registers, shared memory, spills) is kept
    beside it as ``<library>.log``.  Raises ``RuntimeError`` when ``nvcc``
    is missing or a compile fails.
    """
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the repro_torch CUDA kernels are compiled from "
            f"{CSRC} by the CUDA toolkit's nvcc; set CUDA_HOME or put nvcc "
            "on PATH"
        )
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name, out_dir) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{report}")
            continue
        path = paths[name]
        path.with_name(path.name + ".log").write_text(report)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def validate(what: str, dtype, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device.

    Each must have ``dtype``, except ``l2g``, which must be int32.  The
    kernels take fp32 and fp64 only.
    """
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {dtype} not supported (float32/float64)")
    device = None
    for name, t in tensors.items():
        want = torch.int32 if name == "l2g" else dtype
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not a CUDA device")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, others on {device}")
        if t.dtype != want:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        text = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({text})")
