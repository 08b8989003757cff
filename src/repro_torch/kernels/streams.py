"""Launcher of the CUDA CG stream kernel ``fused_axpy_dot``.

The kernel (``csrc/streams.cu``) replaces the TPU kernel
``repro/kernels/streams.py::fused_axpy_dot_pallas``: r − α·Ap and
Σ(r − α·Ap)² in one pass over r and Ap, the sum in fp32 and in a fixed
order (per-block partials, then one block over the partials).  Callers go
through ``kernels.ops.fused_axpy_dot``.  The other stream kernels of the
reference are not ported yet (ROADMAP.md queue B).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_axpy_dot_cuda"]

_SOURCE = "streams"
THREADS = 256
MAX_BLOCKS = 1024  # partials pass 2 sums in one 1024-thread block


def _entry():
    lib = _build.load(_SOURCE)
    fn = lib.fused_axpy_dot
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def n_blocks(n: int) -> int:
    """Blocks of pass 1 for n entries (fixed per n, so the sum order is)."""
    return max(1, min(MAX_BLOCKS, -(-n // THREADS)))


def fused_axpy_dot_cuda(
    r: torch.Tensor, ap: torch.Tensor, alpha: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(r − α·Ap, Σ(r − α·Ap)² in fp32) on the card.

    ``alpha`` is a one-element tensor on the same device, read there by
    the kernel (it is cast to r's dtype first if it differs).  Returns the
    new vector and a 0-d float32 tensor.
    """
    if alpha.numel() != 1:
        raise ValueError("fused_axpy_dot: alpha must hold one value")
    alpha = alpha.reshape(()).to(r.dtype).contiguous()
    _build.validate("fused_axpy_dot", r.dtype, r=r, ap=ap, alpha=alpha)
    if r.shape != ap.shape:
        raise ValueError(f"fused_axpy_dot: r {r.shape} and ap {ap.shape} differ")
    n = r.numel()
    blocks = n_blocks(n)
    r_new = torch.empty_like(r)
    partials = torch.empty(blocks, dtype=torch.float32, device=r.device)
    out = torch.empty((), dtype=torch.float32, device=r.device)
    lib, fn = _entry()
    with torch.cuda.device(r.device):
        code = fn(
            r.data_ptr(), ap.data_ptr(), alpha.data_ptr(), r_new.data_ptr(),
            partials.data_ptr(), out.data_ptr(), n, blocks, THREADS,
            int(r.dtype == torch.float64),
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    _build.check(lib, code, "fused_axpy_dot")
    fused_axpy_dot_cuda.launches += 1
    return r_new, out


fused_axpy_dot_cuda.launches = 0
