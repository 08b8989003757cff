"""Launcher of the single-pass assembled CUDA kernel y_G = Zᵀ(S_L + λW)Z x_G.

The kernel (``csrc/poisson_fused.cu``) replaces the TPU kernel
``repro/kernels/poisson_fused.py::poisson_assembled_fused_pallas``: one
thread block per element gathers its u from x_G through l2g, applies the
element-local operator in shared memory and scatter-adds into y_G with
atomics, so neither x_L nor y_L exists in device memory.  Callers go
through ``kernels.ops.poisson_assembled_fused``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["poisson_assembled_fused_cuda"]

_SOURCE = "poisson_fused"


def _entry():
    lib = _build.load(_SOURCE)
    fn = lib.poisson_assembled_fused
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def poisson_assembled_fused_cuda(
    x_g: torch.Tensor,
    l2g: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor,
    d: torch.Tensor,
    *,
    lam: float,
) -> torch.Tensor:
    """Zᵀ(S_L + λ diag(w))Z x_G on the card.

    Shapes: x_G (N_G,), l2g (E, p) int32 with entries in [0, N_G),
    g (E, 6, p), w (E, p), d (n1, n1).  The sum order of the scatter-add
    varies between runs (atomics), so results agree to round-off.
    """
    _build.validate(
        "poisson_assembled_fused", x_g.dtype, x_g=x_g, l2g=l2g, g=g, w=w, d=d
    )
    e, p = l2g.shape
    n1 = d.shape[0]
    if not 2 <= n1 <= 16 or n1**3 != p or d.shape != (n1, n1):
        raise ValueError(
            f"poisson_assembled_fused: p={p}, d {tuple(d.shape)} is not N=1..15"
        )
    if x_g.dim() != 1 or g.shape != (e, 6, p) or w.shape != (e, p):
        raise ValueError(
            "poisson_assembled_fused: x_G must be (N_G,), g (E, 6, p), w (E, p)"
        )
    y = torch.zeros_like(x_g)
    if e == 0:
        return y
    lib, fn = _entry()
    with torch.cuda.device(x_g.device):
        code = fn(
            x_g.data_ptr(), l2g.data_ptr(), g.data_ptr(), w.data_ptr(),
            d.data_ptr(), y.data_ptr(), e, n1, float(lam),
            int(x_g.dtype == torch.float64),
            torch.cuda.current_stream(x_g.device).cuda_stream,
        )
    _build.check(lib, code, "poisson_assembled_fused")
    poisson_assembled_fused_cuda.launches += 1
    return y


poisson_assembled_fused_cuda.launches = 0
