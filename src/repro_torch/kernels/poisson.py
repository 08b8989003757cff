"""Launcher of the element-local CUDA kernel y_L = (S_L + λW) u.

The kernel (``csrc/poisson.cu``) replaces the TPU kernel
``repro/kernels/poisson.py::poisson_local_pallas``: one thread block per
element, u, D and the weighted gradients in shared memory.  Callers go
through ``kernels.ops.poisson_local``, which routes CPU tensors to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["poisson_local_cuda"]

_SOURCE = "poisson"


def _entry():
    lib = _build.load(_SOURCE)
    fn = lib.poisson_local
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def poisson_local_cuda(
    u: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor | None,
    d: torch.Tensor,
    *,
    lam: float,
) -> torch.Tensor:
    """(S_L + λ diag(w)) u on the card; ``w=None`` means weights of 1.

    Shapes: u (E, p), g (E, 6, p), w (E, p), d (n1, n1) with p = n1³,
    1 ≤ N ≤ 15.  Launches on the current stream without synchronising.
    """
    tensors = {"u": u, "g": g, "d": d} | ({} if w is None else {"w": w})
    _build.validate("poisson_local", u.dtype, **tensors)
    e, p = u.shape
    n1 = d.shape[0]
    if not 2 <= n1 <= 16 or n1**3 != p or d.shape != (n1, n1):
        raise ValueError(f"poisson_local: p={p}, d {tuple(d.shape)} is not N=1..15")
    if g.shape != (e, 6, p) or (w is not None and w.shape != (e, p)):
        raise ValueError("poisson_local: g must be (E, 6, p) and w (E, p)")
    y = torch.empty_like(u)
    if e == 0:
        return y
    lib, fn = _entry()
    with torch.cuda.device(u.device):
        code = fn(
            u.data_ptr(), g.data_ptr(), 0 if w is None else w.data_ptr(),
            d.data_ptr(), y.data_ptr(), e, n1, float(lam),
            int(u.dtype == torch.float64),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    _build.check(lib, code, "poisson_local")
    poisson_local_cuda.launches += 1
    return y


poisson_local_cuda.launches = 0
