"""Public wrappers of the ported kernels: the one place that routes by device.

A CUDA tensor always takes the CUDA kernel, or the launcher raises (no
build, a refused launch, a wrong dtype or layout); nothing falls back.  A
CPU tensor takes the kernel's plain PyTorch version (``kernels/ref.py``).
There is no environment override and no size gate: the TPU's VMEM budget,
element blocking and lane padding do not exist on this card.

Every CUDA launcher counts its launches (``launch_counts``), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from . import ref
from .poisson import poisson_local_cuda
from .poisson_fused import poisson_assembled_fused_cuda
from .streams import fused_axpy_dot_cuda

__all__ = [
    "fused_axpy_dot",
    "launch_counts",
    "make_local_op",
    "make_poisson_assembled_fused",
    "poisson_assembled_fused",
    "poisson_local",
    "reset_launch_counts",
    "should_fuse_streams",
]

_LAUNCHERS = {
    "poisson_local": poisson_local_cuda,
    "poisson_assembled_fused": poisson_assembled_fused_cuda,
    "fused_axpy_dot": fused_axpy_dot_cuda,
}


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in _LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in _LAUNCHERS.values():
        fn.launches = 0


def should_fuse_streams(dtype: torch.dtype, device: str | torch.device) -> bool:
    """Use ``fused_axpy_dot`` as CG's ``fused_update``?

    True for fp32 vectors on the card.  The kernel sums in fp32, which is
    enough for an fp32 solve but would throw away bits an fp64 tol=1e-8
    recurrence needs, so fp64 solves keep the plain update (as the
    reference's ``should_fuse_streams`` rules).
    """
    return torch.device(device).type == "cuda" and dtype == torch.float32


def poisson_local(
    u: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor | None,
    d: torch.Tensor,
    *,
    lam: float,
) -> torch.Tensor:
    """(S_L + λ diag(w)) u per element; ``w=None`` means weights of 1."""
    if u.is_cuda:
        return poisson_local_cuda(u, g, w, d, lam=lam)
    return ref.poisson_local_ref(u, g, w, d, lam=lam)


def make_local_op():
    """Adapter with ``core.operator``'s local_op signature (u, g, d, lam, w)."""

    def op(u, g, d, lam, w):
        return poisson_local(u, g, w, d, lam=float(lam))

    return op


def poisson_assembled_fused(
    x_g: torch.Tensor,
    l2g: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor,
    d: torch.Tensor,
    *,
    lam: float,
) -> torch.Tensor:
    """Single-pass y_G = Zᵀ(S_L + λW)Z x_G."""
    if x_g.is_cuda:
        return poisson_assembled_fused_cuda(x_g, l2g, g, w, d, lam=lam)
    return ref.poisson_assembled_fused_ref(x_g, l2g, g, w, d, lam=lam)


def make_poisson_assembled_fused(prob):
    """Fused-operator apply x_G -> A x_G for a ``core.operator.PoissonProblem``.

    The same call signature as the split ``poisson_assembled(prob,
    fused=False)``; the closure carries ``apply.fused = True``.  k(x) is
    already folded into ``prob.g`` and the λ(x) screen rides the ``w``
    stream with ``lam`` 1.0 (``core.operator.screen_stream``); Dirichlet
    BCs are the mask∘A∘mask wrap around the kernel.
    """
    from ..core.operator import screen_stream  # lazy: core imports kernels

    w_eff, lam_eff = screen_stream(prob)
    mask = prob.mask

    def apply(x_g: torch.Tensor) -> torch.Tensor:
        if mask is not None:
            x_g = mask * x_g
        y_g = poisson_assembled_fused(x_g, prob.l2g, prob.g, w_eff, prob.d, lam=lam_eff)
        return y_g if mask is None else mask * y_g

    apply.fused = True
    return apply


def fused_axpy_dot(
    r: torch.Tensor, ap: torch.Tensor, alpha: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-pass (r − α·Ap, ‖r − α·Ap‖² in fp32) — CG's ``fused_update``."""
    if r.is_cuda:
        return fused_axpy_dot_cuda(r, ap, alpha)
    return ref.fused_axpy_dot_ref(r, ap, alpha)
