"""Plain PyTorch versions of the ported kernels.

The CPU path of every kernel wrapper and the oracle each CUDA kernel is
held against (tests, ``chip_smoke.py``).  Nothing on the card's main path
calls them.
"""
from __future__ import annotations

import torch

from ..core.gather_scatter import gather, scatter
from ..core.operator import local_poisson

__all__ = [
    "poisson_local_ref",
    "poisson_assembled_fused_ref",
    "fused_axpy_dot_ref",
]


def poisson_local_ref(
    u: torch.Tensor, g: torch.Tensor, w: torch.Tensor | None, d: torch.Tensor, *,
    lam: float,
) -> torch.Tensor:
    """y = (S_L + λ diag(w)) u — plain version of ``kernels/poisson.py``."""
    return local_poisson(u, g, d, lam, w)


def poisson_assembled_fused_ref(
    x_g: torch.Tensor,
    l2g: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor,
    d: torch.Tensor,
    *,
    lam: float,
) -> torch.Tensor:
    """y_G = Zᵀ(S_L + λW)Z x_G as scatter, local op, ``index_add_``."""
    y_l = local_poisson(scatter(x_g, l2g), g, d, lam, w)
    return gather(y_l, l2g, x_g.shape[0])


def fused_axpy_dot_ref(
    r: torch.Tensor, ap: torch.Tensor, alpha: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(r − α·Ap, Σ(r − α·Ap)²) with the sum in fp32, as the kernel takes it."""
    r_new = r - alpha * ap
    rf = r_new.to(torch.float32)
    return r_new, torch.sum(rf * rf)
