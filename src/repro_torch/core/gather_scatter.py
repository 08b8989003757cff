"""Gather/scatter Z, Zᵀ, ZZᵀ and the inverse-degree weight W.

  Z      (``scatter``):        x_L = Z x_G, an ``index_select`` through l2g;
  Zᵀ     (``gather``):         b_G = Zᵀ y_L, an ``index_add_`` into zeros;
  ZZᵀ    (``gather_scatter``): NekBone's combined operation on scattered
                               vectors;
  W:     inverse-degree weights with Zᵀ W Z = I (numpy setup).

On the card ``index_add_`` sums with atomics, so ``gather`` agrees with the
reference to round-off, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "scatter",
    "gather",
    "gather_scatter",
    "inverse_degree",
    "local_inverse_degree",
]


def scatter(x_g: torch.Tensor, l2g: torch.Tensor) -> torch.Tensor:
    """x_L = Z x_G. Shapes: x_G (N_G,), l2g (E, p) -> (E, p)."""
    return torch.index_select(x_g, 0, l2g.reshape(-1)).reshape(l2g.shape)


def gather(y_l: torch.Tensor, l2g: torch.Tensor, n_global: int) -> torch.Tensor:
    """b_G = Zᵀ y_L. Shapes: y_L (E, p), l2g (E, p) -> (N_G,)."""
    out = torch.zeros(n_global, dtype=y_l.dtype, device=y_l.device)
    return out.index_add_(0, l2g.reshape(-1), y_l.reshape(-1))


def gather_scatter(
    y_l: torch.Tensor, l2g: torch.Tensor, n_global: int
) -> torch.Tensor:
    """ZZᵀ y_L — NekBone's combined gather-scatter on scattered vectors."""
    return scatter(gather(y_l, l2g, n_global), l2g)


def inverse_degree(l2g: np.ndarray, n_global: int) -> np.ndarray:
    """Global inverse-degree vector diag(ZᵀZ)⁻¹ as numpy float64.

    The counts are small integers, exact in float64 whichever way they are
    summed, so ``bincount`` gives the reference's ``np.add.at`` bit for bit.
    """
    counts = np.bincount(l2g.reshape(-1), minlength=n_global).astype(np.float64)
    return 1.0 / counts


def local_inverse_degree(l2g: np.ndarray, n_global: int) -> np.ndarray:
    """W in scattered layout: (E, p) inverse multiplicity of each local node."""
    return inverse_degree(l2g, n_global)[l2g]
