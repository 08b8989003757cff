"""Named coefficient families for A = -∇·(k(x)∇) + λ(x) (numpy setup).

Counterpart of ``repro/core/coefficients.py``.  ``k`` is folded into the
packed geometric factors at setup and the screen field λ(x) rides the
kernels' ``w`` stream as JW·λ with ``lam`` pinned to 1.0
(``core.operator.screen_stream``), so no kernel signature depends on it.

  * ``"const"`` — constant λ, k ≡ 1, the algebraic λI screen;
  * ``"smooth"`` — k = 1 + ½·cos(πx)cos(πy)cos(πz), λ(x) = λ as a field;
  * ``"checker"`` — per-element octant checkerboard k ∈ {1, CHECKER_RHO}
    evaluated at element centroids.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "CHECKER_RHO",
    "COEFFICIENTS",
    "checker_k",
    "checker_k_elements",
    "coefficient_fields",
    "smooth_k",
]

COEFFICIENTS = ("const", "smooth", "checker")
CHECKER_RHO = 3.0


def smooth_k(x, y, z):
    """Smooth positive diffusion field 1 + ½·cos(πx)cos(πy)cos(πz)."""
    pi = np.pi
    return 1.0 + 0.5 * np.cos(pi * x) * np.cos(pi * y) * np.cos(pi * z)


def checker_k(x, y, z, *, rho: float = CHECKER_RHO):
    """Octant checkerboard: ``rho`` on odd-parity octants of the ½-planes."""
    parity = (
        np.floor(2.0 * np.asarray(x)).astype(np.int64)
        + np.floor(2.0 * np.asarray(y)).astype(np.int64)
        + np.floor(2.0 * np.asarray(z)).astype(np.int64)
    ) % 2
    return np.where(parity == 1, rho, 1.0)


def checker_k_elements(coords: np.ndarray, *, rho: float = CHECKER_RHO):
    """(E, p) per-element-constant checker field from element centroids."""
    c = np.asarray(coords).mean(axis=1)  # (E, 3)
    k_e = checker_k(c[:, 0], c[:, 1], c[:, 2], rho=rho)
    return np.broadcast_to(k_e[:, None], coords.shape[:2]).copy()


def coefficient_fields(name: str | None, coords, lam: float):
    """(k, lam_field) float64 arrays for a named family, or (None, None).

    ``"const"`` (and ``None``) return the sentinels of the constant-λ
    algebraic screen; the variable families return per-node k and a
    constant λ field (the weak mass-weighted screen).
    """
    if name is None or name == "const":
        return None, None
    coords = np.asarray(coords)
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    if name == "smooth":
        k = smooth_k(x, y, z)
    elif name == "checker":
        k = checker_k_elements(coords)
    else:
        raise ValueError(
            f"unknown coefficient family {name!r}; choose from {COEFFICIENTS}"
        )
    lam_field = np.full(coords.shape[:2], float(lam))
    return k, lam_field
