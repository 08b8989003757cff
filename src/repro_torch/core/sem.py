"""GLL nodes, weights and the 1-D SEM derivative matrix (numpy setup).

Counterpart of ``repro/core/sem.py`` for the assembled-solve slice: the
same float64 arithmetic in the same order, so every array is bitwise the
reference's.  Setup-time constants; they are cast once when a problem is
built.  The Schwarz / p-multigrid helpers of the reference come with the
preconditioner slice.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["gll_nodes_weights", "derivative_matrix"]


def _legendre_and_derivative(n: int, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Value and derivative of the Legendre polynomial P_n at points x.

    Three-term recurrence; stable for the modest n (<= 31) used by SEM.
    """
    x = np.asarray(x, dtype=np.float64)
    p_prev = np.ones_like(x)            # P_0
    if n == 0:
        return p_prev, np.zeros_like(x)
    p = x.copy()                        # P_1
    for k in range(1, n):
        p_next = ((2 * k + 1) * x * p - k * p_prev) / (k + 1)
        p_prev, p = p, p_next
    # P'_n via the identity (1 - x^2) P'_n = n (P_{n-1} - x P_n)
    with np.errstate(divide="ignore", invalid="ignore"):
        dp = n * (p_prev - x * p) / (1.0 - x * x)
    # endpoints: P'_n(±1) = (±1)^{n-1} n(n+1)/2
    endv = n * (n + 1) / 2.0
    dp = np.where(x == 1.0, endv, dp)
    dp = np.where(x == -1.0, (-1.0) ** (n - 1) * endv, dp)
    return p, dp


@functools.lru_cache(maxsize=64)
def gll_nodes_weights(n_degree: int) -> tuple[np.ndarray, np.ndarray]:
    """GLL quadrature nodes and weights for polynomial degree ``n_degree``.

    Returns ``(x, w)`` with ``n_degree + 1`` points on [-1, 1]: the
    endpoints plus the roots of P'_N, and ``w_i = 2 / (N (N+1) P_N(x_i)^2)``.
    The cached arrays are shared; callers must not write to them.
    """
    n = int(n_degree)
    if n < 1:
        raise ValueError(f"SEM degree must be >= 1, got {n}")
    if n == 1:
        x = np.array([-1.0, 1.0])
    else:
        # Chebyshev-Gauss-Lobatto initial guess, then Newton on (1-x^2) P'_N
        x = -np.cos(np.pi * np.arange(n + 1) / n)
        for _ in range(200):
            p, dp = _legendre_and_derivative(n, x)
            # f(x) = (1 - x^2) P'_N(x); f'(x) = -N(N+1) P_N(x)
            f = (1.0 - x * x) * dp
            fp = -n * (n + 1) * p
            dx = np.where(np.abs(fp) > 0, f / fp, 0.0)
            dx[0] = 0.0
            dx[-1] = 0.0
            x = x - dx
            if np.max(np.abs(dx)) < 1e-15:
                break
        x[0], x[-1] = -1.0, 1.0
    p, _ = _legendre_and_derivative(n, x)
    w = 2.0 / (n * (n + 1) * p * p)
    return x, w


@functools.lru_cache(maxsize=64)
def derivative_matrix(n_degree: int) -> np.ndarray:
    """1-D SEM derivative matrix D on the GLL points.

    ``(D u)_i = u'(x_i)`` for ``u`` in the degree-N Lagrange basis;
    ``D[i, j] = (P_N(x_i) / P_N(x_j)) / (x_i - x_j)`` off the diagonal,
    with corner values ∓N(N+1)/4.
    """
    n = int(n_degree)
    x, _ = gll_nodes_weights(n)
    p, _ = _legendre_and_derivative(n, x)
    d = np.zeros((n + 1, n + 1), dtype=np.float64)
    for i in range(n + 1):
        for j in range(n + 1):
            if i != j:
                d[i, j] = (p[i] / p[j]) / (x[i] - x[j])
    d[0, 0] = -n * (n + 1) / 4.0
    d[n, n] = n * (n + 1) / 4.0
    return d
