"""Geometric factors G^e for the SEM Laplacian (numpy setup).

For each element, the metric tensor combined with the GLL weights,

    G_ab = J * w_ijk * sum_c (dr_a/dx_c)(dr_b/dx_c),   a, b in {r, s, t},

packed as six entries [G_rr, G_rs, G_rt, G_ss, G_st, G_tt] in the
factor-major (E, 6, p) layout the kernels read.  The same float64
arithmetic as ``repro/core/geometry.py``, so the arrays are bitwise the
reference's; the work runs over chunks of elements so the host's peak
memory stays bounded at full size (every step is element-local, so the
chunking does not change a bit).
"""
from __future__ import annotations

import numpy as np

from . import sem
from .mesh import BoxMesh

__all__ = ["geometric_factors", "geometric_factors_from_coords"]

# elements per chunk: ~0.6 GB of float64 temporaries at N=7
CHUNK_ELEMENTS = 2048


def geometric_factors(mesh: BoxMesh) -> dict[str, np.ndarray]:
    """Geometric factors and quadrature data for a mesh.

    Returns a dict with ``G`` (E, 6, p), ``J`` (E, p) — the Jacobian
    determinant — and ``JW`` (E, p) = J·w (the SEM mass diagonal), all
    float64.
    """
    return geometric_factors_from_coords(mesh.coords, mesh.n_degree)


def _factors_chunk(xyz, d, w3, npts):
    """G, J, JW of one chunk of elements; xyz is (Ec, t, s, r, 3)."""
    e_total = xyz.shape[0]
    dxdr = np.einsum("ia,etsac->etsic", d, xyz)   # d/dr
    dxds = np.einsum("jb,etbrc->etjrc", d, xyz)   # d/ds
    dxdt = np.einsum("kc,ecsrx->eksrx", d, xyz)   # d/dt

    # Jacobian matrix dX/dR: (E, t, s, r, 3[x], 3[r])
    jac = np.stack([dxdr, dxds, dxdt], axis=-1)
    det = np.linalg.det(jac)
    if np.any(det <= 0):
        raise ValueError("mesh has non-positive Jacobian (too much deformation?)")
    inv = np.linalg.inv(jac)  # inv[..., a, c] = dr_a/dx_c

    p = npts**3
    det_f = det.reshape(e_total, p)
    inv_f = inv.reshape(e_total, p, 3, 3)
    jw = det_f * w3[None, :]

    gmat = np.einsum("epac,epbc->epab", inv_f, inv_f)  # (E, p, 3, 3)
    gmat = gmat * jw[..., None, None]
    g = np.stack(
        [
            gmat[..., 0, 0],
            gmat[..., 0, 1],
            gmat[..., 0, 2],
            gmat[..., 1, 1],
            gmat[..., 1, 2],
            gmat[..., 2, 2],
        ],
        axis=1,
    )
    return g, det_f, jw


def geometric_factors_from_coords(
    coords: np.ndarray, n_degree: int
) -> dict[str, np.ndarray]:
    """Same as :func:`geometric_factors` from bare (E, p, 3) node coordinates."""
    n = int(n_degree)
    npts = n + 1
    p = npts**3
    e_total = coords.shape[0]
    d = sem.derivative_matrix(n)
    _, w1 = sem.gll_nodes_weights(n)
    w3 = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :]).reshape(-1)

    # coords: (E, p, 3) with local ordering (t slow, s mid, r fast)
    xyz = coords.reshape(e_total, npts, npts, npts, 3)
    g = np.empty((e_total, 6, p), dtype=np.float64)
    det = np.empty((e_total, p), dtype=np.float64)
    jw = np.empty((e_total, p), dtype=np.float64)
    for lo in range(0, e_total, CHUNK_ELEMENTS):
        hi = min(lo + CHUNK_ELEMENTS, e_total)
        g[lo:hi], det[lo:hi], jw[lo:hi] = _factors_chunk(xyz[lo:hi], d, w3, npts)
    return {"G": g, "J": det, "JW": jw}
