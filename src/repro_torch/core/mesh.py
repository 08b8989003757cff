"""Structured hexahedral SEM box mesh with its global (assembled) numbering.

Counterpart of ``repro/core/mesh.py``: a box of ``E = ex*ey*ez`` elements
with a degree-N GLL grid per element.  Nodes on shared faces, edges and
corners are one global DOF; the local-to-global map ``l2g`` is the
boolean scatter matrix Z (one nonzero per row).  Pure numpy setup code,
bitwise the reference's; the arrays become tensors in ``core.operator``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import sem

__all__ = [
    "BC_FACES",
    "BoxMesh",
    "build_box_mesh",
    "dirichlet_mask",
    "normalize_bc",
]

# face order of a boundary-condition 6-tuple (matches the element-grid axes)
BC_FACES = ("x_lo", "x_hi", "y_lo", "y_hi", "z_lo", "z_hi")
_BC_TAGS = ("dirichlet", "neumann")


def normalize_bc(bc) -> tuple[str, ...] | None:
    """Canonicalize a boundary-condition spec to a 6-face tag tuple.

    ``None`` means no essential BCs (A = S + λ·screen on all DOFs);
    ``"dirichlet"`` / ``"neumann"`` set all six faces, ``"mixed"`` is
    Dirichlet on the two x-faces and Neumann on y/z; or give a 6-sequence
    of per-face tags in :data:`BC_FACES` order.  Neumann faces are natural
    in the weak form, so an all-Neumann spec produces no mask.
    """
    if bc is None:
        return None
    if isinstance(bc, str):
        if bc == "dirichlet":
            return ("dirichlet",) * 6
        if bc == "neumann":
            return ("neumann",) * 6
        if bc == "mixed":
            return ("dirichlet", "dirichlet") + ("neumann",) * 4
        raise ValueError(
            f"unknown bc shorthand {bc!r}; use 'dirichlet'|'neumann'|'mixed' "
            "or a 6-tuple of per-face tags"
        )
    tags = tuple(bc)
    if len(tags) != 6:
        raise ValueError(
            f"bc must name all 6 faces {BC_FACES}, got {len(tags)} entries"
        )
    for face, tag in zip(BC_FACES, tags):
        if tag not in _BC_TAGS:
            raise ValueError(f"bc[{face}] = {tag!r}; choose from {_BC_TAGS}")
    return tags


def dirichlet_mask(mesh: "BoxMesh", bc) -> np.ndarray | None:
    """(N_G,) float64 0/1 mask: 0 on Dirichlet-face DOFs, 1 elsewhere.

    Topological — it reads the structured global grid index, so mesh
    deformation does not move it.  ``None`` when no face is Dirichlet.
    Operators apply it as A_m = mask∘A∘mask.
    """
    tags = normalize_bc(bc)
    if tags is None or all(t == "neumann" for t in tags):
        return None
    n = mesh.n_degree
    ex, ey, ez = mesh.shape
    gx, gy, gz = ex * n + 1, ey * n + 1, ez * n + 1
    if gx * gy * gz != mesh.n_global:
        raise ValueError(
            "dirichlet_mask needs the structured box numbering: "
            f"{gx}*{gy}*{gz} != n_global={mesh.n_global}"
        )
    g = np.arange(mesh.n_global)
    ix = g % gx
    iy = (g // gx) % gy
    iz = g // (gx * gy)
    keep = np.ones(mesh.n_global, dtype=bool)
    for tag, sel in zip(
        tags,
        (ix == 0, ix == gx - 1, iy == 0, iy == gy - 1, iz == 0, iz == gz - 1),
    ):
        if tag == "dirichlet":
            keep &= ~sel
    return keep.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class BoxMesh:
    """A structured SEM box mesh.

    Attributes:
      n_degree: polynomial degree N.
      shape: (ex, ey, ez) element counts per axis.
      l2g: int32 (E, (N+1)^3) local-node -> global-DOF map (the matrix Z).
      coords: float64 (E, (N+1)^3, 3) physical coordinates of local nodes.
      n_global: number of assembled DOFs N_G.
      n_local: number of element-local nodes N_L = E (N+1)^3.
    """

    n_degree: int
    shape: tuple[int, int, int]
    l2g: np.ndarray
    coords: np.ndarray
    n_global: int
    n_local: int

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape))

    @property
    def points_per_element(self) -> int:
        return (self.n_degree + 1) ** 3


def build_box_mesh(
    n_degree: int,
    shape: tuple[int, int, int],
    *,
    extent: tuple[float, float, float] = (1.0, 1.0, 1.0),
    deform: float = 0.0,
    seed: int = 0,
) -> BoxMesh:
    """Build a structured box mesh on [0, Lx] x [0, Ly] x [0, Lz].

    ``deform`` applies a smooth sinusoidal coordinate deformation of that
    relative amplitude (a conforming diffeomorphism, so all six metric
    entries are nonzero); ``deform=0`` is the regular NekBone mesh.
    ``seed`` sets the deformation's phases.
    """
    ex, ey, ez = (int(s) for s in shape)
    n = int(n_degree)
    if min(ex, ey, ez) < 1:
        raise ValueError(f"element grid must be positive, got {shape}")
    gll, _ = sem.gll_nodes_weights(n)

    # global point grid: (ex*N + 1, ey*N + 1, ez*N + 1), x fastest
    gx, gy, gz = ex * n + 1, ey * n + 1, ez * n + 1
    n_global = gx * gy * gz

    def axis_nodes(ne: int, length: float) -> np.ndarray:
        h = length / ne
        pos = np.empty(ne * n + 1, dtype=np.float64)
        for e in range(ne):
            pos[e * n : (e + 1) * n + 1] = (e + (gll + 1.0) / 2.0) * h
        return pos

    px = axis_nodes(ex, extent[0])
    py = axis_nodes(ey, extent[1])
    pz = axis_nodes(ez, extent[2])

    # local node (a, b, c) of element (i, j, k) sits at global grid point
    # (i*N + a, j*N + b, k*N + c); local flat index a + (N+1)*(b + (N+1)*c)
    # (r fastest), element flat index i + ex*(j + ey*k)
    a = np.arange(n + 1)
    la, lb, lc = np.meshgrid(a, a, a, indexing="ij")
    loc_a = la.transpose(2, 1, 0).reshape(-1)
    loc_b = lb.transpose(2, 1, 0).reshape(-1)
    loc_c = lc.transpose(2, 1, 0).reshape(-1)

    ei, ej, ek = np.meshgrid(
        np.arange(ex), np.arange(ey), np.arange(ez), indexing="ij"
    )
    ei = ei.transpose(2, 1, 0).reshape(-1)
    ej = ej.transpose(2, 1, 0).reshape(-1)
    ek = ek.transpose(2, 1, 0).reshape(-1)

    gxi = ei[:, None] * n + loc_a[None, :]
    gyj = ej[:, None] * n + loc_b[None, :]
    gzk = ek[:, None] * n + loc_c[None, :]
    l2g = (gxi + gx * (gyj + gy * gzk)).astype(np.int32)

    coords = np.stack([px[gxi], py[gyj], pz[gzk]], axis=-1)  # (E, p, 3)

    if deform:
        rng = np.random.default_rng(seed)
        phase = rng.uniform(0, 2 * np.pi, size=(3,))
        lx, ly, lz = extent
        x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
        amp = deform * min(extent) / (2 * np.pi)
        sx = np.sin(2 * np.pi * x / lx + phase[0])
        sy = np.sin(2 * np.pi * y / ly + phase[1])
        sz = np.sin(2 * np.pi * z / lz + phase[2])
        coords = coords + amp * np.stack([sy * sz, sx * sz, sx * sy], axis=-1)

    e_total = ex * ey * ez
    return BoxMesh(
        n_degree=n,
        shape=(ex, ey, ez),
        l2g=l2g,
        coords=coords,
        n_global=n_global,
        n_local=e_total * (n + 1) ** 3,
    )
