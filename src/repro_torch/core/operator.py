"""The screened Poisson operator A = S + λ·screen in both storage modes.

hipBone (assembled) mode, the paper's central contribution:
    y_L = (S_L + λW) Z x_G,   A x_G = Zᵀ y_L
— on the card one fused CUDA kernel (``kernels/poisson_fused.py``) by
default, or the split scatter → ``poisson_local`` kernel → gather form.

NekBone (scattered) baseline mode:
    b_L = (ZZᵀ S_L + λI) x_L, with the local op the ``poisson_local`` kernel.

The element-local stiffness is the tensor-product SEM Laplacian
S_L^e = Dᵀ G^e D.  :func:`local_poisson` is its plain PyTorch version
(the oracle every kernel is held against).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from . import coefficients as _coef
from . import geometry, sem
from .gather_scatter import gather, gather_scatter, inverse_degree, scatter
from .mesh import BoxMesh, build_box_mesh, dirichlet_mask, normalize_bc

__all__ = [
    "local_poisson",
    "PoissonProblem",
    "build_problem",
    "problem_from_mesh",
    "problem_from_arrays",
    "cast_problem",
    "poisson_assembled",
    "poisson_scattered",
    "screen_stream",
]


def local_poisson(
    u: torch.Tensor,
    g: torch.Tensor,
    d: torch.Tensor,
    lam: float,
    w: torch.Tensor | None,
) -> torch.Tensor:
    """Element-local screened Poisson action (S_L + λ·screen) u, plain torch.

    Args:
      u:  (E, p) element-local field, p = (N+1)^3, node order (t, s, r).
      g:  (E, 6, p) packed geometric factors [rr, rs, rt, ss, st, tt].
      d:  (N+1, N+1) 1-D derivative matrix.
      lam: screen parameter λ.
      w:  (E, p) weights of the screen (the inverse degree for hipBone's
          λW, JW·λ(x) for a screen field), or None for the plain λI of
          NekBone's scattered form.

    Returns:
      (E, p) result.
    """
    e, p = u.shape
    n1 = d.shape[0]
    u3 = u.reshape(e, n1, n1, n1)  # (E, t, s, r)

    ur = torch.einsum("ia,etsa->etsi", d, u3)
    us = torch.einsum("jb,etbr->etjr", d, u3)
    ut = torch.einsum("kc,ecsr->eksr", d, u3)

    g3 = g.reshape(e, 6, n1, n1, n1)
    wr = g3[:, 0] * ur + g3[:, 1] * us + g3[:, 2] * ut
    ws = g3[:, 1] * ur + g3[:, 3] * us + g3[:, 4] * ut
    wt = g3[:, 2] * ur + g3[:, 4] * us + g3[:, 5] * ut

    out = (
        torch.einsum("ia,etsi->etsa", d, wr)
        + torch.einsum("jb,etjr->etbr", d, ws)
        + torch.einsum("kc,eksr->ecsr", d, wt)
    ).reshape(e, p)

    screen = u if w is None else w * u
    return out + lam * screen


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """A ready-to-run screened Poisson problem on one device.

    Every tensor lies on ``device`` in the runtime ``dtype`` (``l2g`` is
    int32); the mesh stays numpy setup metadata on the host.
    """

    mesh: BoxMesh
    lam: float
    d: torch.Tensor            # (N+1, N+1)
    g: torch.Tensor            # (E, 6, p) — k(x) already folded in when set
    jw: torch.Tensor           # (E, p) mass diagonal
    l2g: torch.Tensor          # (E, p) int32
    w_local: torch.Tensor      # (E, p) inverse degree (scattered layout)
    w_global: torch.Tensor     # (N_G,) inverse degree (assembled layout)
    dtype: torch.dtype
    # variable-coefficient / boundary-condition extension — all None for
    # the constant-λ screened Poisson
    k: torch.Tensor | None = None          # (E, p) diffusion field (unfolded)
    lam_field: torch.Tensor | None = None  # (E, p) screen field λ(x)
    mask: torch.Tensor | None = None       # (N_G,) 0 on Dirichlet DOFs
    bc: tuple | None = None                # 6-face tags (mesh.BC_FACES order)

    @property
    def n_global(self) -> int:
        return self.mesh.n_global

    @property
    def n_local(self) -> int:
        return self.mesh.n_local

    @property
    def device(self) -> torch.device:
        return self.g.device


def screen_stream(prob: PoissonProblem) -> tuple[torch.Tensor, float]:
    """The (w, lam) pair every element kernel takes for the screen term.

    Constant-λ mode (``lam_field is None``): ``(w_local, λ)``, the
    algebraic λ·W screen that assembles to exactly λI.  Field mode:
    ``(JW·λ_field, 1.0)``, the mass-weighted weak screen Zᵀ diag(JW·λ) Z.
    """
    if prob.lam_field is None:
        return prob.w_local, prob.lam
    return prob.jw * prob.lam_field, 1.0


def _eval_field(spec, coords: np.ndarray) -> np.ndarray | None:
    """Evaluate a coefficient spec (None, scalar, callable or (E, p) array)."""
    if spec is None:
        return None
    if callable(spec):
        out = spec(coords[..., 0], coords[..., 1], coords[..., 2])
        return np.broadcast_to(np.asarray(out), coords.shape[:2])
    arr = np.asarray(spec)
    if arr.ndim == 0:
        return np.full(coords.shape[:2], float(arr))
    if arr.shape != coords.shape[:2]:
        raise ValueError(
            f"coefficient field shape {arr.shape} != (E, p) {coords.shape[:2]}"
        )
    return arr


def build_problem(
    n_degree: int,
    shape: tuple[int, int, int],
    *,
    lam: float = 1.0,
    deform: float = 0.0,
    dtype: torch.dtype = torch.float32,
    coefficient: str | None = None,
    bc: Any = None,
    device: str | torch.device | None = None,
) -> PoissonProblem:
    """Construct mesh, geometric factors and gather-scatter data.

    ``coefficient`` names a family of ``core.coefficients`` (None/"const"
    is the constant-λ screen); ``bc`` is a spec for ``mesh.normalize_bc``.
    ``device`` defaults to the card (see ``repro_torch.device``).
    """
    device = resolve_device(device)
    m = build_box_mesh(n_degree, shape, deform=deform)
    k, lam_field = _coef.coefficient_fields(coefficient, m.coords, lam)
    return problem_from_mesh(
        m, lam=lam, dtype=dtype, k=k, lam_field=lam_field, bc=bc, device=device
    )


def _to(arr, dtype, device):
    """A new tensor on ``device`` from a numpy array (never a view of it)."""
    if arr is None:
        return None
    host = torch.from_numpy(np.require(arr, requirements=("C", "W")))
    return host.to(device=device, dtype=dtype, copy=True)


def problem_from_mesh(
    m: BoxMesh,
    *,
    lam: float = 1.0,
    dtype: torch.dtype = torch.float32,
    k: Any = None,
    lam_field: Any = None,
    bc: Any = None,
    device: str | torch.device | None = None,
) -> PoissonProblem:
    """Geometric factors + gather-scatter data for an existing mesh.

    ``k`` / ``lam_field`` accept None, a scalar, an (E, p) array, or a
    callable f(x, y, z) evaluated on the mesh nodes.  ``k`` is folded into
    the packed geometric factors here, so every kernel sees variable
    diffusion through the ``g`` stream it already reads.
    """
    device = resolve_device(device)
    geo = geometry.geometric_factors(m)
    w_g = inverse_degree(m.l2g, m.n_global)
    g = geo["G"]
    k_arr = _eval_field(k, m.coords)
    lam_arr = _eval_field(lam_field, m.coords)
    if k_arr is not None:
        g = g * k_arr[:, None, :]
    tags = normalize_bc(bc)
    mask = None if tags is None else dirichlet_mask(m, tags)
    return _assemble(
        m,
        {
            "d": sem.derivative_matrix(m.n_degree),
            "g": g,
            "jw": geo["JW"],
            "w_local": w_g[m.l2g],
            "w_global": w_g,
            "k": k_arr,
            "lam_field": lam_arr,
            "mask": mask,
        },
        lam=lam,
        tags=tags,
        dtype=dtype,
        device=device,
    )


def _assemble(m, arrays, *, lam, tags, dtype, device) -> PoissonProblem:
    """Move the float64 setup arrays onto ``device`` in ``dtype``."""
    return PoissonProblem(
        mesh=m,
        lam=float(lam),
        d=_to(arrays["d"], dtype, device),
        g=_to(arrays["g"], dtype, device),
        jw=_to(arrays["jw"], dtype, device),
        l2g=_to(m.l2g, torch.int32, device),
        w_local=_to(arrays["w_local"], dtype, device),
        w_global=_to(arrays["w_global"], dtype, device),
        dtype=dtype,
        k=_to(arrays.get("k"), dtype, device),
        lam_field=_to(arrays.get("lam_field"), dtype, device),
        mask=_to(arrays.get("mask"), dtype, device),
        bc=tags,
    )


def problem_from_arrays(
    arrays: dict[str, np.ndarray],
    *,
    n_degree: int,
    shape: tuple[int, int, int],
    lam: float,
    bc: Any = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> PoissonProblem:
    """The port's ``PoissonProblem`` from another problem's numpy arrays.

    ``arrays`` holds ``coords, l2g, d, g, jw, w_local, w_global`` and, when
    set, ``k, lam_field, mask`` — the fields of the reference
    ``PoissonProblem`` (``g`` with k already folded in), handed over as
    numpy.  Missing or None optional entries mean the constant-λ screen /
    no mask.
    """
    device = resolve_device(device)
    l2g = np.asarray(arrays["l2g"], dtype=np.int32)
    coords = np.asarray(arrays["coords"], dtype=np.float64)
    e_total = int(np.prod(shape))
    if l2g.shape != (e_total, (n_degree + 1) ** 3):
        raise ValueError(
            f"l2g shape {l2g.shape} does not match N={n_degree}, shape={shape}"
        )
    m = BoxMesh(
        n_degree=int(n_degree),
        shape=tuple(int(s) for s in shape),
        l2g=l2g,
        coords=coords,
        n_global=int(np.asarray(arrays["w_global"]).shape[0]),
        n_local=int(l2g.size),
    )
    return _assemble(
        m, arrays, lam=lam, tags=normalize_bc(bc), dtype=dtype, device=device
    )


def cast_problem(prob: PoissonProblem, dtype: torch.dtype) -> PoissonProblem:
    """The same problem with every runtime float tensor cast to ``dtype``."""
    cast = lambda a: None if a is None else a.to(dtype)
    return dataclasses.replace(
        prob,
        d=prob.d.to(dtype),
        g=prob.g.to(dtype),
        jw=prob.jw.to(dtype),
        w_local=prob.w_local.to(dtype),
        w_global=prob.w_global.to(dtype),
        dtype=dtype,
        k=cast(prob.k),
        lam_field=cast(prob.lam_field),
        mask=cast(prob.mask),
    )


def poisson_assembled(
    prob: PoissonProblem,
    local_op: Callable[..., torch.Tensor] | None = None,
    *,
    fused: bool | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """hipBone operator: x_G (N_G,) -> A x_G (N_G,).

    ``fused`` (the default unless a ``local_op`` is given) is the single
    pass ``kernels.ops.poisson_assembled_fused``: gather, local operator
    and scatter-add in one CUDA kernel on the card.  ``fused=False`` is the
    split form y_L = (S_L + λW) Z x_G, then Zᵀ y_L, with the local op the
    ``poisson_local`` kernel unless ``local_op`` replaces it.  On CPU
    tensors both forms run the plain versions.  A Dirichlet mask wraps
    either form as mask∘A∘mask.
    """
    from ..kernels import ops  # lazy: kernels import core

    if fused is None:
        fused = local_op is None
    if fused:
        if local_op is not None:
            raise ValueError(
                "poisson_assembled: fused=True replaces the whole "
                "scatter/local_op/gather pipeline; drop local_op"
            )
        return ops.make_poisson_assembled_fused(prob)

    op = local_op or ops.make_local_op()
    w_eff, lam_eff = screen_stream(prob)
    mask = prob.mask

    def apply(x_g: torch.Tensor) -> torch.Tensor:
        if mask is not None:
            x_g = mask * x_g
        x_l = scatter(x_g, prob.l2g)
        y_l = op(x_l, prob.g, prob.d, lam_eff, w_eff)
        y_g = gather(y_l, prob.l2g, prob.n_global)
        return y_g if mask is None else mask * y_g

    apply.fused = False
    return apply


def poisson_scattered(
    prob: PoissonProblem,
    local_op: Callable[..., torch.Tensor] | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """NekBone baseline operator: x_L (E, p) -> b_L = (ZZᵀ S_L + λI) x_L.

    The local op defaults to the ``poisson_local`` kernel (λ = 0, no
    weights).  The scattered baseline keeps NekBone's algebraic λI screen;
    a λ(x) field or a Dirichlet mask needs the assembled operator.
    """
    from ..kernels import ops  # lazy: kernels import core

    if prob.lam_field is not None or prob.mask is not None:
        raise NotImplementedError(
            "poisson_scattered is the constant-λ NekBone baseline; "
            "λ(x) fields / Dirichlet masks need the assembled operator "
            "(poisson_assembled)"
        )
    op = local_op or ops.make_local_op()

    def apply(x_l: torch.Tensor) -> torch.Tensor:
        s_l = op(x_l, prob.g, prob.d, 0.0, None)  # S_L x_L only
        return gather_scatter(s_l, prob.l2g, prob.n_global) + prob.lam * x_l

    return apply
