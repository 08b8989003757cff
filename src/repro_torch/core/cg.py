"""(Preconditioned) Conjugate Gradient in hipBone-assembled and NekBone-scattered form.

Counterpart of ``repro/core/cg.py``, step for step: one PCG serves both
storage modes; plain CG is PCG without a preconditioner.

  * one fused pass computes ``r_{j+1} = r_j - α A p`` AND ``r_{j+1}·r_{j+1}``
    (``fused_update``; on the card for fp32 data the ``fused_axpy_dot``
    CUDA kernel, see ``kernels.ops.should_fuse_streams``);
  * inner products on assembled vectors are plain dots; the scattered
    baseline weights them with W (NekBone's extra stream).

Iteration control: a fixed count (NekBone runs 100) queues every
iteration on the device with no host synchronisation — status, history
and the zero-RHS verdict stay device tensors.  Passing ``tol`` stops at
‖r‖ ≤ tol·‖r₀‖ (capped at ``n_iter``); that loop reads one flag on the
host per iteration to decide whether to go on.

Guardrails, as in the reference: NaN/Inf residual or p·Ap, indefinite
curvature (p·Ap ≤ 0) or preconditioner (r·z < 0), and in tolerance mode
divergence (rdotr > ``divergence_factor``·rdotr₀) and stagnation (no
``stagnation_rtol`` reduction of the best rdotr within
``stagnation_window`` iterations).  The outcome is ``CGResult.status``,
a ``SolveStatus`` code.

``cg_variant="flexible"`` switches β to the Polak–Ribière form
z_new·(r_new − r_old)/(r·z)_old, robust to preconditioners that are only
approximately symmetric.
"""
from __future__ import annotations

import enum
from typing import Callable, NamedTuple

import torch

__all__ = [
    "CGResult",
    "CG_VARIANTS",
    "DIVERGENCE_FACTOR",
    "STAGNATION_RTOL",
    "STAGNATION_WINDOW",
    "SolveStatus",
    "cg_assembled",
    "cg_scattered",
    "fused_residual_update",
    "status_name",
]

CG_VARIANTS = ("standard", "flexible")

# detector defaults (override per solve; None disables that detector);
# rdotr is the squared residual norm, so 1e6 is a 1000x residual growth
DIVERGENCE_FACTOR = 1e6
STAGNATION_WINDOW = 50
STAGNATION_RTOL = 0.99

# in-loop sentinel; never escapes into CGResult.status
_RUNNING = -1


class SolveStatus(enum.IntEnum):
    """Terminal state of a (P)CG solve — ``CGResult.status``.

    * ``CONVERGED`` — ‖r‖ ≤ tol·‖r₀‖, including rdotr₀ = 0 (0 iterations).
    * ``MAX_ITER`` — the budget ran out; the normal completion of a
      fixed-count solve.
    * ``BREAKDOWN_NAN`` — a non-finite reduction scalar.
    * ``BREAKDOWN_INDEFINITE`` — p·Ap ≤ 0 or r·z < 0.
    * ``STAGNATED`` — no progress over the window (tolerance mode only).
    * ``DIVERGED`` — rdotr > divergence_factor·rdotr₀ (tolerance mode only).
    """

    CONVERGED = 0
    MAX_ITER = 1
    BREAKDOWN_NAN = 2
    BREAKDOWN_INDEFINITE = 3
    STAGNATED = 4
    DIVERGED = 5


def status_name(code: int | torch.Tensor) -> str:
    """Lowercase wire name of a ``SolveStatus`` code (e.g. ``"converged"``)."""
    return SolveStatus(int(code)).name.lower()


class CGResult(NamedTuple):
    x: torch.Tensor
    rdotr: torch.Tensor
    iterations: torch.Tensor
    status: torch.Tensor
    rdotr_history: torch.Tensor | None


def fused_residual_update(
    r: torch.Tensor, ap: torch.Tensor, alpha: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """r - α·Ap and its self-dot, in the vectors' own dtype (plain torch)."""
    r_new = r - alpha * ap
    return r_new, _dot(r_new, r_new, None)


def _dot(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    if w is not None:
        a = a * w
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # fixed-iteration CG keeps iterating after convergence; guard 0/0 so x
    # simply freezes at the solution
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)), 0.0)


def _pcg(
    operator: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None,
    *,
    n_iter: int,
    tol: float | None,
    weight: torch.Tensor | None,
    precond: Callable[[torch.Tensor], torch.Tensor] | None,
    fused_update: Callable[..., tuple[torch.Tensor, torch.Tensor]] | None,
    record_history: bool,
    variant: str = "standard",
    divergence_factor: float | None = DIVERGENCE_FACTOR,
    stagnation_window: int | None = STAGNATION_WINDOW,
    stagnation_rtol: float = STAGNATION_RTOL,
) -> CGResult:
    if variant not in CG_VARIANTS:
        raise ValueError(
            f"unknown cg_variant {variant!r}; choose from {CG_VARIANTS}"
        )
    if precond is not None and not callable(precond):
        raise TypeError(
            f"precond must be a callable z = M⁻¹r (or None), got {precond!r}"
        )
    upd = fused_update or fused_residual_update
    # without a preconditioner z_new == r_new and Polak–Ribière reduces to
    # Fletcher–Reeves, so keep the cheaper standard recurrence there
    flexible = variant == "flexible" and precond is not None
    dev = b.device
    x = torch.zeros_like(b) if x0 is None else x0

    def code(c: int) -> torch.Tensor:
        return torch.tensor(int(c), dtype=torch.int32, device=dev)

    run = code(_RUNNING)
    converged = code(SolveStatus.CONVERGED)
    max_iter_ = code(SolveStatus.MAX_ITER)
    nan_code = code(SolveStatus.BREAKDOWN_NAN)
    indef_code = code(SolveStatus.BREAKDOWN_INDEFINITE)

    r = b - operator(x)
    rdotr0 = _dot(r, r, weight)
    if precond is None:
        z, rz = r, rdotr0
    else:
        z = precond(r)
        rz = _dot(r, z, weight)
    p = z

    def detect(pap, rz_new, rdotr_pre, rdotr_new):
        """NaN/indefinite breakdown code for one iteration, else _RUNNING.

        ``rdotr_pre > 0`` guards the indefinite test: a fixed-count solve
        keeps stepping after convergence with p ≈ 0, where p·Ap = 0 is not
        a breakdown.
        """
        bad = ~torch.isfinite(rdotr_new) | ~torch.isfinite(pap)
        indef = ((pap <= 0) | (rz_new < 0)) & (rdotr_pre > 0)
        return torch.where(bad, nan_code, torch.where(indef, indef_code, run))

    # pre-loop breakdowns: non-finite b/x0/operator, or an indefinite M⁻¹
    status0 = torch.where(
        ~torch.isfinite(rdotr0), nan_code, torch.where(rz < 0, indef_code, run)
    )

    def step(x, r, p, rz, rdotr):
        ap = operator(p)
        pap = _dot(p, ap, weight)
        alpha = _safe_div(rz, pap)
        if weight is None:
            r_new, rdotr_new = upd(r, ap, alpha)
        else:
            r_new = r - alpha * ap
            rdotr_new = _dot(r_new, r_new, weight)
        x_new = x + alpha * p
        if precond is None:
            z_new, rz_new = r_new, rdotr_new
            beta = _safe_div(rz_new, rz)
        elif flexible:
            z_new = precond(r_new)
            rz_new = _dot(r_new, z_new, weight)
            beta = _safe_div(rz_new - _dot(z_new, r, weight), rz)
        else:
            z_new = precond(r_new)
            rz_new = _dot(r_new, z_new, weight)
            beta = _safe_div(rz_new, rz)
        p_new = z_new + beta * p
        fail = detect(pap, rz_new, rdotr, rdotr_new)
        return x_new, r_new, p_new, rz_new, rdotr_new, fail

    zero_rhs = rdotr0 == 0

    if tol is None:
        # every iteration is queued without a host sync; the first
        # breakdown is recorded and the loop keeps stepping (_safe_div
        # keeps the post-breakdown arithmetic inert where it can)
        rdotr, status, hist = rdotr0, status0, []
        for _ in range(n_iter):
            x, r, p, rz, rdotr, fail = step(x, r, p, rz, rdotr)
            status = torch.where(status == run, fail, status)
            if record_history:
                hist.append(rdotr)
        status = torch.where(
            status == run, torch.where(zero_rhs, converged, max_iter_), status
        )
        history = None
        if record_history:
            history = torch.stack(hist) if hist else rdotr0.new_zeros(0)
        return CGResult(
            x=x,
            rdotr=rdotr,
            iterations=torch.where(zero_rhs, 0, n_iter).to(torch.int32),
            status=status,
            rdotr_history=history,
        )

    # tolerance mode: ‖r‖ ≤ tol·‖r₀‖, capped at n_iter.  The loop reads
    # one flag on the host per iteration (the early exit); see ROADMAP.md
    # for moving that decision onto the device.
    scalar = lambda v: torch.tensor(v, dtype=rdotr0.dtype, device=dev)
    target = scalar(tol) ** 2 * rdotr0
    hist = torch.zeros(n_iter, dtype=rdotr0.dtype, device=dev)
    diverged_code = code(SolveStatus.DIVERGED)
    stagnated_code = code(SolveStatus.STAGNATED)
    rdotr, status, best = rdotr0, status0, rdotr0
    since = torch.zeros((), dtype=torch.int32, device=dev)
    k = 0
    while k < n_iter and bool((rdotr > target) & (status == run)):
        x, r, p, rz, rdotr_new, fail = step(x, r, p, rz, rdotr)
        if divergence_factor is not None:
            div = rdotr_new > scalar(divergence_factor) * rdotr0
            fail = torch.where((fail == run) & div, diverged_code, fail)
        if stagnation_window is not None:
            improved = rdotr_new < scalar(stagnation_rtol) * best
            since = torch.where(improved, 0, since + 1)
            best = torch.minimum(best, rdotr_new)
            fail = torch.where(
                (fail == run) & (since >= stagnation_window),
                stagnated_code,
                fail,
            )
        # the loop condition guarantees status == run on entry, so fail IS
        # the new status
        status = fail
        if record_history:
            hist[k] = rdotr_new
        rdotr = rdotr_new
        k += 1
    status = torch.where(
        status == run,
        torch.where(rdotr <= target, converged, max_iter_),
        status,
    )
    return CGResult(
        x=x,
        rdotr=rdotr,
        iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        status=status,
        rdotr_history=hist if record_history else None,
    )


def cg_assembled(
    operator: Callable[[torch.Tensor], torch.Tensor],
    b_g: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    n_iter: int = 100,
    tol: float | None = None,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    fused_update: Callable[..., tuple[torch.Tensor, torch.Tensor]] | None = None,
    record_history: bool = False,
    cg_variant: str = "standard",
    divergence_factor: float | None = DIVERGENCE_FACTOR,
    stagnation_window: int | None = STAGNATION_WINDOW,
    stagnation_rtol: float = STAGNATION_RTOL,
) -> CGResult:
    """hipBone (P)CG on assembled (length N_G) vectors; unweighted dots.

    ``precond``: optional z = M⁻¹r; None is plain CG.  ``fused_update``:
    optional one-pass (r − α·Ap, ‖·‖²), e.g. ``kernels.ops.fused_axpy_dot``
    for fp32 solves on the card.  ``tol``: stop at ‖r‖ ≤ tol·‖r₀‖ instead
    of running ``n_iter`` iterations.  ``cg_variant``: "standard"
    (Fletcher–Reeves β) or "flexible" (Polak–Ribière β).  The detector
    knobs are as in the module docstring; None disables one.
    """
    return _pcg(
        operator,
        b_g,
        x0,
        n_iter=n_iter,
        tol=tol,
        weight=None,
        precond=precond,
        fused_update=fused_update,
        record_history=record_history,
        variant=cg_variant,
        divergence_factor=divergence_factor,
        stagnation_window=stagnation_window,
        stagnation_rtol=stagnation_rtol,
    )


def cg_scattered(
    operator: Callable[[torch.Tensor], torch.Tensor],
    b_l: torch.Tensor,
    w_local: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    n_iter: int = 100,
    tol: float | None = None,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    record_history: bool = False,
    cg_variant: str = "standard",
    divergence_factor: float | None = DIVERGENCE_FACTOR,
    stagnation_window: int | None = STAGNATION_WINDOW,
    stagnation_rtol: float = STAGNATION_RTOL,
) -> CGResult:
    """NekBone baseline (P)CG on scattered (length N_L) vectors; W-weighted dots."""
    return _pcg(
        operator,
        b_l,
        x0,
        n_iter=n_iter,
        tol=tol,
        weight=w_local,
        precond=precond,
        fused_update=None,
        record_history=record_history,
        variant=cg_variant,
        divergence_factor=divergence_factor,
        stagnation_window=stagnation_window,
        stagnation_rtol=stagnation_rtol,
    )
