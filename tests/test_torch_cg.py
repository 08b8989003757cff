"""The port's CG against the reference: iterations, status and detectors.

``cg_assembled`` and ``cg_scattered`` run the same iterations and end in
the same ``SolveStatus`` as the JAX reference in both loop modes; the six
plain-CG fp64 rows of ``BENCH_pr10.json`` are reproduced by the port
alone; every detector trips as the reference's does.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.gather_scatter import scatter  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parents[1] / "BENCH_pr10.json"


@pytest.fixture(scope="module")
def pair():
    """The same fp64 problem and right-hand side in both packages."""
    kw = dict(lam=1.0, deform=0.15)
    rp = R.build_problem(3, (2, 2, 2), dtype=jnp.float64, **kw)
    tp = T.build_problem(3, (2, 2, 2), dtype=torch.float64, device="cpu", **kw)
    b = np.random.default_rng(0).standard_normal(tp.n_global)
    return rp, tp, b


def _same_outcome(res_r, res_t, *, x_rtol=1e-9):
    assert int(res_t.iterations) == int(res_r.iterations)
    assert int(res_t.status) == int(res_r.status)
    x_r = np.asarray(res_r.x)
    if np.all(np.isfinite(x_r)):
        scale = max(np.max(np.abs(x_r)), 1e-300)
        assert np.max(np.abs(res_t.x.numpy() - x_r)) <= x_rtol * scale


@pytest.mark.parametrize("tol", [None, 1e-8])
def test_cg_assembled_matches_reference(pair, tol):
    rp, tp, b = pair
    res_r = R.cg_assembled(R.poisson_assembled(rp), jnp.asarray(b), n_iter=40, tol=tol,
                           record_history=True)
    res_t = T.cg_assembled(T.poisson_assembled(tp), torch.from_numpy(b), n_iter=40,
                           tol=tol, record_history=True)
    _same_outcome(res_r, res_t)
    k = int(res_r.iterations)
    h_r, h_t = np.asarray(res_r.rdotr_history)[:k], res_t.rdotr_history.numpy()[:k]
    # healthy iterations agree to round-off; past convergence (fixed-count
    # mode) both sit at the fp64 noise floor
    floor = 1e-24 * float(b @ b)
    np.testing.assert_allclose(h_t, h_r, rtol=1e-6, atol=floor)


@pytest.mark.parametrize("tol", [None, 1e-8])
def test_cg_scattered_matches_reference(pair, tol):
    rp, tp, b = pair
    b_r = jnp.take(jnp.asarray(b), rp.l2g, axis=0)  # the reference's Z x_G
    b_t = scatter(torch.from_numpy(b), tp.l2g)
    res_r = R.cg_scattered(R.poisson_scattered(rp), b_r, rp.w_local, n_iter=40, tol=tol)
    res_t = T.cg_scattered(T.poisson_scattered(tp), b_t, tp.w_local, n_iter=40, tol=tol)
    _same_outcome(res_r, res_t)


def test_fp32_fused_update_matches_reference():
    """fp32 solve with the fused r-update (plain version on CPU) vs the
    reference's interpret-mode Pallas kernel: same iterations and status."""
    rp = R.build_problem(3, (2, 2, 2), lam=1.0, deform=0.15, dtype=jnp.float32)
    tp = T.build_problem(3, (2, 2, 2), lam=1.0, deform=0.15, dtype=torch.float32,
                         device="cpu")
    b = np.random.default_rng(1).standard_normal(tp.n_global).astype(np.float32)
    res_r = R.cg_assembled(
        R.poisson_assembled(rp), jnp.asarray(b), n_iter=100, tol=1e-5,
        fused_update=lambda r, ap, a: ref_ops.fused_axpy_dot(r, ap, a, interpret=True),
    )
    res_t = T.cg_assembled(T.poisson_assembled(tp), torch.from_numpy(b), n_iter=100,
                           tol=1e-5, fused_update=ops.fused_axpy_dot)
    _same_outcome(res_r, res_t, x_rtol=1e-4)
    assert res_t.rdotr.dtype == torch.float32


def _bench_rows():
    rows = json.loads(BENCH.read_text())["precond_records"]
    return [
        (r["n"], r["lam"], r["iters_to_tol"], r["status"]) for r in rows
        if r["kind"] == "none" and r["dtype"] == "fp64" and r["coefficient"] == "const"
    ]


def test_bench_has_six_plain_cg_rows():
    assert sorted((n, lam) for n, lam, _, _ in _bench_rows()) == [
        (3, 0.1), (3, 1.0), (7, 0.1), (7, 1.0), (15, 0.1), (15, 1.0)
    ]


@pytest.mark.parametrize("n,lam,iters,status", _bench_rows())
def test_bench_pr10_plain_cg_rows_reproduced(n, lam, iters, status):
    """benchmarks/precond_solve.py::_solve_case, rebuilt by the port alone."""
    shape = {3: (4, 4, 4), 7: (4, 4, 4), 15: (2, 2, 2)}[n]
    prob = T.build_problem(n, shape, lam=lam, deform=0.15, dtype=torch.float64,
                           device="cpu")
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(prob.n_global))
    res = T.cg_assembled(T.poisson_assembled(prob), b, n_iter=500, tol=1e-8)
    assert (int(res.iterations), T.status_name(res.status)) == (iters, status)


@pytest.mark.parametrize("tol", [None, 1e-8])
@pytest.mark.parametrize("fault", ["nan_rhs", "negated", "zero_rhs"])
def test_detector_statuses_match_reference(pair, fault, tol):
    rp, tp, b = pair
    a_r, a_t = R.poisson_assembled(rp), T.poisson_assembled(tp)
    if fault == "nan_rhs":
        b = b.copy()
        b[3] = np.nan
        want = R.SolveStatus.BREAKDOWN_NAN
    elif fault == "zero_rhs":
        b = np.zeros_like(b)
        want = R.SolveStatus.CONVERGED
    else:
        a_r_inner, a_t_inner = a_r, a_t
        a_r, a_t = (lambda x: -a_r_inner(x)), (lambda x: -a_t_inner(x))
        want = R.SolveStatus.BREAKDOWN_INDEFINITE
    res_r = R.cg_assembled(a_r, jnp.asarray(b), n_iter=30, tol=tol)
    res_t = T.cg_assembled(a_t, torch.from_numpy(b), n_iter=30, tol=tol)
    assert int(res_r.status) == int(want)
    _same_outcome(res_r, res_t)
    if fault == "zero_rhs":
        assert int(res_t.iterations) == 0 and not torch.any(res_t.x)


def test_divergence_detector_matches_reference(pair):
    """A skew-symmetric corruption blows up the recurrence: DIVERGED."""
    rp, tp, b = pair
    a_r, a_t = R.poisson_assembled(rp), T.poisson_assembled(tp)
    skew_r = lambda x: a_r(x) + 5000.0 * (jnp.roll(x, 1) - jnp.roll(x, -1))
    skew_t = lambda x: a_t(x) + 5000.0 * (torch.roll(x, 1) - torch.roll(x, -1))
    res_r = R.cg_assembled(skew_r, jnp.asarray(b), n_iter=500, tol=1e-8)
    res_t = T.cg_assembled(skew_t, torch.from_numpy(b), n_iter=500, tol=1e-8)
    assert int(res_r.status) == R.SolveStatus.DIVERGED
    assert int(res_t.status) == int(res_r.status)
    assert int(res_t.iterations) == int(res_r.iterations)


def test_stagnation_detector_matches_reference(pair):
    """A rank-deficient M⁻¹ pins the residual at a floor: STAGNATED."""
    rp, tp, b = pair
    keep_r = (jnp.arange(rp.n_global) % 7 != 0).astype(jnp.float64)
    keep_t = (torch.arange(tp.n_global) % 7 != 0).to(torch.float64)
    kw = dict(n_iter=500, tol=1e-12, cg_variant="flexible")
    res_r = R.cg_assembled(R.poisson_assembled(rp), jnp.asarray(b),
                           precond=lambda r: r * keep_r, **kw)
    res_t = T.cg_assembled(T.poisson_assembled(tp), torch.from_numpy(b),
                           precond=lambda r: r * keep_t, **kw)
    assert int(res_r.status) == R.SolveStatus.STAGNATED
    assert int(res_t.status) == int(res_r.status)
    assert int(res_t.iterations) == int(res_r.iterations)


@pytest.mark.parametrize("tol", [None, 1e-8])
def test_flexible_with_identity_precond_equals_standard(pair, tol):
    _, tp, b = pair
    a = T.poisson_assembled(tp)
    bt = torch.from_numpy(b)
    std = T.cg_assembled(a, bt, n_iter=40, tol=tol)
    flex = T.cg_assembled(a, bt, n_iter=40, tol=tol, precond=lambda r: r.clone(),
                          cg_variant="flexible")
    assert int(flex.iterations) == int(std.iterations)
    assert int(flex.status) == int(std.status)
    scale = float(std.x.abs().max())
    assert float((flex.x - std.x).abs().max()) <= 1e-10 * scale


def test_unknown_variant_and_string_precond_raise(pair):
    _, tp, b = pair
    a = T.poisson_assembled(tp)
    with pytest.raises(ValueError):
        T.cg_assembled(a, torch.from_numpy(b), cg_variant="bogus")
    with pytest.raises(TypeError):
        T.cg_assembled(a, torch.from_numpy(b), precond="jacobi")
