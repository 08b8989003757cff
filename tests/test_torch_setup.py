"""The port's numpy setup is the reference's, array for array.

GLL data, meshes, geometric factors, coefficient fields, Dirichlet masks
and inverse degrees of ``repro_torch`` are held bitwise (or, for integer
maps, array-equal) to ``repro``; a problem built by the port equals one
carried across from the reference's arrays.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.core import coefficients as ref_coef  # noqa: E402
from repro.core import geometry as ref_geometry  # noqa: E402
from repro.core import mesh as ref_mesh  # noqa: E402
from repro.core import sem as ref_sem  # noqa: E402
from repro.core.gather_scatter import inverse_degree as ref_inverse_degree  # noqa: E402
from repro.core.operator import build_problem as ref_build_problem  # noqa: E402
from repro_torch.core import coefficients, geometry, mesh, sem  # noqa: E402
from repro_torch.core.gather_scatter import (  # noqa: E402
    gather,
    gather_scatter,
    inverse_degree,
    local_inverse_degree,
    scatter,
)
from repro_torch.core.operator import build_problem, problem_from_arrays  # noqa: E402

DEGREES = [1, 3, 7, 15]
SHAPES = {1: (3, 2, 2), 3: (2, 3, 2), 7: (2, 2, 1), 15: (1, 1, 2)}
CPU = torch.device("cpu")


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("n", list(range(1, 16)))
def test_gll_and_derivative_matrix_bitwise(n):
    x, w = sem.gll_nodes_weights(n)
    rx, rw = ref_sem.gll_nodes_weights(n)
    _bitwise(x, rx)
    _bitwise(w, rw)
    _bitwise(sem.derivative_matrix(n), ref_sem.derivative_matrix(n))


@pytest.mark.parametrize("deform", [0.0, 0.15])
@pytest.mark.parametrize("n", DEGREES)
def test_mesh_and_geometry_bitwise(n, deform):
    m = mesh.build_box_mesh(n, SHAPES[n], deform=deform)
    rm = ref_mesh.build_box_mesh(n, SHAPES[n], deform=deform)
    np.testing.assert_array_equal(m.l2g, rm.l2g)
    assert m.l2g.dtype == np.int32
    assert (m.n_global, m.n_local) == (rm.n_global, rm.n_local)
    _bitwise(m.coords, rm.coords)
    geo = geometry.geometric_factors(m)
    rgeo = ref_geometry.geometric_factors(rm)
    for key in ("G", "J", "JW"):
        _bitwise(geo[key], rgeo[key])
    np.testing.assert_array_equal(
        inverse_degree(m.l2g, m.n_global), ref_inverse_degree(rm.l2g, rm.n_global)
    )


@pytest.mark.parametrize("chunk", [1, 5])
def test_geometry_chunking_is_bitwise(chunk, monkeypatch):
    m = mesh.build_box_mesh(3, (3, 2, 2), deform=0.15)
    whole = ref_geometry.geometric_factors(m)
    monkeypatch.setattr(geometry, "CHUNK_ELEMENTS", chunk)
    part = geometry.geometric_factors(m)
    for key in ("G", "J", "JW"):
        _bitwise(part[key], whole[key])


@pytest.mark.parametrize("name", ["const", "smooth", "checker"])
def test_coefficient_fields_bitwise(name):
    m = mesh.build_box_mesh(3, (2, 2, 2), deform=0.15)
    k, lam_field = coefficients.coefficient_fields(name, m.coords, 0.7)
    rk, rlam = ref_coef.coefficient_fields(name, m.coords, 0.7)
    if name == "const":
        assert k is None and lam_field is None and rk is None and rlam is None
        return
    _bitwise(k, rk)
    _bitwise(lam_field, rlam)


@pytest.mark.parametrize("bc", [None, "mixed", "dirichlet", "neumann"])
def test_dirichlet_mask_matches(bc):
    m = mesh.build_box_mesh(3, (2, 3, 2))
    rm = ref_mesh.build_box_mesh(3, (2, 3, 2))
    assert mesh.normalize_bc(bc) == ref_mesh.normalize_bc(bc)
    got, want = mesh.dirichlet_mask(m, bc), ref_mesh.dirichlet_mask(rm, bc)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


def test_gather_scatter_matches_reference(rng):
    # repro.core re-exports a function named gather_scatter over the module
    ref_gs = importlib.import_module("repro.core.gather_scatter")
    m = mesh.build_box_mesh(3, (3, 2, 2))
    x_g = rng.standard_normal(m.n_global)
    y_l = rng.standard_normal(m.l2g.shape)
    l2g = torch.from_numpy(m.l2g)
    np.testing.assert_array_equal(
        scatter(torch.from_numpy(x_g), l2g).numpy(),
        np.asarray(ref_gs.scatter(jnp.asarray(x_g), jnp.asarray(m.l2g))),
    )
    want_g = np.asarray(ref_gs.gather(jnp.asarray(y_l), jnp.asarray(m.l2g), m.n_global))
    got_g = gather(torch.from_numpy(y_l), l2g, m.n_global).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-14, atol=1e-14)
    want_gs = np.asarray(
        ref_gs.gather_scatter(jnp.asarray(y_l), jnp.asarray(m.l2g), m.n_global)
    )
    got_gs = gather_scatter(torch.from_numpy(y_l), l2g, m.n_global).numpy()
    np.testing.assert_allclose(got_gs, want_gs, rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(
        local_inverse_degree(m.l2g, m.n_global),
        ref_gs.local_inverse_degree(m.l2g, m.n_global),
    )


def _arrays(prob):
    """The reference PoissonProblem's arrays as numpy."""
    out = {"coords": prob.mesh.coords, "l2g": prob.mesh.l2g}
    for key in ("d", "g", "jw", "w_local", "w_global", "k", "lam_field", "mask"):
        val = getattr(prob, key)
        out[key] = None if val is None else np.asarray(val)
    return out


CASES = [
    (1, None, None, 0.0),
    (3, "smooth", "mixed", 0.15),
    (7, "checker", "dirichlet", 0.15),
    (15, None, "mixed", 0.0),
]


@pytest.mark.parametrize("n,coefficient,bc,deform", CASES)
def test_build_problem_bitwise_and_carry_across(n, coefficient, bc, deform):
    shape = (2, 2, 2) if coefficient == "checker" else SHAPES[n]
    kw = dict(lam=0.7, deform=deform, coefficient=coefficient, bc=bc)
    ref = ref_build_problem(n, shape, dtype=jnp.float64, **kw)
    port = build_problem(n, shape, dtype=torch.float64, device="cpu", **kw)
    ref_arrays = _arrays(ref)
    for key in ("d", "g", "jw", "w_local", "w_global", "k", "lam_field", "mask"):
        got = getattr(port, key)
        if ref_arrays[key] is None:
            assert got is None, key
        else:
            _bitwise(got.numpy(), ref_arrays[key])
    np.testing.assert_array_equal(port.l2g.numpy(), ref.mesh.l2g)
    assert port.bc == ref.bc and port.lam == ref.lam

    carried = problem_from_arrays(
        ref_arrays, n_degree=n, shape=shape, lam=0.7, bc=bc,
        dtype=torch.float64, device="cpu",
    )
    assert carried.n_global == port.n_global and carried.n_local == port.n_local
    assert carried.bc == port.bc and carried.device == CPU
    _bitwise(carried.mesh.coords, port.mesh.coords)
    for key in ("d", "g", "jw", "l2g", "w_local", "w_global", "k", "lam_field", "mask"):
        a, b = getattr(carried, key), getattr(port, key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert torch.equal(a, b), key


def test_problem_dtype_cast_matches_reference_fp32():
    ref = ref_build_problem(3, (2, 2, 2), deform=0.15, dtype=jnp.float32)
    port = build_problem(3, (2, 2, 2), deform=0.15, dtype=torch.float32, device="cpu")
    for key in ("d", "g", "jw", "w_local", "w_global"):
        _bitwise(getattr(port, key).numpy(), np.asarray(getattr(ref, key)))


@pytest.mark.parametrize("e,n", [(1, 1), (64, 3), (32768, 7), (4096, 15)])
def test_fom_counts_match_reference(e, n):
    from repro.core import fom as ref_fom
    from repro_torch.core import fom

    for name in ("nekbone_flops_per_iter", "hipbone_flops_per_iter", "operator_flops"):
        assert getattr(fom, name)(e, n) == getattr(ref_fom, name)(e, n)
    for name in ("operator_bytes", "fused_apply_bytes", "cg_iter_bytes", "nekbone_iter_bytes"):
        for word in (4, 8):
            assert getattr(fom, name)(e, n, word=word) == getattr(ref_fom, name)(e, n, word=word)
    assert fom.fom_gflops(e, n, 100, 0.5) == ref_fom.fom_gflops(e, n, 100, 0.5)
    t, by = fom.H100_SXM.bound_seconds(fom.fused_apply_bytes(e, n), fom.operator_flops(e, n), 8)
    assert by == "bytes" and t == fom.fused_apply_bytes(e, n) / 3.35e12
