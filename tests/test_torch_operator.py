"""The port's operators and kernel plain versions against the reference.

``local_poisson``, ``poisson_assembled`` (split and fused, which on CPU
tensors run the kernels' plain versions) and ``poisson_scattered`` are held
to the JAX reference at ≤ 1e-12 relative in fp64 and ≤ 1e-5 in fp32; each
kernel's plain version is also held to the reference's Pallas kernel run
in interpret mode, as the JAX tests run it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from repro.core import operator as R  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.poisson import poisson_local_pallas  # noqa: E402
from repro_torch.core import operator as T  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = {"float64": 1e-12, "float32": 1e-5}
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _pair(n, shape, dtype, **kw):
    jdt, tdt = DTYPES[dtype]
    return (
        R.build_problem(n, shape, dtype=jdt, **kw),
        T.build_problem(n, shape, dtype=tdt, device="cpu", **kw),
    )


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,shape,deform", [(1, (3, 2, 1), 0.0), (3, (2, 2, 2), 0.15),
                                            (7, (2, 1, 1), 0.15), (15, (1, 1, 1), 0.15)])
def test_local_poisson_matches_reference(n, shape, deform, dtype, rng):
    rp, tp = _pair(n, shape, dtype, lam=1.3, deform=deform)
    u = rng.standard_normal(tp.l2g.shape)
    for w_r, w_t in ((rp.w_local, tp.w_local), (None, None)):
        want = R.local_poisson(jnp.asarray(u, rp.dtype), rp.g, rp.d, 1.3, w_r)
        got = T.local_poisson(_t(u, dtype), tp.g, tp.d, 1.3, w_t)
        assert _rel(got, want) <= RTOL[dtype]


CASES = [
    (3, (2, 2, 2), 0.0, None, None),
    (3, (2, 2, 2), 0.15, "smooth", "mixed"),
    (3, (2, 2, 2), 0.15, "checker", "dirichlet"),
    (7, (2, 1, 1), 0.15, None, None),
    (15, (1, 1, 1), 0.15, None, "mixed"),
]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,shape,deform,coefficient,bc", CASES)
def test_poisson_assembled_matches_reference(n, shape, deform, coefficient, bc, dtype, rng):
    rp, tp = _pair(n, shape, dtype, lam=0.7, deform=deform, coefficient=coefficient, bc=bc)
    x = rng.standard_normal(tp.n_global)
    want = R.poisson_assembled(rp, fused=False)(jnp.asarray(x, rp.dtype))
    fused = T.poisson_assembled(tp)
    split = T.poisson_assembled(tp, fused=False)
    assert fused.fused and not split.fused
    for apply in (fused, split):
        assert _rel(apply(_t(x, dtype)), want) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,shape", [(3, (2, 2, 2)), (7, (2, 1, 1))])
def test_poisson_scattered_matches_reference(n, shape, dtype, rng):
    rp, tp = _pair(n, shape, dtype, lam=1.1, deform=0.15)
    x_l = rng.standard_normal(tp.l2g.shape)
    want = R.poisson_scattered(rp)(jnp.asarray(x_l, rp.dtype))
    got = T.poisson_scattered(tp)(_t(x_l, dtype))
    assert _rel(got, want) <= RTOL[dtype]


def test_poisson_scattered_rejects_fields_and_masks():
    tp = T.build_problem(3, (2, 2, 2), coefficient="smooth", bc="mixed", device="cpu")
    with pytest.raises(NotImplementedError):
        T.poisson_scattered(tp)


def test_fused_with_local_op_raises():
    tp = T.build_problem(1, (1, 1, 1), device="cpu")
    with pytest.raises(ValueError):
        T.poisson_assembled(tp, local_op=ops.make_local_op(), fused=True)


def test_cast_problem_equals_fp32_build():
    p64 = T.build_problem(3, (2, 2, 2), deform=0.15, dtype=torch.float64, device="cpu",
                          coefficient="smooth", bc="mixed")
    p32 = T.build_problem(3, (2, 2, 2), deform=0.15, dtype=torch.float32, device="cpu",
                          coefficient="smooth", bc="mixed")
    cast = T.cast_problem(p64, torch.float32)
    for key in ("d", "g", "jw", "w_local", "w_global", "k", "lam_field", "mask"):
        assert torch.equal(getattr(cast, key), getattr(p32, key)), key
    assert cast.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,shape", [(3, (2, 2, 1)), (7, (1, 1, 1))])
def test_poisson_local_plain_matches_pallas_interpret(n, shape, dtype, rng):
    rp, tp = _pair(n, shape, dtype, lam=1.3, deform=0.15)
    u = rng.standard_normal(tp.l2g.shape)
    e = tp.l2g.shape[0]
    want = poisson_local_pallas(
        jnp.asarray(u, rp.dtype), rp.g, rp.w_local, rp.d, lam=1.3, block_e=e,
        interpret=True,
    )
    got = ref.poisson_local_ref(_t(u, dtype), tp.g, tp.w_local, tp.d, lam=1.3)
    assert _rel(got, want) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,shape", [(3, (2, 2, 1)), (7, (1, 1, 1))])
def test_poisson_assembled_fused_plain_matches_pallas_interpret(n, shape, dtype, rng):
    rp, tp = _pair(n, shape, dtype, lam=1.3, deform=0.15)
    x = rng.standard_normal(tp.n_global)
    want = ref_ops.poisson_assembled_fused(
        jnp.asarray(x, rp.dtype), rp.l2g, rp.g, rp.w_local, rp.d, lam=1.3, interpret=True
    )
    got = ref.poisson_assembled_fused_ref(
        _t(x, dtype), tp.l2g, tp.g, tp.w_local, tp.d, lam=1.3
    )
    assert _rel(got, want) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [1, 1000, 4099])
def test_fused_axpy_dot_plain_matches_pallas_interpret(n, dtype, rng):
    r, ap = rng.standard_normal(n), rng.standard_normal(n)
    jdt, tdt = DTYPES[dtype]
    want_r, want_rr = ref_ops.fused_axpy_dot(
        jnp.asarray(r, jdt), jnp.asarray(ap, jdt), jnp.asarray(0.3, jdt), interpret=True
    )
    got_r, got_rr = ref.fused_axpy_dot_ref(
        _t(r, dtype), _t(ap, dtype), torch.tensor(0.3, dtype=tdt)
    )
    assert got_rr.dtype == torch.float32
    assert _rel(got_r, want_r) <= RTOL[dtype]
    # both sum in fp32, in different orders
    assert abs(float(got_rr) - float(want_rr)) <= 1e-5 * float(want_rr)
