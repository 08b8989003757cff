#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of hipBone end to end on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit's nvcc; run from anywhere inside
a checkout (it imports ``src/repro_torch`` beside this file).  Every phase
prints one JSON line and any failure ends the run with a non-zero exit:

  1. card        — name and power limit from nvidia-smi;
  2. build       — compile the three kernels from src/repro_torch/csrc;
  3. parity      — each kernel against its plain PyTorch version on the
                   same CUDA tensors at small ragged shapes (E=1, 3;
                   N=1, 3, 7, 15) and on variable-coefficient problems;
  4. targets     — the six plain-CG fp64 iteration counts of
                   BENCH_pr10.json, met exactly through the fused kernel;
  5. hipbone     — the full-size solve: N=7 on a 32^3-element box, fp64,
                   100 iterations through the fused operator kernel, then
                   the same in fp32 with fused_axpy_dot as the fused update;
  6. nekbone     — the scattered NekBone baseline on the same problem
                   through the poisson_local kernel;
  7. hipbone_n15 — N=15 on a 16^3-element box (the >48 KB shared-memory
                   path), fp64, 100 iterations;
  8. kernels     — one line with every kernel's launches on the main path,
                   time, plain time and bound.

The last line is the run's verdict: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# tolerances, relative to the largest magnitude of the plain result: fp64
# round-off of a 3(N+1)-term contraction plus at most 8 atomic adds in an
# order that changes per run; fp32 the same at single precision
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DOT_RTOL = 1e-5          # the fp32 sum of fused_axpy_dot, relative
# fp32 residual history of the kernel solve vs the plain solve on the card:
# fp32 round-off in r is ~1e-7 of ‖r0‖, so once CG reaches its fp32 floor
# rdotr is noise of order 1e-14·rdotr0; 1e-8·rdotr0 absolute covers that
# floor and 1e-3 relative the early iterations
HIST_RTOL, HIST_ATOL = 1e-3, 1e-8
FULL_N, FULL_SHAPE = 7, (32, 32, 32)
N15_SHAPE = (16, 16, 16)
N_ITER = 100
TOL = 1e-8

TPU_KERNELS = {
    "poisson_local": ("src/repro_torch/csrc/poisson.cu", "src/repro/kernels/poisson.py:124"),
    "poisson_assembled_fused": (
        "src/repro_torch/csrc/poisson_fused.cu",
        "src/repro/kernels/poisson_fused.py:159",
    ),
    "fused_axpy_dot": ("src/repro_torch/csrc/streams.cu", "src/repro/kernels/streams.py:175"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got − want|, that over max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-300)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() in ms, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rhs(prob, dtype):
    """_solve_case's right-hand side: default_rng(0) normals on N_G DOFs."""
    b = np.random.default_rng(0).standard_normal(prob.n_global)
    if prob.mask is not None:
        b = b * prob.mask.double().cpu().numpy()
    return torch.from_numpy(b).to("cuda", dtype)


def phase_parity(core, ops, ref, scatter):
    worst = {}
    for dtype in (torch.float64, torch.float32):
        for n in (1, 3, 7, 15):
            for shape in ((1, 1, 1), (3, 1, 1)):
                prob = core.build_problem(
                    n, shape, lam=1.3, deform=0.15, dtype=dtype, device="cuda"
                )
                x = rhs(prob, dtype)
                x_l = scatter(x, prob.l2g)
                w, lam = prob.w_local, prob.lam
                errs = {
                    "poisson_local": rel_err(
                        ops.poisson_local(x_l, prob.g, w, prob.d, lam=lam),
                        ref.poisson_local_ref(x_l, prob.g, w, prob.d, lam=lam),
                    ),
                    "poisson_local_noweight": rel_err(
                        ops.poisson_local(x_l, prob.g, None, prob.d, lam=0.0),
                        ref.poisson_local_ref(x_l, prob.g, None, prob.d, lam=0.0),
                    ),
                    "poisson_assembled_fused": rel_err(
                        ops.poisson_assembled_fused(x, prob.l2g, prob.g, w, prob.d, lam=lam),
                        ref.poisson_assembled_fused_ref(x, prob.l2g, prob.g, w, prob.d, lam=lam),
                    ),
                }
                alpha = torch.tensor(0.37, dtype=dtype, device="cuda")
                ap = x.flip(0)
                r_k, rr_k = ops.fused_axpy_dot(x, ap, alpha)
                r_p, rr_p = ref.fused_axpy_dot_ref(x, ap, alpha)
                errs["fused_axpy_dot"] = rel_err(r_k, r_p)
                dot = rel_err(rr_k, rr_p)[1]
                torch.cuda.synchronize()
                for name, (_, rel) in errs.items():
                    require(rel <= RTOL[dtype], f"{name} N={n} E={prob.mesh.n_elements} "
                            f"{dtype}: rel err {rel:.3e} > {RTOL[dtype]}")
                require(dot <= DOT_RTOL, f"fused_axpy_dot sum N={n} {dtype}: {dot:.3e}")
                key = str(dtype).replace("torch.", "")
                for name, (_, rel) in list(errs.items()) + [("fused_axpy_dot_sum", (0, dot))]:
                    worst[f"{name}/{key}"] = max(worst.get(f"{name}/{key}", 0.0), rel)
    # variable coefficients and Dirichlet masks reach the fused kernel only
    # through g, w and the mask wrap
    for coefficient, bc in (("smooth", "mixed"), ("checker", "dirichlet")):
        for dtype in (torch.float64, torch.float32):
            prob = core.build_problem(
                3, (2, 2, 2), lam=0.7, deform=0.15, dtype=dtype,
                coefficient=coefficient, bc=bc, device="cuda",
            )
            x = rhs(prob, dtype)
            split_plain = core.poisson_assembled(
                prob, local_op=lambda u, g, d, lam, w: ref.poisson_local_ref(u, g, w, d, lam=lam)
            )
            _, rel = rel_err(core.poisson_assembled(prob)(x), split_plain(x))
            require(rel <= RTOL[dtype], f"fused {coefficient}/{bc} {dtype}: {rel:.3e}")
            worst[f"fused_{coefficient}_{bc}/{str(dtype).replace('torch.', '')}"] = rel
    emit("parity", max_rel_err=worst, rtol={"float64": 1e-12, "float32": 1e-5},
         dot_rtol=DOT_RTOL)


def phase_targets(core):
    bench = json.loads((ROOT / "BENCH_pr10.json").read_text())
    rows = [
        r for r in bench["precond_records"]
        if r["kind"] == "none" and r["dtype"] == "fp64" and r["coefficient"] == "const"
    ]
    shapes = {3: (4, 4, 4), 7: (4, 4, 4), 15: (2, 2, 2)}
    require(len(rows) == 6, f"expected 6 plain-CG fp64 rows, found {len(rows)}")
    got = []
    for row in rows:
        n, lam = row["n"], row["lam"]
        prob = core.build_problem(
            n, shapes[n], lam=lam, deform=0.15, dtype=torch.float64, device="cuda"
        )
        res = core.cg_assembled(
            core.poisson_assembled(prob), rhs(prob, torch.float64), n_iter=500, tol=TOL
        )
        iters, status = int(res.iterations), core.status_name(res.status)
        got.append({"n": n, "lam": lam, "iters": iters, "want": row["iters_to_tol"],
                    "status": status})
        require(iters == row["iters_to_tol"] and status == row["status"],
                f"N={n} lam={lam}: {iters} {status} != {row['iters_to_tol']} {row['status']}")
    emit("targets", rows=got)


def timed_solve(core, ops, solve):
    """Warm-up solve, then the counted and timed one: (result, s, counts)."""
    solve()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, seconds, ops.launch_counts()


# exact traffic of this run's inputs (core/fom.py models N_G as E·N³)
def local_bytes(e, p, word, weighted):
    """poisson_local traffic: u, six G, (w), y per local node."""
    return (1 + 6 + int(weighted) + 1) * word * e * p


def fused_bytes(n_global, e, p, word):
    """poisson_assembled_fused traffic: x_G, y_G, and l2g + six G + w per node."""
    return 2 * word * n_global + (4 + 7 * word) * e * p


def kernel_entry(name, *, launches, err, ms, plain_ms, nbytes, flops, word, fom):
    bound_s, bound_by = fom.H100_SXM.bound_seconds(nbytes, flops, word)
    source, replaces = TPU_KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3, "bound_by": bound_by, "library_ms": None,
    }


def phase_hipbone(core, ops, ref, fom, kernels):
    prob = core.build_problem(
        FULL_N, FULL_SHAPE, lam=1.0, deform=0.15, dtype=torch.float64, device="cuda"
    )
    e, p, n_g = prob.mesh.n_elements, prob.mesh.points_per_element, prob.n_global
    b = rhs(prob, torch.float64)
    a = core.poisson_assembled(prob)
    require(a.fused, "the default assembled operator must be the fused kernel")

    # fp64 main path: the fused operator kernel, plain update
    res, seconds, counts = timed_solve(
        core, ops, lambda: core.cg_assembled(a, b, n_iter=N_ITER)
    )
    require(counts["poisson_assembled_fused"] == N_ITER + 1,
            f"fused kernel launches {counts['poisson_assembled_fused']} != {N_ITER + 1}")
    rdotr0 = float(b.dot(b))  # r0 = b - A·0
    require(bool(torch.isfinite(res.x).all()) and float(res.rdotr) <= 1e-16 * rdotr0,
            f"fp64 solve did not converge: rdotr {float(res.rdotr):.3e}")
    w, lam = prob.w_local, prob.lam
    apply_ms = cuda_ms(lambda: ops.poisson_assembled_fused(b, prob.l2g, prob.g, w, prob.d, lam=lam))
    plain_ms = cuda_ms(lambda: ref.poisson_assembled_fused_ref(
        b, prob.l2g, prob.g, w, prob.d, lam=lam), reps=5)
    err, rel = rel_err(ops.poisson_assembled_fused(b, prob.l2g, prob.g, w, prob.d, lam=lam),
                       ref.poisson_assembled_fused_ref(b, prob.l2g, prob.g, w, prob.d, lam=lam))
    require(rel <= RTOL[torch.float64], f"full-size fused fp64 rel err {rel:.3e}")
    nbytes = fused_bytes(n_g, e, p, 8)
    kernels["poisson_assembled_fused"] = kernel_entry(
        "poisson_assembled_fused", launches=counts["poisson_assembled_fused"], err=err,
        ms=apply_ms, plain_ms=plain_ms, nbytes=nbytes,
        flops=fom.operator_flops(e, FULL_N), word=8, fom=fom,
    )
    emit("hipbone", dtype="float64", n=FULL_N, shape=FULL_SHAPE, elements=e, n_global=n_g,
         n_local=prob.n_local, iterations=int(res.iterations), seconds=seconds,
         fom_gflops=fom.fom_gflops(e, FULL_N, N_ITER, seconds),
         apply_ms=apply_ms, apply_bound_ms=kernels["poisson_assembled_fused"]["bound_ms"],
         apply_rel_err=rel, launches=counts,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    x64 = res.x

    # fp32 main path: fused operator + fused_axpy_dot
    p32 = core.cast_problem(prob, torch.float32)
    b32 = b.to(torch.float32)
    a32 = core.poisson_assembled(p32)
    require(ops.should_fuse_streams(torch.float32, b32.device), "fp32 streams not fused")
    res32, seconds32, counts32 = timed_solve(core, ops, lambda: core.cg_assembled(
        a32, b32, n_iter=N_ITER, fused_update=ops.fused_axpy_dot, record_history=True))
    require(counts32["fused_axpy_dot"] == N_ITER,
            f"fused_axpy_dot launches {counts32['fused_axpy_dot']} != {N_ITER}")
    require(counts32["poisson_assembled_fused"] == N_ITER + 1, "fp32 fused operator launches")
    plain32 = core.cg_assembled(
        lambda x: ref.poisson_assembled_fused_ref(x, p32.l2g, p32.g, p32.w_local, p32.d,
                                                  lam=p32.lam),
        b32, n_iter=N_ITER, fused_update=ref.fused_axpy_dot_ref, record_history=True,
    )
    h_k, h_p = res32.rdotr_history.double(), plain32.rdotr_history.double()
    h0 = float(b32.double().dot(b32.double()))
    hist_ok = bool(((h_k - h_p).abs() <= HIST_RTOL * h_p.abs() + HIST_ATOL * h0).all())
    require(hist_ok, "fp32 rdotr history of the kernel solve departs from the plain solve")
    r32, ap32 = b32.clone(), a32(b32)
    alpha = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    axpy_ms = cuda_ms(lambda: ops.fused_axpy_dot(r32, ap32, alpha), reps=50)
    axpy_plain_ms = cuda_ms(lambda: ref.fused_axpy_dot_ref(r32, ap32, alpha), reps=50)
    (rk, sk), (rp, sp) = ops.fused_axpy_dot(r32, ap32, alpha), ref.fused_axpy_dot_ref(
        r32, ap32, alpha)
    axpy_err, axpy_rel = rel_err(rk, rp)
    dot_rel = abs(float(sk) - float(sp)) / float(sp)
    require(axpy_rel <= RTOL[torch.float32] and dot_rel <= DOT_RTOL,
            f"full-size fused_axpy_dot: rel {axpy_rel:.3e}, dot rel {dot_rel:.3e}")
    kernels["fused_axpy_dot"] = kernel_entry(
        "fused_axpy_dot", launches=counts32["fused_axpy_dot"], err=axpy_err, ms=axpy_ms,
        plain_ms=axpy_plain_ms, nbytes=3 * 4 * n_g + 4, flops=4 * n_g, word=4, fom=fom,
    )
    emit("hipbone", dtype="float32", fused_update="fused_axpy_dot",
         iterations=int(res32.iterations), seconds=seconds32,
         fom_gflops=fom.fom_gflops(e, FULL_N, N_ITER, seconds32), launches=counts32,
         history_max_rel_dev=float(((h_k - h_p).abs() / (h_p.abs() + HIST_ATOL * h0)).max()),
         axpy_ms=axpy_ms, axpy_bound_ms=kernels["fused_axpy_dot"]["bound_ms"],
         axpy_dot_rel_err=dot_rel)
    del p32, b32, a32, res32, plain32, r32, ap32
    return prob, b, x64, seconds


def phase_nekbone(core, ops, ref, fom, kernels, prob, b, x_assembled, seconds_assembled):
    from repro_torch.core.gather_scatter import gather, scatter

    e, p = prob.mesh.n_elements, prob.mesh.points_per_element
    a_s = core.poisson_scattered(prob)
    b_l = scatter(b, prob.l2g)
    res, seconds, counts = timed_solve(
        core, ops, lambda: core.cg_scattered(a_s, b_l, prob.w_local, n_iter=N_ITER)
    )
    require(counts["poisson_local"] == N_ITER + 1,
            f"poisson_local launches {counts['poisson_local']} != {N_ITER + 1}")
    x_g = gather(prob.w_local * res.x, prob.l2g, prob.n_global)
    dx = float((x_g - x_assembled).abs().max())
    require(dx <= 1e-8 * float(x_assembled.abs().max()), f"storage modes disagree: {dx:.3e}")
    ms = cuda_ms(lambda: ops.poisson_local(b_l, prob.g, None, prob.d, lam=0.0))
    plain_ms = cuda_ms(lambda: ref.poisson_local_ref(b_l, prob.g, None, prob.d, lam=0.0), reps=5)
    err, rel = rel_err(ops.poisson_local(b_l, prob.g, None, prob.d, lam=0.0),
                       ref.poisson_local_ref(b_l, prob.g, None, prob.d, lam=0.0))
    require(rel <= RTOL[torch.float64], f"full-size poisson_local rel err {rel:.3e}")
    kernels["poisson_local"] = kernel_entry(
        "poisson_local", launches=counts["poisson_local"], err=err, ms=ms,
        plain_ms=plain_ms, nbytes=local_bytes(e, p, 8, weighted=False),
        flops=fom.operator_flops(e, FULL_N), word=8, fom=fom,
    )
    weighted_ms = cuda_ms(lambda: ops.poisson_local(
        b_l, prob.g, prob.w_local, prob.d, lam=prob.lam))
    emit("nekbone", seconds=seconds, fom_gflops=fom.fom_gflops(e, FULL_N, N_ITER, seconds),
         assembled_speedup=seconds / seconds_assembled,
         modelled_byte_ratio=fom.nekbone_iter_bytes(e, FULL_N) / fom.cg_iter_bytes(e, FULL_N),
         max_abs_dx=dx, launches=counts, local_ms=ms,
         local_bound_ms=kernels["poisson_local"]["bound_ms"],
         local_weighted_ms=weighted_ms,
         local_weighted_bound_ms=local_bytes(e, p, 8, True) / fom.H100_SXM.hbm_bandwidth * 1e3)


def phase_n15(core, ops, ref, fom):
    n = 15
    prob = core.build_problem(
        n, N15_SHAPE, lam=1.0, deform=0.15, dtype=torch.float64, device="cuda"
    )
    e, p, n_g = prob.mesh.n_elements, prob.mesh.points_per_element, prob.n_global
    b = rhs(prob, torch.float64)
    a = core.poisson_assembled(prob)
    res, seconds, counts = timed_solve(
        core, ops, lambda: core.cg_assembled(a, b, n_iter=N_ITER)
    )
    require(counts["poisson_assembled_fused"] == N_ITER + 1, "N=15 fused kernel launches")
    require(bool(torch.isfinite(res.x).all()), "N=15 solve is not finite")
    w, lam = prob.w_local, prob.lam
    apply_ms = cuda_ms(lambda: ops.poisson_assembled_fused(b, prob.l2g, prob.g, w, prob.d, lam=lam))
    _, rel = rel_err(ops.poisson_assembled_fused(b, prob.l2g, prob.g, w, prob.d, lam=lam),
                     ref.poisson_assembled_fused_ref(b, prob.l2g, prob.g, w, prob.d, lam=lam))
    require(rel <= RTOL[torch.float64], f"N=15 fused rel err {rel:.3e}")
    x_l = b[prob.l2g.long()]
    local_ms = cuda_ms(lambda: ops.poisson_local(x_l, prob.g, w, prob.d, lam=lam))
    _, local_rel = rel_err(ops.poisson_local(x_l, prob.g, w, prob.d, lam=lam),
                           ref.poisson_local_ref(x_l, prob.g, w, prob.d, lam=lam))
    require(local_rel <= RTOL[torch.float64], f"N=15 poisson_local rel err {local_rel:.3e}")
    bound_s, bound_by = fom.H100_SXM.bound_seconds(
        fused_bytes(n_g, e, p, 8), fom.operator_flops(e, n), 8)
    local_bound_s, _ = fom.H100_SXM.bound_seconds(
        local_bytes(e, p, 8, True), fom.operator_flops(e, n), 8)
    emit("hipbone_n15", n=n, shape=N15_SHAPE, elements=e, n_global=n_g,
         iterations=int(res.iterations), seconds=seconds,
         fom_gflops=fom.fom_gflops(e, n, N_ITER, seconds), launches=counts,
         apply_ms=apply_ms, apply_bound_ms=bound_s * 1e3, apply_bound_by=bound_by,
         apply_rel_err=rel, local_ms=local_ms, local_bound_ms=local_bound_s * 1e3,
         local_rel_err=local_rel)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch import core
    from repro_torch.core import fom
    from repro_torch.core.gather_scatter import scatter
    from repro_torch.kernels import _build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    libs = _build.build()
    ptxas = {
        name: [ln.strip() for ln in path.with_name(path.name + ".log").read_text().splitlines()
               if "Used" in ln or "spill" in ln]
        for name, path in libs.items()
    }
    emit("build", seconds=time.perf_counter() - t0, libraries=[p.name for p in libs.values()],
         ptxas=ptxas)

    t0 = time.perf_counter()
    phase_parity(core, ops, ref, scatter)
    t1 = time.perf_counter()
    phase_targets(core)
    emit("timing", parity_s=t1 - t0, targets_s=time.perf_counter() - t1)

    kernels: dict[str, dict] = {}
    t0 = time.perf_counter()
    prob, b, x64, seconds64 = phase_hipbone(core, ops, ref, fom, kernels)
    phase_nekbone(core, ops, ref, fom, kernels, prob, b, x64, seconds64)
    del prob, b, x64
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    phase_n15(core, ops, ref, fom)
    emit("timing", n7_s=t1 - t0, n15_s=time.perf_counter() - t1,
         total_s=time.perf_counter() - t_start)

    print(card_line(), flush=True)
    print(json.dumps({"kernels": [kernels[name] for name in TPU_KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
