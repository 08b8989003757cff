"""Figure of merit, FLOP counts and data-motion models (paper Eqs. 3-6).

The analytic counts of ``repro/core/fom.py``, parameterized by element
count E, degree N and the word size (the paper is FP64; the index stays
4 bytes), plus the H100's data-sheet rates that bound every kernel's time
in ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "nekbone_flops_per_iter",
    "hipbone_flops_per_iter",
    "operator_flops",
    "operator_bytes",
    "fused_apply_bytes",
    "cg_iter_bytes",
    "nekbone_iter_bytes",
    "fom_gflops",
    "GpuSpec",
    "H100_SXM",
]


def _np1(n: int) -> int:
    return n + 1


def nekbone_flops_per_iter(e: int, n: int) -> float:
    """Eq. (3): NekBone's historical FLOP count per CG iteration (the FOM)."""
    return 12.0 * e * _np1(n) ** 4 + 34.0 * e * _np1(n) ** 3


def hipbone_flops_per_iter(e: int, n: int) -> float:
    """Eq. (5): hipBone's true FLOP count per CG iteration."""
    return 12.0 * e * _np1(n) ** 4 + 19.0 * e * _np1(n) ** 3 + 10.0 * e * n**3


def operator_flops(e: int, n: int) -> float:
    """Fused (S_L + λW)Z kernel FLOPs: 12E(N+1)^4 + 18E(N+1)^3."""
    return 12.0 * e * _np1(n) ** 4 + 18.0 * e * _np1(n) ** 3


def operator_bytes(e: int, n: int, *, word: int = 8, index: int = 4) -> float:
    """Fused operator data motion, perfect caching: 8 N_G + 68 N_L (FP64).

    word*N_G + (index + 7*word + word)*N_L
      = x_G read + [Z index + 6 G factors + W + y_L write] per local node.
    """
    n_l = e * _np1(n) ** 3
    n_g = e * n**3
    return word * n_g + (index + 8 * word) * n_l


def fused_apply_bytes(e: int, n: int, *, word: int = 8, index: int = 4) -> float:
    """Single-kernel assembled apply y_G = Zᵀ(S_L + λW)Z x_G traffic bound.

    x_G read + y_G write (2 word N_G) + [l2g index + 6 G factors + W] per
    local node ((index + 7 word) N_L); y_L is never materialized.
    """
    n_l = e * _np1(n) ** 3
    n_g = e * n**3
    return 2 * word * n_g + (index + 7 * word) * n_l


def cg_iter_bytes(e: int, n: int, *, word: int = 8, index: int = 4) -> float:
    """Per-CG-iteration data motion, assembled form: 108 N_G + 80 N_L (FP64).

    operator (8 N_G + 68 N_L) + gather (index-CSR 12 N_L + 12 N_G)
    + 11 vector reads/writes (88 N_G).
    """
    n_l = e * _np1(n) ** 3
    n_g = e * n**3
    op = word * n_g + (index + 8 * word) * n_l
    gather = (word + index) * n_l + (word + index) * n_g
    vectors = 11 * word * n_g
    return op + gather + vectors


def nekbone_iter_bytes(e: int, n: int, *, word: int = 8, index: int = 4) -> float:
    """Per-iteration data motion for the scattered NekBone baseline.

    Operator (x_L read, 6G + W, y write) + gather-scatter ZZᵀ (y_L twice
    plus indices) + 11 N_L vector streams + 2 weight reads in the dots.
    """
    n_l = e * _np1(n) ** 3
    n_g = e * n**3
    op = (2 + 7) * word * n_l
    gs_bytes = (2 * word + index) * n_l + (word + index) * n_g
    vectors = 11 * word * n_l + 2 * word * n_l
    return op + gs_bytes + vectors


def fom_gflops(e: int, n: int, n_iter: int, seconds: float) -> float:
    """The benchmark FOM: NekBone FLOP count (Eq. 3) over wall time."""
    return nekbone_flops_per_iter(e, n) * n_iter / seconds / 1e9


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """Roofline constants of one card (data sheet, full power limit)."""

    name: str
    hbm_bandwidth: float   # bytes/s
    hbm_bytes: float       # capacity
    fp64_flops: float      # FLOP/s outside the tensor cores
    fp32_flops: float      # FLOP/s outside the tensor cores

    def flops(self, word: int) -> float:
        """Peak FLOP/s for a word size of 8 (fp64) or 4 (fp32) bytes."""
        return self.fp64_flops if word == 8 else self.fp32_flops

    def bound_seconds(self, nbytes: float, flops: float, word: int) -> tuple[float, str]:
        """Least time for the work and what bounds it ("bytes"/"operations")."""
        t_bytes = nbytes / self.hbm_bandwidth
        t_ops = flops / self.flops(word)
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 80 GB, 34 TFLOP/s FP64 and
# 67 TFLOP/s FP32 (dense, outside the tensor cores), at the 700 W limit
H100_SXM = GpuSpec(
    name="H100 SXM",
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
    fp64_flops=34e12,
    fp32_flops=67e12,
)
