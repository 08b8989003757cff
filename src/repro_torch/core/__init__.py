"""Mesh, setup, operators and CG of the port (see ``repro/core`` for the reference)."""
from .cg import CGResult, SolveStatus, cg_assembled, cg_scattered, status_name
from .mesh import BoxMesh, build_box_mesh
from .operator import (
    PoissonProblem,
    build_problem,
    cast_problem,
    local_poisson,
    poisson_assembled,
    poisson_scattered,
    problem_from_arrays,
    problem_from_mesh,
)
