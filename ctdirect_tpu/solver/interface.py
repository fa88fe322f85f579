"""High-level solve API (≙ CommonSolve.solve(docp, init, modeler, solver) in the
reference stack, test/test_common.jl:97).

`solve(ocp, ...)` is the front door: transcribe + solve + build Solution.
The jitted solver is cached per (DOCP, options) so repeated solves (warm starts,
continuation sequences) pay compilation once.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from ctdirect_tpu.model.init import InitialGuess
from ctdirect_tpu.model.ocp import OCP
from ctdirect_tpu.model.solution import Solution
from ctdirect_tpu.solver.ipm import IPMOptions, ipm_solve, make_spec, STATUS_MESSAGES
from ctdirect_tpu.transcription.docp import DOCP, transcribe


def _get_solver(docp: DOCP, options: IPMOptions):
    cache = getattr(docp, "_solver_cache", None)
    if cache is None:
        cache = {}
        docp._solver_cache = cache
    key = options
    if key not in cache:
        spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        if options.kkt_mode == "dense":
            kkt = None  # ipm_solve defaults to DenseKKT
        elif options.kkt_mode in ("structured", "cr"):
            import jax.numpy as jnp

            from ctdirect_tpu.solver.structured_kkt import StructuredKKT

            algo = "cr" if options.kkt_mode == "cr" else "scan"
            sdt = (
                jnp.float32
                if options.kkt_solve_dtype in ("f32", "float32")
                else None
            )
            kkt = StructuredKKT(
                docp,
                algorithm=algo,
                solve_dtype=sdt,
                refine=options.kkt_refine if sdt is not None else 0,
                equilibrate=options.kkt_equilibrate,
            )
        else:
            raise ValueError(f"unknown kkt_mode {options.kkt_mode!r}")

        def run(z0, zl, zu, cl, cu):
            result = ipm_solve(
                docp.nlp_objective,
                docp.constraints,
                spec,
                z0,
                zl,
                zu,
                cl,
                cu,
                options=options,
                kkt=kkt,
            )
            # fuse the solution postprocess (X, u_out, v, t) into the same
            # program: the front door then needs ONE dispatch + ONE batched
            # device_get per solve, with no eager device ops around it
            # (each one is a host-device round trip on the solve's path)
            return result, docp.postprocess(result.z)

        cache[key] = jax.jit(run)
    return cache[key]


def solve_docp(
    docp: DOCP,
    init: Optional[InitialGuess] = None,
    options: IPMOptions = IPMOptions(),
    display: bool = False,
) -> Solution:
    """Solve a transcribed DOCP and map the result back to continuous time."""
    if isinstance(init, Solution):
        init = InitialGuess.from_solution(init)
    z0 = docp.initial_guess(init)
    solver = _get_solver(docp, options)
    result, post = jax.device_get(
        solver(z0, docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    )
    sol = docp.build_solution(
        result, message=STATUS_MESSAGES.get(int(result.status), "Unknown"),
        post=post,
    )
    if display:
        print(sol)
    return sol


def solve(
    ocp: OCP,
    grid_size: int = 250,
    scheme: str = "midpoint",
    time_grid=None,
    control_steps: int = 1,
    init: Optional[InitialGuess] = None,
    options: Optional[IPMOptions] = None,
    display: bool = False,
    **opt_kwargs,
) -> Solution:
    """Transcribe and solve an OCP.

    Defaults mirror the reference Collocation strategy (grid_size=250,
    scheme=:midpoint — collocation.jl:8–48). Extra keyword args are IPMOptions
    fields (tol=..., max_iter=..., ...).
    """
    if options is None:
        options = IPMOptions(**opt_kwargs)
    elif opt_kwargs:
        options = options.replace(**opt_kwargs)
    docp = transcribe(
        ocp,
        grid_size=grid_size,
        scheme=scheme,
        time_grid=time_grid,
        control_steps=control_steps,
    )
    return solve_docp(docp, init=init, options=options, display=display)
