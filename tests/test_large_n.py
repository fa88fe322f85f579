"""Grid-scaling regression gate (reference anchor:
test/archives/AD_backend.md:26–32 — the reference demonstrates N=10,000).

The structured solvers are O(N) memory / O(N) (scan) or O(log N) (cr) depth;
this CI test pins that at N=2000–4000 on CPU so grid scaling has a regression
gate between device runs (the N=10k cell runs through benchmarks/sweep.py)."""

import numpy as np
import pytest

import ctdirect_tpu as ct
from ctdirect_tpu.problems import get_problem
from ctdirect_tpu.solver.interface import solve_docp
from ctdirect_tpu.solver.ipm import IPMOptions


@pytest.mark.slow
@pytest.mark.parametrize("N,mode", [(2000, "structured"), (4000, "cr")])
def test_beam_large_grid(N, mode):
    """beam (reference objective 8.898598, test/problems/beam.jl:18) at large N:
    convergence + objective + O(N) memory sanity."""
    prob = get_problem("beam")
    docp = ct.transcribe(prob.ocp, grid_size=N, scheme="trapeze")
    sol = solve_docp(
        docp, init=prob.init, options=IPMOptions(tol=1e-8, max_iter=300, kkt_mode=mode)
    )
    assert sol.successful, (N, mode, sol.message)
    np.testing.assert_allclose(sol.objective, prob.obj, rtol=1e-2)
    # O(N) structure sanity: the KKT block data for N steps of width bs must
    # be ~N*bs^2 floats, i.e. << N^2 (a dense formulation would be (N*bw)^2).
    bs = docp.bw + docp.cw
    assert docp.N * bs * bs * 8 < 0.01 * (docp.nz**2) * 8  # block data << dense


@pytest.mark.slow
def test_goddard_all_n2500():
    """goddard_all (all constraint types) at N=2500 structured — the
    reference's large-N flagship (AD_backend.md:80–86 runs it at N=10k)."""
    prob = get_problem("goddard_all")
    docp = ct.transcribe(prob.ocp, grid_size=2500, scheme="trapeze")
    sol = solve_docp(
        docp, init=prob.init, options=IPMOptions(tol=1e-7, max_iter=400)
    )
    assert sol.successful, sol.message
    np.testing.assert_allclose(sol.objective, prob.obj, rtol=1e-2)
