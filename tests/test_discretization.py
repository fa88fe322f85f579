"""Discretization options (≙ reference test/ci/test_discretization.jl):
explicit-uniform grid equals default grid BIT-FOR-BIT (objective AND iteration
count), non-uniform grids round-trip into the solution, and every scheme solves
both a Lagrange problem and a free-time Mayer problem. Plus direct shooting
(control_steps > 1) and the strategy/options layer."""

import numpy as np
import pytest

import ctdirect_tpu as ct
from ctdirect_tpu.problems import get_problem
from ctdirect_tpu.solver.interface import solve_docp
from ctdirect_tpu.solver.ipm import IPMOptions
from ctdirect_tpu.utils.options import OptionError

OPTS = IPMOptions(tol=1e-8)


def test_explicit_grid_matches_default():
    """time_grid=linspace must reproduce the default-grid run exactly
    (objective AND iteration count — test_discretization.jl:13–16)."""
    p = get_problem("beam")
    d1 = ct.transcribe(p.ocp, grid_size=40, scheme="trapeze")
    d2 = ct.transcribe(p.ocp, time_grid=np.linspace(0, 1, 41), scheme="trapeze")
    s1 = solve_docp(d1, options=OPTS)
    s2 = solve_docp(d2, options=OPTS)
    assert s1.iterations == s2.iterations
    assert s1.objective == s2.objective


def test_nonuniform_grid_roundtrip():
    """A non-uniform grid must appear verbatim in the solution time grid
    (test_discretization.jl:18–22)."""
    p = get_problem("beam")
    grid = np.array([0.0, 0.05, 0.1, 0.3, 0.5, 0.7, 0.85, 1.0])
    d = ct.transcribe(p.ocp, time_grid=grid, scheme="trapeze")
    s = solve_docp(d, options=OPTS)
    np.testing.assert_allclose(s.time_grid, grid)
    assert s.successful


def test_nonuniform_grid_free_tf():
    """Non-uniform normalized grid with free tf scales to [t0, tf(v)]
    (test_discretization.jl:36–40)."""
    p = get_problem("double_integrator_mintf")
    grid = np.array([0.0, 0.1, 0.3, 0.6, 0.8, 0.95, 1.0])
    d = ct.transcribe(p.ocp, time_grid=grid, scheme="trapeze")
    s = solve_docp(d, options=IPMOptions(tol=1e-6))
    assert s.successful
    tf = s.variable[0]
    np.testing.assert_allclose(s.time_grid, grid * tf, atol=1e-8)


ALL_SCHEMES = [
    "trapeze",
    "midpoint",
    "euler",
    "euler_implicit",
    "gauss_legendre_1",
    "gauss_legendre_2",
    "gauss_legendre_3",
    "gauss_legendre_2_constant_control",
    "gauss_legendre_3_constant_control",
]


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_all_schemes_lagrange(scheme):
    """Every scheme solves a Lagrange-cost problem (test_discretization.jl:61–80)."""
    p = get_problem("vanderpol")
    d = ct.transcribe(p.ocp, grid_size=25, scheme=scheme)
    s = solve_docp(d, options=IPMOptions(tol=1e-6))
    assert s.successful, (scheme, s.message)
    np.testing.assert_allclose(s.objective, p.obj, rtol=5e-2)


@pytest.mark.parametrize(
    "scheme", ["trapeze", "midpoint", "euler", "gauss_legendre_2", "gauss_legendre_3"]
)
def test_schemes_free_t0tf_mayer(scheme):
    """Free-t0/tf Mayer problem across schemes incl. stagewise GL2/GL3
    (test_discretization.jl:61–80). The GL2 exclusion of round 1 is gone: the
    bound-relaxation + restoration + dual-refresh solver upgrades handle the
    degenerate t0=tf default start."""
    p = get_problem("double_integrator_freet0tf")
    d = ct.transcribe(p.ocp, grid_size=25, scheme=scheme)
    s = solve_docp(d, options=IPMOptions(tol=1e-6, max_iter=300))
    assert s.successful, (scheme, s.message)
    np.testing.assert_allclose(s.objective, 8.0, rtol=1e-2)


def test_direct_shooting_control_steps():
    """DirectShooting with control_steps sub-controls per step
    (direct_shooting.jl:26–31, midpoint.jl:98–113)."""
    p = get_problem("double_integrator_minenergy")
    docp = ct.discretize(p.ocp, ct.DirectShooting(grid_size=20, control_steps=4))
    assert docp.cs == 4
    assert docp.Nu == 20
    s = solve_docp(docp, options=OPTS)
    assert s.successful
    # finer control grid beats cs=1 at equal steps: compare objectives
    d1 = ct.discretize(p.ocp, ct.DirectShooting(grid_size=20, control_steps=1))
    s1 = solve_docp(d1, options=OPTS)
    assert s.objective <= s1.objective + 1e-9
    np.testing.assert_allclose(s.objective, 12.0, rtol=1e-2)


def test_direct_shooting_requires_midpoint():
    p = get_problem("beam")
    with pytest.raises(ValueError):
        ct.discretize(p.ocp, ct.DirectShooting(control_steps=2, scheme="trapeze"))


def test_options_strict_and_aliases():
    c = ct.Collocation(disc_method="trapeze", grid_size=10)
    assert c.opts["scheme"] == "trapeze"
    with pytest.raises(OptionError):
        ct.Collocation(bogus=1)
    with pytest.raises(OptionError):
        ct.Collocation(scheme="rk9")
    c2 = ct.Collocation(mode="permissive", future_opt=7)
    assert c2.opts["future_opt"] == 7


def test_stagewise_vs_constant_control_equivalence():
    """Stagewise GL2 (distinct control per stage) and constant-control GL2
    must agree on the solved optimum within 1e-4 and on the state trajectory,
    and their variable counts must satisfy the bookkeeping identity
    nz_stagewise = nz_cc + N*m*(s-1) (≙ reference
    test/ci/test_discretization_stagewise.jl:114–173)."""
    p = get_problem("vanderpol")
    N = 100
    d_sw = ct.transcribe(p.ocp, grid_size=N, scheme="gauss_legendre_2")
    d_cc = ct.transcribe(p.ocp, grid_size=N, scheme="gauss_legendre_2_constant_control")
    # var-count bookkeeping: stagewise carries s controls per step vs 1
    s_stages = d_sw.s
    assert s_stages == 2
    assert d_sw.nz == d_cc.nz + N * d_sw.m * (s_stages - 1)
    # constraint counts are identical (same defect + stage rows)
    assert d_sw.nc == d_cc.nc
    s1 = solve_docp(d_sw, init=p.init, options=IPMOptions(tol=1e-8))
    s2 = solve_docp(d_cc, init=p.init, options=IPMOptions(tol=1e-8))
    assert s1.successful and s2.successful
    np.testing.assert_allclose(s1.objective, s2.objective, atol=1e-4)
    np.testing.assert_allclose(s1.state(s1.time_grid), s2.state(s2.time_grid), atol=1e-3)
