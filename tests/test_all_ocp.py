"""Full-fixture CI suite: solve EVERY registered problem and check its stored
reference objective (≙ reference test/ci/test_all_ocp.jl:1–133, which solves
all ~28 problems with `@test successful && objective ≈ prob.obj rtol=1e-2`,
runtests.jl:5–11).

Per-problem (grid, scheme, options) below play the role of the reference's
per-problem `adnlp_backend=:manual` / grid overrides (test_all_ocp.jl:83,123).
"""

import numpy as np
import pytest

import ctdirect_tpu as ct
from ctdirect_tpu.problems import get_problem, problem_names
from ctdirect_tpu.solver.interface import solve_docp
from ctdirect_tpu.solver.ipm import IPMOptions


class Cfg:
    def __init__(self, grid=100, scheme="trapeze", rtol=1e-2, pre_grids=(),
                 warm_mu=None, **opts):
        self.grid = grid
        self.scheme = scheme
        self.rtol = rtol
        # coarse-to-fine mesh-refinement stages before the final grid
        # (solver.grid_continuation); the degenerate fixtures stall cold on a
        # fine grid but truly converge through refinement — measured in
        # benchmarks/swimmer_lab.py / truck_lab.py and the r4 rescue lab
        self.pre_grids = list(pre_grids)
        # cooler barrier for the warm stages (options.replace(mu_init=...)):
        # re-heating mu to 0.1 on a near-optimal warm point discards most of
        # its value. Measured to matter on space_shuttle (see CONFIG).
        self.warm_mu = warm_mu
        self.opts = dict(tol=1e-6, max_iter=600)
        self.opts.update(opts)


# defaults: N=100 trapeze (the reference default N=250 midpoint is slower at
# equal accuracy for these rtol-1e-2 oracles; hard problems override below)
CONFIG = {
    # cold N=200 soft-stalls near the optimum with rounding-luck-sensitive
    # recovery (same math converged or stalled across different compiles);
    # 3-stage refinement is deterministic-robust: 61/197/383 iterations to
    # obj 5.45008 (ref 5.4522), reproduced twice (r4 rescue lab)
    "algal_bacterial": Cfg(grid=200, pre_grids=[50, 100], max_iter=2000),
    # action has no stored reference objective (misc.py): the oracle is
    # successful-only, so no rtol override applies. Cold N=200 hits max_iter;
    # refinement from N=50 converges in 288 warm iterations (r4 rescue lab)
    "action": Cfg(grid=200, pre_grids=[50], max_iter=1200),
    "bioreactor_Ndays": Cfg(grid=200),
    "electric_vehicle": Cfg(grid=200),
    "fuller": Cfg(grid=250),
    "glider": Cfg(grid=150),
    "insurance": Cfg(grid=150),
    # cold N=250 converges to a WORSE local optimum (obj 1.179 vs ref 0.962);
    # refinement from N=60 lands on the reference optimum (213+28 iters, r4)
    "moonlander": Cfg(grid=250, pre_grids=[60]),
    "robbins": Cfg(grid=250),
    # cold N=150 soft-stalls (Search_Direction_Becomes_Too_Small);
    # refinement from N=50 converges the fine stage in 210 iterations (r4)
    "quadrotor": Cfg(grid=150, pre_grids=[50]),
    # max-crossrange reentry: cold N=150 (and 2-stage refinement) hit
    # max_iter; the measured recipe is 3-stage refinement with a cooler warm
    # barrier: [30, 75, 150] + mu_init 1e-3 -> 318/13/386 iterations, obj
    # 0.59586 vs ref 0.59655 (r4 rescue lab)
    "space_shuttle": Cfg(grid=150, pre_grids=[30, 75], warm_mu=1e-3,
                         max_iter=3000),
    "goddard_all": Cfg(grid=150),
    # refinement [75, 150, 300] totals 1116 iterations vs 1932 cold (r4 lab)
    "orbit_transfer": Cfg(grid=300, pre_grids=[75, 150], max_iter=2000),
    "cartpole": Cfg(grid=150),
    # truck_trailer (min-time jackknife park) is degenerate on fine grids: at
    # N>=100 every config stalls at viol ~1e-6..1e-5 wandering a flat valley
    # (obj 55.3-55.8) without formal KKT success; N=50 trapeze TRULY converges
    # (Solve_Succeeded, 316 it, viol 8e-9, obj 55.948 — 5.6% better than the
    # reference's 59.28). A GL2 N=100 cell "converges" to 38.5 but does NOT
    # survive refinement onto trapeze N=200/400 (snaps back to ~55.x) — it is
    # under-resolved inter-node corner-cutting, rejected as an oracle.
    # Evidence: benchmarks/truck_lab.py + the refinement study in r3 notes.
    "truck_trailer": Cfg(grid=50, max_iter=2000),
    # swimmer: the r4 recipe (plain refinement from N=60) converged on
    # COMPILE LUCK — its 600-900-iteration coarse stage flipped between
    # success and stall across bit-identical-math program changes (measured
    # r5: same data, zeros-vs-computed-zeros Hessian flipped it). The robust
    # recipe starts the barrier cooler: mu_init 1e-2 cold, 1e-4 warm —
    # both stages then converge DECISIVELY (126 + 145 iterations, r5
    # swimmer_recipes lab) to obj 0.98193, within the uniform rtol-1e-2
    # oracle of the reference objective 0.984273 — so swimmer/swimmer2 no
    # longer need the BETTER_OK band at all.
    "swimmer": Cfg(grid=120, pre_grids=[60], mu_init=1e-2, warm_mu=1e-4,
                   max_iter=1500),
    "swimmer2": Cfg(grid=120, pre_grids=[60], mu_init=1e-2, warm_mu=1e-4,
                    max_iter=1500),
}

# `pattern` is a sparsity-visualization dummy in the reference (SURVEY.md §4);
# it is exercised by tests/test_structure.py, not solved for an objective.
SKIP = {"pattern"}

# multi-modal problems where this solver provably reaches a DIFFERENT (better)
# local optimum than the reference's Ipopt run, with FULL KKT success (no
# feasibility-only escape): accept objectives at least as good as the stored
# reference, within a tight 10% band so a formulation bug can't hide behind
# "better". r5: swimmer/swimmer2 RETIRED from this set (the mu-cooled recipe
# converges them to the reference optimum under the uniform rtol-1e-2
# oracle); truck_trailer remains, with a two-scheme certificate test below
# (trapeze 55.948 and midpoint 57.176 both formally converge better than
# the stored 59.28).
BETTER_OK = {"truck_trailer"}
BETTER_BAND = 0.10

ALL = [n for n in problem_names() if n not in SKIP]


def _fuel_integral(sol):
    """Unsmoothed trapezoid of |u(t)| — the physical fuel consumption of the
    returned control, independent of the smoothed objective."""
    t = np.asarray(sol.control_grid)
    u = np.asarray(sol.control_values)
    mag = np.sqrt((u**2).sum(axis=1))
    trapz = getattr(np, "trapezoid", np.trapz)
    return float(trapz(mag, t))


@pytest.mark.slow
@pytest.mark.parametrize("name", ALL)
def test_solve_fixture(name):
    cfg = CONFIG.get(name, Cfg())
    prob = get_problem(name)
    opts = IPMOptions(**cfg.opts)
    if cfg.pre_grids:
        from ctdirect_tpu.solver import grid_continuation

        warm_opts = opts if cfg.warm_mu is None else opts.replace(mu_init=cfg.warm_mu)
        sols = grid_continuation(
            prob.ocp,
            cfg.pre_grids + [cfg.grid],
            scheme=cfg.scheme,
            options=opts,
            warm_options=warm_opts,
            init=prob.init,
        )
        sol = sols[-1]
    else:
        docp = ct.transcribe(prob.ocp, grid_size=cfg.grid, scheme=cfg.scheme)
        sol = solve_docp(docp, init=prob.init, options=opts)
    if name == "orbit_transfer":
        # physical oracle no smoothing artifact can undershoot: the impulsive
        # Hohmann transfer bounds the true fuel integral below (Δv = 0.1816
        # for r 1 → 1.5, μ = 1); the stored smoothed objective + the maximum
        # smoothing undershoot (<= eps per unit time x tf = 1e-3 * 11) bounds
        # it above (dense-oracle N=120: obj 0.17262, fuel 0.18294)
        fuel = _fuel_integral(sol)
        assert 0.1816 <= fuel <= prob.obj + 1e-3 * 11.0 + 0.005, (fuel, prob.obj)
    assert sol.successful, (name, sol.message, sol.objective)
    if prob.obj is None:
        return
    if name in BETTER_OK:
        sense = -1.0 if prob.ocp.maximize else 1.0
        improvement = sense * (prob.obj - sol.objective)  # >= 0 when better
        assert improvement >= -cfg.rtol * abs(prob.obj), (name, sol.objective, prob.obj)
        assert abs(sol.objective - prob.obj) <= BETTER_BAND * abs(prob.obj), (
            name,
            sol.objective,
            prob.obj,
        )
    else:
        np.testing.assert_allclose(sol.objective, prob.obj, rtol=cfg.rtol)


@pytest.mark.slow
def test_truck_trailer_fine_grid_smoke():
    """Fine-grid feasibility + objective smoke for truck_trailer (the CI oracle
    runs N=50 where it truly converges; this guards the N=200 regime the
    reference solves at its default grid — a near-feasible stall in the flat
    valley around obj ~55.x is the measured behavior, benchmarks/truck_lab.py).
    """
    prob = get_problem("truck_trailer")
    docp = ct.transcribe(prob.ocp, grid_size=200, scheme="trapeze")
    sol = solve_docp(docp, init=prob.init, options=IPMOptions(tol=1e-6, max_iter=800))
    assert sol.constraints_violation <= 1e-4, sol.constraints_violation
    assert 54.0 <= sol.objective <= 57.0, sol.objective


@pytest.mark.slow
def test_truck_trailer_better_optimum_cross_scheme_certificate():
    """BETTER_OK certification: the claim that this solver
    reaches a BETTER local optimum than the reference's stored 59.28 must not
    be a single-scheme artifact. Two independent discretizations both reach
    formal KKT success at optima better than the reference (measured r5:
    trapeze N=50 -> 55.949 in 326 it, midpoint N=50 -> 57.176 in 150 it; the
    ~2% scheme gap is the O(h^2) discretization spread of a coarse-grid
    min-time bang-bang problem, not a disagreement about the basin)."""
    prob = get_problem("truck_trailer")
    objs = {}
    for scheme in ("trapeze", "midpoint"):
        docp = ct.transcribe(prob.ocp, grid_size=50, scheme=scheme)
        sol = solve_docp(docp, init=prob.init,
                         options=IPMOptions(tol=1e-6, max_iter=2000))
        assert sol.successful, (scheme, sol.message)
        objs[scheme] = sol.objective
        # strictly better than the stored reference optimum, but within the
        # 10% band so a formulation bug cannot hide behind "better"
        assert sol.objective <= prob.obj, (scheme, sol.objective)
        assert sol.objective >= (1.0 - BETTER_BAND) * prob.obj, (scheme, sol.objective)
    # both schemes sit in the same (better) basin: within 3% of each other
    a, b = objs["trapeze"], objs["midpoint"]
    assert abs(a - b) <= 0.03 * max(a, b), objs
