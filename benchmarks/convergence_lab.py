"""Convergence-evidence lab:

1. `--traces`: per-iteration IPM histories (mu, kkt_err, filter size,
   inertia shift, objective) for the goddard family under the PRODUCTION
   sweep config (cr + f32 block solve + f64 refine + Ruiz equilibration,
   monotone mu) -> TRACES.json. The reference's Ipopt prints this table
   per solve (test/archives/NLP_comparison.md derives its iteration counts
   from it); here it is a committed artifact.

2. `--orbit`: recipe search for the orbit_transfer grid-continuation chain
   (test_all_ocp.py CONFIG entry): the r4 recipe [75,150,300] monotone
   totals 1116 iterations; target <= 600 total by stage/mu-strategy tuning.

Usage:
    python benchmarks/convergence_lab.py --traces [--cpu]
    python benchmarks/convergence_lab.py --orbit  [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, flush=True)


def trace_solve(name, N, opts_kw, scheme="trapeze", max_iter=500):
    """One solve with return_history=True under the sweep's production
    config; returns (summary, trimmed per-iteration trace)."""
    import jax
    import jax.numpy as jnp

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.ipm import IPMOptions, ipm_solve, make_spec
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT

    prob = get_problem(name)
    docp = transcribe(prob.ocp, grid_size=N, scheme=scheme)
    opts = IPMOptions(tol=1e-6, max_iter=max_iter, kkt_mode="cr",
                      kkt_solve_dtype="f32", **opts_kw)
    kkt = StructuredKKT(docp, algorithm="cr", solve_dtype=jnp.float32,
                        refine=opts.kkt_refine, equilibrate=opts.kkt_equilibrate)
    spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    z0 = docp.initial_guess(prob.init)

    run = jax.jit(lambda z: ipm_solve(
        docp.nlp_objective, docp.constraints, spec, z,
        docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub,
        options=opts, kkt=kkt, return_history=True))
    t0 = time.time()
    result, hist = jax.device_get(run(z0))
    wall = time.time() - t0
    it, mu, kkt_err, filt_n, delta_w, f = hist
    n = int(result.iterations)
    trace = [
        dict(it=int(it[k]), mu=float(mu[k]), kkt_err=float(kkt_err[k]),
             filter_size=int(filt_n[k]), delta_w=float(delta_w[k]),
             obj=float(f[k]))
        for k in range(min(n, len(it)))
    ]
    summary = dict(
        problem=name, N=N, scheme=scheme, backend=jax.default_backend(),
        iterations=n,
        status=int(result.status), successful=bool(result.successful),
        objective=float(result.objective), ref=prob.obj,
        kkt_error=float(result.kkt_error), wall_s=round(wall, 2),
        config=dict(kkt="cr", solve_dtype="f32", refine=opts.kkt_refine,
                    equilibrate=bool(kkt.equilibrate),
                    mu_strategy=opts.mu_strategy),
    )
    log(f"{name:16s} N={N:<5d} iters={n:4d} status={int(result.status)} "
        f"obj={float(result.objective):.6g} (ref {prob.obj}) "
        f"kkt={float(result.kkt_error):.1e} {wall:.1f}s")
    return summary, trace


def run_traces(out_path):
    cells = [
        # the goddard family: iteration
        # counts under the equilibrated-f32 production config, with full
        # per-iteration traces as committed evidence. (N=250 cells: the
        # fixed-length-scan history program is too big a CPU compile at
        # N=1000)
        ("goddard", 250, {}),
        ("goddard_all", 250, {}),
        # jackson's measured green config (sweep.py PROBLEM_OVERRIDES)
        ("jackson", 500, dict(mu_strategy="adaptive", kkt_equilibrate=False)),
    ]
    out = []
    for name, N, kw in cells:
        summary, trace = trace_solve(name, N, kw)
        out.append(dict(**summary, trace=trace))
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)
    log(f"wrote {out_path}")


def solve_docp_lab(docp, guess, options):
    from ctdirect_tpu.solver.interface import solve_docp

    return solve_docp(docp, init=guess, options=options)


def orbit_recipe(pre_grids, grid, mu_strategy, warm_mu, max_iter=2000,
                 scheme="trapeze", tol=1e-6, pre_tol=None):
    """Run one orbit_transfer continuation recipe; return per-stage iteration
    counts + the final-solution validity checks used by test_all_ocp.py."""
    import numpy as np

    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver import grid_continuation
    from ctdirect_tpu.solver.ipm import IPMOptions

    prob = get_problem("orbit_transfer")
    opts = IPMOptions(tol=tol, max_iter=max_iter, kkt_mode="cr",
                      kkt_solve_dtype="f32", mu_strategy=mu_strategy)
    warm = opts if warm_mu is None else opts.replace(mu_init=warm_mu)
    t0 = time.time()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if pre_tol is None:
            sols = grid_continuation(prob.ocp, list(pre_grids) + [grid],
                                     scheme=scheme, options=opts,
                                     warm_options=warm, init=prob.init)
        else:
            # loose pre-stages: a warm start only needs ~pre_tol accuracy —
            # over-converging the coarse grids to the final tol wastes most
            # of the chain's iterations (stage totals in the --orbit output)
            from ctdirect_tpu import transcribe
            from ctdirect_tpu.model.init import InitialGuess

            sols, guess = [], prob.init
            grids_all = list(pre_grids) + [grid]
            for k, n in enumerate(grids_all):
                stage = opts if k == 0 else warm
                if k < len(grids_all) - 1:
                    stage = stage.replace(tol=pre_tol)
                docp = transcribe(prob.ocp, grid_size=int(n), scheme=scheme)
                sol = solve_docp_lab(docp, guess, stage)
                sols.append(sol)
                guess = InitialGuess.from_solution(sol)
    wall = time.time() - t0
    iters = [int(s.iterations) for s in sols]
    sol = sols[-1]
    # fuel-integral oracle from tests/test_all_ocp.py: Hohmann lower bound
    # 0.1816 <= trapz |u| <= ref + smoothing allowance
    t = np.asarray(sol.control_grid)
    u = np.asarray(sol.control_values)
    trapz = getattr(np, "trapezoid", np.trapz)
    fuel = float(trapz(np.sqrt((u ** 2).sum(axis=1)), t))
    row = dict(pre_grids=list(pre_grids), grid=grid, mu_strategy=mu_strategy,
               warm_mu=warm_mu, pre_tol=pre_tol,
               stage_iters=iters, total_iters=sum(iters),
               successful=bool(sol.successful), objective=float(sol.objective),
               fuel=round(fuel, 5),
               fuel_ok=bool(0.1816 <= fuel <= prob.obj + 1e-3 * 11.0 + 0.005),
               wall_s=round(wall, 1))
    log(f"orbit {pre_grids}+[{grid}] mu={mu_strategy} warm_mu={warm_mu}: "
        f"stages={iters} total={sum(iters)} ok={row['successful']} "
        f"fuel={fuel:.4f} ({wall:.0f}s)")
    return row


def run_orbit(out_path):
    recipes = [
        # r4 baseline recipe (1116 total)
        dict(pre_grids=[75, 150], grid=300, mu_strategy="monotone", warm_mu=None),
        # cooler warm barrier: don't re-heat mu on a near-optimal warm start
        dict(pre_grids=[75, 150], grid=300, mu_strategy="monotone", warm_mu=1e-4),
        dict(pre_grids=[75, 150], grid=300, mu_strategy="monotone", warm_mu=1e-3),
        # adaptive (LOQO) mu end-to-end
        dict(pre_grids=[75, 150], grid=300, mu_strategy="adaptive", warm_mu=None),
        # coarser first stage: spend the expensive cold iterations at N=40
        dict(pre_grids=[40, 150], grid=300, mu_strategy="monotone", warm_mu=1e-3),
    ]
    rows = [orbit_recipe(**r) for r in recipes]
    with open(out_path, "w") as fh:
        json.dump(rows, fh, indent=1)
    log(f"wrote {out_path}")


def run_orbit2(out_path):
    """Round 2: loose pre-stage tolerance — the coarse stages only exist to
    warm-start, so converging them to the final 1e-6 wastes iterations
    (stage-1 alone was 586 of the 1416 baseline total)."""
    recipes = [
        dict(pre_grids=[75, 150], grid=300, mu_strategy="monotone",
             warm_mu=1e-3, pre_tol=1e-4),
        dict(pre_grids=[75, 150], grid=300, mu_strategy="monotone",
             warm_mu=1e-3, pre_tol=1e-3),
        dict(pre_grids=[75], grid=300, mu_strategy="monotone",
             warm_mu=1e-3, pre_tol=1e-4),
    ]
    rows = [orbit_recipe(**r) for r in recipes]
    with open(out_path, "w") as fh:
        json.dump(rows, fh, indent=1)
    log(f"wrote {out_path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--traces", action="store_true")
    ap.add_argument("--orbit", action="store_true")
    ap.add_argument("--orbit2", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        # update the live config too, in case jax was imported already
        # (as tests/conftest.py does)
        jax.config.update("jax_platforms", "cpu")

    from ctdirect_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"backend: {jax.default_backend()}")
    if args.traces:
        run_traces(args.out or "TRACES.json")
    if args.orbit:
        run_orbit(args.out or "ORBIT_LAB.json")
    if args.orbit2:
        run_orbit2(args.out or "ORBIT_LAB2.json")


if __name__ == "__main__":
    main()
