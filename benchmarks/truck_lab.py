"""Truck-trailer convergence lab: find a (grid, scheme,
options, init) cell where the jackknife parking fixture reaches TRUE KKT
success at a reference-quality objective (ref 59.28, truck_trailer.jl:7-119),
so the FEASIBILITY_OK escape hatch in tests/test_all_ocp.py can be retired.

The canonical failure mode: the solve reaches feasibility (viol ~1e-5) at an
objective BETTER than 59.28 but oscillates around the degenerate min-time
optimum without meeting the formal KKT tolerance. Cells below probe the known
remedies: adaptive barrier, coarse-to-fine warm continuation, midpoint scheme,
acceptable-level exits, and longer budgets.

Usage: python benchmarks/truck_lab.py [--json out.json] [--cells a,b,...]
Runs on CPU (canonical test config)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def cell(name, grid, scheme, opt_kw, warm_from=None):
    import ctdirect_tpu as ct
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions

    prob = get_problem("truck_trailer")
    docp = ct.transcribe(prob.ocp, grid_size=grid, scheme=scheme)
    use_init = prob.init if warm_from is None else warm_from
    t0 = time.time()
    sol = solve_docp(docp, init=use_init, options=IPMOptions(**opt_kw))
    row = dict(
        cell=name,
        N=grid,
        scheme=scheme,
        opts={k: str(v) for k, v in opt_kw.items()},
        successful=bool(sol.successful),
        objective=float(sol.objective),
        iters=int(sol.iterations),
        viol=float(sol.constraints_violation),
        message=sol.message,
        wall_s=round(time.time() - t0, 1),
    )
    print(json.dumps(row), flush=True)
    return row, sol


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--cells", default=None)
    args = ap.parse_args()
    want = set(args.cells.split(",")) if args.cells else None

    rows = []

    def go(name, *a, **kw):
        if want is None or name in want:
            r, sol = cell(name, *a, **kw)
            rows.append(r)
            return sol
        return None

    from ctdirect_tpu.model.init import InitialGuess

    # a: canonical failing config (baseline for comparison)
    go("canonical", 200, "trapeze", dict(tol=1e-6, max_iter=2000))
    # b: adaptive barrier
    go("adaptive", 200, "trapeze", dict(tol=1e-6, max_iter=2000, mu_strategy="adaptive"))
    # c: coarse-to-canonical continuation N=50 -> 100 -> 200
    sol50 = go("coarse50", 50, "trapeze", dict(tol=1e-6, max_iter=2000))
    if sol50 is not None and bool(sol50.successful):
        sol100 = go(
            "warm100-from50",
            100,
            "trapeze",
            dict(tol=1e-6, max_iter=2000),
            warm_from=InitialGuess.from_solution(sol50),
        )
        if sol100 is not None and bool(sol100.successful):
            go(
                "warm200-from100",
                200,
                "trapeze",
                dict(tol=1e-6, max_iter=2000),
                warm_from=InitialGuess.from_solution(sol100),
            )
    # d: midpoint scheme (reference default)
    go("midpoint", 200, "midpoint", dict(tol=1e-6, max_iter=2000))
    # e: looser-but-acceptable tol
    go("tol1e-5", 200, "trapeze", dict(tol=1e-5, max_iter=2000))

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
