"""Swimmer convergence lab: find a (grid, scheme, options,
init) cell where the Purcell swimmer reaches TRUE KKT success at a
reference-quality objective (ref 0.984273, swimmer.jl:139), so the BETTER_OK
escape hatch in tests/test_all_ocp.py can be retired.

Usage: python benchmarks/swimmer_lab.py [--json out.json] [--cells a,b,...]
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


def cell(name, grid, scheme, opt_kw, init=None, warm_from=None):
    import ctdirect_tpu as ct
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions

    prob = get_problem("swimmer")
    docp = ct.transcribe(prob.ocp, grid_size=grid, scheme=scheme)
    use_init = init if init is not None else prob.init
    if warm_from is not None:
        use_init = warm_from
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

    # a: canonical failing config (baseline for comparison)
    go("canonical", 120, "trapeze", dict(tol=1e-6, max_iter=1500))
    # b: adaptive barrier (fixed in r3; helps degenerate central paths)
    go("adaptive", 120, "trapeze", dict(tol=1e-6, max_iter=1500, mu_strategy="adaptive"))
    # c: coarse-to-canonical continuation: solve N=60 then warm start N=120
    sol60 = go("coarse60", 60, "trapeze", dict(tol=1e-6, max_iter=1500))
    if sol60 is not None and bool(sol60.successful):
        from ctdirect_tpu.model.init import InitialGuess

        go(
            "warm120-from60",
            120,
            "trapeze",
            dict(tol=1e-6, max_iter=1500),
            warm_from=InitialGuess.from_solution(sol60),
        )
    # d: looser-but-acceptable tol (Ipopt default acceptable path)
    go("tol1e-5", 120, "trapeze", dict(tol=1e-5, max_iter=1500))
    # e: midpoint scheme (reference default)
    go("midpoint", 120, "midpoint", dict(tol=1e-6, max_iter=1500))

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
