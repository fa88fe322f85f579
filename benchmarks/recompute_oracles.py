"""Recompute the self-authored fixture oracles (cartpole, orbit_transfer) by
cross-path, cross-grid agreement.

Every reference fixture carries an externally validated objective (e.g.
goddard 1.01257, /root/reference/test/problems/goddard.jl:48). cartpole and
orbit_transfer do not exist in the reference, so their stored objectives are
certified here instead by:
  - the dense-KKT oracle (LAPACK-style dense factorization) at TWO grids,
  - the structured block-tridiagonal scan and the cyclic-reduction engine
    at the finer grid (independent solve paths, identical DOCP),
  - for orbit_transfer: the UNSMOOTHED fuel integral of the returned control
    (trapezoid of |u(t)|) vs the impulsive Hohmann lower bound 0.1816 — a
    bound no smoothing artifact can undershoot.

Usage: python benchmarks/recompute_oracles.py [--json out.json]
Always runs on CPU (the dense oracle at these sizes is host-friendly, and the
oracle must not depend on accelerator numerics): JAX_PLATFORMS=cpu is set
before jax is imported and the live config is updated too (as in
tests/conftest.py).
"""

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


def fuel_integral(sol):
    """Unsmoothed trapezoid of |u(t)| over the control grid."""
    t = np.asarray(sol.control_grid)
    u = np.asarray(sol.control_values)
    mag = np.sqrt((u**2).sum(axis=1))
    trapz = getattr(np, "trapezoid", np.trapz)
    return float(trapz(mag, t))


def run(name, grid, scheme, mode, tol, max_iter):
    import ctdirect_tpu as ct
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions

    prob = get_problem(name)
    docp = ct.transcribe(prob.ocp, grid_size=grid, scheme=scheme)
    t0 = time.time()
    sol = solve_docp(
        docp,
        init=prob.init,
        options=IPMOptions(kkt_mode=mode, tol=tol, max_iter=max_iter),
    )
    wall = time.time() - t0
    row = dict(
        problem=name,
        N=grid,
        scheme=scheme,
        kkt=mode,
        successful=bool(sol.successful),
        objective=float(sol.objective),
        iters=int(sol.iterations),
        wall_s=round(wall, 1),
        message=sol.message,
    )
    if name == "orbit_transfer":
        row["fuel_integral"] = round(fuel_integral(sol), 6)
        row["tf"] = float(np.asarray(sol.variable)[0])
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", default=None, help="cartpole|orbit_transfer")
    args = ap.parse_args()

    # dense-oracle cells stay at CI-sized grids (a dense (nz+nc)^2 factorization
    # per iteration is O(minutes) on host above N~150); the production-grid
    # stored value is certified by the two INDEPENDENT structured paths (scan
    # elimination vs cyclic reduction), cross-scheme agreement, and (orbit)
    # the unsmoothed Hohmann fuel bound.
    rows = []
    if args.only in (None, "orbit_transfer"):
        rows.append(run("orbit_transfer", 120, "midpoint", "dense", 1e-10, 2500))
        rows.append(run("orbit_transfer", 160, "midpoint", "dense", 1e-10, 2500))
        rows.append(run("orbit_transfer", 120, "midpoint", "structured", 1e-10, 2500))
        rows.append(run("orbit_transfer", 300, "midpoint", "structured", 1e-10, 3000))
        rows.append(run("orbit_transfer", 300, "midpoint", "cr", 1e-10, 3000))
        rows.append(run("orbit_transfer", 300, "trapeze", "structured", 1e-10, 3000))
    if args.only in (None, "cartpole"):
        rows.append(run("cartpole", 100, "trapeze", "dense", 1e-10, 800))
        rows.append(run("cartpole", 150, "trapeze", "dense", 1e-10, 800))
        rows.append(run("cartpole", 200, "trapeze", "structured", 1e-10, 800))
        rows.append(run("cartpole", 200, "trapeze", "cr", 1e-10, 800))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
