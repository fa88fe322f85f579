"""BASELINE.json config 4: orbit transfer (fuel-min, free tf) with batched
initial-condition scenarios, midpoint collocation.

Monte-Carlo scenario study: each instance perturbs the initial orbit state
(injection errors) and re-solves the fuel-min transfer WARM-STARTED from the
nominal optimal trajectory — the production pattern for dispersion analyses.
The perturbed x0 enters through the boundary-constraint rhs, so ONE compiled
BatchSolver program serves every scenario; per-instance variable boxes also
vary (each scenario gets its own tf deadline) to exercise the batched-zl/zu
path.

Usage: python benchmarks/orbit_scenarios.py [--cpu] [--batch 2048] [--n 500]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import argparse
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--sigma", type=float, default=1e-3)
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ctdirect_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from ctdirect_tpu import transcribe, InitialGuess
    from ctdirect_tpu.parallel.batch import BatchSolver
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions

    log(f"device: {jax.devices()[0]}")
    B, N = args.batch, args.n

    prob = get_problem("orbit_transfer")
    docp = transcribe(prob.ocp, grid_size=N, scheme="midpoint")

    # nominal solve (full IPM) -> warm start for every scenario
    t0 = time.time()
    nominal = solve_docp(
        docp,
        init=prob.init,
        options=IPMOptions(tol=1e-6, max_iter=3000, lsq_lambda_init=False),
    )
    log(
        f"nominal solve: {nominal.message} obj={nominal.objective:.6f} "
        f"it={nominal.iterations} ({time.time()-t0:.1f}s incl compile)"
    )

    z_nom = docp.initial_guess(InitialGuess.from_solution(nominal))
    rng = np.random.default_rng(0)

    # scenario batch: perturbed initial state through the boundary rhs rows
    # (rows 0..3 = x(t0) pins), per-scenario tf deadline through zl/zu
    rows = docp.boundary_row_indices()[:4]
    cl = np.tile(docp._c_lb, (B, 1))
    cu = np.tile(docp._c_ub, (B, 1))
    dx0 = args.sigma * rng.standard_normal((B, 4))
    cl[:, rows] += dx0
    cu[:, rows] += dx0
    zl = np.tile(docp._z_lb, (B, 1))
    zu = np.tile(docp._z_ub, (B, 1))
    zu[:, -1] = 15.0 + rng.uniform(-1.0, 1.0, B)  # per-scenario deadline

    opts = IPMOptions(
        tol=1e-6, max_iter=args.max_iter, lsq_lambda_init=False, kkt_mode="cr"
    )
    solver = BatchSolver(docp, options=opts)
    z0 = jnp.broadcast_to(jnp.asarray(z_nom), (B,) + z_nom.shape)

    t0 = time.time()
    res = solver(z0, jnp.asarray(cl), jnp.asarray(cu), jnp.asarray(zl), jnp.asarray(zu))
    res.z.block_until_ready()
    log(f"batch compile+run: {time.time()-t0:.1f}s")

    t0 = time.time()
    res = solver(z0, jnp.asarray(cl), jnp.asarray(cu), jnp.asarray(zl), jnp.asarray(zu))
    res.z.block_until_ready()
    wall = time.time() - t0

    ok = np.asarray(res.successful)
    iters = np.asarray(res.iterations)
    sps = B / wall
    log(
        f"B={B} N={N}: {wall:.2f}s -> {sps:.1f} scenario solves/s "
        f"({ok.mean()*100:.1f}% converged, median iters {np.median(iters):.0f})"
    )
    print(
        json.dumps(
            {
                "metric": "orbit-transfer scenario solves/s/chip (midpoint)",
                "value": round(sps, 2),
                "unit": "solves/s",
                "batch": B,
                "grid": N,
                "converged_frac": round(float(ok.mean()), 4),
                "median_iters": int(np.median(iters)),
            }
        )
    )


if __name__ == "__main__":
    main()
