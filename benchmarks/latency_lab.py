"""Single-solve latency lab: measure warm (compile-free) full-IPM solve time
across KKT configurations on the GPU — the workload where the reference
(CTDirect+Ipopt on CPU) sets its published suite numbers
(test/archives/NLP_comparison.md:15–20: 0.6/1.4/3.8/18.0/74.8 s suite totals
at N=250..5000).

Configs: kkt_mode x solve_dtype. "structured" is the O(N)-depth sequential
block elimination; "cr" is the O(log N)-depth cyclic reduction — a single
instance is latency-bound on the scan's N sequential steps.
"f32" factors/solves the blocks in f32 inside the f64 Newton loop
(inexact Newton; IPMOptions.kkt_solve_dtype).

Usage: python benchmarks/latency_lab.py [--problems beam,goddard]
       [--grids 250,1000,5000] [--configs cr:f32,cr:f64,structured:f32]
       [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problems", default="beam,goddard")
    ap.add_argument("--grids", default="250,1000,5000")
    ap.add_argument("--configs", default="structured:f64,cr:f64,cr:f32,structured:f32")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ctdirect_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions

    print(f"backend: {jax.default_backend()}", flush=True)
    rows = []
    for name in args.problems.split(","):
        prob = get_problem(name)
        for N in [int(g) for g in args.grids.split(",")]:
            docp = transcribe(prob.ocp, grid_size=N, scheme="trapeze")
            for cfg in args.configs.split(","):
                mode, dt = cfg.split(":")
                opts = IPMOptions(
                    tol=args.tol,
                    max_iter=500,
                    kkt_mode=mode,
                    kkt_solve_dtype=None if dt == "f64" else dt,
                )
                t0 = time.time()
                try:
                    sol = solve_docp(docp, init=prob.init, options=opts)
                    cold = time.time() - t0
                    times = []
                    for _ in range(args.reps):
                        t1 = time.time()
                        sol = solve_docp(docp, init=prob.init, options=opts)
                        times.append(time.time() - t1)
                    warm = min(times)
                    ok = sol.successful and (
                        prob.obj is None
                        or abs(sol.objective - prob.obj) <= 1e-2 * abs(prob.obj)
                    )
                    row = dict(
                        problem=name, N=N, mode=mode, dtype=dt, ok=bool(ok),
                        iters=int(sol.iterations), warm_s=round(warm, 4),
                        per_iter_ms=round(1e3 * warm / max(sol.iterations, 1), 2),
                        cold_s=round(cold, 1), obj=float(sol.objective),
                    )
                except Exception as e:  # noqa: BLE001
                    row = dict(problem=name, N=N, mode=mode, dtype=dt, ok=False,
                               error=str(e)[:120], cold_s=round(time.time() - t0, 1))
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
