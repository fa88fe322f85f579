"""Benchmark sweep harness (≙ reference test/benchmark.jl:202–287): solve a
problem set across grid sizes, print a success/iterations/time matrix, and
optionally dump JSON for regression tracking.

Usage:
    python benchmarks/sweep.py                       # default easy set, GPU
    python benchmarks/sweep.py --cpu                 # force CPU
    python benchmarks/sweep.py --grids 250,1000 --problems beam,goddard
    python benchmarks/sweep.py --micro               # objective/constraints/KKT
                                                     # kernel micro-bench
Reference baselines to beat (SURVEY.md §6): 10-problem easy suite, trapeze,
Ipopt/MUMPS CPU: 0.6 / 1.4 / 3.8 / 18.0 / 74.8 s at N=250/500/1000/2500/5000.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import argparse
import json
import sys
import time


# the reference's NLP-comparison suite, EXACT composition
# (test/archives/NLP_comparison.md:10: beam, double_integrator x3 incl.
# freet0tf, fuller, goddard, goddard_all, jackson, simple_integrator,
# vanderpol)
EASY_SET = [
    "beam",
    "double_integrator_mintf",
    "double_integrator_minenergy",
    "double_integrator_freet0tf",
    "fuller",
    "goddard",
    "goddard_all",
    "jackson",
    "simple_integrator",
    "vanderpol",
]


# Per-problem solver overrides (≙ the reference benchmark's per-problem
# adnlp_backend/:manual overrides, test/ci/test_all_ocp.jl:83,123 and
# benchmark.jl problem lists). r5: the full-f64 overrides for the
# singular-arc family are RETIRED — Ruiz equilibration of the assembled KKT
# (StructuredKKT.equilibrate, on by default for f32 solves) makes the
# f32+refine directions contract on these problems too (measured: goddard
# N=1000 f32 290-iteration stall -> 59-iteration Solve_Succeeded;
# goddard_all N=1000 102 iters; goddard N=250 54 iters vs 120 under f64).
# jackson (bang-bang) still stalls formally a hair above tol under f32+r2;
# deeper refinement is its measured fix (see ab3 lab, docs/benchmarks.md).
# jackson (bang-bang): the equilibrated-f32 configs all stall formally a hair
# above tol (obj right to ~1e-3 but status 2 at every refine depth tried);
# the measured green config is adaptive-mu WITHOUT equilibration (N=500: 60
# iters Solve_Succeeded — ab2 lab). Still f32: the f64 override
# is retired.
PROBLEM_OVERRIDES = {
    "jackson": dict(mu_strategy="adaptive", kkt_equilibrate=False),
    # goddard (singular arc): adaptive (LOQO) mu converges in a fraction of
    # the monotone iterations on the fine grids (N=1000: 36 iterations vs
    # 115 monotone); equilibration stays on
    "goddard": dict(mu_strategy="adaptive"),
}
# Per-CELL override: goddard_all N=5000 stalls a hair above tol at refine=2
# with the right objective (1.01257, 67 iters); `--refine 3` converges it
# formally (77 iters). Run that one
# cell as:  python benchmarks/sweep.py --warm --refine 3 \
#              --problems goddard_all --grids 5000


def run_sweep(problems, grids, scheme, tol, max_iter, kkt, warm=False,
              solve_dtype="f32", refine=None):
    import jax

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions

    base_opts = IPMOptions(
        tol=tol,
        max_iter=max_iter,
        kkt_mode=kkt,
        kkt_solve_dtype=None if solve_dtype in (None, "f64") else solve_dtype,
    )
    if refine is not None:
        base_opts = base_opts.replace(kkt_refine=refine)
    rows = []
    for name in problems:
        prob = get_problem(name)
        opts = base_opts.replace(**PROBLEM_OVERRIDES.get(name, {}))
        for N in grids:
            docp = transcribe(prob.ocp, grid_size=N, scheme=scheme)
            t0 = time.time()
            try:
                sol = solve_docp(docp, init=prob.init, options=opts)
                wall = time.time() - t0
                ok = sol.successful and (
                    prob.obj is None
                    or abs(sol.objective - prob.obj) <= 1e-2 * abs(prob.obj)
                )
                row = dict(
                    problem=name,
                    N=N,
                    ok=bool(ok),
                    obj=float(sol.objective),
                    ref=prob.obj,
                    iters=sol.iterations,
                    wall_s=round(wall, 3),
                )
                rows.append(row)
                if warm:
                    # second solve of the SAME compiled program, fresh cold
                    # init: pure device execution time (the reference's CPU
                    # numbers carry no JIT cost either — AD prep is reported
                    # separately in AD_backend.md). Separate try so a warm
                    # failure can't discard the committed cold row.
                    try:
                        t1 = time.time()
                        sol2 = solve_docp(docp, init=prob.init, options=opts)
                        row["warm_s"] = round(time.time() - t1, 3)
                        row["warm_ok"] = bool(sol2.successful)
                    except Exception as e:  # noqa: BLE001
                        row["warm_ok"] = False
                        row["warm_error"] = str(e)[:120]
                status = "ok " if ok else "FAIL"
            except Exception as e:  # noqa: BLE001 — keep sweeping (benchmark.jl:160–176)
                wall = time.time() - t0
                rows.append(
                    dict(problem=name, N=N, ok=False, error=str(e)[:120], wall_s=wall)
                )
                status = "ERR "
            r = rows[-1]
            print(
                f"{status} {name:32s} N={N:<6d} obj={r.get('obj', float('nan')):12.6g} "
                f"iters={r.get('iters', -1):4d} {r['wall_s']:8.2f}s",
                flush=True,
            )
    return rows


def run_micro(problems, N, scheme):
    """Micro-bench: jitted objective / constraints / one structured-KKT solve
    (≙ @btime kernels, benchmark.jl:89–139)."""
    import jax
    import jax.numpy as jnp

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem

    rows = []
    for name in problems:
        prob = get_problem(name)
        docp = transcribe(prob.ocp, grid_size=N, scheme=scheme)
        z0 = jnp.asarray(docp.initial_guess(prob.init))
        f = jax.jit(docp.objective)
        c = jax.jit(docp.constraints)
        g = jax.jit(jax.grad(docp.nlp_objective))
        for label, fn in [("objective", f), ("constraints", c), ("gradient", g)]:
            fn(z0).block_until_ready()  # compile
            reps = 50
            t0 = time.time()
            for _ in range(reps):
                out = fn(z0)
            out.block_until_ready()
            us = (time.time() - t0) / reps * 1e6
            rows.append(dict(problem=name, kernel=label, N=N, micros=round(us, 1)))
            print(f"{name:32s} {label:12s} N={N:<6d} {us:10.1f} us", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--grids", default="250,500,1000")
    ap.add_argument("--problems", default=",".join(EASY_SET))
    ap.add_argument("--scheme", default="trapeze")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--kkt", default="cr", choices=["dense", "structured", "cr"],
                    help="default cr: O(log N) cyclic reduction, the "
                         "configuration the ladder cells run")
    ap.add_argument("--solve-dtype", default="f32", choices=["f32", "f64"],
                    help="f32: native-precision block solve + 1 f64 iterative-"
                         "refinement sweep (IPMOptions.kkt_solve_dtype)")
    ap.add_argument("--refine", type=int, default=None,
                    help="override IPMOptions.kkt_refine (f64 iterative-"
                         "refinement sweeps on the f32 block solve); the "
                         "measured rescue for cells that stall a hair above "
                         "tol at very large N (goddard_all N=5000)")
    ap.add_argument("--micro", action="store_true")
    ap.add_argument("--warm", action="store_true",
                    help="also time a second (compile-free) solve per cell")
    ap.add_argument("--no-persist-cache", dest="persist_cache",
                    action="store_false", default=True,
                    help="disable the on-disk JAX compilation cache (cache is "
                         "ON by default; cold wall_s then measures first-ever "
                         "compiles only — use warm_s for compile-free numbers)")
    ap.add_argument("--json", default=None, help="write results to this path")
    args = ap.parse_args()

    import os

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    if args.persist_cache:
        from ctdirect_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    print(f"backend: {jax.default_backend()}, devices: {jax.devices()}", flush=True)

    grids = [int(g) for g in args.grids.split(",")]
    problems = args.problems.split(",")
    t0 = time.time()
    if args.micro:
        rows = run_micro(problems, grids[0], args.scheme)
    else:
        rows = run_sweep(problems, grids, args.scheme, args.tol, args.max_iter,
                         args.kkt, warm=args.warm, solve_dtype=args.solve_dtype,
                         refine=args.refine)
        total = sum(r["wall_s"] for r in rows)
        nok = sum(1 for r in rows if r.get("ok"))
        print(f"\ntotal {total:.1f}s wall ({time.time()-t0:.1f}s incl compile), "
              f"{nok}/{len(rows)} ok", flush=True)
        if args.warm:
            for N in grids:
                tw = sum(r.get("warm_s", 0.0) for r in rows if r["N"] == N)
                print(f"warm suite total N={N}: {tw:.2f}s", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
