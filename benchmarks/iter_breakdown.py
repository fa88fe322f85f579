"""Decompose the full-IPM per-iteration cost on the GPU: time the major
sub-programs of one iteration (derivative assembly, KKT solve, residual/merit
evaluations) separately, in f64 and f32, to locate the latency floor that the
suite-ladder warm numbers sit on.

Usage: python benchmarks/iter_breakdown.py [--n 250] [--problem beam]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, reps=20):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=250)
    ap.add_argument("--problem", default="beam")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ctdirect_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT

    prob = get_problem(args.problem)
    docp = transcribe(prob.ocp, grid_size=args.n, scheme="trapeze")
    z0 = jnp.asarray(docp.initial_guess(prob.init))
    nz, nc = docp.nz, docp.nc
    lam = jnp.zeros((nc,))
    sf = jnp.asarray(1.0)
    sc = jnp.ones((nc,))
    print(f"backend {jax.default_backend()}  N={args.n} nz={nz} nc={nc}", flush=True)

    kkt = StructuredKKT(docp, algorithm="cr", solve_dtype=jnp.float32, refine=1)
    kkt64 = StructuredKKT(docp, algorithm="cr")

    prep = jax.jit(lambda z, l: kkt.prepare(z, l, sf, sc))
    data = prep(z0, lam)
    print(f"prepare (f64 hessians):      {timeit(prep, z0, lam):8.2f} ms", flush=True)

    sigma = jnp.ones((nz,))
    Drow = jnp.zeros((nc,))
    dw = jnp.asarray(0.0)
    dc = jnp.asarray(1e-8)
    rz = jnp.ones((nz,))
    rp = jnp.ones((nc,))
    sv32 = jax.jit(lambda d: kkt.solve(d, sigma, Drow, dw, dc, rz, rp))
    sv64 = jax.jit(lambda d: kkt64.solve(d, sigma, Drow, dw, dc, rz, rp))
    print(f"cr solve f32+refine1:        {timeit(sv32, data):8.2f} ms", flush=True)
    print(f"cr solve f64:                {timeit(sv64, data):8.2f} ms", flush=True)

    f = jax.jit(docp.nlp_objective)
    c = jax.jit(docp.constraints)
    g = jax.jit(jax.grad(docp.nlp_objective))

    def gv(z, l):
        return jax.grad(docp.nlp_objective)(z) + jax.vjp(docp.constraints, z)[1](l)[0]

    gvj = jax.jit(gv)
    print(f"objective eval:              {timeit(f, z0):8.2f} ms", flush=True)
    print(f"constraints eval:            {timeit(c, z0):8.2f} ms", flush=True)
    print(f"grad f:                      {timeit(g, z0):8.2f} ms", flush=True)
    print(f"grad f + J^T lam (vjp):      {timeit(gvj, z0, lam):8.2f} ms", flush=True)

    def hvp(z, l, v):
        gl = lambda zz: jax.grad(
            lambda z3: docp.nlp_objective(z3) + jnp.dot(l, docp.constraints(z3))
        )(zz)
        return jax.jvp(gl, (z,), (v,))[1]

    hj = jax.jit(hvp)
    print(f"lagrangian HVP:              {timeit(hj, z0, lam, rz):8.2f} ms", flush=True)

    rn = jax.jit(kkt.row_norms)
    print(f"row_norms:                   {timeit(rn, z0):8.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
