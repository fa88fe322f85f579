"""Per-component timing of one structured-KKT IPM iteration at large N.

The suite-ladder rungs at N >= 2500 are expected to be per-ITERATION-cost
bound. This harness times the pieces of an iteration separately so the
optimization target is measured, not guessed:

    prepare      vmapped per-step Lagrangian Hessians + Jacobians
    assemble     block scatter into (A, B, E, F, r, rb)
    equilibrate  2-pass Ruiz scaling
    cr_f32       one f32 cyclic-reduction solve of the assembled system
    refine2      the production solve: f32 CR + 2 f64 refinement sweeps
    residuals    grad f + J^T lam + constraint evaluation (rbar build)

Usage: python benchmarks/solve_breakdown.py --problem goddard --n 2500
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench(fn, args, reps=20):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)  # compile
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps * 1e3  # ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="goddard")
    ap.add_argument("--n", type=int, default=2500)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json", default=None)
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

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.structured_kkt import (
        StructuredKKT,
        _apply_scales,
        _cr_solve,
        _cr_solve_chain_lanes,
        _ruiz_scales,
        _scan_solve,
    )

    prob = get_problem(args.problem)
    docp = transcribe(prob.ocp, grid_size=args.n, scheme="trapeze")
    kkt32 = StructuredKKT(docp, algorithm="cr", solve_dtype=jnp.float32, refine=2)
    nz, nc = docp.nz, docp.nc
    z = jnp.asarray(docp.initial_guess(prob.init))
    lam = jnp.asarray(0.01 * np.random.default_rng(0).standard_normal(nc))
    sf = jnp.asarray(1.0)
    sc = jnp.ones((nc,))
    sigma = jnp.ones((nz,))
    Drow = jnp.zeros((nc,))
    rz = jnp.asarray(np.random.default_rng(1).standard_normal(nz))
    rp = jnp.asarray(np.random.default_rng(2).standard_normal(nc))
    dw = jnp.asarray(1e-8)
    dc = jnp.asarray(1e-8)

    prep = jax.jit(kkt32.prepare)
    data = prep(z, lam, sf, sc)
    asm = jax.jit(lambda d: kkt32._assemble(d, sigma, Drow, dw, dc, rz, rp))
    blocks = asm(data)

    def eq(blocks):
        A, B, E, F, r, rb = blocks
        d1, db1 = _ruiz_scales(A, B, E, F)
        return _apply_scales(A, B, E, F, r, rb, d1, db1)

    eqj = jax.jit(eq)
    sblocks = eqj(blocks)
    f32blocks = tuple(b.astype(jnp.float32) for b in sblocks)
    cr32 = jax.jit(lambda b: _cr_solve(*b))
    solve_full = jax.jit(
        lambda d: kkt32.solve(d, sigma, Drow, dw, dc, rz, rp)
    )

    rows = dict(problem=args.problem, N=args.n, backend=jax.default_backend())
    rows["prepare_ms"] = round(bench(prep, (z, lam, sf, sc)), 3)
    rows["assemble_ms"] = round(bench(asm, (data,)), 3)
    rows["equilibrate_ms"] = round(bench(eqj, (blocks,)), 3)
    rows["cr_f32_ms"] = round(bench(cr32, (f32blocks,)), 3)
    cr_chain = jax.jit(lambda b: _cr_solve_chain_lanes(*b))
    rows["cr_chainlanes_f32_ms"] = round(bench(cr_chain, (f32blocks,)), 3)
    rows["solve_refine2_ms"] = round(bench(solve_full, (data,)), 3)

    # residual side of an iteration: grad f + J^T lam + c(z)
    def resid(z, lam):
        gf = jax.grad(docp.nlp_objective)(z)
        return gf + jax.vjp(docp.constraints, z)[1](lam)[0], docp.constraints(z)

    rows["residuals_ms"] = round(bench(jax.jit(resid), (z, lam)), 3)
    print(json.dumps(rows))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
