"""Stage-level profiling of the warm-resolve MPC tick (the headline bench path).

Times, separately jitted and vmapped over the bench batch:
  prepare   — vmapped per-step Lagrangian Hessian/Jacobian AD (StructuredKKT.prepare)
  assemble  — block-tridiagonal + arrowhead block construction
  solve     — the CR (or scan) block solve given assembled blocks
  tick      — the full fused 3-iteration resolve (what bench.py measures)

Usage: python benchmarks/profile_tick.py [--cpu] [--b 512] [--n 100] [--algo cr]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--algo", default="cr")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument(
        "--solve-f32",
        action="store_true",
        help="mixed precision: f32 block solve inside the f64 tick "
        "(the headline-bench default, StructuredKKT.solve_dtype)",
    )
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    if args.f32:
        os.environ["CTDIRECT_TPU_X64"] = "0"

    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ctdirect_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.solver.ipm import IPMOptions
    from ctdirect_tpu.solver import structured_kkt as sk

    prob = get_problem("double_integrator_minenergy")
    docp = transcribe(prob.ocp, grid_size=args.n, scheme="trapeze")
    sdt = jnp.float32 if args.solve_f32 else None
    kkt = sk.StructuredKKT(docp, algorithm=args.algo, solve_dtype=sdt)
    B = args.b

    ctrl = MPCController(
        docp,
        x0_boundary_rows=[0, 1],
        resolve_iters=3,
        kkt_algorithm=args.algo,
        kkt_solve_dtype=sdt,
    )
    warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
    states = broadcast_state(warm, B)
    log(f"device={jax.devices()[0]}  B={B} N={args.n} algo={args.algo}")

    z_b = states.z
    lam_b = states.lam
    sf = jnp.ones((), z_b.dtype)
    sc = jnp.ones((docp.nc,), z_b.dtype)
    nz = docp.nz

    def bench(name, fn, *xs, reps=10):
        out = fn(*xs)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(reps):
            out = fn(*xs)
        jax.block_until_ready(out)
        dt = (time.time() - t0) / reps
        log(f"{name:>10}: {dt*1e3:9.2f} ms")
        return out, dt

    # ---- stage 1: prepare (AD) ----
    prep1 = jax.jit(jax.vmap(lambda z, lam: kkt.prepare(z, lam, sf, sc)))
    data, t_prep = bench("prepare", prep1, z_b, lam_b)

    # ---- stage 2: assemble blocks ----
    sigma_z = jnp.ones((B, nz), z_b.dtype) * 0.1
    Drow = jnp.ones((B, docp.nc), z_b.dtype)
    rz = jnp.ones((B, nz), z_b.dtype)
    rp = jnp.ones((B, docp.nc), z_b.dtype)

    asm1 = jax.jit(
        jax.vmap(lambda d, s, dr, a, b: kkt._assemble(d, s, dr, 1e-8, 1e-8, a, b))
    )
    blocks, t_asm = bench("assemble", asm1, data, sigma_z, Drow, rz, rp)

    # ---- stage 3: block solve (same dispatch as the tick: the custom_vmap
    # cr_solve routes to the lane-minor engine under vmap; scan stays plain) ----
    from ctdirect_tpu.solver.lanes import cr_solve

    solver_fn = cr_solve if args.algo == "cr" else sk._scan_solve
    if sdt is not None:
        blocks = tuple(b.astype(sdt) for b in blocks)
    sol1 = jax.jit(jax.vmap(lambda A, Bb, E, F, r, rb: solver_fn(A, Bb, E, F, r, rb)))
    _, t_sol = bench("solve", sol1, *blocks)

    # ---- full tick ----
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(0.03 * rng.standard_normal((B, 2)))
    tick1 = lambda s, x: ctrl(s, x)
    (_, u0, _, _), t_tick = bench("tick(3it)", tick1, states, x0)

    log(
        f"sum(3*(prep+asm+solve)) = {3*(t_prep+t_asm+t_sol)*1e3:.2f} ms "
        f"vs tick {t_tick*1e3:.2f} ms"
    )

    # ---- roofline of the tick program (device runs only) ----
    if args.cpu:
        log("roofline: not measured (CPU run)")
        return
    stats = roofline(ctrl._tick, t_tick, (states, x0))
    log(
        f"roofline: {stats['gflops']:.1f} GFLOP/s ({100*stats['fp64_peak_share']:.2f}% of "
        f"{stats['peak_tflops_fp64']:.0f} TFLOP/s FP64 peak), "
        f"{stats['gbps']:.1f} GB/s HBM ({100*stats['hbm_share']:.1f}% of "
        f"{stats['peak_gbps']:.0f} GB/s) -> "
        f"{'BANDWIDTH' if stats['hbm_share'] > stats['fp64_peak_share'] else 'COMPUTE'}-bound"
    )


# Published per-card peaks, dense rates without sparsity, from NVIDIA's H100
# data sheet. Keyed by a substring of jax `device_kind`; checked in order.
# tflops_fp64: FP64 vector (CUDA cores) — the tick and the IPM run in f64
# outside the tensor cores, so roofline shares divide by this row. The data
# sheet's FP64 tensor-core and FP32 rates (SXM: 67 and 67 TFLOP/s) are not
# divided by anywhere.
PEAKS = (
    ("H100 PCIe", dict(tflops_fp64=26.0, gbps=2000.0)),
    ("H100 NVL", dict(tflops_fp64=30.0, gbps=3900.0)),
    ("H100", dict(tflops_fp64=34.0, gbps=3350.0)),
)


def peaks_for(device_kind: str) -> dict:
    """Peak row for a jax `device_kind`; an unknown device is an error."""
    for key, row in PEAKS:
        if key.lower() in device_kind.lower():
            return row
    raise KeyError(f"no published peaks for device kind {device_kind!r}")


def roofline(jitted, wall_s, args):
    """XLA cost analysis of a compiled function -> achieved FLOP/s and bytes/s
    against the card's published peaks. `fp64_peak_share` divides by the FP64
    vector peak (the tick is an f64 program); `hbm_share` by HBM bandwidth.
    XLA's counts are the compiled program's, not an algorithmic minimum."""
    import jax

    peaks = peaks_for(jax.devices()[0].device_kind)
    cost = jitted.lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    bts = float(cost.get("bytes accessed", 0.0))
    gflops = flops / wall_s / 1e9
    gbps = bts / wall_s / 1e9
    return dict(
        flops=flops,
        bytes=bts,
        gflops=gflops,
        gbps=gbps,
        fp64_peak_share=gflops / (peaks["tflops_fp64"] * 1e3),
        hbm_share=gbps / peaks["gbps"],
        peak_tflops_fp64=peaks["tflops_fp64"],
        peak_gbps=peaks["gbps"],
    )


if __name__ == "__main__":
    main()
