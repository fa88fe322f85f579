"""Headline benchmark: warm-started MPC solves/s at N=100 trapezoidal collocation
(BASELINE.json's batched-MPC configuration; vs_baseline = value/10000).

Runs on the GPU and exits non-zero when JAX finds none. Prints ONE JSON line
naming the device; diagnostics go to stderr.

The measured unit is one receding-horizon MPC tick per instance: inject a new
measured initial state through the boundary rhs, shift the previous plan one
step, and run a fixed-iteration primal-dual resolve (solver/resolve.py) over
the structured block-tridiagonal KKT (solver/structured_kkt.py) — the
real-time-iteration hot path, vmapped over BENCH_BATCH instances in f64.
"""

import json
import os
import sys
import time

if os.environ.get("BENCH_F32") == "1":
    os.environ["CTDIRECT_TPU_X64"] = "0"

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from ctdirect_tpu.utils.compile_cache import enable_compile_cache

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.solver.ipm import IPMOptions

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    log(f"device: {dev.device_kind} x{len(jax.devices())}")

    N = int(os.environ.get("BENCH_N", "100"))
    B = int(os.environ.get("BENCH_BATCH", "512"))
    ITERS = int(os.environ.get("BENCH_ITERS", "3"))

    prob = get_problem("double_integrator_minenergy")
    docp = transcribe(prob.ocp, grid_size=N, scheme="trapeze")
    algo = os.environ.get("BENCH_ALGO", "cr")
    # Mixed precision is the DEFAULT: f32 block solve inside an otherwise-f64
    # tick (inexact Newton; StructuredKKT.solve_dtype). The f64 residual
    # contracts by the f32 direction error every iteration, so the KKT error
    # still reaches machine level. BENCH_SOLVE_F32=0 forces the full-f64
    # solve path; which one is faster on the GPU is not measured yet.
    sdt = None if os.environ.get("BENCH_SOLVE_F32") == "0" else jnp.float32
    # BENCH_PIVOT=0: elide the lane-GJ pivot passes (quasi-definite warm
    # blocks; resolve guards non-finite directions) — fewer HBM traversals
    # BENCH_ASM_F32=1: prepare+assembly in f32 end-to-end (halved bytes of
    # the biggest producers; Newton residuals stay f64)
    adt = jnp.float32 if os.environ.get("BENCH_ASM_F32") == "1" else None
    ctrl = MPCController(
        docp,
        x0_boundary_rows=[0, 1],
        resolve_iters=ITERS,
        kkt_algorithm=algo,
        kkt_solve_dtype=sdt,
        kkt_pivot=os.environ.get("BENCH_PIVOT", "1") != "0",
        kkt_assemble_dtype=adt,
        resolve_loop=os.environ.get("BENCH_LOOP", "unroll"),
    )

    t0 = time.time()
    warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
    cold_s = time.time() - t0
    log(f"cold start (full IPM): {cold_s:.1f}s incl compile")

    states = broadcast_state(warm, B)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(0.03 * rng.standard_normal((B, 2)))

    # compile + first tick
    t0 = time.time()
    states, u0, kkt, viol = ctrl(states, x0)
    u0.block_until_ready()
    tick_compile_s = time.time() - t0
    log(f"tick compile+run: {tick_compile_s:.1f}s")

    # timed ticks (new measured states each tick, like a real control loop),
    # two measurements over >= 30 ticks:
    # (a) pipelined batches of `chunk` ticks (async dispatch, one sync per
    #     batch; ticks serialize on device through the states dependency, so
    #     this is device throughput with dispatch overlapped), reported as the
    #     headline with p50/p90 across batches;
    # (b) per-tick host-synced times: the closed-loop latency a controller
    #     sees, dispatch and host round trip included.
    reps = int(os.environ.get("BENCH_REPS", "30"))
    chunk = 10  # ticks per pipelined batch; p50/p90 across batches
    xs = [jnp.asarray(0.03 * rng.standard_normal((B, 2))) for _ in range(reps)]
    batch_ms = []
    for k0 in range(0, reps, chunk):
        t0 = time.time()
        for k in range(k0, min(k0 + chunk, reps)):
            states, u0, kkt, viol = ctrl(states, xs[k])
        u0.block_until_ready()
        batch_ms.append((time.time() - t0) / (min(k0 + chunk, reps) - k0) * 1e3)
    batch_ms = np.asarray(batch_ms)
    p50 = float(np.percentile(batch_ms, 50))
    p90 = float(np.percentile(batch_ms, 90))
    synced_ms = []
    for k in range(reps):
        t0 = time.time()
        states, u0, kkt, viol = ctrl(states, xs[k % len(xs)])
        u0.block_until_ready()
        synced_ms.append((time.time() - t0) * 1e3)
    sync_p50 = float(np.percentile(np.asarray(synced_ms), 50))
    sync_p99 = float(np.percentile(np.asarray(synced_ms), 99))
    dt = p50 / 1e3
    solves_per_s = B / dt

    kkt_max = float(jnp.max(kkt))
    viol_max = float(jnp.max(viol))
    log(
        f"B={B} N={N} iters={ITERS} algo={algo}: p50 {p50:.2f} ms/tick "
        f"(p90 {p90:.2f}, synced p50 {sync_p50:.2f}) -> "
        f"{solves_per_s:.0f} solves/s (kkt {kkt_max:.1e}, viol {viol_max:.1e})"
    )

    # roofline of the tick program against the card's published peaks
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks.profile_tick import roofline

    stats = roofline(ctrl._tick, dt, (states, xs[-1]))
    log(
        f"roofline: {stats['gflops']:.1f} GFLOP/s "
        f"({100*stats['fp64_peak_share']:.2f}% of FP64 peak), "
        f"{stats['gbps']:.1f} GB/s HBM ({100*stats['hbm_share']:.1f}% of peak)"
    )

    print(
        json.dumps(
            {
                "metric": "warm-start MPC solves/s/card, N=100 trapezoid",
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "value": round(solves_per_s, 2),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / 10000.0, 4),
                "fp64_peak_share": stats["fp64_peak_share"],
                "hbm_share": stats["hbm_share"],
                "achieved_gflops": stats["gflops"],
                "achieved_gbps": stats["gbps"],
                "tick_compile_s": round(tick_compile_s, 1),
                "cold_start_s": round(cold_s, 1),
                "kkt_solve_dtype": "f32" if sdt is not None else "f64",
                "kkt_max": kkt_max,
                "tick_ms_p50": round(p50, 3),
                "tick_ms_p90": round(p90, 3),
                "tick_ms_synced_p50": round(sync_p50, 3),
                "tick_ms_synced_p99": round(sync_p99, 3),
                "reps": reps,
            }
        )
    )


if __name__ == "__main__":
    main()
