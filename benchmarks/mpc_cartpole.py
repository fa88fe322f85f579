"""BASELINE.json config 3: cart-pole swing-up receding-horizon MPC, 1k
warm-started batched instances per chip.

Unlike the headline double-integrator tick (a near-QP), the cart-pole horizon
problem carries ACTIVE path/box constraints at the optimum (|u| <= 12 and the
cart box saturate during the swing), so the fixed-iteration resolve must track
a switching active set across ticks — the robustness case for the tick. Per tick: inject measured x0 through the boundary rhs, shift the
plan, run K predictor-corrector iterations over the structured KKT.

Usage: python benchmarks/mpc_cartpole.py [--cpu] [--batch 1024] [--n 60]
Writes one JSON line to stdout; diagnostics to stderr.
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
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--algo", default="cr", choices=["scan", "cr"])
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
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.ipm import IPMOptions

    log(f"device: {jax.devices()[0]}")
    B, N, K = args.batch, args.n, args.iters

    prob = get_problem("cartpole")
    docp = transcribe(prob.ocp, grid_size=N, scheme="trapeze")
    ctrl = MPCController(
        docp, x0_boundary_rows=[0, 1, 2, 3], resolve_iters=K, kkt_algorithm=args.algo
    )

    t0 = time.time()
    warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=200), init=prob.init)
    log(f"cold start (full IPM): {time.time()-t0:.1f}s incl compile")

    states = broadcast_state(warm, B)
    rng = np.random.default_rng(0)
    x0_nom = np.array([0.0, 0.0, 0.0, 0.0])

    def sample_x0():
        return jnp.asarray(
            x0_nom + 0.02 * rng.standard_normal((B, 4)) * np.array([1, 1, 0.5, 0.5])
        )

    t0 = time.time()
    states, u0, kkt, viol = ctrl(states, sample_x0())
    u0.block_until_ready()
    log(f"tick compile+run: {time.time()-t0:.1f}s")

    xs = [sample_x0() for _ in range(args.ticks)]
    t0 = time.time()
    for x in xs:
        states, u0, kkt, viol = ctrl(states, x)
    u0.block_until_ready()
    dt = (time.time() - t0) / args.ticks
    sps = B / dt

    # active-set evidence: count saturated force bounds in the final plans
    V = jax.vmap(docp.unpack)(states.z)
    u_all = np.asarray(V.U).reshape(B, -1)
    frac_sat = float(np.mean(np.abs(np.abs(u_all) - 12.0) < 1e-6))
    kkt_max = float(jnp.max(kkt))
    viol_max = float(jnp.max(viol))
    log(
        f"B={B} N={N} iters={K} algo={args.algo}: {dt*1e3:.2f} ms/tick -> "
        f"{sps:.0f} solves/s (kkt {kkt_max:.1e}, viol {viol_max:.1e}, "
        f"{100*frac_sat:.1f}% saturated force nodes)"
    )

    print(
        json.dumps(
            {
                "metric": "cart-pole MPC solves/s/chip (active path constraints)",
                "value": round(sps, 2),
                "unit": "solves/s",
                "batch": B,
                "grid": N,
                "kkt_err_max": kkt_max,
                "viol_max": viol_max,
                "saturated_force_frac": round(frac_sat, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
