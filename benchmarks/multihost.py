"""Multi-host scaling harness: warm-started MPC solves/s at 1 chip / 1 host /
N hosts (BASELINE.json: "linear multi-host scaling of batched solves").

The batch axis is embarrassingly parallel, so the expected scaling law is
linear in chip count with ZERO hot-path collectives: the mesh only shards the
batch dimension, XLA partitions the tick program per-chip, and no
cross-device communication occurs inside the resolve (verified by leg 3 of
__graft_entry__.dryrun_multichip on the 8-virtual-device CPU mesh).

This script is runnable on any JAX distributed environment:

  single host (all local devices):
      python benchmarks/multihost.py --batch-per-chip 512

  multi-host (one process per host; standard JAX distributed init):
      python benchmarks/multihost.py --coordinator <host0>:8476 \
          --num-hosts 4 --host-id $RANK --batch-per-chip 512

  simulation (no GPU; 8 virtual CPU devices):
      python benchmarks/multihost.py --simulate 8

Protocol (see SCALING.md): each host contributes its local devices to one
global Mesh over the flattened device list; the global batch B = batch_per_chip
x n_chips is sharded over the "batch" axis; every host feeds its local shard
via jax.make_array_from_process_local_data. Reported metric is global
solves/s = B x ticks / wall; linearity = solves/s(N chips) / (N x solves/s(1)).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="host0 address host:port for jax.distributed.initialize")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--simulate", type=int, default=0,
                    help="run on N virtual CPU devices instead of the GPUs")
    ap.add_argument("--batch-per-chip", type=int, default=512)
    ap.add_argument("--n", type=int, default=100, help="grid size")
    ap.add_argument("--iters", type=int, default=3, help="resolve iterations")
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    if args.simulate:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.simulate}"
        ).strip()
    import jax

    if args.simulate:
        jax.config.update("jax_platforms", "cpu")
    if args.coordinator:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_hosts,
            process_id=args.host_id,
        )
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.ipm import IPMOptions

    devices = np.array(jax.devices())
    n_chips = len(devices)
    log(f"host {args.host_id}/{args.num_hosts}: {n_chips} global chips, "
        f"{jax.local_device_count()} local")

    mesh = Mesh(devices, axis_names=("batch",))
    B = args.batch_per_chip * n_chips

    prob = get_problem("double_integrator_minenergy")
    docp = transcribe(prob.ocp, grid_size=args.n, scheme="trapeze")
    ctrl = MPCController(
        docp,
        x0_boundary_rows=[0, 1],
        resolve_iters=args.iters,
        kkt_algorithm="cr",
        mesh=mesh,
    )
    warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
    sharding = NamedSharding(mesh, P("batch"))
    multiproc = jax.process_count() > 1

    def to_global(local_np):
        """Assemble a global batch-sharded array from this process's shard
        (every host feeds only its local portion — the SCALING.md protocol)."""
        if multiproc:
            return jax.make_array_from_process_local_data(
                sharding, np.asarray(local_np)
            )
        return jax.device_put(jnp.asarray(local_np), sharding)

    B_local = args.batch_per_chip * jax.local_device_count()
    states = jax.tree_util.tree_map(
        lambda a: to_global(np.broadcast_to(np.asarray(a), (B_local,) + a.shape)),
        warm,
    )

    rng = np.random.default_rng(args.host_id)
    x0 = to_global(0.03 * rng.standard_normal((B_local, 2)))

    t0 = time.time()
    states, u0, kkt, viol = ctrl(states, x0)
    u0.block_until_ready()
    log(f"tick compile+run: {time.time()-t0:.1f}s")

    xs = [
        to_global(0.03 * rng.standard_normal((B_local, 2)))
        for _ in range(args.ticks)
    ]
    t0 = time.time()
    for x in xs:
        states, u0, kkt, viol = ctrl(states, x)
    u0.block_until_ready()
    dt = (time.time() - t0) / args.ticks
    # replicated reduction so every process can read the scalar
    global_max = jax.jit(jnp.max, out_shardings=NamedSharding(mesh, P()))
    kkt_max = float(global_max(kkt))

    # ---- collective-cost isolation ----
    # The production tick has ZERO hot-path collectives (batch axis is
    # embarrassingly parallel). To measure what a dp-axis collective WOULD
    # cost at this process/chip count, time the same tick loop with one
    # global (replicated-output) reduction over the batch axis per tick —
    # an all-reduce across every chip/host. delta = pure collective+sync
    # cost per tick; if scaling is sub-linear while this delta is small,
    # the bottleneck is NOT the interconnect (e.g. host CPU
    # oversubscription in the simulated runs).
    t0 = time.time()
    for x in xs:
        states, u0, kkt, viol = ctrl(states, x)
        kkt_global = global_max(kkt)
    float(kkt_global)  # force the replicated scalar to the host each tick
    u0.block_until_ready()
    dt_coll = (time.time() - t0) / args.ticks
    out = dict(
        metric="multi-host warm MPC solves/s",
        n_hosts=args.num_hosts,
        n_chips=n_chips,
        batch=B,
        ms_per_tick=round(dt * 1e3, 2),
        ms_per_tick_with_dp_allreduce=round(dt_coll * 1e3, 2),
        dp_allreduce_cost_ms=round((dt_coll - dt) * 1e3, 2),
        solves_per_s=round(B / dt, 1),
        solves_per_s_per_chip=round(B / dt / n_chips, 1),
        kkt_max=kkt_max,
    )
    if args.host_id == 0:
        print(json.dumps(out))
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
