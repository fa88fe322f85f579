"""Smoke run of the solver's main path on an NVIDIA GPU, at real size.

    python chip_smoke.py               # phases 0-3 on one card
    python chip_smoke.py --four-cards  # sharded paths on four cards, only

Phase 0 requires a GPU (`jax.devices()[0].platform == "gpu"`) and exits
non-zero otherwise: this script never runs on the CPU. Phase 1 solves single
OCPs through the public front door (`ct.transcribe` + `ct.solve_docp`, the two
calls `ct.solve` makes, so that a second solve of the same DOCP is warm).
Phase 2 runs the batched receding-horizon MPC tick (`MPCController`) at the
size `bench.py` measures. Phase 3 solves one tick's assembled KKT blocks with
the batched cyclic-reduction engine and checks them against the C++ host
oracle (`csrc/blocktri.cpp`, needs g++). Without options it uses one card
(`CUDA_VISIBLE_DEVICES=0` unless the variable is set). `--four-cards` runs
the time-sharded IPM solve and the batch-sharded tick over a 1-D mesh of
four cards, each against the same single-device program on the host CPU,
and no other phase.

Every phase prints its numbers on its own line. A failed check raises and
the script exits non-zero; nothing is caught. The last line of stdout is
`{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# phase 2: the bench.py cell
TICK_B, TICK_N, TICK_K, TICK_REPS = 512, 100, 3, 30
TICK_KKT_MAX = 1e-8
# u0 of the f32-block-solve tick on the GPU vs the full-f64 tick on the CPU
U0_ATOL = 1e-6
U0_COMPARED = 16
# phase 3 bounds against the C++ host oracle. The f32 bound sits between the
# H100's two readings: 5.1e-8 with every contraction at HIGHEST, 1.87e-6 with
# XLA:GPU free to use TF32 (DEFAULT), so a lost precision pin fails here.
F64_REL_ERR_MAX = 1e-10
F32_BACKWARD_ERR_MAX = 3e-7
# phase 1: the sweep.py production configuration for the ladder
LADDER_OPTS = dict(
    tol=1e-6, max_iter=500, kkt_mode="cr", kkt_solve_dtype="f32", kkt_refine=2
)
# --four-cards
SHARDED_U0_ATOL = 1e-10
TIME_SHARD_N = 1024
TIME_SHARD_OBJ_RTOL = 1e-8
TIME_SHARD_Z_ATOL = 1e-6


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def report(phase, name, **numbers):
    print(f"phase {phase} {name}: {json.dumps(numbers)}", flush=True)


def require_gpu(n_cards):
    """Phase 0: the device guard. Exits non-zero unless JAX sees a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"phase 0 failed: JAX found {devs[0].platform!r}, not a GPU")
    if len(devs) < n_cards:
        sys.exit(f"phase 0 failed: {len(devs)} GPU(s), {n_cards} needed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    report(0, "device", kind=devs[0].device_kind, count=len(devs))
    print(smi, flush=True)
    return devs


def _timed_twice(solve):
    t0 = time.perf_counter()
    sol = solve()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = solve()
    warm_s = time.perf_counter() - t0
    return sol, first_s, warm_s


def phase1_solves(di_n=100, beam_n=1000):
    import ctdirect_tpu as ct
    from ctdirect_tpu.problems import get_problem

    # analytic oracle: objective 12, u(t) = 6 - 12t, p(0) = [24, 12]
    p = get_problem("double_integrator_minenergy")
    docp = ct.transcribe(p.ocp, grid_size=di_n, scheme="trapeze")
    opts = ct.IPMOptions(tol=1e-8)
    sol, first_s, warm_s = _timed_twice(
        lambda: ct.solve_docp(docp, init=p.init, options=opts)
    )
    t = sol.time_grid
    u = sol.control_values[:, 0]
    u_err = float(np.max(np.abs(u[2:-2] - (6 - 12 * t[2:-2]))))
    p0 = sol.costate_values[0]
    report(1, f"double_integrator N={di_n}", status=sol.status,
           iterations=sol.iterations, objective=sol.objective,
           interior_u_err=u_err, p0=[float(x) for x in p0],
           first_s=first_s, warm_s=warm_s, compile_s=first_s - warm_s)
    check(sol.status == 0, "double integrator status 0")
    check(abs(sol.objective - 12.0) <= 1e-2 * 12.0, "objective ~ 12")
    # interior nodes at O(h^2); the endpoints carry the trapeze boundary layer
    check(u_err < 5e-3, "u(t) ~ 6 - 12t at interior nodes")
    check(np.allclose(p0, [24.0, 12.0], rtol=1e-2, atol=0.05), "p(0) ~ [24, 12]")

    p = get_problem("beam")
    docp = ct.transcribe(p.ocp, grid_size=beam_n, scheme="trapeze")
    opts = ct.IPMOptions(**LADDER_OPTS)
    sol, first_s, warm_s = _timed_twice(
        lambda: ct.solve_docp(docp, init=p.init, options=opts)
    )
    report(1, f"beam trapeze N={beam_n}", status=sol.status,
           iterations=sol.iterations, objective=sol.objective, reference=p.obj,
           first_s=first_s, warm_s=warm_s, compile_s=first_s - warm_s)
    check(sol.successful, "beam converged")
    check(abs(sol.objective - p.obj) <= 1e-2 * abs(p.obj), "beam objective rtol 1e-2")


def _tick_setup(B, N, K, mesh=None):
    import jax.numpy as jnp

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController
    from ctdirect_tpu.problems import get_problem

    docp = transcribe(
        get_problem("double_integrator_minenergy").ocp, grid_size=N, scheme="trapeze"
    )

    def controller(solve_dtype=jnp.float32, mesh=mesh):
        # bench.py's construction
        return MPCController(
            docp, x0_boundary_rows=[0, 1], resolve_iters=K, kkt_algorithm="cr",
            kkt_solve_dtype=solve_dtype, mesh=mesh,
        )

    return docp, controller


def _cold_states(ctrl, B):
    from ctdirect_tpu.parallel.mpc import broadcast_state
    from ctdirect_tpu.solver.ipm import IPMOptions

    warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
    return broadcast_state(warm, B)


def _x0(rng, B):
    return 0.03 * rng.standard_normal((B, 2))


def phase2_tick(B=TICK_B, N=TICK_N, K=TICK_K, reps=TICK_REPS, compared=U0_COMPARED):
    import jax
    import jax.numpy as jnp

    docp, controller = _tick_setup(B, N, K)
    ctrl = controller()
    states = _cold_states(ctrl, B)
    rng = np.random.default_rng(SEED)
    x0 = jnp.asarray(_x0(rng, B))

    t0 = time.perf_counter()
    new_states, u0, kkt, _ = ctrl(states, x0)
    u0.block_until_ready()
    compile_s = time.perf_counter() - t0

    # the same first tick in full f64 on the CPU, for `compared` instances
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ctrl_ref = controller(solve_dtype=None)
        sub = jax.device_put(
            jax.tree_util.tree_map(lambda a: np.asarray(a[:compared]), states), cpu
        )
        _, u0_ref, _, _ = ctrl_ref(sub, jax.device_put(np.asarray(x0[:compared]), cpu))
    u0_err = float(np.max(np.abs(np.asarray(u0[:compared]) - np.asarray(u0_ref))))

    states = new_states
    kkt_max = float(jnp.max(kkt))
    xs = [jnp.asarray(_x0(rng, B)) for _ in range(reps)]
    tick_ms = []
    for k in range(reps):
        t0 = time.perf_counter()
        states, u0, kkt, _ = ctrl(states, xs[k])
        u0.block_until_ready()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        kkt_max = max(kkt_max, float(jnp.max(kkt)))
    report(2, f"mpc tick B={B} N={N} K={K}", tick_compile_s=compile_s,
           reps=reps, synced_p50_ms=float(np.percentile(tick_ms, 50)),
           synced_p99_ms=float(np.percentile(tick_ms, 99)),
           solves_per_s_at_p50=B / (float(np.percentile(tick_ms, 50)) / 1e3),
           kkt_max=kkt_max, u0_max_abs_err_vs_cpu_f64=u0_err,
           u0_atol=U0_ATOL, u0_compared=compared)
    check(all(np.isfinite(tick_ms)), "finite tick times")
    check(kkt_max <= TICK_KKT_MAX, f"max(kkt) <= {TICK_KKT_MAX}")
    check(u0_err <= U0_ATOL, f"u0 within {U0_ATOL} of the f64 CPU tick")
    return docp, states


def _block_matvec_np(A, B, E, F, X, xb):
    """Batched K @ [X; xb] on the host (leading instance axis)."""
    y = np.einsum("bnij,bnj->bni", A, X)
    y[:, 1:] += np.einsum("bnji,bnj->bni", B, X[:, :-1])
    y[:, :-1] += np.einsum("bnij,bnj->bni", B, X[:, 1:])
    y += np.einsum("bniw,bw->bni", E, xb)
    yb = np.einsum("bnsw,bns->bw", E, X) + np.einsum("bvw,bw->bv", F, xb)
    return y, yb


def backward_error(host_blocks, X, xb):
    """Largest normwise backward error |Kx - b| / (|K||x| + |b|) (inf-norms,
    f64 on the host) over the instances of a batched solution."""
    A, B, E, F, r, rb = host_blocks
    X = np.asarray(X, np.float64)
    xb = np.asarray(xb, np.float64)
    y, yb = _block_matvec_np(A, B, E, F, X, xb)
    resid = np.maximum(np.abs(y - r).max(axis=(1, 2)), np.abs(yb - rb).max(axis=1))
    rs, rsb = _block_matvec_np(
        *(np.abs(a) for a in (A, B, E, F)), np.ones_like(X), np.ones_like(xb)
    )
    k_inf = np.maximum(rs.max(axis=(1, 2)), rsb.max(axis=1))
    x_inf = np.maximum(np.abs(X).max(axis=(1, 2)), np.abs(xb).max(axis=1))
    b_inf = np.maximum(np.abs(r).max(axis=(1, 2)), np.abs(rb).max(axis=1))
    return float(np.max(resid / (k_inf * x_inf + b_inf)))


def _steady_ms(fn, args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def tick_blocks(docp, states):
    """One tick's assembled blocks at the states' batch size, on the device
    (StructuredKKT.prepare + _assemble, as benchmarks/profile_tick.py does)."""
    import jax
    import jax.numpy as jnp

    from ctdirect_tpu.solver.structured_kkt import StructuredKKT

    kkt = StructuredKKT(docp, algorithm="cr")
    B = states.z.shape[0]
    rng = np.random.default_rng(SEED + 1)
    sf = jnp.ones((), states.z.dtype)
    sc = jnp.ones((docp.nc,), states.z.dtype)
    data = jax.jit(jax.vmap(lambda z, lam: kkt.prepare(z, lam, sf, sc)))(
        states.z, states.lam
    )
    sigma_z = jnp.full((B, docp.nz), 0.1)
    Drow = jnp.ones((B, docp.nc))
    rz = jnp.asarray(rng.standard_normal((B, docp.nz)))
    rp = jnp.asarray(rng.standard_normal((B, docp.nc)))
    asm = jax.jit(
        jax.vmap(lambda d, s, dr, a, b: kkt._assemble(d, s, dr, 1e-8, 1e-8, a, b))
    )
    return asm(data, sigma_z, Drow, rz, rp)


def phase3_block_solve(docp, states):
    import jax
    import jax.numpy as jnp

    from ctdirect_tpu import native
    from ctdirect_tpu.solver import lanes

    blocks = tick_blocks(docp, states)
    host = [np.asarray(b) for b in blocks]
    Xr, xbr = native.blocktri_solve_batch(*host)
    ref = np.concatenate([Xr.reshape(Xr.shape[0], -1), xbr], axis=1)

    solve = jax.jit(jax.vmap(lanes.cr_solve))
    X64, xb64 = solve(*blocks)
    got = np.concatenate([np.asarray(X64).reshape(ref.shape[0], -1), np.asarray(xb64)], 1)
    rel64 = float(np.max(np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)))

    blocks32 = tuple(b.astype(jnp.float32) for b in blocks)
    bwd32 = backward_error(host, *solve(*blocks32))

    B, N, bs = host[4].shape
    report(3, f"batched cr_solve B={B} N={N} bs={bs} wb={host[5].shape[1]}",
           f64_rel_err_vs_host=rel64, f32_backward_err=bwd32,
           solve_f64_ms=_steady_ms(solve, blocks),
           solve_f32_ms=_steady_ms(solve, blocks32))
    check(rel64 <= F64_REL_ERR_MAX, f"f64 relative error <= {F64_REL_ERR_MAX}")
    check(bwd32 <= F32_BACKWARD_ERR_MAX, f"f32 backward error <= {F32_BACKWARD_ERR_MAX}")


def _compiled(fn, *args):
    """Lower and compile `fn` for `args`; returns it with lower and compile
    seconds, so a slow compile shows apart from the run."""
    t0 = time.perf_counter()
    lowered = fn.lower(*args)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    return compiled, t1 - t0, time.perf_counter() - t1


def time_sharded_ipm(devs, ref_dev, n=TIME_SHARD_N):
    """Full IPM with the time axis sharded over `devs` (distributed CR, one
    halo exchange per level), against the single-device StructuredKKT("cr")
    solve of the same DOCP on `ref_dev`."""
    import jax
    from jax.sharding import Mesh

    from ctdirect_tpu import native, transcribe
    from ctdirect_tpu.parallel.time_shard import TimeShardedKKT
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.ipm import IPMOptions, ipm_solve, make_spec
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT

    docp = transcribe(get_problem("double_integrator_minenergy").ocp,
                      grid_size=n, scheme="trapeze")
    spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    opts = IPMOptions(tol=1e-8)

    def solver(kkt):
        return jax.jit(lambda z0: ipm_solve(
            docp.nlp_objective, docp.constraints, spec, z0, docp._z_lb,
            docp._z_ub, docp._c_lb, docp._c_ub, options=opts, kkt=kkt))

    z0 = np.asarray(docp.initial_guess(None))
    kkt_t = TimeShardedKKT(docp, Mesh(np.array(devs), ("time",)), axis="time")
    run_t, lower_s, compile_s = _compiled(solver(kkt_t), z0)
    res_t, first_s, warm_s = _timed_twice(lambda: jax.block_until_ready(run_t(z0)))

    with jax.default_device(ref_dev):
        kkt_1 = StructuredKKT(docp, algorithm="cr")
        res_1 = jax.block_until_ready(solver(kkt_1)(z0))
        # one KKT system at the solution, for the distributed solve alone
        blocks = jax.jit(lambda z, lam: kkt_1._assemble(
            kkt_1.prepare(z, lam, 1.0, np.ones(docp.nc)), np.ones(docp.nz),
            np.ones(docp.nc), 1e-8, 1e-8, np.ones(docp.nz), np.ones(docp.nc),
        ))(res_1.z, res_1.lam)
    host = [np.asarray(b) for b in blocks]
    X, xb = jax.jit(kkt_t._solver)(*host)
    X_dev = len(X.sharding.device_set)
    Xr, xbr = native.blocktri_solve_batch(*(b[None] for b in host))
    ref = np.concatenate([Xr[0].ravel(), xbr[0]])
    dcr_rel = float(np.linalg.norm(
        np.concatenate([np.asarray(X).ravel(), np.asarray(xb)]) - ref
    ) / np.linalg.norm(ref))

    obj_rel = abs(float(res_t.objective) - float(res_1.objective)) / abs(float(res_1.objective))
    z_err = float(np.max(np.abs(np.asarray(res_t.z) - np.asarray(res_1.z))))
    report("4c", f"time-sharded IPM N={n}", cards=len(devs),
           solve_output_devices=X_dev, dcr_rel_err_vs_host=dcr_rel,
           status=int(res_t.status), iterations=int(res_t.iterations),
           reference_iterations=int(res_1.iterations),
           objective=float(res_t.objective), objective_rel_diff=obj_rel,
           z_max_abs_diff=z_err, lower_s=lower_s, compile_s=compile_s,
           first_run_s=first_s, warm_s=warm_s)
    check(X_dev == len(devs), f"distributed CR output spans {len(devs)} devices")
    check(dcr_rel <= F64_REL_ERR_MAX, f"distributed CR within {F64_REL_ERR_MAX} of the host oracle")
    check(int(res_t.status) == 0, "time-sharded solve status 0")
    check(obj_rel <= TIME_SHARD_OBJ_RTOL, f"objective within rtol {TIME_SHARD_OBJ_RTOL}")
    check(z_err <= TIME_SHARD_Z_ATOL, f"z within {TIME_SHARD_Z_ATOL}")


def batch_sharded_tick(devs, ref_dev, B_per_card=TICK_B, N=TICK_N, K=TICK_K, ticks=10):
    """The MPC tick with its batch sharded over `devs` (B = B_per_card per
    card), against the same instances and ticks on `ref_dev`."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    B = len(devs) * B_per_card
    mesh = Mesh(np.array(devs), ("batch",))
    _, controller = _tick_setup(B, N, K)
    ctrl = controller(mesh=mesh)
    with jax.default_device(ref_dev):
        ctrl_ref = controller(mesh=None)
        states = _cold_states(ctrl_ref, B)
    rng = np.random.default_rng(SEED)
    xs = [_x0(rng, B) for _ in range(ticks)]
    shard = NamedSharding(mesh, P("batch"))

    st = jax.device_put(states, shard)
    ms, u0s = [], []
    for x0 in xs:
        t0 = time.perf_counter()
        st, u0, _, _ = ctrl(st, jax.device_put(x0, shard))
        u0.block_until_ready()
        ms.append((time.perf_counter() - t0) * 1e3)
        u0s.append(np.asarray(u0))
    n_dev = {len(st.z.sharding.device_set), len(u0.sharding.device_set)}

    st_ref = states
    err = 0.0
    with jax.default_device(ref_dev):
        for x0, u0 in zip(xs, u0s):
            st_ref, u0_ref, _, _ = ctrl_ref(st_ref, jax.device_put(x0, ref_dev))
            err = max(err, float(np.max(np.abs(u0 - np.asarray(u0_ref)))))
    report("4c", f"batch-sharded tick B={B} N={N} K={K}", devices=sorted(n_dev),
           u0_max_abs_diff_vs_reference=err, ticks=ticks,
           first_tick_s=ms[0] / 1e3, synced_p50_ms=float(np.percentile(ms[1:], 50)))
    check(n_dev == {len(devs)}, f"tick state and u0 span {len(devs)} devices")
    check(err <= SHARDED_U0_ATOL, f"sharded u0 within {SHARDED_U0_ATOL} of the reference")


def four_cards(devs, ref_dev, time_shard_n=TIME_SHARD_N, B_per_card=TICK_B, N=TICK_N):
    """The sharded paths over a 1-D mesh of the first four devices. Each is
    compared with the same single-device program on `ref_dev`; on a GPU host
    that is the host CPU, which compiles these programs in seconds where
    XLA:GPU takes minutes, so the cards compile only the two sharded ones.
    The time-sharded solve runs first: it is the only path with collectives."""
    devs = devs[:4]
    time_sharded_ipm(devs, ref_dev, n=time_shard_n)
    batch_sharded_tick(devs, ref_dev, B_per_card=B_per_card, N=N)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths over a mesh of 4 GPUs")
    args = ap.parse_args(argv)

    if args.four_cards:
        # autotuning GEMM algorithms adds ~40% to XLA:GPU compile time
        # (IPM at N=100 on an H100: 84 s with it, 48 s without) and the
        # four-card check compares results, not speed
        os.environ["XLA_FLAGS"] = " ".join(
            [os.environ.get("XLA_FLAGS", ""), "--xla_gpu_autotune_level=0"]
        ).strip()
    else:
        # one card: JAX reserves memory on every visible GPU
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    devs = require_gpu(4 if args.four_cards else 1)

    import ctdirect_tpu  # noqa: F401  (sets x64 before any array exists)
    from ctdirect_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.four_cards:
        import jax

        four_cards(devs, jax.devices("cpu")[0])
    else:
        phase1_solves()
        docp, states = phase2_tick()
        phase3_block_solve(docp, states)

    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
