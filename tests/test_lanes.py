"""Lane-minor (batch-last) block linear algebra and cyclic reduction
(solver/lanes.py): agreement with the single-instance reference path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ctdirect_tpu.solver import lanes
from ctdirect_tpu.solver.kkt import gj_inverse
from ctdirect_tpu.solver.structured_kkt import _cr_solve


def _rand_chain(rng, N, bs, wb, B=None):
    """Random well-conditioned block-tridiagonal + arrowhead system; optional
    leading batch axis."""
    lead = () if B is None else (B,)
    A = rng.standard_normal(lead + (N, bs, bs)) + 6.0 * np.eye(bs)
    A = A + np.swapaxes(A, -1, -2)  # symmetric-ish, diag dominant
    Bc = 0.3 * rng.standard_normal(lead + (N - 1, bs, bs))
    E = 0.3 * rng.standard_normal(lead + (N, bs, wb))
    F = rng.standard_normal(lead + (wb, wb)) + 6.0 * np.eye(wb)
    F = F + np.swapaxes(F, -1, -2)
    r = rng.standard_normal(lead + (N, bs))
    rb = rng.standard_normal(lead + (wb,))
    return tuple(jnp.asarray(x) for x in (A, Bc, E, F, r, rb))


def test_gj_inverse_lanes_matches_reference():
    rng = np.random.default_rng(0)
    m, n, B = 7, 5, 9
    A = rng.standard_normal((m, n, n, B)) + 4.0 * np.eye(n)[None, :, :, None]
    I1 = lanes.gj_inverse_lanes(jnp.asarray(A))
    I2 = jax.vmap(jax.vmap(gj_inverse, in_axes=-1, out_axes=-1))(jnp.asarray(A))
    np.testing.assert_allclose(np.asarray(I1), np.asarray(I2), rtol=1e-9, atol=1e-9)


def test_gj_inverse_lanes_pivots():
    # a structurally-zero leading diagonal entry forces a row swap per lane
    A = np.array([[0.0, 1.0], [1.0, 1e-3]])
    Ab = np.broadcast_to(A[None, :, :, None], (3, 2, 2, 4)).copy()
    I = np.asarray(lanes.gj_inverse_lanes(jnp.asarray(Ab)))
    np.testing.assert_allclose(
        I[1, :, :, 2], np.linalg.inv(A), rtol=1e-12, atol=1e-12
    )


@pytest.mark.parametrize("N", [1, 2, 5, 8, 13])
def test_cr_solve_vmap_matches_per_instance(N):
    """vmap(cr_solve) (lane-minor engine) == per-instance _cr_solve."""
    rng = np.random.default_rng(N)
    bs, wb, B = 4, 3, 6
    batched = _rand_chain(rng, N, bs, wb, B=B)

    X1, xb1 = jax.jit(jax.vmap(lanes.cr_solve))(*batched)
    X2, xb2 = jax.vmap(_cr_solve)(*batched)
    np.testing.assert_allclose(np.asarray(X1), np.asarray(X2), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(xb1), np.asarray(xb2), rtol=1e-8, atol=1e-8)


def test_cr_solve_unbatched_passthrough():
    rng = np.random.default_rng(42)
    args = _rand_chain(rng, 6, 3, 2)
    X1, xb1 = jax.jit(lanes.cr_solve)(*args)
    X2, xb2 = _cr_solve(*args)
    np.testing.assert_allclose(np.asarray(X1), np.asarray(X2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(xb1), np.asarray(xb2), rtol=1e-12)


def test_cr_solve_vmap_residual():
    """The batched solution actually solves the block system."""
    rng = np.random.default_rng(7)
    N, bs, wb, B = 8, 3, 2, 5
    A, Bc, E, F, r, rb = _rand_chain(rng, N, bs, wb, B=B)
    X, xb = jax.vmap(lanes.cr_solve)(A, Bc, E, F, r, rb)
    X, xb = np.asarray(X), np.asarray(xb)
    A, Bc, E, F, r, rb = map(np.asarray, (A, Bc, E, F, r, rb))
    for b in range(B):
        # dense reconstruction
        n_tot = N * bs + wb
        K = np.zeros((n_tot, n_tot))
        rhs = np.zeros(n_tot)
        for i in range(N):
            sl = slice(i * bs, (i + 1) * bs)
            K[sl, sl] = A[b, i]
            K[sl, N * bs :] = E[b, i]
            K[N * bs :, sl] = E[b, i].T
            rhs[sl] = r[b, i]
            if i < N - 1:
                sl2 = slice((i + 1) * bs, (i + 2) * bs)
                K[sl, sl2] = Bc[b, i]
                K[sl2, sl] = Bc[b, i].T
        K[N * bs :, N * bs :] = F[b]
        rhs[N * bs :] = rb[b]
        sol = np.concatenate([X[b].reshape(-1), xb[b]])
        np.testing.assert_allclose(K @ sol, rhs, rtol=1e-8, atol=1e-8)


def test_mpc_resolve_uses_lane_path():
    """End-to-end: the batched MPC tick (vmapped resolve over StructuredKKT
    'cr') produces the same controls as the 'scan' (non-custom-vmap) path."""
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.ipm import IPMOptions

    prob = get_problem("double_integrator_minenergy")
    docp = transcribe(prob.ocp, grid_size=12, scheme="trapeze")
    B = 3
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(0.05 * rng.standard_normal((B, 2)))

    outs = {}
    for algo in ("cr", "scan"):
        ctrl = MPCController(
            docp, x0_boundary_rows=[0, 1], resolve_iters=2, kkt_algorithm=algo
        )
        warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
        states = broadcast_state(warm, B)
        _, u0, kkt_err, viol = ctrl(states, x0)
        outs[algo] = np.asarray(u0)
        assert np.all(np.isfinite(outs[algo]))
    np.testing.assert_allclose(outs["cr"], outs["scan"], rtol=1e-6, atol=1e-8)


@pytest.mark.slow  # ~70 s of compiles on the 2-core CI box (fast-tier budget)
def test_mixed_precision_resolve_matches_f64():
    """solve_dtype=f32 (mixed-precision block solve inside f64 Newton) must
    reach the same warm-resolve fixed point: the f32 direction error (~1e-7
    relative) contracts the KKT error per iteration, so after 2 ticks x 3
    iterations both precisions sit at machine-level KKT (measured 1.6e-15
    on CPU)."""
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.ipm import IPMOptions

    prob = get_problem("double_integrator_minenergy")
    docp = transcribe(prob.ocp, grid_size=24, scheme="trapeze")
    B = 4
    x0 = jnp.asarray(0.03 * np.random.default_rng(0).standard_normal((B, 2)))
    outs = {}
    warm = None  # ONE full-IPM cold start serves both precisions (the f32
    # variant seeds from the same state; compiling a second full IPM program
    # doubled this test's CI cost for no coverage)
    for sdt in (None, jnp.float32):
        ctrl = MPCController(
            docp,
            x0_boundary_rows=[0, 1],
            resolve_iters=3,
            kkt_algorithm="cr",
            kkt_solve_dtype=sdt,
        )
        if warm is None:
            warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
        states = broadcast_state(warm, B)
        states, u0, kkt_err, viol = ctrl(states, x0)
        states, u0, kkt_err, viol = ctrl(states, x0)
        assert float(jnp.max(kkt_err)) < 1e-10, (sdt, float(jnp.max(kkt_err)))
        outs[repr(sdt)] = np.asarray(u0)
    np.testing.assert_allclose(outs["None"], outs[repr(jnp.float32)], atol=1e-9)


def test_resolve_loop_scan_matches_unroll():
    """loop="scan" (compile-size variant) computes the identical iteration."""
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.ipm import IPMOptions

    prob = get_problem("double_integrator_minenergy")
    docp = transcribe(prob.ocp, grid_size=12, scheme="trapeze")
    B = 3
    x0 = jnp.asarray(0.05 * np.random.default_rng(1).standard_normal((B, 2)))
    outs = {}
    for lp in ("unroll", "scan"):
        ctrl = MPCController(
            docp,
            x0_boundary_rows=[0, 1],
            resolve_iters=2,
            kkt_algorithm="cr",
            resolve_loop=lp,
        )
        warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
        states = broadcast_state(warm, B)
        _, u0, _, _ = ctrl(states, x0)
        outs[lp] = np.asarray(u0)
    np.testing.assert_allclose(outs["unroll"], outs["scan"], rtol=1e-12, atol=1e-12)


def _lane_chain(P, bs, wb, B, seed):
    """Random well-conditioned padded block chain in lane-minor f32 layout.

    A and F are SYMMETRIC: the CR recurrences exploit the KKT system's
    symmetry (the reduced even-even subdiagonal is taken as the transpose of
    -Bl A_o^{-1} Br, which requires A_o = A_o^T). Couplings Bp/E are general."""
    rng = np.random.default_rng(seed)

    def rnd(*s):
        return rng.standard_normal(s).astype(np.float32)

    A = rnd(P, bs, bs, B) * 0.3
    A = A + np.swapaxes(A, 1, 2) + np.eye(bs, dtype=np.float32)[None, :, :, None] * 4.0
    Bp = rnd(P, bs, bs, B) * 0.3
    Bp[-1] = 0.0
    E = rnd(P, bs, wb, B) * 0.2
    F = rnd(wb, wb, B) * 0.2
    F = F + np.swapaxes(F, 0, 1) + np.eye(wb, dtype=np.float32)[:, :, None] * (4.0 + P)
    r = rnd(P, bs, B)
    rb = rnd(wb, B)
    return A, Bp, E, F, r, rb


@pytest.mark.parametrize("P,bs,wb,B", [(16, 4, 3, 128), (13, 5, 7, 9)])
def test_cr_solve_vmap_f32_solves_the_system(P, bs, wb, B):
    """Independent oracle: reassemble the dense block-tridiagonal + arrowhead
    system for a few instances and check the normwise backward error of the
    batched f32 solve (vmap(cr_solve) -> the lane-minor engine)."""
    A, Bp, E, F, r, rb = _lane_chain(P, bs, wb, B, seed=3)
    # instance-major inputs, the layout vmap hands the custom_vmap rule
    args = (A, Bp[:-1], E, F, r, rb)
    X, xb = jax.jit(jax.vmap(lanes.cr_solve))(
        *(jnp.asarray(np.moveaxis(a, -1, 0)) for a in args)
    )
    assert X.dtype == jnp.float32
    X, xb = np.asarray(X, dtype=np.float64), np.asarray(xb, dtype=np.float64)
    A, Bp, E, F, r, rb = (np.asarray(x, dtype=np.float64) for x in (A, Bp, E, F, r, rb))
    n = P * bs + wb
    for lane in (0, B // 2, B - 1):
        K = np.zeros((n, n))
        rhs = np.zeros(n)
        for i in range(P):
            sl = slice(i * bs, (i + 1) * bs)
            K[sl, sl] = A[i, :, :, lane]
            if i + 1 < P:
                sl1 = slice((i + 1) * bs, (i + 2) * bs)
                K[sl, sl1] = Bp[i, :, :, lane]
                K[sl1, sl] = Bp[i, :, :, lane].T
            K[sl, P * bs :] = E[i, :, :, lane]
            K[P * bs :, sl] = E[i, :, :, lane].T
            rhs[sl] = r[i, :, lane]
        K[P * bs :, P * bs :] = F[:, :, lane]
        rhs[P * bs :] = rb[:, lane]
        x = np.concatenate([X[lane].reshape(-1), xb[lane]])
        # |Kx - b| / (|K||x| + |b|); the solve runs in f32, so ~cond * eps_f32
        resid = np.abs(K @ x - rhs).max()
        scale = np.abs(K).sum(axis=1).max() * np.abs(x).max() + np.abs(rhs).max()
        assert resid / scale < 2e-4, (lane, resid, scale)


def test_batched_f32_solve_dispatches_to_lanes_engine(monkeypatch):
    """With x64 off, vmap(cr_solve) on f32 blocks runs the lane-minor XLA
    engine (there is no other batched kernel to choose)."""
    calls = []
    real = lanes.cr_solve_lanes

    def spy(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(lanes, "cr_solve_lanes", spy)
    with jax.enable_x64(False):
        rng = np.random.default_rng(5)
        batched = tuple(
            jnp.asarray(x, jnp.float32) for x in _rand_chain(rng, 8, 4, 3, B=128)
        )
        X, xb = jax.vmap(lanes.cr_solve)(*batched)
        X_ref, xb_ref = jax.vmap(_cr_solve)(*batched)
    assert calls == [jnp.float32]
    assert X.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(X), np.asarray(X_ref), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(xb), np.asarray(xb_ref), rtol=1e-3, atol=1e-4)
