"""Lane-minor (batch-minor) small-block linear algebra + cyclic reduction.

A batched KKT solve that keeps its tiny (bs, bs) blocks in the trailing dims
— the natural result of `vmap`ping the single-instance solver — turns every
block operation into a batch of tiny matrix products. This module keeps the
batch axis LAST instead: every tensor ends in the batch axis B, block indices
live in the leading dims, and all tiny-dim contractions are unrolled into
elementwise multiply-adds over whole (..., B) slabs. The public entry point
`cr_solve` is a `jax.custom_batching.custom_vmap` wrapper around the
single-instance cyclic-reduction solve: un-batched callers get the plain
solver, while ANY `vmap` over it (batched MPC resolve, batched full IPM)
dispatches here instead of deriving the batch-major layout.

The few contractions that remain `dot_general`s (pivot-row selection, border
Schur updates) carry `precision=PREC` (kkt.py): the block solve runs in f32
under mixed precision, and a reduced-precision matmul mode would corrupt the
pivot rows themselves.

Shapes (lane-minor): A (P, bs, bs, B) diagonal blocks, Bp (P, bs, bs, B)
super-diagonal couplings (Bp[i]: block i -> i+1, last slot zero), E (P, bs,
wb, B) border coupling, F (wb, wb, B) border block, r (P, bs, B), rb (wb, B).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ctdirect_tpu.solver.kkt import PREC


# ----------------------------------------------------------------------------
# lane-minor primitives (trailing batch axis; tiny dims unrolled)
# ----------------------------------------------------------------------------


def bmm(X, Y):
    """(..., i, j, B) @ (..., j, k, B) -> (..., i, k, B), unrolled over j."""
    j = X.shape[-2]
    return sum(X[..., :, t, None, :] * Y[..., None, t, :, :] for t in range(j))


def bmm_tn(X, Y):
    """X^T @ Y: (..., j, i, B), (..., j, k, B) -> (..., i, k, B)."""
    j = X.shape[-3]
    return sum(X[..., t, :, None, :] * Y[..., t, None, :, :] for t in range(j))


def bmv(X, y):
    """(..., i, j, B) @ (..., j, B) -> (..., i, B)."""
    j = X.shape[-2]
    return sum(X[..., :, t, :] * y[..., None, t, :] for t in range(j))


def bmv_tn(X, y):
    """X^T @ y: (..., j, i, B), (..., j, B) -> (..., i, B)."""
    j = X.shape[-3]
    return sum(X[..., t, :, :] * y[..., t, None, :] for t in range(j))


def _gj_eliminate_lanes(M, n, pivot=True):
    """Gauss-Jordan on augmented (..., n, n + k, B), unrolled over the n
    columns. pivot=True: per-lane partial pivoting — the pivot row index is
    chosen independently for every (..., B) lane via argmax + onehot selects
    (pure elementwise work, no cross-lane data movement). pivot=False skips
    the argmax/swap passes (~2.5x fewer full-array traversals).

    WARNING — pivot=False is an experiment that FAILED on the production
    tick and must not be defaulted: quasi-definite blocks are factorizable
    without pivoting in exact arithmetic (Vanderbei 1995), but the warm
    resolve's H + Sigma + delta_w diagonal is ~1e-8 on unbounded
    zero-curvature state columns (min-energy double integrator), and the
    1e8 pivot amplification destroys the solve (on identical tick blocks
    the pivotless KKT error blew up while the pivoted one reached machine
    precision). Kept only for
    experiments on problems whose primal diagonal is uniformly bounded
    away from zero."""
    rows = jnp.arange(n)
    rsel = rows[(None,) * (M.ndim - 3) + (slice(None), None)]  # (..., n, 1)-ish
    for j in range(n):
        if pivot:
            colj = jnp.abs(M[..., :, j, :])  # (..., n, B)
            colj = jnp.where(rsel >= j, colj, -jnp.inf)
            p = jnp.argmax(colj, axis=-2)  # (..., B)
            oh = (p[..., None, :] == rsel).astype(M.dtype)  # (..., n, B)
            rowp = jnp.einsum(
                "...rB,...rcB->...cB", oh, M, precision=PREC
            )  # pivot row (..., c, B)
            rowj = M[..., j, :, :]
            # swap rows j and p lane-wise: row p receives row j, row j receives row p
            M = M + oh[..., :, None, :] * (rowj[..., None, :, :] - rowp[..., None, :, :])
            M = M.at[..., j, :, :].set(rowp)
        piv = M[..., j, j, :]
        row = M[..., j, :, :] / piv[..., None, :]
        colv = M[..., :, j, :].at[..., j, :].set(0.0)
        M = M - colv[..., :, None, :] * row[..., None, :, :]
        M = M.at[..., j, :, :].set(row)
    return M


def gj_inverse_lanes(A, pivot=True):
    """Gauss-Jordan inverse, lane-minor. A: (..., n, n, B)."""
    n = A.shape[-2]
    eye = jnp.eye(n, dtype=A.dtype)[..., None]
    M = jnp.concatenate([A, jnp.broadcast_to(eye, A.shape)], axis=-2)
    return _gj_eliminate_lanes(M, n, pivot)[..., :, n:, :]


def gj_solve_lanes(A, B_, pivot=True):
    """Solve A X = B lane-minor. A: (..., n, n, B), B: (..., n, k, B)."""
    n = A.shape[-2]
    M = jnp.concatenate([A, B_], axis=-2)
    return _gj_eliminate_lanes(M, n, pivot)[..., :, n:, :]


# ----------------------------------------------------------------------------
# lane-minor block cyclic reduction + arrowhead border
# ----------------------------------------------------------------------------


def cr_solve_lanes(A, Bp, E, F, r, rb, pivot=True):
    """Block cyclic reduction + border Schur, lane-minor layout (see module
    docstring for shapes). Same recurrences as structured_kkt._cr_solve.
    P = A.shape[0] must be a power of two (caller pads)."""
    P, bs, _, B = A.shape
    wb = E.shape[-2]
    dtype = A.dtype

    levels = []
    M = P
    while M > 1:
        Ae, Ao = A[0::2], A[1::2]
        Bl = Bp[0::2]  # even_j -> odd_j
        Br = Bp[1::2]  # odd_j -> even_{j+1} (last slot zero)
        Eo, ro = E[1::2], r[1::2]
        Ainv_o = gj_inverse_lanes(Ao, pivot)

        CL = bmm(Bl, Ainv_o)  # (M/2, bs, bs, B)
        CR = bmm_tn(Br, Ainv_o)  # B_r^T A_o^{-1}

        # A'[even_j]   -= CL @ Bl^T ; A'[even_{j+1}] -= CR @ Br
        A_new = Ae - bmm(CL, jnp.swapaxes(Bl, -3, -2))
        A_new = A_new.at[1:].add(-bmm(CR, Br)[:-1])
        E_new = E[0::2] - bmm(CL, Eo)
        E_new = E_new.at[1:].add(-bmm(CR, Eo)[:-1])
        r_new = r[0::2] - bmv(CL, ro)
        r_new = r_new.at[1:].add(-bmv(CR, ro)[:-1])
        B_new = -bmm(CL, Br)
        B_new = B_new.at[-1].set(jnp.zeros((bs, bs, B), dtype))

        AiE = bmm(Ainv_o, Eo)  # (M/2, bs, wb, B)
        F = F - jnp.einsum("msvB,mswB->vwB", Eo, AiE, precision=PREC)
        rb = rb - jnp.einsum("msvB,msB->vB", Eo, bmv(Ainv_o, ro), precision=PREC)

        levels.append((Ainv_o, Bl, Br, Eo, ro))
        A, Bp, E, r = A_new, B_new, E_new, r_new
        M //= 2

    # root: [[A0, E0], [E0^T, F]] [x0; xb] = [r0; rb]
    top = jnp.concatenate([A[0], E[0]], axis=-2)  # (bs, bs+wb, B)
    bot = jnp.concatenate([jnp.swapaxes(E[0], -3, -2), F], axis=-2)
    root = jnp.concatenate([top, bot], axis=-3)  # (bs+wb, bs+wb, B)
    rhs = jnp.concatenate([r[0], rb], axis=-2)[..., :, None, :]
    # the root gathers every elimination's fill-in; keep it pivoted even in
    # pivot=False mode (one small block — negligible bytes)
    sol = gj_solve_lanes(root, rhs, True)[..., :, 0, :]  # (bs+wb, B)
    X = sol[:bs][None]  # (1, bs, B)
    xb = sol[bs:]  # (wb, B)

    for Ainv_o, Bl, Br, Eo, ro in reversed(levels):
        m = Ainv_o.shape[0]
        x_e = X  # (m, bs, B)
        x_e_next = jnp.concatenate([x_e[1:], jnp.zeros((1, bs, B), dtype)], axis=0)
        rhs = (
            ro
            - bmv_tn(Bl, x_e)
            - bmv(Br, x_e_next)
            - bmv(Eo, jnp.broadcast_to(xb, (m, wb, B)))
        )
        x_o = bmv(Ainv_o, rhs)
        X = jnp.stack([x_e, x_o], axis=1).reshape(2 * m, bs, B)

    return X, xb


# ----------------------------------------------------------------------------
# custom-vmap entry point
# ----------------------------------------------------------------------------


def _make_cr_solve(pivot):
    @jax.custom_batching.custom_vmap
    def _cr(A, B_, E, F, r, rb):
        # un-batched: chain-in-lanes CR (the suite-ladder hot path) — the
        # level width rides the minor dim instead of the major dim
        # (benchmarks/solve_breakdown.py compares the two layouts)
        from ctdirect_tpu.solver.structured_kkt import _cr_solve_chain_lanes

        return _cr_solve_chain_lanes(A, B_, E, F, r, rb)

    @_cr.def_vmap
    def _cr_vmap(axis_size, in_batched, A, B_, E, F, r, rb):
        return _cr_solve_vmap_impl(axis_size, in_batched, A, B_, E, F, r, rb, pivot)

    return _cr


# Block-tridiagonal + arrowhead solve via cyclic reduction.
#
# Single instance: A (N, bs, bs), B_ (N-1, bs, bs), E (N, bs, wb),
# F (wb, wb), r (N, bs), rb (wb) -> (X (N, bs), xb (wb)).
#
# Under `jax.vmap`, dispatches to the lane-minor engine (batch axis moved
# last) instead of the default batching rule — identical math, without the
# batch of tiny per-instance matrix products. `cr_solve_nopivot` is the
# same engine with the Gauss-Jordan pivot passes elided (see
# _gj_eliminate_lanes) — an experiment for quasi-definite blocks only.
cr_solve = _make_cr_solve(True)
cr_solve_nopivot = _make_cr_solve(False)


def _cr_solve_vmap_impl(axis_size, in_batched, A, B_, E, F, r, rb, pivot):
    # move any batched leading axis to the LAST (lane) position; broadcast
    # unbatched operands across it
    def prep(x, batched):
        if batched:
            return jnp.moveaxis(x, 0, -1)
        return jnp.broadcast_to(x[..., None], x.shape + (axis_size,))

    args = [
        prep(x, b)
        for x, b in zip((A, B_, E, F, r, rb), in_batched)
    ]
    N = args[0].shape[0]
    Ax, Bx, Ex, rx = _pad_pow2_lanes(args[0], args[1], args[2], args[4])
    X, xb = cr_solve_lanes(Ax, Bx, Ex, args[3], rx, args[5], pivot)
    X = jnp.moveaxis(X[:N], -1, 0)
    xb = jnp.moveaxis(xb, -1, 0)
    return (X, xb), (True, True)


def _pad_pow2_lanes(A, B_, E, r):
    """Pad to a power of two, lane-minor layout: A (N, bs, bs, B) etc."""
    N, bs, _, B = A.shape
    dtype = A.dtype
    P = 1
    while P < N:
        P *= 2
    pad = P - N
    if pad:
        eye = jnp.broadcast_to(jnp.eye(bs, dtype=dtype)[..., None], (pad, bs, bs, B))
        A = jnp.concatenate([A, eye], axis=0)
        E = jnp.concatenate([E, jnp.zeros((pad, bs, E.shape[-2], B), dtype)], axis=0)
        r = jnp.concatenate([r, jnp.zeros((pad, bs, B), dtype)], axis=0)
    Bp = jnp.concatenate(
        [B_, jnp.zeros((P - B_.shape[0], bs, bs, B), dtype)], axis=0
    )
    return A, Bp, E, r


# ----------------------------------------------------------------------------
# single-instance cyclic reduction, LEVEL-in-lanes layout
# ----------------------------------------------------------------------------


def cr_solve_chain_lanes(A, Bp, E, F, r, rb):
    """Single-instance block cyclic reduction + border Schur with the CHAIN
    dimension minor (last).

    The plain single-instance CR (structured_kkt._cr_solve) carries its level
    arrays chain-major, (M, bs, bs): every vmapped Gauss-Jordan op then works
    on the TINY trailing (bs, bs) dims — the same shape the batched lanes
    engine exists to avoid. Here the level arrays are (bs, bs, M): the level
    width M (large at the top levels — N/2 blocks) is the minor dim, each
    block entry is one contiguous (M,) slab, and the cyclic-reduction
    neighbor couplings become shifts along that axis. Shrinking-width form:
    each level halves M (strided lane slices), so the per-level arrays stay
    exact-width; program size is log2(P) unrolled level bodies like the
    original pre-r4 CR, but each body is ~10 lane-wide ops instead of ~100
    batch-major ones, so the compiled program is small.

    Shapes: A (bs, bs, P), Bp (bs, bs, P) (Bp[..., i]: block i -> i+1, last
    slot zero), E (bs, wb, P), F (wb, wb), r (bs, P), rb (wb). P must be a
    power of two (caller pads; padding = identity A, zero B/E/r).
    Returns X (P, bs), xb (wb)."""
    bs = A.shape[0]
    wb = E.shape[1]
    P = A.shape[-1]
    dtype = A.dtype

    levels = []
    M = P
    while M > 1:
        Ae, Ao = A[..., 0::2], A[..., 1::2]
        Bl = Bp[..., 0::2]  # even_j -> odd_j
        Br = Bp[..., 1::2]  # odd_j -> even_{j+1} (last slot zero)
        Eo, ro = E[..., 1::2], r[..., 1::2]
        Ainv_o = gj_inverse_lanes(Ao)

        CL = bmm(Bl, Ainv_o)  # (bs, bs, M/2)
        CR = bmm_tn(Br, Ainv_o)  # B_r^T A_o^{-1}

        half = M // 2
        A_new = Ae - bmm(CL, jnp.swapaxes(Bl, 0, 1))
        contrib = bmm(CR, Br)  # lands on even_{j+1}
        A_new = A_new.at[..., 1:].add(-contrib[..., : half - 1])
        E_new = E[..., 0::2] - bmm(CL, Eo)
        E_contrib = bmm(CR, Eo)
        E_new = E_new.at[..., 1:].add(-E_contrib[..., : half - 1])
        r_new = r[..., 0::2] - bmv(CL, ro)
        r_contrib = bmv(CR, ro)
        r_new = r_new.at[..., 1:].add(-r_contrib[..., : half - 1])
        B_new = -bmm(CL, Br)
        if half >= 1:
            B_new = B_new.at[..., half - 1].set(jnp.zeros((bs, bs), dtype))

        F = F - jnp.einsum("jiM,jkM->ik", Eo, bmm(Ainv_o, Eo), precision=PREC)
        rb = rb - jnp.einsum("jiM,jM->i", Eo, bmv(Ainv_o, ro), precision=PREC)

        levels.append((Ainv_o, Bl, Br, Eo, ro))
        A, Bp, E, r = A_new, B_new, E_new, r_new
        M = half

    # root: [[A0, E0], [E0^T, F]] [x0; xb] = [r0; rb] — plain dense solve
    A0 = A[..., 0]
    E0 = E[..., 0]
    r0 = r[..., 0]
    top = jnp.concatenate([A0, E0], axis=1)
    bot = jnp.concatenate([E0.T, F], axis=1)
    root = jnp.concatenate([top, bot], axis=0)
    from ctdirect_tpu.solver.kkt import gj_solve

    sol = gj_solve(root, jnp.concatenate([r0, rb])[:, None])[:, 0]
    xb = sol[bs:]
    x = sol[:bs][:, None]  # (bs, 1) — active chain of width 1

    for Ainv_o, Bl, Br, Eo, ro in reversed(levels):
        m = Ainv_o.shape[-1]
        x_e = x  # (bs, m)
        x_e_next = jnp.concatenate(
            [x_e[..., 1:], jnp.zeros((bs, 1), dtype)], axis=-1
        )
        rhs = (
            ro
            - bmv_tn(Bl, x_e)
            - bmv(Br, x_e_next)
            - jnp.einsum("iwM,w->iM", Eo, xb, precision=PREC)
        )
        x_o = bmv(Ainv_o, rhs)
        x = jnp.stack([x_e, x_o], axis=-1).reshape(bs, 2 * m)

    return x.T, xb  # (P, bs), (wb,)
