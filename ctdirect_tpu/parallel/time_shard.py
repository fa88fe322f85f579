"""Time-axis-sharded block-tridiagonal solve: distributed cyclic reduction.

This is the SURVEY.md §7 "structural analogue of context parallelism": the
collocation KKT chain (one super-block per time step) is sharded over a mesh
axis, and each cyclic-reduction level combines batched local block algebra with
ONE neighbor halo exchange (`jax.lax.ppermute` — NVLink between GPUs). After
log2(N) levels a single root block remains (owned by shard 0, then broadcast),
and back-substitution retraces the levels with the reverse halo exchanges.

The border (arrowhead) columns are handled as in the single-chip solver: every
shard accumulates its Schur contribution to the border block and a `psum`
combines them — v / boundary rows are replicated, exactly how small dense
"global" state should be treated on a mesh.

Layout contract: N_padded = P = 2^L blocks sharded evenly over D devices
(P % D == 0), block index = global position. All arrays are sharded on their
leading block axis; F/rb are replicated.

This module provides the building block `dcr_solve_shardmap` (a drop-in for
structured_kkt._cr_solve across a mesh) and `TimeShardedKKT`, a KKT operator
wrapper that runs assembly locally and the solve distributed."""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ctdirect_tpu.solver.kkt import PREC, gj_inverse, gj_solve


def _halo_from_left(x, axis_name):
    """Receive the LAST element of the left neighbor's shard (leading axis);
    shard 0 receives zeros."""
    D = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % D) for i in range(D)]
    last = x[-1:]
    recv = jax.lax.ppermute(last, axis_name, perm)
    idx = jax.lax.axis_index(axis_name)
    return jnp.where(idx == 0, jnp.zeros_like(recv), recv)


def _halo_from_right(x, axis_name):
    """Receive the FIRST element of the right neighbor's shard; last shard
    receives zeros."""
    D = jax.lax.axis_size(axis_name)
    perm = [(i, (i - 1) % D) for i in range(D)]
    first = x[:1]
    recv = jax.lax.ppermute(first, axis_name, perm)
    idx = jax.lax.axis_index(axis_name)
    return jnp.where(idx == D - 1, jnp.zeros_like(recv), recv)


def _cr_local_level(A, Bp, E, r, axis_name):
    """One cyclic-reduction level over the sharded block axis.

    A/E/r hold this shard's blocks ((L, bs, bs), ...), Bp[i] couples global
    block i to i+1 (the last device's final slot is zero). Returns the halved
    arrays (still sharded), this shard's border-Schur DELTAS (to be psum'd),
    and the per-level back-substitution data."""
    # local chain must have even length per shard (guaranteed by P % D == 0
    # and stopping distributed levels once L == 1)
    Ae, Ao = A[0::2], A[1::2]
    Bl = Bp[0::2]  # even_j -> odd_j (both local: odd is local since L even)
    Br = Bp[1::2]  # odd_j -> even_{j+1}; the right even may live on the NEXT shard
    Eo, ro = E[1::2], r[1::2]
    Ainv_o = jax.vmap(gj_inverse)(Ao)

    CL = jnp.einsum("nij,njk->nik", Bl, Ainv_o, precision=PREC)
    CR = jnp.einsum("nji,njk->nik", Br, Ainv_o, precision=PREC)

    A_new = Ae - jnp.einsum("nij,nkj->nik", CL, Bl, precision=PREC)
    E_new = E[0::2] - jnp.einsum("nij,njk->nik", CL, Eo, precision=PREC)
    r_new = r[0::2] - jnp.einsum("nij,nj->ni", CL, ro, precision=PREC)

    # right-neighbor contribution of odd_j lands on even_{j+1}: within the
    # shard for j < L/2-1; the LAST odd's contribution goes to the right
    # neighbor's first even -> halo shift
    contribA = jnp.einsum("nij,njk->nik", CR, Br, precision=PREC)
    contribE = jnp.einsum("nij,njk->nik", CR, Eo, precision=PREC)
    contribr = jnp.einsum("nij,nj->ni", CR, ro, precision=PREC)
    A_new = A_new.at[1:].add(-contribA[:-1])
    E_new = E_new.at[1:].add(-contribE[:-1])
    r_new = r_new.at[1:].add(-contribr[:-1])
    A_new = A_new.at[:1].add(-_halo_from_left(contribA, axis_name))
    E_new = E_new.at[:1].add(-_halo_from_left(contribE, axis_name))
    r_new = r_new.at[:1].add(-_halo_from_left(contribr, axis_name))

    B_new = -jnp.einsum("nij,njk->nik", CL, Br, precision=PREC)  # even_j -> even_{j+1}

    dF = -jnp.einsum("nji,njk,nkl->il", Eo, Ainv_o, Eo, precision=PREC)
    drb = -jnp.einsum("nji,njk,nk->i", Eo, Ainv_o, ro, precision=PREC)
    level = (Ainv_o, Bl, Br, Eo, ro)
    return A_new, B_new, E_new, r_new, dF, drb, level


def _cr_local_back(level, X, xb, axis_name):
    """Back-substitute one level: X are the even solutions on this shard."""
    Ainv_o, Bl, Br, Eo, ro = level
    bs = X.shape[-1]
    # x_e[j+1] for the last odd lives on the right neighbor's first slot
    x_next = jnp.concatenate([X[1:], jnp.zeros((1, bs), X.dtype)], axis=0)
    x_next = x_next.at[-1:].add(_halo_from_right(X, axis_name))
    rhs = (
        ro
        - jnp.einsum("nji,nj->ni", Bl, X, precision=PREC)
        - jnp.einsum("nij,nj->ni", Br, x_next, precision=PREC)
        - jnp.einsum("nij,j->ni", Eo, xb, precision=PREC)
    )
    x_o = jnp.einsum("nij,nj->ni", Ainv_o, rhs, precision=PREC)
    m = X.shape[0]
    return jnp.stack([X, x_o], axis=1).reshape(2 * m, bs)


def dcr_solve(A, Bp, E, r, F, rb, axis_name, local_len: int, n_dev: int):
    """Distributed cyclic reduction INSIDE a shard_map region.

    A/E/r: this shard's (local_len, ...) blocks; Bp: couplings (last global
    slot zero); F/rb replicated. local_len and n_dev are static."""
    levels = []
    L = local_len
    # phase 1: reduce until one block per device; border-Schur contributions
    # accumulate as LOCAL deltas and are psum'd once at the end of the phase
    dF_acc = jnp.zeros_like(F)
    drb_acc = jnp.zeros_like(rb)
    while L > 1:
        A, Bp, E, r, dF, drb, lev = _cr_local_level(A, Bp, E, r, axis_name)
        dF_acc = dF_acc + dF
        drb_acc = drb_acc + drb
        levels.append(lev)
        L //= 2

    # phase 2: gather the D remaining blocks everywhere and finish redundantly
    # (D is small; one all_gather then identical local math — keeps every
    # device's back-substitution data local)
    Ag = jax.lax.all_gather(A, axis_name, tiled=True)  # (D, bs, bs)
    Bg = jax.lax.all_gather(Bp, axis_name, tiled=True)
    Eg = jax.lax.all_gather(E, axis_name, tiled=True)
    rg = jax.lax.all_gather(r, axis_name, tiled=True)
    Fg = F + jax.lax.psum(dF_acc, axis_name)
    rbg = rb + jax.lax.psum(drb_acc, axis_name)

    glevels = []
    M = n_dev
    Ad, Bd, Ed, rd = Ag, Bg, Eg, rg
    while M > 1:
        Ae, Ao = Ad[0::2], Ad[1::2]
        Bl, Br = Bd[0::2], Bd[1::2]
        Eo, ro = Ed[1::2], rd[1::2]
        Ainv_o = jax.vmap(gj_inverse)(Ao)
        CL = jnp.einsum("nij,njk->nik", Bl, Ainv_o, precision=PREC)
        CR = jnp.einsum("nji,njk->nik", Br, Ainv_o, precision=PREC)
        A_new = Ae - jnp.einsum("nij,nkj->nik", CL, Bl, precision=PREC)
        A_new = A_new.at[1:].add(-jnp.einsum("nij,njk->nik", CR, Br, precision=PREC)[:-1])
        E_new = Ed[0::2] - jnp.einsum("nij,njk->nik", CL, Eo, precision=PREC)
        E_new = E_new.at[1:].add(-jnp.einsum("nij,njk->nik", CR, Eo, precision=PREC)[:-1])
        r_new = rd[0::2] - jnp.einsum("nij,nj->ni", CL, ro, precision=PREC)
        r_new = r_new.at[1:].add(-jnp.einsum("nij,nj->ni", CR, ro, precision=PREC)[:-1])
        B_new = -jnp.einsum("nij,njk->nik", CL, Br, precision=PREC)
        B_new = B_new.at[-1].set(jnp.zeros_like(B_new[-1]))
        Fg = Fg - jnp.einsum("nji,njk,nkl->il", Eo, Ainv_o, Eo, precision=PREC)
        rbg = rbg - jnp.einsum("nji,njk,nk->i", Eo, Ainv_o, ro, precision=PREC)
        glevels.append((Ainv_o, Bl, Br, Eo, ro))
        Ad, Bd, Ed, rd = A_new, B_new, E_new, r_new
        M //= 2

    bs = A.shape[-1]
    top = jnp.concatenate([Ad[0], Ed[0]], axis=1)
    bot = jnp.concatenate([Ed[0].T, Fg], axis=1)
    root = jnp.concatenate([top, bot], axis=0)
    sol = gj_solve(root, jnp.concatenate([rd[0], rbg])[:, None])[:, 0]
    Xg = sol[:bs][None]
    xb = sol[bs:]

    for Ainv_o, Bl, Br, Eo, ro in reversed(glevels):
        m = Ainv_o.shape[0]
        x_next = jnp.concatenate([Xg[1:], jnp.zeros((1, bs), Xg.dtype)], axis=0)
        rhs = (
            ro
            - jnp.einsum("nji,nj->ni", Bl, Xg, precision=PREC)
            - jnp.einsum("nij,nj->ni", Br, x_next, precision=PREC)
            - jnp.einsum("nij,j->ni", Eo, xb, precision=PREC)
        )
        x_o = jnp.einsum("nij,nj->ni", Ainv_o, rhs, precision=PREC)
        Xg = jnp.stack([Xg, x_o], axis=1).reshape(2 * m, bs)

    # each device takes its slot from the redundantly-computed global solution
    idx = jax.lax.axis_index(axis_name)
    X = jax.lax.dynamic_slice_in_dim(Xg, idx, 1, axis=0)  # (1, bs)

    # phase 3: local back-substitution down the shard levels
    for lev in reversed(levels):
        X = _cr_local_back(lev, X, xb, axis_name)
    return X, xb


def make_sharded_tridiag_solver(mesh: Mesh, axis: str, N: int, bs: int, wb: int):
    """Build solve(A, B, E, F, r, rb) -> (X, xb) running distributed CR over
    `axis` of `mesh`. N is padded to a power of two divisible by D."""
    D = mesh.shape[axis]
    P_len = 1
    while P_len < max(N, D):
        P_len *= 2
    assert P_len % D == 0
    local_len = P_len // D

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(axis), P()),
        out_specs=(P(axis), P()),
        # xb IS replicated (built from all_gather'd + psum'd data) but the
        # static replication checker cannot see through the fori_loop solves
        check_vma=False,
    )
    def _solve(A, Bp, E, F, r, rb):
        return dcr_solve(A, Bp, E, r, F, rb, axis, local_len, D)

    def solve(A, B, E, F, r, rb):
        dtype = A.dtype
        pad = P_len - N
        if pad:
            eye = jnp.broadcast_to(jnp.eye(bs, dtype=dtype), (pad, bs, bs))
            A = jnp.concatenate([A, eye], axis=0)
            E = jnp.concatenate([E, jnp.zeros((pad, bs, wb), dtype)], axis=0)
            r = jnp.concatenate([r, jnp.zeros((pad, bs), dtype)], axis=0)
        Bp = jnp.concatenate(
            [B, jnp.zeros((P_len - B.shape[0], bs, bs), dtype)], axis=0
        )
        X, xb = _solve(A, Bp, E, F, r, rb)
        return X[:N], xb

    return solve


class InsideTimeShardKKT:
    """StructuredKKT variant for use INSIDE an open shard_map region (the 2-D
    batch x time MPC mesh, parallel/mpc.py): block assembly runs replicated
    over the time axis, each device slices its shard of the chain, the solve is
    the distributed CR (ppermute/psum over `axis`), and one
    all_gather rebuilds the full step vector for the replicated IPM update.

    This is the composition the BASELINE "linear multi-host scaling" config
    names: batch data-parallel over one mesh axis, the N-long collocation chain
    over the other."""

    def __init__(self, docp, axis: str, n_dev: int, solve_dtype=None):
        from ctdirect_tpu.solver.structured_kkt import StructuredKKT

        self.inner = StructuredKKT(docp, solve_dtype=solve_dtype)
        self.axis = axis
        self.D = n_dev
        d = self.inner.d
        P_len = 1
        while P_len < max(d.N, n_dev):
            P_len *= 2
        assert P_len % n_dev == 0
        self.P_len = P_len
        self.local_len = P_len // n_dev

    def row_norms(self, z):
        return self.inner.row_norms(z)

    def prepare(self, z, lam, sf, sc):
        return self.inner.prepare(z, lam, sf, sc)

    def diag_scale(self, data):
        return self.inner.diag_scale(data)

    def gauss_newton_data(self, data):
        return self.inner.gauss_newton_data(data)

    def lsq_lambda(self, z, g, sf, sc, Drow=None):
        return self.inner.lsq_lambda(z, g, sf, sc, Drow)

    def solve(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        d = self.inner.d
        A, B, E, F, r, rb = self.inner._assemble(
            data, sigma_z, Drow, delta_w, delta_c, rz, rp
        )
        out_dtype = rz.dtype
        sdt = self.inner.solve_dtype
        if sdt is not None:
            A, B, E, F, r, rb = (x.astype(sdt) for x in (A, B, E, F, r, rb))
        dtype = A.dtype
        pad = self.P_len - d.N
        if pad:
            eye = jnp.broadcast_to(jnp.eye(d.bs, dtype=dtype), (pad, d.bs, d.bs))
            A = jnp.concatenate([A, eye], axis=0)
            E = jnp.concatenate([E, jnp.zeros((pad, d.bs, d.wb), dtype)], axis=0)
            r = jnp.concatenate([r, jnp.zeros((pad, d.bs), dtype)], axis=0)
        Bp = jnp.concatenate(
            [B, jnp.zeros((self.P_len - B.shape[0], d.bs, d.bs), dtype)], axis=0
        )
        idx = jax.lax.axis_index(self.axis)
        L = self.local_len

        def shard(x):
            return jax.lax.dynamic_slice_in_dim(x, idx * L, L, axis=0)

        X, xb = dcr_solve(
            shard(A), shard(Bp), shard(E), shard(r), F, rb, self.axis, L, self.D
        )
        X_full = jax.lax.all_gather(X, self.axis, axis=0, tiled=True)[: d.N]
        if sdt is not None:
            X_full = X_full.astype(out_dtype)
            xb = xb.astype(out_dtype)
        return self.inner._unscatter(X_full, xb)


class TimeShardedKKT:
    """KKT operator running block assembly locally and the tridiagonal solve
    distributed over a mesh time axis. Wraps a StructuredKKT."""

    def __init__(self, docp, mesh: Mesh, axis: str = "time"):
        from ctdirect_tpu.solver.structured_kkt import StructuredKKT

        self.inner = StructuredKKT(docp)
        d = self.inner.d
        self._solver = make_sharded_tridiag_solver(mesh, axis, d.N, d.bs, d.wb)

    def row_norms(self, z):
        return self.inner.row_norms(z)

    def prepare(self, z, lam, sf, sc):
        return self.inner.prepare(z, lam, sf, sc)

    def diag_scale(self, data):
        return self.inner.diag_scale(data)

    def gauss_newton_data(self, data):
        return self.inner.gauss_newton_data(data)

    def lsq_lambda(self, z, g, sf, sc, Drow=None):
        # the LSQ init/refresh solve is tiny relative to the IPM iterations:
        # run it through the local (unsharded) block elimination
        return self.inner.lsq_lambda(z, g, sf, sc, Drow)

    def solve(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        blocks = self.inner._assemble(data, sigma_z, Drow, delta_w, delta_c, rz, rp)
        A, B, E, F, r, rb = blocks
        X, xb = self._solver(A, B, E, F, r, rb)
        return self.inner._unscatter(X, xb)
