"""Structured KKT operator: block-tridiagonal + arrowhead, solved in O(N).

This replaces the reference stack's general sparse direct
solvers (MUMPS/umfpack/cuDSS — SURVEY.md §2.2): the condensed IPM system of a
collocation DOCP is, after interleaving primal step-blocks with their
constraint multipliers, a symmetric block-TRIDIAGONAL matrix with a dense
ARROWHEAD border:

    [ A_1  B_1              E_1 ] [x_1]   [r_1]
    [ B_1' A_2  B_2         E_2 ] [x_2]   [r_2]
    [          ...          ... ] [...] = [...]
    [            B_{N-1}' A_N E_N] [x_N]   [r_N]
    [ E_1' E_2' ...  E_N'     F ] [xb ]   [rb ]

    x_i = [dw_i; dlam_i]   (step variables + step constraint multipliers)
    xb  = [d_tail; dv; dlam_finalpath; dlam_boundary]

Blocks come from vmapped per-step Hessians/Jacobians of the scheme's LOCAL
residual/cost forms (schemes.local_residual/local_cost) — there is no sparsity
detection, no coloring, and no hand-maintained pattern (the reference spends
~40% of each scheme file on those, e.g. trapeze.jl:149–303). The border carries
v (free time couples every step — SURVEY.md §7.3.2), the tail state, and the
final-path/boundary multiplier rows.

The solve is a forward block elimination with border Schur complement and a
backward substitution (two lax.scans), or block cyclic reduction. Block
inverses use pivoted Gauss-Jordan (kkt.py) — pure arithmetic that vmaps
across problem instances. The time-axis-sharded distributed cyclic reduction
builds on the same block data (parallel/time_shard.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ctdirect_tpu.solver.kkt import PREC, gj_inverse, gj_solve
from ctdirect_tpu.transcription.docp import DOCP


class _Dims(NamedTuple):
    N: int
    bw: int  # step primal width
    cw: int  # step constraint rows
    iw: int  # interface width (tail width): n (+m for trapeze)
    q: int
    n: int
    npath: int
    nb: int
    bs: int  # super-block = bw + cw
    wb: int  # border width = iw + q + npath + nb


class StructuredKKT:
    """KKT operator exploiting the DOCP's step structure (see solver/kkt.py
    for the operator protocol)."""

    def __init__(self, docp: DOCP, algorithm: str = "scan", solve_dtype=None,
                 refine: int = 0, equilibrate: Optional[bool] = None,
                 pivot: bool = True, assemble_dtype=None):
        """algorithm: "scan" (sequential block elimination, O(N) depth) or
        "cr" (block cyclic reduction, O(log N) depth — the basis of the
        batched lane-minor engine and of the time-axis-sharded solver).

        solve_dtype: optional lower precision (jnp.float32) for the BLOCK
        SOLVE only — assembly, residuals and the applied step stay f64, so
        this is inexact Newton with relative direction error eta ~ cond*1e-7:
        each outer iteration still contracts the KKT error by ~eta. Every
        contraction of the solve carries precision=PREC (kkt.py), so the f32
        solve is true f32, never a reduced matmul mode. Leave None for
        full-precision directions.

        refine: f64 iterative-refinement sweeps around the reduced-precision
        solve (classic mixed-precision: residual r - K@x in f64 on the
        assembled blocks, correction solved in solve_dtype). Each sweep costs
        one extra reduced-precision solve and recovers ~7 digits of direction
        accuracy; needed when cond(K) ~ N^2 outgrows bare-f32 directions
        (measured: robbins trapeze N=2500 takes 280 IPM iterations with the
        bare f32 solve vs 47 with f64-quality directions). No effect when
        solve_dtype is None."""
        if algorithm not in ("scan", "cr"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.algorithm = algorithm
        self.solve_dtype = solve_dtype
        self.refine = int(refine)
        # symmetric Ruiz row/col scaling of the assembled system before the
        # block solve (K' = D K D, d_i = rownorm^{-1/2}, f64, once per
        # assemble): compresses the IPM's Sigma ~ mu/gap^2 diagonal spread so
        # the f32 factorization + f64 refinement see a well-scaled matrix —
        # what lets the singular-arc fixtures (goddard family, jackson) run
        # mixed-precision instead of full f64. Default: on iff reduced solve.
        self.equilibrate = (solve_dtype is not None) if equilibrate is None else bool(equilibrate)
        # pivot=False elides the per-column pivot passes of the lane-minor
        # Gauss-Jordan under vmap — an experiment that FAILED on the
        # production tick (1e-8 regularization pivots on zero-curvature
        # columns; see lanes._gj_eliminate_lanes WARNING). Keep True.
        self.pivot = bool(pivot)
        # assemble_dtype=jnp.float32: run prepare (the vmapped per-step
        # Hessians/Jacobians) AND assembly in f32 end-to-end — for the warm
        # RTI resolve tick, whose Newton residuals stay f64 while the
        # direction is inexact anyway (solve_dtype=f32). Halves the bytes
        # of the tick's biggest producers; whether that wins is not measured
        # on the GPU yet. Do NOT use for the full IPM: its curvature retry logic
        # and restoration want f64 block data. None = inherit input dtype.
        self.assemble_dtype = assemble_dtype
        self.docp = docp
        d = _Dims(
            N=docp.N,
            bw=docp.bw,
            cw=docp.cw,
            iw=docp.tail_w,
            q=docp.q,
            n=docp.n,
            npath=docp.n_path,
            nb=docp.n_boundary,
            bs=docp.bw + docp.cw,
            wb=docp.tail_w + docp.q + docp.n_path + docp.n_boundary,
        )
        self.d = d
        self.snorm = np.asarray(docp._snorm)  # (N+1,) normalized grid
        scheme = docp.scheme
        fns = docp.fns
        ocp = docp.ocp
        n, m, s, cs = docp.n, docp.m, docp.s, docp.cs

        def times(si, sip1, v):
            ts = ocp.time
            t0 = ts.t0 if not ts.free_t0 else v[ts.t0_index]
            tf = ts.tf if not ts.free_tf else v[ts.tf_index]
            return t0 + si * (tf - t0), t0 + sip1 * (tf - t0)

        def split_w(w):
            x = w[:n]
            U = w[n : n + cs * m].reshape(cs, m)
            K = w[n + cs * m :].reshape(s, n) if s > 0 else None
            return x, U, K

        def split_y(y):
            xn = y[:n]
            un = y[n:] if scheme.u_at_nodes else None
            return xn, un

        # ---- per-step local constraint rows [defect | stages | path(t_i)] ----
        def cons_step(si, sip1, w, y, v):
            ti, tip1 = times(si, sip1, v)
            x, U, K = split_w(w)
            xn, un = split_y(y)
            res = scheme.local_residual(fns, ti, tip1, x, U, K, xn, un, v)
            if docp._path is not None:
                u_node = scheme.local_node_control(U)
                res = jnp.concatenate([res, docp._path(ti, x, u_node, v)])
            return res

        def cost_step(si, sip1, w, y, v):
            if fns.lagrange is None:
                return jnp.asarray(0.0, w.dtype)
            ti, tip1 = times(si, sip1, v)
            x, U, K = split_w(w)
            xn, un = split_y(y)
            return scheme.local_cost(fns, ti, tip1, x, U, K, xn, un, v)

        # ---- border rows: final-node path, boundary; border cost: Mayer ----
        def final_node_control(wN, tail):
            if scheme.u_at_nodes:  # trapeze: control stored in the tail
                return tail[n:]
            _, U, _ = split_w(wN)
            return scheme.local_node_control(U)  # node N+1 reads step N's control

        def cons_fp(wN, tail, v):
            ts = ocp.time
            tf = ts.tf if not ts.free_tf else v[ts.tf_index]
            return docp._path(tf, tail[:n], final_node_control(wN, tail), v)

        def cons_bc(x0, tail, v):
            return docp._boundary(x0, tail[:n], v)

        def cost_border(x0, wN, tail, v):
            if docp._mayer is None:
                return jnp.asarray(0.0, tail.dtype)
            g = docp._mayer(x0, tail[:n], v)
            return -g if ocp.maximize else g

        self._cons_step = cons_step
        self._cost_step = cost_step
        self._cons_fp = cons_fp if docp._path is not None else None
        self._cons_bc = cons_bc if docp._boundary is not None else None
        self._cost_border = cost_border
        # sign of the minimized objective (docp.nlp_objective = ±objective);
        # local cost forms are in user sense, so flip for max problems
        self._obj_sign = -1.0 if ocp.maximize else 1.0

    # ------------------------------------------------------------------
    # flat-vector split/merge
    # ------------------------------------------------------------------
    def _split_z(self, z):
        d = self.d
        Wm = z[: d.N * d.bw].reshape(d.N, d.bw)
        tail = z[d.N * d.bw : d.N * d.bw + d.iw]
        v = z[d.N * d.bw + d.iw :]
        # interface rows: y_i = first iw entries of the NEXT block; y_{N-1} = tail
        Y = jnp.concatenate([Wm[1:, : d.iw], tail[None, :]], axis=0)  # (N, iw)
        return Wm, Y, tail, v

    def _split_lam(self, lam):
        d = self.d
        lam_steps = lam[: d.N * d.cw].reshape(d.N, d.cw)
        lam_fp = lam[d.N * d.cw : d.N * d.cw + d.npath]
        lam_bc = lam[d.N * d.cw + d.npath :]
        return lam_steps, lam_fp, lam_bc

    # ------------------------------------------------------------------
    # operator protocol
    # ------------------------------------------------------------------
    def row_norms(self, z):
        """Unscaled |J| row-inf-norms from the block jacobians."""
        d = self.d
        Wm, Y, tail, v = self._split_z(z)
        si = jnp.asarray(self.snorm[:-1])
        sip1 = jnp.asarray(self.snorm[1:])

        def one(si_, sip1_, w, y):
            Jl = jax.jacfwd(
                lambda arg: self._cons_step(
                    si_, sip1_, arg[: d.bw], arg[d.bw : d.bw + d.iw], arg[d.bw + d.iw :]
                )
            )(jnp.concatenate([w, y, v]))
            return jnp.max(jnp.abs(Jl), axis=1)

        rows = jax.vmap(one)(si, sip1, Wm, Y).reshape(-1)
        parts = [rows]
        if self._cons_fp is not None:
            Jfp = jax.jacfwd(
                lambda arg: self._cons_fp(
                    arg[: d.bw], arg[d.bw : d.bw + d.iw], arg[d.bw + d.iw :]
                )
            )(jnp.concatenate([Wm[-1], tail, v]))
            parts.append(jnp.max(jnp.abs(Jfp), axis=1))
        if self._cons_bc is not None:
            Jbc = jax.jacfwd(
                lambda arg: self._cons_bc(
                    arg[: d.n], arg[d.n : d.n + d.iw], arg[d.n + d.iw :]
                )
            )(jnp.concatenate([Wm[0][: d.n], tail, v]))
            parts.append(jnp.max(jnp.abs(Jbc), axis=1))
        return jnp.concatenate(parts)

    def prepare(self, z, lam, sf, sc):
        """Per-step scaled Lagrangian Hessians + constraint Jacobians."""
        d = self.d
        if self.assemble_dtype is not None:
            z = z.astype(self.assemble_dtype)
            lam = lam.astype(self.assemble_dtype)
            sf = jnp.asarray(sf, self.assemble_dtype)
            sc = jnp.asarray(sc, self.assemble_dtype)
        Wm, Y, tail, v = self._split_z(z)
        lam_steps, lam_fp, lam_bc = self._split_lam(lam)
        sc_steps, sc_fp, sc_bc = self._split_lam(sc)
        # match the working dtype (an f64 grid constant would silently
        # promote the whole AD pass back to f64 under assemble_dtype=f32)
        si = jnp.asarray(self.snorm[:-1], z.dtype)
        sip1 = jnp.asarray(self.snorm[1:], z.dtype)
        sgn = self._obj_sign

        D = d.bw + d.iw + d.q

        def step_data(si_, sip1_, w, y, lam_i, sc_i):
            arg = jnp.concatenate([w, y, v])

            def cons(a):
                return self._cons_step(si_, sip1_, a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :])

            def lag(a):
                cost = self._cost_step(
                    si_, sip1_, a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :]
                )
                return sgn * sf * cost + jnp.dot(sc_i * lam_i, cons(a))

            H = jax.hessian(lag)(arg)  # (D, D)
            J = sc_i[:, None] * jax.jacfwd(cons)(arg)  # (cw, D)
            return H, J

        Hloc, Jloc = jax.vmap(step_data)(si, sip1, Wm, Y, lam_steps, sc_steps)

        # border: hessian of sf*mayer + lam_fp' fp + lam_bc' bc over (x0,wN,tail,v)
        Db = d.n + d.bw + d.iw + d.q
        argb = jnp.concatenate([Wm[0][: d.n], Wm[-1], tail, v])

        def border_lag(a):
            x0 = a[: d.n]
            wN = a[d.n : d.n + d.bw]
            tl = a[d.n + d.bw : d.n + d.bw + d.iw]
            vv = a[d.n + d.bw + d.iw :]
            val = sf * self._cost_border(x0, wN, tl, vv)
            if self._cons_fp is not None:
                val = val + jnp.dot(sc_fp * lam_fp, self._cons_fp(wN, tl, vv))
            if self._cons_bc is not None:
                val = val + jnp.dot(sc_bc * lam_bc, self._cons_bc(x0, tl, vv))
            return val

        Hb = jax.hessian(border_lag)(argb)  # (Db, Db)

        if self._cons_fp is not None:
            Jfp = sc_fp[:, None] * jax.jacfwd(
                lambda a: self._cons_fp(a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :])
            )(jnp.concatenate([Wm[-1], tail, v]))  # (npath, bw+iw+q)
        else:
            Jfp = jnp.zeros((0, d.bw + d.iw + d.q), z.dtype)
        if self._cons_bc is not None:
            Jbc = sc_bc[:, None] * jax.jacfwd(
                lambda a: self._cons_bc(a[: d.n], a[d.n : d.n + d.iw], a[d.n + d.iw :])
            )(jnp.concatenate([Wm[0][: d.n], tail, v]))  # (nb, n+iw+q)
        else:
            Jbc = jnp.zeros((0, d.n + d.iw + d.q), z.dtype)

        return dict(Hloc=Hloc, Jloc=Jloc, Hb=Hb, Jfp=Jfp, Jbc=Jbc)

    def prepare_jac_only(self, z, sc):
        """prepare() minus the Lagrangian Hessians (zeros instead): the
        Jacobian-only data the LSQ multiplier init needs. Skips the vmapped
        per-step jax.hessian pass entirely — prepare() at sf=0, lam=0 would
        still trace and execute it (sf is a traced value, XLA cannot DCE)."""
        d = self.d
        Wm, Y, tail, v = self._split_z(z)
        sc_steps, sc_fp, sc_bc = self._split_lam(sc)
        si = jnp.asarray(self.snorm[:-1])
        sip1 = jnp.asarray(self.snorm[1:])
        D = d.bw + d.iw + d.q

        def step_jac(si_, sip1_, w, y, sc_i):
            def cons(a):
                return self._cons_step(
                    si_, sip1_, a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :]
                )

            return sc_i[:, None] * jax.jacfwd(cons)(jnp.concatenate([w, y, v]))

        Jloc = jax.vmap(step_jac)(si, sip1, Wm, Y, sc_steps)
        Db = d.n + d.bw + d.iw + d.q
        if self._cons_fp is not None:
            Jfp = sc_fp[:, None] * jax.jacfwd(
                lambda a: self._cons_fp(a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :])
            )(jnp.concatenate([Wm[-1], tail, v]))
        else:
            Jfp = jnp.zeros((0, d.bw + d.iw + d.q), z.dtype)
        if self._cons_bc is not None:
            Jbc = sc_bc[:, None] * jax.jacfwd(
                lambda a: self._cons_bc(a[: d.n], a[d.n : d.n + d.iw], a[d.n + d.iw :])
            )(jnp.concatenate([Wm[0][: d.n], tail, v]))
        else:
            Jbc = jnp.zeros((0, d.n + d.iw + d.q), z.dtype)
        return dict(
            Hloc=jnp.zeros((d.N, D, D), z.dtype),
            Jloc=Jloc,
            Hb=jnp.zeros((Db, Db), z.dtype),
            Jfp=Jfp,
            Jbc=Jbc,
        )

    def diag_scale(self, data):
        return 1.0 + jnp.max(jnp.abs(jnp.diagonal(data["Hloc"], axis1=-2, axis2=-1)))

    def gauss_newton_data(self, data):
        """Zero-Hessian view of prepared data (same scaled Jacobians) — the
        Gauss-Newton system of the restoration step, without re-running the
        vmapped per-step jax.hessian at the same point."""
        return dict(
            Hloc=jnp.zeros_like(data["Hloc"]),
            Jloc=data["Jloc"],
            Hb=jnp.zeros_like(data["Hb"]),
            Jfp=data["Jfp"],
            Jbc=data["Jbc"],
        )

    def lsq_lambda(self, z, g, sf, sc, Drow=None):
        """Least-squares multiplier init on the structured path: solving the
        block system [I J~^T; J~ -(D + eps) I][dz; lam] = [-g; 0] yields
        lam = -(J~ J~^T + D + eps)^-1 J~ g — the same estimate DenseKKT
        computes (kkt.py), but via the instance's own algorithm/precision
        (an initial GUESS, which the reduced-precision solve serves as well
        as an f64 one). The identity Hessian enters through sigma_z = 1;
        optional Drow damps selected rows (dual refresh damps ineq rows)."""
        dtype = z.dtype
        nz = self.docp.nz
        nc = self.docp.nc
        data = self.prepare_jac_only(z, sc)
        blocks = self._assemble(
            data,
            jnp.ones((nz,), dtype),  # sigma_z = 1 -> unit Hessian block
            jnp.zeros((nc,), dtype) if Drow is None else Drow,
            jnp.asarray(0.0, dtype),
            jnp.asarray(1e-8, dtype),  # eps regularization on the J J^T block
            g,
            jnp.zeros((nc,), dtype),
        )
        if self.solve_dtype is not None:
            blocks = tuple(b.astype(self.solve_dtype) for b in blocks)
        if self.algorithm == "cr":
            X, xb = _cr_solve(*blocks)
        else:
            X, xb = _scan_solve(*blocks)
        _, lam = self._unscatter(X.astype(dtype), xb.astype(dtype))
        return lam

    # ------------------------------------------------------------------
    # assembly + solve
    # ------------------------------------------------------------------
    def solve(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        out_dtype = rz.dtype
        if self.assemble_dtype is not None:
            adt = self.assemble_dtype
            sigma_z = sigma_z.astype(adt)
            Drow = Drow.astype(adt)
            delta_w = jnp.asarray(delta_w, adt)
            delta_c = jnp.asarray(delta_c, adt)
            rz = rz.astype(adt)
            rp = rp.astype(adt)
        A, B, E, F, r, rb = self._assemble(
            data, sigma_z, Drow, delta_w, delta_c, rz, rp
        )

        if self.equilibrate:
            # symmetric Ruiz scaling K' = D K D, d_i = rownorm^{-1/2}, done in
            # f64 on the assembled blocks. The IPM diagonals (Sigma ~ mu/gap^2
            # on active bounds) put ~16 decades into the spectrum; this
            # compresses it to what an f32 factorization + f64 refinement
            # handles (the singular-arc fixtures goddard/jackson needed full
            # f64 before this). Ruiz is an iterative method — two passes
            # bring every row inf-norm within a few percent of 1 (one pass
            # leaves the cross-coupled rows unbalanced, which is what limits
            # the f32 refinement contraction at N >= 2500).
            # Solution unscaled at the end (x = D x').
            d_step, d_b = _ruiz_scales(A, B, E, F)
            A, B, E, F, r, rb = _apply_scales(A, B, E, F, r, rb, d_step, d_b)
            d2_step, d2_b = _ruiz_scales(A, B, E, F)
            A, B, E, F, r, rb = _apply_scales(A, B, E, F, r, rb, d2_step, d2_b)
            d_step = d_step * d2_step
            d_b = d_b * d2_b

        def run(rr, rrb):
            blocks = (A, B, E, F, rr, rrb)
            if self.solve_dtype is not None:
                # mixed precision: factor+solve in solve_dtype, everything
                # around it stays f64 — __init__ docstring
                blocks = tuple(b.astype(self.solve_dtype) for b in blocks)
            if self.algorithm == "cr":
                # custom_vmap wrapper: un-batched -> chain-in-lanes CR; under
                # vmap -> the lane-minor engine (solver/lanes.py), which keeps
                # the batch axis last instead of the batch-major layout
                from ctdirect_tpu.solver.lanes import cr_solve, cr_solve_nopivot

                cr = cr_solve if self.pivot else cr_solve_nopivot
                X, xb = cr(*blocks)
            else:
                X, xb = _scan_solve(*blocks)
            if self.solve_dtype is not None:
                X = X.astype(out_dtype)
                xb = xb.astype(out_dtype)
            return X, xb

        if self.solve_dtype is None or self.refine == 0:
            X, xb = run(r, rb)
        else:
            # refinement as a fori_loop FROM ZERO: iteration 0 reproduces the
            # base solve (residual of x=0 is r), so one reduced-precision
            # solver instantiation serves base + all refinement sweeps — the
            # program stays the same size as the unrefined solve
            def body(_, carry):
                X, xb = carry
                y, yb = _block_matvec(A, B, E, F, X, xb)
                dX, dxb = run(r - y, rb - yb)
                return (X + dX, xb + dxb)

            X0 = (jnp.zeros(r.shape, r.dtype), jnp.zeros(rb.shape, rb.dtype))
            X, xb = jax.lax.fori_loop(0, 1 + self.refine, body, X0)
        if self.equilibrate:
            X = X * d_step
            xb = xb * d_b
        return self._unscatter(X, xb)

    def _assemble(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        """Build (A, B, E, F, r, rb) block-tridiagonal + border data."""
        d = self.d
        dtype = rz.dtype
        Hloc, Jloc = data["Hloc"], data["Jloc"]
        Hb, Jfp, Jbc = data["Hb"], data["Jfp"], data["Jbc"]

        # index ranges inside the per-step D-dim: [w | y | v]
        w0, w1 = 0, d.bw
        y0, y1 = d.bw, d.bw + d.iw
        v0, v1 = d.bw + d.iw, d.bw + d.iw + d.q
        # border block col layout: [tail | v | lam_fp | lam_bc]
        t0c, t1c = 0, d.iw
        vb0, vb1 = d.iw, d.iw + d.q
        fp0, fp1 = vb1, vb1 + d.npath
        bc0, bc1 = fp1, fp1 + d.nb
        # border-hessian arg layout: [x0 | wN | tail | v]
        bx0, bx1 = 0, d.n
        bw0, bw1 = d.n, d.n + d.bw
        bt0, bt1 = d.n + d.bw, d.n + d.bw + d.iw
        bv0, bv1 = d.n + d.bw + d.iw, d.n + d.bw + d.iw + d.q

        sig_steps = sigma_z[: d.N * d.bw].reshape(d.N, d.bw)
        sig_tail = sigma_z[d.N * d.bw : d.N * d.bw + d.iw]
        sig_v = sigma_z[d.N * d.bw + d.iw :]
        D_steps, D_fp, D_bc = self._split_lam(Drow)
        rz_steps = rz[: d.N * d.bw].reshape(d.N, d.bw)
        rz_tail = rz[d.N * d.bw : d.N * d.bw + d.iw]
        rz_v = rz[d.N * d.bw + d.iw :]
        rp_steps, rp_fp, rp_bc = self._split_lam(rp)

        N, bw, cw, iw, bs, wb = d.N, d.bw, d.cw, d.iw, d.bs, d.wb

        # ---- A blocks ----
        Hww = Hloc[:, w0:w1, w0:w1]
        # interface-interface of the PREVIOUS step lands in the first iw of w_i
        Hyy_prev = jnp.zeros_like(Hww)
        Hyy_prev = Hyy_prev.at[1:, :iw, :iw].add(Hloc[:-1, y0:y1, y0:y1])
        # border (x0,x0) into A_0; (wN,wN) into A_{N-1}
        Hww_border = jnp.zeros_like(Hww)
        Hww_border = Hww_border.at[0, : d.n, : d.n].add(Hb[bx0:bx1, bx0:bx1])
        Hww_border = Hww_border.at[N - 1].add(Hb[bw0:bw1, bw0:bw1])
        Aw = Hww + Hyy_prev + Hww_border
        Aw = Aw + jax.vmap(jnp.diag)(sig_steps + delta_w)
        Jw = Jloc[:, :, w0:w1]  # (N, cw, bw)
        Dreg = jax.vmap(jnp.diag)(D_steps + delta_c)  # (N, cw, cw)
        A = jnp.concatenate(
            [
                jnp.concatenate([Aw, jnp.swapaxes(Jw, 1, 2)], axis=2),
                jnp.concatenate([Jw, -Dreg], axis=2),
            ],
            axis=1,
        )  # (N, bs, bs)

        # ---- B blocks (couple super-block i -> i+1), i = 0..N-2 ----
        Bw = jnp.zeros((N - 1, bw, bw), dtype) if N > 1 else jnp.zeros((0, bw, bw), dtype)
        if N > 1:
            Bw = Bw.at[:, :, :iw].set(Hloc[:-1, w0:w1, y0:y1])
        BJ = jnp.zeros((N - 1, cw, bw), dtype)
        if N > 1:
            BJ = BJ.at[:, :, :iw].set(Jloc[:-1, :, y0:y1])
        B = jnp.zeros((max(N - 1, 0), bs, bs), dtype)
        if N > 1:
            B = B.at[:, :bw, :bw].set(Bw)
            B = B.at[:, bw:, :bw].set(BJ)

        # ---- E blocks (step -> border) ----
        E = jnp.zeros((N, bs, wb), dtype)
        # v coupling: every step
        E = E.at[:, :bw, vb0:vb1].add(Hloc[:, w0:w1, v0:v1])
        E = E.at[1:, :iw, vb0:vb1].add(Hloc[:-1, y0:y1, v0:v1])
        E = E.at[:, bw:, vb0:vb1].add(Jloc[:, :, v0:v1])
        # tail coupling: last step's (w,y) and (lam,y)
        E = E.at[N - 1, :bw, t0c:t1c].add(Hloc[N - 1, w0:w1, y0:y1])
        E = E.at[N - 1, bw:, t0c:t1c].add(Jloc[N - 1, :, y0:y1])
        # border-hessian couplings
        E = E.at[0, : d.n, t0c:t1c].add(Hb[bx0:bx1, bt0:bt1])
        E = E.at[0, : d.n, vb0:vb1].add(Hb[bx0:bx1, bv0:bv1])
        E = E.at[N - 1, :bw, t0c:t1c].add(Hb[bw0:bw1, bt0:bt1])
        E = E.at[N - 1, :bw, vb0:vb1].add(Hb[bw0:bw1, bv0:bv1])
        # final-path multiplier column: fp depends on wN
        E = E.at[N - 1, :bw, fp0:fp1].add(Jfp[:, :bw].T)
        # boundary multiplier column: bc depends on x0
        E = E.at[0, : d.n, bc0:bc1].add(Jbc[:, : d.n].T)

        # ---- F border block ----
        F = jnp.zeros((wb, wb), dtype)
        F = F.at[t0c:t1c, t0c:t1c].add(
            Hloc[N - 1, y0:y1, y0:y1] + Hb[bt0:bt1, bt0:bt1] + jnp.diag(sig_tail + delta_w)
        )
        F = F.at[t0c:t1c, vb0:vb1].add(Hloc[N - 1, y0:y1, v0:v1] + Hb[bt0:bt1, bv0:bv1])
        F = F.at[vb0:vb1, t0c:t1c].add(
            (Hloc[N - 1, y0:y1, v0:v1] + Hb[bt0:bt1, bv0:bv1]).T
        )
        F = F.at[vb0:vb1, vb0:vb1].add(
            jnp.sum(Hloc[:, v0:v1, v0:v1], axis=0)
            + Hb[bv0:bv1, bv0:bv1]
            + jnp.diag(sig_v + delta_w)
        )
        # final-path rows/cols (fp args: [wN | tail | v])
        F = F.at[t0c:t1c, fp0:fp1].add(Jfp[:, bw : bw + iw].T)
        F = F.at[fp0:fp1, t0c:t1c].add(Jfp[:, bw : bw + iw])
        F = F.at[vb0:vb1, fp0:fp1].add(Jfp[:, bw + iw :].T)
        F = F.at[fp0:fp1, vb0:vb1].add(Jfp[:, bw + iw :])
        F = F.at[fp0:fp1, fp0:fp1].add(-jnp.diag(D_fp + delta_c))
        # boundary rows/cols (bc args: [x0 | tail | v])
        F = F.at[t0c:t1c, bc0:bc1].add(Jbc[:, d.n : d.n + iw].T)
        F = F.at[bc0:bc1, t0c:t1c].add(Jbc[:, d.n : d.n + iw])
        F = F.at[vb0:vb1, bc0:bc1].add(Jbc[:, d.n + iw :].T)
        F = F.at[bc0:bc1, vb0:vb1].add(Jbc[:, d.n + iw :])
        F = F.at[bc0:bc1, bc0:bc1].add(-jnp.diag(D_bc + delta_c))

        # ---- rhs ----
        r = -jnp.concatenate([rz_steps, rp_steps], axis=1)  # (N, bs)
        rb = -jnp.concatenate([rz_tail, rz_v, rp_fp, rp_bc])  # (wb,)

        return A, B, E, F, r, rb

    def _unscatter(self, X, xb):
        d = self.d
        t0c, t1c = 0, d.iw
        vb0, vb1 = d.iw, d.iw + d.q
        fp0, fp1 = vb1, vb1 + d.npath
        bc0, bc1 = fp1, fp1 + d.nb
        dz = jnp.concatenate(
            [X[:, : d.bw].reshape(d.N * d.bw), xb[t0c:t1c], xb[vb0:vb1]]
        )
        dlam = jnp.concatenate(
            [X[:, d.bw :].reshape(d.N * d.cw), xb[fp0:fp1], xb[bc0:bc1]]
        )
        return dz, dlam


# ----------------------------------------------------------------------------
# solve algorithms (module-level; operate on assembled block data)
# ----------------------------------------------------------------------------


def _mm(a, b):
    """Matrix product at the block solvers' pinned precision (kkt.PREC)."""
    return jnp.matmul(a, b, precision=PREC)


def _ruiz_scales(A, B, E, F):
    """Row-inf-norm scales for one symmetric Ruiz pass over the block
    tridiagonal + arrowhead system. Returns (d_step (N, bs), d_b (wb,)) with
    d = rownorm^{-1/2}; symmetry is preserved because row i and column i get
    the same scale."""
    rn = jnp.max(jnp.abs(A), axis=2)  # (N, bs)
    if B.shape[0] > 0:
        rn = rn.at[1:].max(jnp.max(jnp.abs(B), axis=1))  # B^T rows of block i+1
        rn = rn.at[:-1].max(jnp.max(jnp.abs(B), axis=2))  # B rows of block i
    rn = jnp.maximum(rn, jnp.max(jnp.abs(E), axis=2))
    rb_n = jnp.maximum(
        jnp.max(jnp.abs(E), axis=(0, 1)), jnp.max(jnp.abs(F), axis=1)
    )
    d_step = 1.0 / jnp.sqrt(jnp.maximum(rn, 1e-30))
    d_b = 1.0 / jnp.sqrt(jnp.maximum(rb_n, 1e-30))
    return d_step, d_b


def _apply_scales(A, B, E, F, r, rb, d_step, d_b):
    """K' = D K D, r' = D r for the block system (D = diag(d_step..., d_b))."""
    A = A * d_step[:, :, None] * d_step[:, None, :]
    if B.shape[0] > 0:
        B = B * d_step[:-1, :, None] * d_step[1:, None, :]
    E = E * d_step[:, :, None] * d_b[None, None, :]
    F = F * d_b[:, None] * d_b[None, :]
    r = r * d_step
    rb = rb * d_b
    return A, B, E, F, r, rb


def _block_matvec(A, B, E, F, X, xb):
    """K @ [X; xb] for the symmetric block-tridiagonal + arrowhead system:
    row i: A_i X_i + B_{i-1}^T X_{i-1} + B_i X_{i+1} + E_i xb;
    border: sum_i E_i^T X_i + F xb. Used by the f64 iterative-refinement
    sweeps around the reduced-precision solve."""
    y = jnp.einsum("nij,nj->ni", A, X, precision=PREC)
    if B.shape[0] > 0:
        y = y.at[1:].add(jnp.einsum("nji,nj->ni", B, X[:-1], precision=PREC))
        y = y.at[:-1].add(jnp.einsum("nij,nj->ni", B, X[1:], precision=PREC))
    y = y + jnp.einsum("niw,w->ni", E, xb, precision=PREC)
    yb = jnp.einsum("nsw,ns->w", E, X, precision=PREC) + _mm(F, xb)
    return y, yb


def _scan_solve(A, B, E, F, r, rb):
    """Sequential forward block elimination + border Schur + back substitution.
    O(N) depth; minimal flops. A:(N,bs,bs), B:(N-1,bs,bs), E:(N,bs,wb)."""
    N = A.shape[0]
    Ainv0 = gj_inverse(A[0])
    Etil0, rtil0 = E[0], r[0]

    def fwd(carry, inp):
        Ainv_p, Etil_p, rtil_p = carry
        A_i, B_p, E_i, r_i = inp
        C = _mm(B_p.T, Ainv_p)
        Atil = A_i - _mm(C, B_p)
        Etil = E_i - _mm(C, Etil_p)
        rtil = r_i - _mm(C, rtil_p)
        Ainv = gj_inverse(Atil)
        return (Ainv, Etil, rtil), (Ainv, Etil, rtil)

    if N > 1:
        _, (Ainvs_rest, Etils_rest, rtils_rest) = jax.lax.scan(
            fwd, (Ainv0, Etil0, rtil0), (A[1:], B, E[1:], r[1:])
        )
        Ainvs = jnp.concatenate([Ainv0[None], Ainvs_rest], axis=0)
        Etils = jnp.concatenate([Etil0[None], Etils_rest], axis=0)
        rtils = jnp.concatenate([rtil0[None], rtils_rest], axis=0)
    else:
        Ainvs, Etils, rtils = Ainv0[None], Etil0[None], rtil0[None]

    AinvE = jnp.einsum("nij,njk->nik", Ainvs, Etils, precision=PREC)
    Ainvr = jnp.einsum("nij,nj->ni", Ainvs, rtils, precision=PREC)
    Ftil = F - jnp.einsum("nji,njk->ik", Etils, AinvE, precision=PREC)
    rbtil = rb - jnp.einsum("nji,nj->i", Etils, Ainvr, precision=PREC)
    xb = gj_solve(Ftil, rbtil[:, None])[:, 0]

    xN = Ainvr[N - 1] - _mm(AinvE[N - 1], xb)

    def bwd(x_next, inp):
        Ainv, rtil, Etil, B_i = inp
        x_i = _mm(Ainv, rtil - _mm(B_i, x_next) - _mm(Etil, xb))
        return x_i, x_i

    if N > 1:
        _, xs_rev = jax.lax.scan(
            bwd,
            xN,
            (Ainvs[:-1][::-1], rtils[:-1][::-1], Etils[:-1][::-1], B[::-1]),
        )
        X = jnp.concatenate([xs_rev[::-1], xN[None]], axis=0)
    else:
        X = xN[None]
    return X, xb


def _cr_solve_chain_lanes(A, B, E, F, r, rb):
    """Single-instance CR with the CHAIN dim minor (adapter around
    lanes.cr_solve_chain_lanes: pads to a power of two and transposes the
    block arrays to (bs, bs, P)). Same math as _cr_solve; the layout keeps
    the level width in the minor dim instead of the major dim, so the
    level-batched Gauss-Jordan ops work on contiguous (M,) slabs (see the
    lanes.py module docstring)."""
    from ctdirect_tpu.solver.lanes import cr_solve_chain_lanes

    N, bs, _ = A.shape
    wb = E.shape[-1]
    dtype = A.dtype
    P = 1
    while P < N:
        P *= 2
    pad = P - N
    if pad:
        eye = jnp.broadcast_to(jnp.eye(bs, dtype=dtype), (pad, bs, bs))
        A = jnp.concatenate([A, eye], axis=0)
        E = jnp.concatenate([E, jnp.zeros((pad, bs, wb), dtype)], axis=0)
        r = jnp.concatenate([r, jnp.zeros((pad, bs), dtype)], axis=0)
    Bp = jnp.concatenate([B, jnp.zeros((P - B.shape[0], bs, bs), dtype)], axis=0)
    X, xb = cr_solve_chain_lanes(
        jnp.moveaxis(A, 0, -1),
        jnp.moveaxis(Bp, 0, -1),
        jnp.moveaxis(E, 0, -1),
        F,
        jnp.moveaxis(r, 0, -1),
        rb,
    )
    return X[:N], xb


def _cr_solve(A, B, E, F, r, rb):
    """Block CYCLIC REDUCTION + border Schur, FIXED-WIDTH (masked) form:
    O(log N) sequential depth with ONE compiled level body.

    The textbook recursion halves the arrays each level, which under tracing
    unrolls into log2(P) distinct level programs (~18k StableHLO lines at
    N=250). Here every
    level instead operates on a constant-width P/2 array whose ACTIVE prefix
    halves; the padding (identity A, zero B/E/r) is self-maintaining through
    the level recurrences (zero couplings produce zero updates and identity
    Schur complements), so the whole up-sweep is a lax.scan over log2(P)
    iterations of one body, and the down-sweep a reverse scan whose carry's
    active prefix doubles (garbage stays exactly zero for the same reason).
    ~log2(P)/2 x more block flops than the shrinking version, for a
    ~log2(P) x smaller program.

    Eliminating every odd block i yields, for its even neighbors:
        A'[i-1] -= B[i-1] A_i^{-1} B[i-1]^T        (left even)
        A'[i+1] -= B[i]^T  A_i^{-1} B[i]           (right even)
        B'      = -B[i-1] A_i^{-1} B[i]            (new even-even coupling)
    plus matching rhs/border updates; recurse on the even half.
    """
    N, bs, _ = A.shape
    wb = E.shape[-1]
    dtype = A.dtype

    # pad to a power of two with decoupled identity blocks
    P = 1
    while P < N:
        P *= 2
    pad = P - N
    if pad:
        eye = jnp.broadcast_to(jnp.eye(bs, dtype=dtype), (pad, bs, bs))
        A = jnp.concatenate([A, eye], axis=0)
        E = jnp.concatenate([E, jnp.zeros((pad, bs, wb), dtype)], axis=0)
        r = jnp.concatenate([r, jnp.zeros((pad, bs), dtype)], axis=0)
    # Bp[i] couples block i to i+1; zero at the last slot
    Bp = jnp.concatenate(
        [B, jnp.zeros((P - B.shape[0], bs, bs), dtype)], axis=0
    )

    if P == 1:
        top = jnp.concatenate([A[0], E[0]], axis=1)
        bot = jnp.concatenate([E[0].T, F], axis=1)
        root = jnp.concatenate([top, bot], axis=0)
        sol = gj_solve(root, jnp.concatenate([r[0], rb])[:, None])[:, 0]
        return sol[:bs][None][:N], sol[bs:]

    vinv = jax.vmap(gj_inverse)
    H = P // 2
    L = P.bit_length() - 1  # log2(P) levels
    eyeH = jnp.broadcast_to(jnp.eye(bs, dtype=dtype), (H, bs, bs))
    zeroH = jnp.zeros((H, bs, bs), dtype)

    def up(carry, _):
        A, Bp, E, r, F, rb = carry  # (P, ...) with active prefix M
        Ae, Ao = A[0::2], A[1::2]  # (H, ...): active prefix M/2, then padding
        Bl = Bp[0::2]  # couples even_j -> odd_j
        Br = Bp[1::2]  # couples odd_j -> even_{j+1} (last ACTIVE slot is zero)
        Eo, ro = E[1::2], r[1::2]
        Ainv_o = vinv(Ao)

        CL = jnp.einsum("nij,njk->nik", Bl, Ainv_o, precision=PREC)  # (H, bs, bs)
        CR = jnp.einsum("nji,njk->nik", Br, Ainv_o, precision=PREC)  # B_r^T A_o^{-1}

        A_new = Ae - jnp.einsum("nij,nkj->nik", CL, Bl, precision=PREC)
        A_new = A_new.at[1:].add(-jnp.einsum("nij,njk->nik", CR, Br, precision=PREC)[:-1])
        E_new = E[0::2] - jnp.einsum("nij,njk->nik", CL, Eo, precision=PREC)
        E_new = E_new.at[1:].add(-jnp.einsum("nij,njk->nik", CR, Eo, precision=PREC)[:-1])
        r_new = r[0::2] - jnp.einsum("nij,nj->ni", CL, ro, precision=PREC)
        r_new = r_new.at[1:].add(-jnp.einsum("nij,nj->ni", CR, ro, precision=PREC)[:-1])
        B_new = -jnp.einsum("nij,njk->nik", CL, Br, precision=PREC)  # even_j -> even_{j+1}

        F = F - jnp.einsum("nji,njk,nkl->il", Eo, Ainv_o, Eo, precision=PREC)
        rb = rb - jnp.einsum("nji,njk,nk->i", Eo, Ainv_o, ro, precision=PREC)

        # re-pad to constant width P (the active prefix just halved); padding
        # stays inert: identity A, zero couplings/rhs
        A2 = jnp.concatenate([A_new, eyeH], axis=0)
        B2 = jnp.concatenate([B_new, zeroH], axis=0)
        E2 = jnp.concatenate([E_new, jnp.zeros((H, bs, wb), dtype)], axis=0)
        r2 = jnp.concatenate([r_new, jnp.zeros((H, bs), dtype)], axis=0)
        return (A2, B2, E2, r2, F, rb), (Ainv_o, Bl, Br, Eo, ro)

    (A, Bp, E, r, F, rb), saves = jax.lax.scan(
        up, (A, Bp, E, r, F, rb), None, length=L
    )

    # root: [[A0, E0], [E0^T, F]] [x0; xb] = [r0; rb]
    top = jnp.concatenate([A[0], E[0]], axis=1)
    bot = jnp.concatenate([E[0].T, F], axis=1)
    root = jnp.concatenate([top, bot], axis=0)
    sol = gj_solve(root, jnp.concatenate([r[0], rb])[:, None])[:, 0]
    xb = sol[bs:]
    # full-width X carry: active prefix doubles each down level; padding solves
    # are exactly zero (zero rhs against identity blocks), so the prefix of the
    # interleave is always the valid solution
    X = jnp.zeros((P, bs), dtype).at[0].set(sol[:bs])

    def down(X, save):
        Ainv_o, Bl, Br, Eo, ro = save
        x_e = X[:H]  # (H, bs): active prefix m, zeros beyond
        x_e_next = jnp.concatenate([x_e[1:], jnp.zeros((1, bs), dtype)], axis=0)
        rhs = (
            ro
            - jnp.einsum("nji,nj->ni", Bl, x_e, precision=PREC)
            - jnp.einsum("nij,nj->ni", Br, x_e_next, precision=PREC)
            - jnp.einsum("nij,j->ni", Eo, xb, precision=PREC)
        )
        x_o = jnp.einsum("nij,nj->ni", Ainv_o, rhs, precision=PREC)
        return jnp.stack([x_e, x_o], axis=1).reshape(P, bs), None

    X, _ = jax.lax.scan(down, X, saves, reverse=True)
    return X[:N], xb
