"""From-scratch primal-dual interior-point NLP solver in JAX.

Replaces the reference stack's external C++/Fortran/Julia solvers (Ipopt + MUMPS,
MadNLP — SURVEY.md §2.2, L5) with a solver whose every iteration is a fixed-shape
JAX program: the whole solve `jit`s, `vmap`s across thousands of problem
instances, and shards over device meshes. No tape AD, no sparsity detection, no
general sparse LU — derivatives come from `jax.grad`/`jax.hessian`/`jax.jacfwd`,
and the KKT solve is pluggable (dense LU for small problems, block-structured
cyclic reduction for collocation NLPs).

Problem form (the DOCP emits exactly this):

    min  f(z)   s.t.   cl <= c(z) <= cu,   zl <= z <= zu

Rows with cl == cu are equalities; the rest get slacks s with box [cl, cu]
(Ipopt's formulation). Barrier terms are applied to every finite bound of z and
s. The Newton system is condensed to the symmetric (nz + nc) form

    [ W + Sigma_z + dw*I    J^T          ] [dz  ]   [ -rbar_z ]
    [ J                     -(D + dc*I)  ] [dlam] = [ -rbar_p ]

with D = 0 on equality rows and Sigma_s^{-1} on inequality rows, followed by
recovery of ds and the bound multiplier steps, fraction-to-boundary step limits,
and a backtracking line search on the l1-penalty merit function. Regularization
(dw, dc) is adapted inertia-free: if the step has insufficient positive
curvature (or the solve produced NaNs), dw is increased and the KKT system
re-solved — the structured analogue of Ipopt's inertia-correction loop
(which we cannot replicate without an LDL^T inertia signal; SURVEY.md §7.3.1).

Monotone Fiacco-McCormick barrier schedule (Ipopt defaults: kappa_mu = 0.2,
theta_mu = 1.5), Ipopt-scaled termination error, and a fixed-iteration
`lax.while_loop` so batched instances with divergent iteration counts simply
mask out (SURVEY.md §7.3.3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ctdirect_tpu.solver.kkt import DenseKKT


# ----------------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class IPMOptions:
    """Solver options (≙ the reference's Ipopt/MadNLP option dicts,
    test/test_common.jl:66–94; defaults chosen to match Ipopt's)."""

    tol: float = 1e-8
    acceptable_tol: float = 1e-6  # Ipopt Solved_To_Acceptable_Level fallback
    mu_init: float = 0.1
    mu_min: float = 1e-12
    # "monotone" (Fiacco-McCormick, Ipopt mu_strategy=monotone) or "adaptive"
    # (LOQO-style centrality rule — the free-mode analogue of Ipopt's
    # mu_strategy=adaptive the reference relies on, test/test_common.jl:66-94)
    mu_strategy: str = "monotone"
    kappa_mu: float = 0.2  # linear barrier decrease factor
    theta_mu: float = 1.5  # superlinear barrier decrease exponent
    # Ipopt bound_relax_factor: every box bound is relaxed internally by
    # eps*max(1,|b|) so solutions ON a bound don't stall the barrier; the final
    # primal point is clipped back (honor_original_bounds).
    bound_relax_factor: float = 1e-8
    kappa_eps: float = 10.0  # barrier subproblem tolerance = kappa_eps * mu
    tau_min: float = 0.99  # fraction-to-boundary minimum
    max_iter: int = 200
    max_ls: int = 25  # backtracking steps
    eta_ls: float = 1e-4  # Armijo constant
    s_max: float = 100.0  # KKT error scaling threshold (Ipopt s_max)
    kappa_push: float = 1e-2  # initial-point push from bounds
    delta_w_init: float = 1e-8
    delta_w_max: float = 1e20
    delta_c: float = 1e-8  # constraint-block regularization
    max_reg_trials: int = 20
    curvature_frac: float = 1e-11  # inertia-free test threshold (Chiang-Zavala)
    max_soft_fail: int = 8  # consecutive failed line searches before abort
    # "structured" (block-tridiag elimination, O(N) depth) | "cr" (block cyclic
    # reduction, O(log N) depth) | "dense" (correctness oracle, small N only)
    kkt_mode: str = "structured"
    # Mixed-precision KKT block solve: "f32" factors+solves the structured
    # blocks in float32 while residuals, assembly and the applied step stay
    # f64 — inexact Newton with direction error ~cond*1e-7 per iteration
    # (StructuredKKT.solve_dtype). None = full precision. Whether it beats
    # full f64 on the GPU is not measured yet. Ignored by kkt_mode="dense".
    kkt_solve_dtype: Optional[str] = None
    # f64 iterative-refinement sweeps around the f32 block solve (cond(K) ~
    # N^2 makes bare-f32 directions degrade convergence at large N; see
    # StructuredKKT.refine). 2 sweeps measured necessary-and-sufficient on the
    # worst fixture: goddard trapeze N=2500 stalls at refine=1 (500 iters) but
    # converges in 59 with refine=2 (robbins N=5000: 47 iters either way).
    kkt_refine: int = 2
    # Ruiz equilibration of the assembled KKT blocks before the reduced-
    # precision solve (StructuredKKT.equilibrate). None = solver default
    # (on iff kkt_solve_dtype is reduced). Measured r5: turns goddard
    # trapeze N=1000 from a 290-iteration f32 stall into a 59-iteration
    # Solve_Succeeded.
    kkt_equilibrate: Optional[bool] = None
    grad_scaling: bool = True  # Ipopt gradient-based f/c scaling at z0
    scaling_max_grad: float = 100.0
    lsq_lambda_init: bool = True  # least-squares equality multiplier init
    lambda_init_max: float = 1e3  # reject LS init if larger (Ipopt constr_mult_init_max)
    # dual refresh (Ipopt recalc_y): when the line search collapses (alpha tiny)
    # while nearly feasible, the multipliers — not the primal point — are what's
    # wrong (degenerate active sets leave lam far from the central value and
    # the primal line search throttles dlam to alpha*dlam). Recompute lam by
    # least squares at the current point instead of crawling.
    recalc_lam: bool = True
    recalc_lam_feas_tol: float = 1e-3
    recalc_lam_alpha: float = 0.02
    # --- filter line search (Waechter-Biegler) parameters, Ipopt defaults ---
    filter_size: int = 64  # fixed-capacity filter (circular overwrite)
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-8
    delta_switch: float = 1.0
    s_theta: float = 1.1
    s_phi: float = 2.3
    eta_phi: float = 1e-8  # Armijo constant for f-type steps
    kappa_soc: float = 0.99  # SOC acceptance: theta_soc <= kappa_soc * theta
    max_soc: int = 3  # second-order correction rounds
    debug: bool = False  # jax.debug.print per-iteration line-search diagnostics

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class NLPSpec(NamedTuple):
    """Static structure of the NLP (masks are concrete numpy bools — they define
    the compiled program; bound *values* are runtime arrays)."""

    nz: int
    nc: int
    eq_mask: np.ndarray  # (nc,) True on equality rows (cl == cu)
    zl_mask: np.ndarray  # (nz,) True where zl finite
    zu_mask: np.ndarray
    sl_mask: np.ndarray  # (nc,) finite lower bound on inequality-row slack
    su_mask: np.ndarray


def make_spec(zl, zu, cl, cu) -> NLPSpec:
    zl, zu = np.asarray(zl), np.asarray(zu)
    cl, cu = np.asarray(cl), np.asarray(cu)
    eq = np.isfinite(cl) & np.isfinite(cu) & (cl == cu)
    ineq = ~eq
    return NLPSpec(
        nz=zl.shape[0],
        nc=cl.shape[0],
        eq_mask=eq,
        zl_mask=np.isfinite(zl),
        zu_mask=np.isfinite(zu),
        sl_mask=ineq & np.isfinite(cl),
        su_mask=ineq & np.isfinite(cu),
    )


class IPMResult(NamedTuple):
    z: jnp.ndarray
    lam: jnp.ndarray  # constraint multipliers (nc,)
    zL: jnp.ndarray  # lower bound multipliers on z (nz,)
    zU: jnp.ndarray
    s: jnp.ndarray  # slacks (nc; meaningful on inequality rows)
    yL: jnp.ndarray  # slack lower-bound duals (inequality rows)
    yU: jnp.ndarray
    objective: jnp.ndarray
    iterations: jnp.ndarray
    kkt_error: jnp.ndarray
    constraints_violation: jnp.ndarray
    status: jnp.ndarray  # 0 solved, 1 max_iter, 2 line-search stall, 3 diverged
    successful: jnp.ndarray  # bool


STATUS_MESSAGES = {
    0: "Solve_Succeeded",
    1: "Maximum_Iterations_Exceeded",
    2: "Search_Direction_Becomes_Too_Small",
    3: "Diverging_Iterates",
    4: "Solved_To_Acceptable_Level",
}


# ----------------------------------------------------------------------------
# Helpers
# ----------------------------------------------------------------------------


def _safe_gap(x, lb, mask):
    """x - lb where the bound is finite, else 1 (keeps arithmetic NaN-free)."""
    return jnp.where(mask, x - jnp.where(mask, lb, 0.0), 1.0)


def _max_step_to_boundary(x, dx, lb, ub, lmask, umask, tau):
    """Largest alpha in (0, 1] with x + alpha dx >= lb + (1-tau) gap etc."""
    gapL = _safe_gap(x, lb, lmask)
    gapU = _safe_gap(ub, x, umask)
    # alpha limit where dx pushes toward a finite bound
    aL = jnp.where(lmask & (dx < 0), -tau * gapL / jnp.where(dx < 0, dx, -1.0), 1.0)
    aU = jnp.where(umask & (dx > 0), tau * gapU / jnp.where(dx > 0, dx, 1.0), 1.0)
    lo = jnp.minimum(jnp.min(aL, initial=1.0), jnp.min(aU, initial=1.0))
    return jnp.clip(lo, 0.0, 1.0)


def _dual_step_to_boundary(w, dw, mask, tau):
    """Largest alpha keeping w + alpha dw >= (1-tau) w (w >= 0 duals)."""
    a = jnp.where(mask & (dw < 0), -tau * w / jnp.where(dw < 0, dw, -1.0), 1.0)
    return jnp.clip(jnp.min(a, initial=1.0), 0.0, 1.0)


# ----------------------------------------------------------------------------
# Core solver
# ----------------------------------------------------------------------------


class _Carry(NamedTuple):
    z: jnp.ndarray
    s: jnp.ndarray  # (nc,) slacks; 0 on eq rows
    lam: jnp.ndarray
    wL: jnp.ndarray  # z lower bound duals
    wU: jnp.ndarray
    yL: jnp.ndarray  # slack lower bound duals
    yU: jnp.ndarray
    mu: jnp.ndarray
    filt_theta: jnp.ndarray  # (filter_size,) augmented theta entries (inf = empty)
    filt_phi: jnp.ndarray  # (filter_size,) augmented phi entries
    filt_n: jnp.ndarray  # next write slot
    delta_w_last: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray
    status: jnp.ndarray
    kkt_err: jnp.ndarray
    soft_fails: jnp.ndarray


def ipm_solve(
    f: Callable,
    c: Callable,
    spec: NLPSpec,
    z0,
    zl,
    zu,
    cl,
    cu,
    options: IPMOptions = IPMOptions(),
    kkt=None,
    return_history: bool = False,
):
    """Solve the NLP. Fully traceable: jit/vmap over z0 and bound values.

    `kkt` is a KKT operator (see solver/kkt.py) supplying derivative assembly
    and the condensed-system solve; defaults to DenseKKT. Pass a StructuredKKT
    to solve the block-tridiagonal + arrowhead collocation system in O(N).
    """
    opts = options
    nz, nc = spec.nz, spec.nc
    dtype = jnp.result_type(jnp.asarray(z0).dtype, jnp.float32)

    z0 = jnp.asarray(z0, dtype)
    zl = jnp.asarray(zl, dtype)
    zu = jnp.asarray(zu, dtype)
    cl = jnp.asarray(cl, dtype)
    cu = jnp.asarray(cu, dtype)
    zl_orig, zu_orig = zl, zu

    # Ipopt bound_relax_factor: relax every finite box bound (z boxes and
    # inequality-row slack boxes) by eps*max(1,|b|); equality rows untouched.
    if opts.bound_relax_factor > 0:
        brf = opts.bound_relax_factor

        def _relax(lo, hi, row_eq=None):
            rl = lo - brf * jnp.maximum(1.0, jnp.abs(lo))
            rh = hi + brf * jnp.maximum(1.0, jnp.abs(hi))
            if row_eq is not None:  # keep equality rows exact
                rl = jnp.where(row_eq, lo, rl)
                rh = jnp.where(row_eq, hi, rh)
            return rl, rh

        zl, zu = _relax(zl, zu)
        cl, cu = _relax(cl, cu, jnp.asarray(spec.eq_mask))

    eq = jnp.asarray(spec.eq_mask)
    ineq = ~eq
    zlm = jnp.asarray(spec.zl_mask)
    zum = jnp.asarray(spec.zu_mask)
    slm = jnp.asarray(spec.sl_mask)
    sum_ = jnp.asarray(spec.su_mask)
    n_duals = float(nc + nz)  # for Ipopt-style scaling

    # ---- gradient-based scaling (Ipopt nlp_scaling_method=gradient-based):
    # scale f and each constraint row so its gradient inf-norm at z0 is <= 100.
    # Internally everything runs scaled; duals/violations are unscaled on exit.
    f_user, c_user = f, c
    if kkt is None:
        kkt = DenseKKT(f_user, c_user, nz, nc)
    if opts.grad_scaling:
        g0 = jax.grad(f_user)(z0)
        scale_f = jnp.minimum(
            1.0, opts.scaling_max_grad / jnp.maximum(jnp.max(jnp.abs(g0)), 1e-8)
        )
        row_norm = kkt.row_norms(z0)
        scale_c = jnp.minimum(
            1.0, opts.scaling_max_grad / jnp.maximum(row_norm, 1e-8)
        )

        def f(z):
            return scale_f * f_user(z)

        def c(z):
            return scale_c * c_user(z)

        cl = scale_c * cl
        cu = scale_c * cu
    else:
        scale_f = jnp.asarray(1.0, dtype)
        scale_c = jnp.ones((nc,), dtype)

    grad_f = jax.grad(f)

    def lag_hvp(z, lam, v):
        """(scaled) Lagrangian Hessian-vector product, matrix-free."""
        g = lambda zz: jax.grad(lambda z3: f(z3) + jnp.dot(lam, c(z3)))(zz)
        return jax.jvp(g, (z,), (v,))[1]

    # slack bounds: cl/cu on inequality rows; harmless [0,0] placeholders on eq rows
    sl = jnp.where(ineq, cl, 0.0)
    su = jnp.where(ineq, cu, 0.0)

    # ---- initial point (Ipopt-style push into the interior) ----
    kap = opts.kappa_push

    def push_interior(x, lb, ub, lmask, umask):
        lo = jnp.where(lmask, lb, -jnp.inf)
        hi = jnp.where(umask, ub, jnp.inf)
        width = jnp.where(lmask & umask, hi - lo, jnp.inf)
        pL = jnp.where(lmask, jnp.minimum(kap * jnp.maximum(1.0, jnp.abs(lo)), 0.5 * width), 0.0)
        pU = jnp.where(umask, jnp.minimum(kap * jnp.maximum(1.0, jnp.abs(hi)), 0.5 * width), 0.0)
        x = jnp.where(lmask, jnp.maximum(x, lo + pL), x)
        x = jnp.where(umask, jnp.minimum(x, hi - pU), x)
        return x

    z_init = push_interior(z0, zl, zu, zlm, zum)
    c0 = c(z_init)
    s_init = jnp.where(ineq, push_interior(c0, sl, su, slm, sum_), 0.0)

    mu0 = jnp.asarray(opts.mu_init, dtype)
    gapL0 = _safe_gap(z_init, zl, zlm)
    gapU0 = _safe_gap(zu, z_init, zum)
    sgapL0 = _safe_gap(s_init, sl, slm)
    sgapU0 = _safe_gap(su, s_init, sum_)
    wL0 = jnp.where(zlm, mu0 / gapL0, 0.0)
    wU0 = jnp.where(zum, mu0 / gapU0, 0.0)
    yL0 = jnp.where(slm, mu0 / sgapL0, 0.0)
    yU0 = jnp.where(sum_, mu0 / sgapU0, 0.0)

    rhs_eq = jnp.where(eq, cl, 0.0)

    # ---- residuals ----
    def primal_residual(z, s):
        return c(z) - rhs_eq - jnp.where(ineq, s, 0.0)

    def kkt_error_pair(z, s, lam, wL, wU, yL, yU, mu):
        """Ipopt's scaled optimality error E_mu (Waechter-Biegler eq. 5),
        evaluated at BOTH the current barrier mu and mu = 0 in one pass (the
        two share every residual; only the complementarity offset differs)."""
        gL = _safe_gap(z, zl, zlm)
        gU = _safe_gap(zu, z, zum)
        sgL = _safe_gap(s, sl, slm)
        sgU = _safe_gap(su, s, sum_)
        r_d = grad_f(z) + jax.vjp(c, z)[1](lam)[0] - wL + wU
        r_s = jnp.where(ineq, -lam - yL + yU, 0.0)
        r_p = primal_residual(z, s)
        prods = jnp.concatenate(
            [
                jnp.where(zlm, wL * gL, 0.0),
                jnp.where(zum, wU * gU, 0.0),
                jnp.where(slm, yL * sgL, 0.0),
                jnp.where(sum_, yU * sgU, 0.0),
            ]
        )
        masks = jnp.concatenate([zlm, zum, slm, sum_])
        bound_dual_sum = jnp.sum(wL + wU) + jnp.sum(yL + yU)
        dual_sum = jnp.sum(jnp.abs(lam)) + bound_dual_sum
        s_d = jnp.maximum(opts.s_max, dual_sum / n_duals) / opts.s_max
        s_c = (
            jnp.maximum(opts.s_max, bound_dual_sum / jnp.maximum(1.0, float(nz + nc)))
            / opts.s_max
        )
        e_d = jnp.max(jnp.abs(jnp.concatenate([r_d, r_s]))) / s_d
        e_p = jnp.max(jnp.abs(r_p), initial=0.0)
        e_c0 = jnp.max(jnp.abs(prods), initial=0.0) / s_c
        e_cmu = jnp.max(jnp.abs(jnp.where(masks, prods - mu, 0.0)), initial=0.0) / s_c
        base = jnp.maximum(e_d, e_p)
        return jnp.maximum(base, e_cmu), jnp.maximum(base, e_c0), e_p

    def kkt_error(z, s, lam, wL, wU, yL, yU, mu):
        err_mu, _, e_p = kkt_error_pair(z, s, lam, wL, wU, yL, yU, mu)
        return err_mu, e_p

    def barrier_phi(z, s):
        gL = _safe_gap(z, zl, zlm)
        gU = _safe_gap(zu, z, zum)
        sgL = _safe_gap(s, sl, slm)
        sgU = _safe_gap(su, s, sum_)
        barr = (
            jnp.sum(jnp.where(zlm, jnp.log(gL), 0.0))
            + jnp.sum(jnp.where(zum, jnp.log(gU), 0.0))
            + jnp.sum(jnp.where(slm, jnp.log(sgL), 0.0))
            + jnp.sum(jnp.where(sum_, jnp.log(sgU), 0.0))
        )
        return f(z), barr

    # ---- filter initialization (Ipopt: theta_max = 1e4 max(1, theta_0),
    # theta_min = 1e-4 max(1, theta_0); the filter starts as {theta >= theta_max}) ----
    theta_at_init = jnp.sum(jnp.abs(primal_residual(z_init, s_init)))
    theta_max = 1e4 * jnp.maximum(1.0, theta_at_init)
    theta_min = 1e-4 * jnp.maximum(1.0, theta_at_init)

    def _fresh_filter():
        th = jnp.full((opts.filter_size,), jnp.inf, dtype).at[0].set(theta_max)
        ph = jnp.full((opts.filter_size,), -jnp.inf, dtype)
        return th, ph

    # ---- one IPM iteration ----
    def step(carry: _Carry) -> _Carry:
        z, s, lam, wL, wU, yL, yU = (
            carry.z,
            carry.s,
            carry.lam,
            carry.wL,
            carry.wU,
            carry.yL,
            carry.yU,
        )
        mu = carry.mu

        gL = _safe_gap(z, zl, zlm)
        gU = _safe_gap(zu, z, zum)
        sgL = _safe_gap(s, sl, slm)
        sgU = _safe_gap(su, s, sum_)

        n_compl = int(
            np.sum(spec.zl_mask)
            + np.sum(spec.zu_mask)
            + np.sum(spec.sl_mask)
            + np.sum(spec.su_mask)
        )
        if opts.mu_strategy == "adaptive" and n_compl > 0:
            # LOQO centrality rule (Vanderbei; also MadNLP's adaptive oracle):
            # mu = sigma * avg_compl with sigma driven by how uncentered the
            # most-converged complementarity pair is.
            prods = jnp.concatenate(
                [
                    jnp.where(zlm, wL * gL, jnp.nan),
                    jnp.where(zum, wU * gU, jnp.nan),
                    jnp.where(slm, yL * sgL, jnp.nan),
                    jnp.where(sum_, yU * sgU, jnp.nan),
                ]
            )
            avg = jnp.nansum(prods) / n_compl
            xi = jnp.nanmin(jnp.where(jnp.isnan(prods), jnp.nan, prods)) / jnp.maximum(
                avg, 1e-300
            )
            sigma_c = 0.1 * jnp.minimum(0.05 * (1.0 - xi) / jnp.maximum(xi, 1e-12), 2.0) ** 3
            # rate-limit the decrease (factor 100/iter): the raw LOQO rule can
            # crash mu 1e-5 -> 1e-12 in one step when momentarily centered,
            # which slams the next iterate onto the boundary (inf barrier,
            # spurious divergence — observed on goddard N=200 GL2cc)
            mu = jnp.clip(
                sigma_c * avg, jnp.maximum(opts.mu_min, 1e-2 * mu), opts.mu_init
            )

        sigma_z = jnp.where(zlm, wL / gL, 0.0) + jnp.where(zum, wU / gU, 0.0)
        sigma_s = jnp.where(slm, yL / sgL, 0.0) + jnp.where(sum_, yU / sgU, 0.0)
        # inequality rows with no finite slack bound at all would make D singular;
        # the DOCP never emits such rows, but guard anyway
        sigma_s = jnp.where(ineq, jnp.maximum(sigma_s, 1e-12), 1.0)

        kdata = kkt.prepare(z, lam, scale_f, scale_c)

        gf = grad_f(z)
        rbar_z = (
            gf
            + jax.vjp(c, z)[1](lam)[0]
            - jnp.where(zlm, mu / gL, 0.0)
            + jnp.where(zum, mu / gU, 0.0)
        )
        rbar_s = jnp.where(ineq, -lam - jnp.where(slm, mu / sgL, 0.0) + jnp.where(sum_, mu / sgU, 0.0), 0.0)
        r_p = primal_residual(z, s)
        rbar_p = r_p + jnp.where(ineq, rbar_s / sigma_s, 0.0)

        Drow = jnp.where(ineq, 1.0 / sigma_s, 0.0)

        # ---- regularized KKT solve with inertia-free curvature retry ----
        # NB: scale delta_w by the Lagrangian Hessian's diagonal ONLY — the
        # barrier Sigma is PSD and never needs offsetting, and near active
        # bounds max(sigma) ~ mu/gap^2 explodes, which would lock the ladder
        # at astronomical delta_w (gradient-like steps, permanent stall)
        h_scale = kkt.diag_scale(kdata)

        def reg_solve(delta_w, delta_c):
            dz, dlam = kkt.solve(
                kdata, sigma_z, Drow, delta_w, delta_c, rbar_z, rbar_p
            )
            ds = jnp.where(ineq, (dlam - rbar_s) / sigma_s, 0.0)
            # inertia-free acceptance (Chiang-Zavala): curvature along the full
            # primal step (z AND slacks) must be sufficiently positive
            curv = (
                dz @ lag_hvp(z, lam, dz)
                + (sigma_z + delta_w) @ (dz * dz)
                + ds @ (sigma_s * ds)
            )
            nrm2 = dz @ dz + ds @ ds
            ok = (
                jnp.all(jnp.isfinite(dz))
                & jnp.all(jnp.isfinite(dlam))
                & (curv >= opts.curvature_frac * nrm2)
            )
            return dz, dlam, ds, ok

        # retry ladder (Ipopt inertia-correction analogue): on failure, bump
        # delta_w geometrically and engage the dual regularization
        # delta_c = delta_c_bar * mu^{1/4}, which bounds multiplier blow-up on
        # locally rank-deficient constraint Jacobians
        delta_c_reg = jnp.maximum(opts.delta_c, 1e-8 * mu**0.25)

        def reg_cond(state):
            (delta_w, trials), _, _, _, ok = state
            return (~ok) & (trials <= opts.max_reg_trials)

        def reg_body(state):
            (delta_w, trials), _, _, _, _ = state
            # trial 0 is the unregularized solve; afterwards Ipopt's
            # inertia-correction ladder (Waechter-Biegler Algorithm IC):
            # first correction from the decayed last-used value (kappa_w^- =
            # 1/3), escalate by kappa_w^+ = 8 (100 on the very first-ever
            # correction). One solve instantiation serves every trial — the
            # loop body is compiled once.
            never_used = carry.delta_w_last == 0.0
            first = jnp.where(
                never_used,
                opts.delta_w_init * h_scale,
                jnp.maximum(1e-20 * h_scale, carry.delta_w_last / 3.0),
            )
            new_dw = jnp.where(
                trials == 0,
                jnp.asarray(0.0, dtype),
                jnp.where(
                    trials == 1,
                    first,
                    delta_w * jnp.where(never_used, 100.0, 8.0),
                ),
            )
            # dual regularization PROPORTIONAL to the primal one
            # (Friedlander-Orban regularized-SQP pairing): with H ~ dw*I the
            # multiplier step scales like dw * r_p / (|J|^2 + dw*dc), so a
            # dc ~ 1e-8 dw bounds |dlam| instead of letting it blow up with
            # every ladder escalation (the lam -> |W| -> dw feedback loop
            # that stalled truck_trailer in round 1).
            new_dc = jnp.where(
                trials == 0,
                jnp.asarray(opts.delta_c, dtype),
                jnp.maximum(delta_c_reg, 1e-8 * new_dw),
            )
            dz, dlam, ds, ok = reg_solve(new_dw, new_dc)
            return (new_dw, trials + 1), dz, dlam, ds, ok

        zeros_state = (
            (jnp.asarray(0.0, dtype), jnp.asarray(0, jnp.int32)),
            jnp.zeros((nz,), dtype),
            jnp.zeros((nc,), dtype),
            jnp.zeros((nc,), dtype),
            jnp.asarray(False),
        )
        (delta_w_used, _), dz, dlam, ds, solve_ok = jax.lax.while_loop(
            reg_cond, reg_body, zeros_state
        )
        delta_w_last = jnp.where(delta_w_used > 0, delta_w_used, carry.delta_w_last)

        # ---- fraction-to-boundary (primal; dual step sizes computed after the
        # line search selects the final direction) ----
        tau = jnp.maximum(opts.tau_min, 1.0 - mu)
        a_z = _max_step_to_boundary(z, dz, zl, zu, zlm, zum, tau)
        a_s = _max_step_to_boundary(s, ds, sl, su, slm, sum_, tau)
        alpha_max = jnp.minimum(a_z, a_s)

        # ---- filter line search (Waechter-Biegler / Ipopt) ----
        theta0 = jnp.sum(jnp.abs(r_p))
        f0, b0 = barrier_phi(z, s)
        phi0 = f0 - mu * b0
        # barrier-function directional derivative
        dphi = (
            gf @ dz
            - jnp.sum(jnp.where(zlm, mu / gL * dz, 0.0))
            + jnp.sum(jnp.where(zum, mu / gU * dz, 0.0))
            - jnp.sum(jnp.where(slm, mu / sgL * ds, 0.0))
            + jnp.sum(jnp.where(sum_, mu / sgU * ds, 0.0))
        )
        filt_th, filt_ph = carry.filt_theta, carry.filt_phi

        def eval_trial(zt, st):
            ft, bt = barrier_phi(zt, st)
            phi_t = ft - mu * bt
            theta_t = jnp.sum(jnp.abs(primal_residual(zt, st)))
            return theta_t, phi_t

        def trial_accept(alpha, theta_t, phi_t):
            """(accepted, is_ftype) per the filter method's case analysis."""
            not_blocked = ~jnp.any((theta_t >= filt_th) & (phi_t >= filt_ph))
            switching = (dphi < 0) & (
                alpha * (-dphi) ** opts.s_phi
                > opts.delta_switch * theta0**opts.s_theta
            )
            armijo = phi_t <= phi0 + opts.eta_phi * alpha * dphi
            suff = (theta_t <= (1.0 - opts.gamma_theta) * theta0) | (
                phi_t <= phi0 - opts.gamma_phi * theta0
            )
            ok_f = switching & armijo
            ok = jnp.where(
                theta0 <= theta_min,
                jnp.where(switching, ok_f, suff),
                ok_f | suff,
            )
            ok = ok & not_blocked & jnp.isfinite(phi_t) & jnp.isfinite(theta_t)
            return ok, ok_f

        # first trial at alpha_max (+ second-order correction on rejection)
        th_1, ph_1 = eval_trial(z + alpha_max * dz, s + alpha_max * ds)
        ok_1, ftype_1 = trial_accept(alpha_max, th_1, ph_1)

        # SOC: if the full step was rejected and did not reduce infeasibility,
        # re-solve with rhs  alpha*r_p + r_p(trial)  (same KKT matrix) — corrects
        # constraint curvature so active-set steps are not cut to pieces.
        # Ipopt performs SOC only after a rejected first trial; the lax.cond
        # keeps the extra KKT solve + merit evaluations off the common
        # (first-trial-accepted) path.
        delta_c_used = jnp.where(
            delta_w_used > 0,
            jnp.maximum(delta_c_reg, 1e-8 * delta_w_used),
            opts.delta_c,
        )
        soc_wanted = (~ok_1) & (th_1 >= theta0)

        def do_soc(_):
            rp_trial = primal_residual(z + alpha_max * dz, s + alpha_max * ds)
            rbar_p_soc = (alpha_max * r_p + rp_trial) + jnp.where(
                ineq, rbar_s / sigma_s, 0.0
            )
            dz_c, dlam_c = kkt.solve(
                kdata, sigma_z, Drow, delta_w_used, delta_c_used, rbar_z, rbar_p_soc
            )
            ds_c = jnp.where(ineq, (dlam_c - rbar_s) / sigma_s, 0.0)
            a_soc = jnp.minimum(
                _max_step_to_boundary(z, dz_c, zl, zu, zlm, zum, tau),
                _max_step_to_boundary(s, ds_c, sl, su, slm, sum_, tau),
            )
            th_soc, ph_soc = eval_trial(z + a_soc * dz_c, s + a_soc * ds_c)
            ok_soc_raw, ftype_soc = trial_accept(a_soc, th_soc, ph_soc)
            valid = (
                ok_soc_raw
                & jnp.all(jnp.isfinite(dz_c))
                & (th_soc <= opts.kappa_soc * theta0)
            )
            return dz_c, dlam_c, ds_c, a_soc, valid, ftype_soc

        def no_soc(_):
            zero = jnp.asarray(0.0, dtype)
            return (
                jnp.zeros_like(dz),
                jnp.zeros_like(dlam),
                jnp.zeros_like(ds),
                zero,
                jnp.asarray(False),
                jnp.asarray(False),
            )

        dz_c, dlam_c, ds_c, a_soc, soc_valid_raw, ftype_soc = jax.lax.cond(
            soc_wanted, do_soc, no_soc, None
        )
        soc_valid = soc_wanted & soc_valid_raw

        # backtracking from alpha_max/2 (only reached if both trials failed)
        def ls_cond(state):
            alpha, ls_it, accepted, _ = state
            return (~accepted) & (ls_it < opts.max_ls)

        def ls_body(state):
            alpha, ls_it, _, _ = state
            th_t, ph_t = eval_trial(z + alpha * dz, s + alpha * ds)
            ok, ftype = trial_accept(alpha, th_t, ph_t)
            if opts.debug:
                jax.debug.print(
                    "   ls a={a:.3e} th={th:.6e} ph={ph:.8e} ok={ok}",
                    a=alpha,
                    th=th_t,
                    ph=ph_t,
                    ok=ok,
                )
            return jnp.where(ok, alpha, alpha * 0.5), ls_it + 1, ok, ftype

        alpha_bt, _, ok_bt, ftype_bt = jax.lax.while_loop(
            ls_cond,
            ls_body,
            (
                alpha_max * 0.5,
                jnp.asarray(0, jnp.int32),
                ok_1 | soc_valid,  # skip backtracking when already accepted
                jnp.asarray(False),
            ),
        )

        use_soc = soc_valid & (~ok_1)
        accepted = ok_1 | soc_valid | ok_bt
        if opts.debug:
            jax.debug.print(
                "it={it} mu={mu:.1e} amax={amax:.2e} th0={th0:.3e} phi0={phi0:.6e} "
                "dphi={dphi:.3e} th1={th1:.3e} ph1={ph1:.6e} ok1={ok1} soc={soc} "
                "okbt={okbt} abt={abt:.2e} dw={dw:.1e} |dz|={ndz:.2e} |dlam|={ndl:.2e}",
                it=carry.it,
                mu=mu,
                amax=alpha_max,
                th0=theta0,
                phi0=phi0,
                dphi=dphi,
                th1=th_1,
                ph1=ph_1,
                ok1=ok_1,
                soc=soc_valid,
                okbt=ok_bt,
                abt=alpha_bt,
                dw=delta_w_used,
                ndz=jnp.max(jnp.abs(dz)),
                ndl=jnp.max(jnp.abs(dlam)),
            )
        alpha = jnp.where(
            ok_1, alpha_max, jnp.where(use_soc, a_soc, alpha_bt)
        )
        alpha = jnp.where(accepted, alpha, alpha_max * (0.5 ** opts.max_ls))
        is_ftype = jnp.where(
            ok_1, ftype_1, jnp.where(use_soc, ftype_soc, ftype_bt)
        )
        dz_f = jnp.where(use_soc, dz_c, dz)
        ds_f = jnp.where(use_soc, ds_c, ds)
        dlam_f = jnp.where(use_soc, dlam_c, dlam)

        # augment the filter on h-type (non-Armijo) accepted steps
        add_entry = accepted & (~is_ftype)
        slot = carry.filt_n % opts.filter_size
        filt_th_n = jnp.where(
            add_entry,
            filt_th.at[slot].set((1.0 - opts.gamma_theta) * theta0),
            filt_th,
        )
        filt_ph_n = jnp.where(
            add_entry, filt_ph.at[slot].set(phi0 - opts.gamma_phi * theta0), filt_ph
        )
        filt_n_n = jnp.where(add_entry, carry.filt_n + 1, carry.filt_n)

        # bound-multiplier steps along the selected direction, full dual FTB step
        dwL = jnp.where(zlm, -(wL / gL) * dz_f - wL + mu / gL, 0.0)
        dwU = jnp.where(zum, (wU / gU) * dz_f - wU + mu / gU, 0.0)
        dyL = jnp.where(slm, -(yL / sgL) * ds_f - yL + mu / sgL, 0.0)
        dyU = jnp.where(sum_, (yU / sgU) * ds_f - yU + mu / sgU, 0.0)
        a_wL = _dual_step_to_boundary(wL, dwL, zlm, tau)
        a_wU = _dual_step_to_boundary(wU, dwU, zum, tau)
        a_yL = _dual_step_to_boundary(yL, dyL, slm, tau)
        a_yU = _dual_step_to_boundary(yU, dyU, sum_, tau)
        alpha_dual = jnp.minimum(jnp.minimum(a_wL, a_wU), jnp.minimum(a_yL, a_yU))

        z_n = z + alpha * dz_f
        s_n = s + alpha * ds_f
        lam_n = lam + alpha * dlam_f
        wL_n = jnp.clip(wL + alpha_dual * dwL, 0.0)
        wU_n = jnp.clip(wU + alpha_dual * dwU, 0.0)
        yL_n = jnp.clip(yL + alpha_dual * dyL, 0.0)
        yU_n = jnp.clip(yU + alpha_dual * dyU, 0.0)

        # ---- feasibility restoration (lite) ----
        # When NO trial step is acceptable (Ipopt enters its restoration-phase
        # NLP here, Waechter-Biegler sec. 3.3), take a damped Gauss-Newton step
        # on the constraint violation ||c(z) - rhs - s||^2 with the slacks reset
        # to the projection of c(z) onto their box (Ipopt's slack reset), and
        # restart the filter. This is the rescue path the reference leans on
        # via Ipopt/MadNLP (test/test_common.jl:87-90).
        did_restore = ~accepted

        def restore(_):
            # Gauss-Newton system reuses kdata's scaled Jacobians (same point
            # z) with the Hessian zeroed — no second prepare() in the program
            gn_data = kkt.gauss_newton_data(kdata)
            s_r = jnp.where(ineq, push_interior(c(z), sl, su, slm, sum_), 0.0)
            r_r = primal_residual(z, s_r)
            dz_gn, _ = kkt.solve(
                gn_data,
                jnp.zeros((nz,), dtype),
                jnp.ones((nc,), dtype),
                jnp.asarray(1e-8, dtype),
                jnp.asarray(0.0, dtype),
                jnp.zeros((nz,), dtype),
                r_r,
            )
            dz_gn = jnp.where(jnp.isfinite(dz_gn), dz_gn, 0.0)
            a_r = _max_step_to_boundary(z, dz_gn, zl, zu, zlm, zum, tau)
            cand = a_r * 0.5 ** jnp.arange(8, dtype=dtype)

            def theta_of(a):
                return jnp.sum(jnp.abs(primal_residual(z + a * dz_gn, s_r)))

            ths = jax.vmap(theta_of)(cand)
            kbest = jnp.argmin(ths)
            z_r = z + cand[kbest] * dz_gn
            s_rr = jnp.where(ineq, push_interior(c(z_r), sl, su, slm, sum_), 0.0)
            progressed = ths[kbest] <= (1.0 - 1e-4) * theta0
            # Ipopt resets equality multipliers after restoration
            # (constr_mult_reset_threshold default): the stale lam is exactly
            # what drove the solver into the corner
            return z_r, s_rr, jnp.zeros_like(lam), progressed

        def no_restore(_):
            return z_n, s_n, lam_n, jnp.asarray(False)

        z_n, s_n, lam_n, resto_progress = jax.lax.cond(
            did_restore, restore, no_restore, None
        )
        soft_fails = jnp.where(
            accepted & solve_ok,
            0,
            jnp.where(resto_progress, carry.soft_fails, carry.soft_fails + 1),
        )

        # Ipopt's kappa_Sigma dual safeguard: keep bound duals consistent with mu
        def clamp_dual(wv, gap, mask):
            lo = mu / (1e10 * gap)
            hi = 1e10 * mu / gap
            return jnp.where(mask, jnp.clip(wv, lo, hi), 0.0)

        gLn = _safe_gap(z_n, zl, zlm)
        gUn = _safe_gap(zu, z_n, zum)
        sgLn = _safe_gap(s_n, sl, slm)
        sgUn = _safe_gap(su, s_n, sum_)
        wL_n = clamp_dual(wL_n, gLn, zlm)
        wU_n = clamp_dual(wU_n, gUn, zum)
        yL_n = clamp_dual(yL_n, sgLn, slm)
        yU_n = clamp_dual(yU_n, sgUn, sum_)

        # ---- dual refresh (Ipopt recalc_y; see IPMOptions.recalc_lam) ----
        if opts.recalc_lam and nc > 0:
            refresh_wanted = (
                accepted
                & (alpha <= opts.recalc_lam_alpha)
                & (theta0 <= opts.recalc_lam_feas_tol)
            )

            def refresh(_):
                g_n = grad_f(z_n) - wL_n + wU_n
                # damp inequality rows in the LSQ system and refresh ONLY the
                # equality multipliers: ineq-row lam must stay consistent with
                # the slack duals (r_s = -lam - yL + yU), which the LSQ ignores
                lam_ls = kkt.lsq_lambda(
                    z_n, g_n, scale_f, scale_c, Drow=jnp.where(ineq, 1.0, 0.0)
                )
                lam_ls = jnp.where(eq, lam_ls, lam_n)
                # monotone safeguard: keep the refresh only if it strictly
                # reduces the dual residual at z_n (a bad LSQ jump on a
                # nonconvex iterate otherwise derails the whole solve)
                vjp_c = jax.vjp(c, z_n)[1]

                def e_d(lam_try):
                    return jnp.max(jnp.abs(g_n + vjp_c(lam_try)[0]))

                ok = (
                    jnp.all(jnp.isfinite(lam_ls))
                    & (jnp.max(jnp.abs(lam_ls)) < 1e8)
                    & (e_d(lam_ls) < 0.5 * e_d(lam_n))
                )
                return jnp.where(ok, lam_ls, lam_n)

            lam_n = jax.lax.cond(refresh_wanted, refresh, lambda _: lam_n, None)

        # ---- convergence & barrier update ----
        err_mu, err_0, viol = kkt_error_pair(
            z_n, s_n, lam_n, wL_n, wU_n, yL_n, yU_n, mu
        )

        # a non-finite TRIAL point (objective/constraints inf at a
        # near-boundary step) is a failed iteration, not divergence: revert to
        # the previous iterate and let soft_fail/restoration machinery act.
        # True divergence is detected on the iterate norm below.
        bad_new = ~jnp.isfinite(err_0)
        z_n = jnp.where(bad_new, z, z_n)
        s_n = jnp.where(bad_new, s, s_n)
        lam_n = jnp.where(bad_new, lam, lam_n)
        wL_n = jnp.where(bad_new, wL, wL_n)
        wU_n = jnp.where(bad_new, wU, wU_n)
        yL_n = jnp.where(bad_new, yL, yL_n)
        yU_n = jnp.where(bad_new, yU, yU_n)
        err_0 = jnp.where(bad_new, carry.kkt_err, err_0)
        err_mu = jnp.where(bad_new, jnp.inf, err_mu)  # no barrier decrease
        soft_fails = jnp.where(bad_new, carry.soft_fails + 1, soft_fails)

        if opts.mu_strategy == "adaptive" and n_compl > 0:
            # adaptive mode recomputes mu from complementarity at the top of
            # every iteration; the filter is only restarted on restoration
            mu_next = mu
            mu_changed = jnp.asarray(False)
        else:
            mu_next = jnp.where(
                err_mu <= opts.kappa_eps * mu,
                jnp.maximum(
                    opts.mu_min,
                    jnp.minimum(opts.kappa_mu * mu, mu**opts.theta_mu),
                ),
                mu,
            )
            mu_next = jnp.maximum(mu_next, opts.mu_min)
            mu_changed = mu_next < mu

        # the filter belongs to one barrier subproblem: reset it when mu drops
        # and after a restoration step (fresh filter for the restored point)
        refresh = mu_changed | did_restore
        fresh_th, fresh_ph = _fresh_filter()
        filt_th_n = jnp.where(refresh, fresh_th, filt_th_n)
        filt_ph_n = jnp.where(refresh, fresh_ph, filt_ph_n)
        filt_n_n = jnp.where(refresh, jnp.asarray(1, jnp.int32), filt_n_n)

        converged = err_0 <= opts.tol
        diverged = ~jnp.isfinite(err_0) | (jnp.max(jnp.abs(z_n)) > 1e20)
        stalled = soft_fails >= opts.max_soft_fail
        done = converged | diverged | stalled
        status = jnp.where(
            converged, 0, jnp.where(diverged, 3, jnp.where(stalled, 2, 1))
        ).astype(jnp.int32)

        return _Carry(
            z=z_n,
            s=s_n,
            lam=lam_n,
            wL=wL_n,
            wU=wU_n,
            yL=yL_n,
            yU=yU_n,
            mu=mu_next,
            filt_theta=filt_th_n,
            filt_phi=filt_ph_n,
            filt_n=filt_n_n,
            delta_w_last=delta_w_last,
            it=carry.it + 1,
            done=done,
            status=status,
            kkt_err=err_0,
            soft_fails=soft_fails,
        )

    # ---- driver loop ----
    lam0 = jnp.zeros((nc,), dtype)
    lam_ls = None
    if opts.lsq_lambda_init and nc > 0:
        # least-squares multiplier init (Ipopt's resto-free init): solve
        # (J J^T + eps I) lam = -J (grad f - wL + wU); reject if too large
        g_init = grad_f(z_init) - wL0 + wU0
        lam_ls = kkt.lsq_lambda(z_init, g_init, scale_f, scale_c)
    if lam_ls is not None:
        lam0 = jnp.where(
            (jnp.max(jnp.abs(lam_ls)) <= opts.lambda_init_max)
            & jnp.all(jnp.isfinite(lam_ls)),
            lam_ls,
            lam0,
        )
    err_init, viol_init = kkt_error(z_init, s_init, lam0, wL0, wU0, yL0, yU0, 0.0)

    init_carry = _Carry(
        z=z_init,
        s=s_init,
        lam=lam0,
        wL=wL0,
        wU=wU0,
        yL=yL0,
        yU=yU0,
        mu=mu0,
        filt_theta=_fresh_filter()[0],
        filt_phi=_fresh_filter()[1],
        filt_n=jnp.asarray(1, jnp.int32),
        delta_w_last=jnp.asarray(0.0, dtype),
        it=jnp.asarray(0, jnp.int32),
        done=err_init <= opts.tol,
        status=jnp.where(err_init <= opts.tol, 0, 1).astype(jnp.int32),
        kkt_err=err_init,
        soft_fails=jnp.asarray(0, jnp.int32),
    )

    history = None
    if opts.max_iter == 0:
        final = init_carry
    elif return_history:
        # debug mode: fixed-length scan with masked steps, emitting per-iteration
        # (mu, kkt_err, alpha-proxy via |dz| impossible here; log scalars we have)
        def scan_body(carry, _):
            active = (~carry.done) & (carry.it < opts.max_iter)
            new = step(carry)
            out = jax.tree_util.tree_map(
                lambda a, b: jnp.where(active, b, a), carry, new
            )
            rec = (out.it, out.mu, out.kkt_err, out.filt_n, out.delta_w_last, f(out.z))
            return out, rec

        final, history = jax.lax.scan(scan_body, init_carry, None, length=opts.max_iter)
    else:
        final = jax.lax.while_loop(
            lambda cr: (~cr.done) & (cr.it < opts.max_iter),
            step,
            init_carry,
        )

    viol_final = jnp.max(
        jnp.abs(primal_residual(final.z, final.s) / scale_c), initial=0.0
    )
    status = jnp.where(
        final.done, final.status, jnp.asarray(1, jnp.int32)
    )
    # acceptable-level fallback: a stall or iteration cap with the error already
    # below acceptable_tol counts as success (Ipopt Solved_To_Acceptable_Level)
    status = jnp.where(
        (status != 0) & (status != 3) & (final.kkt_err <= opts.acceptable_tol),
        jnp.asarray(4, jnp.int32),
        status,
    )
    if opts.max_iter == 0:
        # transcription round-trip mode (reference max_iter=0 trick,
        # test/ci/test_initial_guess.jl:6–54): report the init as "solved"
        status = jnp.asarray(0, jnp.int32)

    # honor_original_bounds: project the final point back inside the
    # UNRELAXED box (the bound_relax_factor slack is an internal device)
    z_out = jnp.clip(final.z, zl_orig, zu_orig)
    final = final._replace(z=z_out)

    # unscale duals back to the user's problem: the scaled problem is
    # min s_f f s.t. s_c c, so lam_user = lam * s_c / s_f, bound duals / s_f
    result = IPMResult(
        z=final.z,
        lam=final.lam * scale_c / scale_f,
        zL=final.wL / scale_f,
        zU=final.wU / scale_f,
        s=final.s,
        yL=final.yL,
        yU=final.yU,
        objective=f_user(final.z),
        iterations=final.it,
        kkt_error=final.kkt_err,
        constraints_violation=viol_final,
        status=status,
        successful=(status == 0) | (status == 4),
    )
    if return_history:
        return result, history
    return result
