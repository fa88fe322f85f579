"""KKT operators: pluggable derivative computation + condensed-system solve.

The IPM core (ipm.py) is agnostic to HOW the condensed symmetric system

    [ W~ + Sigma_z + dw I    J~^T          ] [dz  ]   [ -rz ]
    [ J~                     -(D + dc I)   ] [dlam] = [ -rp ]

is represented and solved (W~ and J~ are the gradient-SCALED Lagrangian Hessian
and constraint Jacobian). A KKT operator provides:

    row_norms(z)                      -> (nc,) unscaled |J| row-inf-norms (for scaling)
    prepare(z, lam, sf, sc)           -> opaque data (the scaled W~, J~ in some form)
    solve(data, sigma_z, Drow, dw, dc, rz, rp) -> (dz, dlam)
    diag_scale(data)                  -> scalar ~ max |diag W~| (regularization scale)
    lsq_lambda(z, g, sf, sc)          -> lam least-squares init, or None

`DenseKKT` (here) materializes W and J and solves by dense factorization — the
reference path for small problems and the correctness oracle for the structured
path. `StructuredKKT` (structured_kkt.py) assembles per-step blocks and solves
the block-tridiagonal + arrowhead system in O(N) with no general factorization.

The dense solve uses `jnp.linalg.solve` (LU) in every precision. The small
block inverses of the structured engines use hand-rolled pivoted Gauss-Jordan
elimination (`gj_inverse` / `gj_solve` below): pure arithmetic that vmaps and
unrolls into the surrounding fusions.

`PREC` is the precision every `dot_general` of the block solvers carries.
Under mixed precision the block solve runs in f32, and XLA:GPU may run f32
products at default precision in TF32 (~10 mantissa bits), which would
corrupt even the one-hot pivot-row selections. HIGHEST keeps them exact f32;
it changes nothing on the CPU or for f64 operands."""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

PREC = jax.lax.Precision.HIGHEST


# ----------------------------------------------------------------------------
# Small-matrix kernels (pivoted Gauss-Jordan, lapack-free)
# ----------------------------------------------------------------------------


def _gj_eliminate(M: jnp.ndarray, n: int) -> jnp.ndarray:
    """Gauss-Jordan elimination WITH partial pivoting on an augmented (n, n+k)
    matrix. Row swaps are data movement (dynamic_update_slice), not lapack.
    Partial pivoting is required: interior-point KKT matrices have
    structurally zero diagonal entries (unbounded primal variables with zero
    Lagrangian curvature)."""

    def body(j, M):
        col = jnp.abs(M[:, j])
        col = jnp.where(jnp.arange(n) >= j, col, -jnp.inf)
        p = jnp.argmax(col)
        rowj, rowp = M[j], M[p]
        M = M.at[j].set(rowp).at[p].set(rowj)
        piv = M[j, j]
        row = M[j] / piv
        colv = M[:, j].at[j].set(0.0)
        M = M - jnp.outer(colv, row)
        M = M.at[j].set(row)
        return M

    return jax.lax.fori_loop(0, n, body, M)


def gj_inverse(A: jnp.ndarray) -> jnp.ndarray:
    """Matrix inverse via pivoted Gauss-Jordan. A: (n, n) (vmap for batches)."""
    n = A.shape[-1]
    M = jnp.concatenate([A, jnp.eye(n, dtype=A.dtype)], axis=-1)
    return _gj_eliminate(M, n)[:, n:]


def gj_solve(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve A X = B via pivoted Gauss-Jordan. A: (n, n), B: (n, k)."""
    n = A.shape[-1]
    M = jnp.concatenate([A, B], axis=-1)
    return _gj_eliminate(M, n)[:, n:]


# ----------------------------------------------------------------------------
# Dense operator
# ----------------------------------------------------------------------------


class DenseKKT:
    """Dense W/J via jax.hessian / jax.jacfwd; dense LU solve.

    Suitable for moderate problem sizes (the v0 path and the correctness oracle
    for StructuredKKT). f_user/c_user are the UNSCALED problem callables."""

    def __init__(self, f_user: Callable, c_user: Callable, nz: int, nc: int):
        self.f_user = f_user
        self.c_user = c_user
        self.nz = nz
        self.nc = nc

    def row_norms(self, z):
        J = jax.jacfwd(self.c_user)(z)
        return jnp.max(jnp.abs(J), axis=1)

    def prepare(self, z, lam, sf, sc):
        def lag(zz):
            return sf * self.f_user(zz) + jnp.dot(sc * lam, self.c_user(zz))

        W = jax.hessian(lag)(z)
        J = sc[:, None] * jax.jacfwd(self.c_user)(z)
        return (W, J)

    def solve(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        W, J = data
        Hbar = W + jnp.diag(sigma_z + delta_w)
        Dreg = Drow + delta_c
        KKT = jnp.block([[Hbar, J.T], [J, -jnp.diag(Dreg)]])
        rhs = -jnp.concatenate([rz, rp])
        sol = jnp.linalg.solve(KKT, rhs)
        return sol[: self.nz], sol[self.nz :]

    def diag_scale(self, data):
        W, _ = data
        return 1.0 + jnp.max(jnp.abs(jnp.diagonal(W)))

    def gauss_newton_data(self, data):
        """Same constraint Jacobians, zero Hessian — the Gauss-Newton system
        the restoration step solves. Reuses the prepared data instead of
        re-deriving at the same point."""
        W, J = data
        return (jnp.zeros_like(W), J)

    def lsq_lambda(self, z, g, sf, sc, Drow=None):
        """argmin_lam |g + J~^T lam| via (J~ J~^T + D + eps) lam = -J~ g.
        Optional Drow damps selected rows (the dual-refresh path damps
        inequality rows so their multipliers stay with the slack duals)."""
        J = sc[:, None] * jax.jacfwd(self.c_user)(z)
        M = J @ J.T + 1e-8 * jnp.eye(self.nc, dtype=z.dtype)
        if Drow is not None:
            M = M + jnp.diag(Drow)
        return gj_solve(M, -(J @ g)[:, None])[:, 0]
