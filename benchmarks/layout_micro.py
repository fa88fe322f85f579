"""Microbenchmark: batched tiny-block linear algebra, batch-MAJOR (B, m, n, n)
vs batch-MINOR / lane-layout (m, n, n, B).

Measures the layout decision behind the lane-minor cyclic-reduction solver:
with the batch axis last, every tiny-block operation is an elementwise op
over contiguous (B,) slabs instead of a batch of tiny (5, 5) matrix
products. Which layout wins on the GPU is not measured yet.

Usage: python benchmarks/layout_micro.py [--cpu] [--b 512] [--m 128] [--n 5]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--m", type=int, default=128)  # blocks per instance
    ap.add_argument("--n", type=int, default=5)  # block size
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    if args.f64:
        os.environ["CTDIRECT_TPU_X64"] = "1"
    import jax
    import jax.numpy as jnp

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import numpy as np

    from ctdirect_tpu.solver.kkt import gj_inverse

    B, m, n = args.b, args.m, args.n
    dtype = jnp.float64 if args.f64 else jnp.float32
    rng = np.random.default_rng(0)
    A_major = jnp.asarray(
        rng.standard_normal((B, m, n, n)) + 4.0 * np.eye(n), dtype=dtype
    )
    A_minor = jnp.asarray(np.moveaxis(np.asarray(A_major), 0, -1))  # (m, n, n, B)

    def bench(name, fn, *xs, reps=20):
        out = jax.block_until_ready(fn(*xs))
        t0 = time.time()
        for _ in range(reps):
            out = fn(*xs)
        jax.block_until_ready(out)
        dt = (time.time() - t0) / reps
        print(f"{name:>28}: {dt*1e3:9.3f} ms", flush=True)
        return out

    # ---- matmul A @ A ----
    mm_major = jax.jit(lambda A: jnp.einsum("bmij,bmjk->bmik", A, A))
    mm_minor = jax.jit(lambda A: jnp.einsum("mijB,mjkB->mikB", A, A))

    def mm_minor_unrolled(A):
        # explicit sum over the tiny contraction index — elementwise ops
        return sum(
            A[:, :, j, None, :] * A[:, None, j, :, :] for j in range(n)
        )

    mm_minor_u = jax.jit(mm_minor_unrolled)

    bench("matmul batch-major einsum", mm_major, A_major)
    bench("matmul batch-minor einsum", mm_minor, A_minor)
    bench("matmul batch-minor unroll", mm_minor_u, A_minor)

    # ---- inverse ----
    inv_major = jax.jit(jax.vmap(jax.vmap(gj_inverse)))

    def gj_inverse_lanes(A):
        """Pivoted Gauss-Jordan in lane layout: A (m, n, n, B) -> inverse.
        Unrolled over columns; per-lane partial pivoting via onehot selects."""
        M = jnp.concatenate(
            [A, jnp.broadcast_to(jnp.eye(n, dtype=A.dtype)[None, :, :, None], A.shape)],
            axis=2,
        )  # (m, n, 2n, B)
        rows = jnp.arange(n)
        for j in range(n):
            colj = jnp.abs(M[:, :, j, :])  # (m, n, B)
            colj = jnp.where((rows >= j)[None, :, None], colj, -jnp.inf)
            p = jnp.argmax(colj, axis=1)  # (m, B)
            oh = (p[:, None, :] == rows[None, :, None]).astype(M.dtype)  # (m,n,B)
            rowp = jnp.einsum("mrB,mrcB->mcB", oh, M)  # pivot row (m, 2n, B)
            rowj = M[:, j, :, :]
            # swap: M[p] <- rowj, M[j] <- rowp
            M = M + oh[:, :, None, :] * (rowj[:, None, :, :] - rowp[:, None, :, :])
            M = M.at[:, j, :, :].set(rowp)
            piv = M[:, j, j, :]
            row = M[:, j, :, :] / piv[:, None, :]
            colv = M[:, :, j, :].at[:, j, :].set(0.0)
            M = M - colv[:, :, None, :] * row[:, None, :, :]
            M = M.at[:, j, :, :].set(row)
        return M[:, :, n:, :]

    inv_minor = jax.jit(gj_inverse_lanes)

    I1 = bench("inverse batch-major vmap-gj", inv_major, A_major)
    I2 = bench("inverse batch-minor lanes", inv_minor, A_minor)
    err = np.max(
        np.abs(np.moveaxis(np.asarray(I2), -1, 0) - np.asarray(I1))
    )
    print(f"inverse agreement: {err:.3e}")


if __name__ == "__main__":
    main()
