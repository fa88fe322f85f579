"""Precision of the block solvers: every contraction of the reduced-precision
(f32) solve is pinned to Precision.HIGHEST, so no backend may run it in a
reduced matmul mode; and the dense oracle's plain LU matches Gauss-Jordan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ctdirect_tpu.solver import lanes
from ctdirect_tpu.solver import structured_kkt as sk
from ctdirect_tpu.solver.kkt import DenseKKT, gj_solve
from ctdirect_tpu.parallel.time_shard import make_sharded_tridiag_solver

HIGHEST = jax.lax.Precision.HIGHEST
N, BS, WB, B = 6, 4, 3, 5


def _chain(lead=()):
    rng = np.random.default_rng(0)
    A = rng.standard_normal(lead + (N, BS, BS)) + 6.0 * np.eye(BS)
    A = A + np.swapaxes(A, -1, -2)
    Bc = 0.3 * rng.standard_normal(lead + (N - 1, BS, BS))
    E = 0.3 * rng.standard_normal(lead + (N, BS, WB))
    F = rng.standard_normal(lead + (WB, WB)) + 6.0 * np.eye(WB)
    F = F + np.swapaxes(F, -1, -2)
    r = rng.standard_normal(lead + (N, BS))
    rb = rng.standard_normal(lead + (WB,))
    return tuple(jnp.asarray(x, jnp.float32) for x in (A, Bc, E, F, r, rb))


def _subjaxprs(v):
    if hasattr(v, "eqns"):
        yield v
    elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
        yield v.jaxpr
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _subjaxprs(x)


def _dot_precisions(jaxpr):
    """precision params of every dot_general, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                out += _dot_precisions(sub)
    return out


def _time_shard_solve(*chain):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("time",))
    return make_sharded_tridiag_solver(mesh, "time", N, BS, WB)(*chain)


@pytest.mark.parametrize(
    "name,fn,lead",
    [
        pytest.param(name, fn, lead, id=name)
        for name, fn, lead in [
            ("lanes_batched", jax.vmap(lanes.cr_solve), (B,)),
            ("lanes_chain", lanes.cr_solve, ()),
            ("masked_cr", sk._cr_solve, ()),
            ("scan", sk._scan_solve, ()),
            ("time_shard", _time_shard_solve, ()),
        ]
    ],
)
def test_f32_solve_contractions_are_highest(name, fn, lead):
    jaxpr = jax.make_jaxpr(fn)(*_chain(lead)).jaxpr
    precs = _dot_precisions(jaxpr)
    assert precs, f"{name}: no dot_general traced"
    bad = [p for p in precs if p is None or any(x != HIGHEST for x in p)]
    assert not bad, f"{name}: {len(bad)} of {len(precs)} dot_generals not HIGHEST: {bad[:3]}"


def test_dense_kkt_lu_matches_gauss_jordan():
    """DenseKKT.solve (plain jnp.linalg.solve, f64) against pivoted
    Gauss-Jordan on the same assembled quasi-definite system."""
    rng = np.random.default_rng(1)
    nz, nc = 7, 3
    Q = rng.standard_normal((nz, nz))
    Q = Q @ Q.T + np.eye(nz)
    Jc = rng.standard_normal((nc, nz))
    op = DenseKKT(
        lambda z: 0.5 * z @ jnp.asarray(Q) @ z,
        lambda z: jnp.asarray(Jc) @ z,
        nz, nc,
    )
    z = jnp.asarray(rng.standard_normal(nz))
    data = op.prepare(z, jnp.zeros(nc), 1.0, jnp.ones(nc))
    sigma = jnp.asarray(rng.uniform(0.1, 1.0, nz))
    Drow = jnp.asarray(rng.uniform(0.0, 0.1, nc))
    rz = jnp.asarray(rng.standard_normal(nz))
    rp = jnp.asarray(rng.standard_normal(nc))
    dz, dlam = op.solve(data, sigma, Drow, 1e-8, 1e-8, rz, rp)
    assert dz.dtype == jnp.float64

    W, J = data
    K = jnp.block([[W + jnp.diag(sigma + 1e-8), J.T], [J, -jnp.diag(Drow + 1e-8)]])
    ref = gj_solve(K, -jnp.concatenate([rz, rp])[:, None])[:, 0]
    np.testing.assert_allclose(np.asarray(dz), np.asarray(ref[:nz]), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dlam), np.asarray(ref[nz:]), rtol=1e-11, atol=1e-12)
