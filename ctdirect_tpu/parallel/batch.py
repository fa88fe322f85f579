"""Batched solves: vmap the ENTIRE interior-point solve across problem instances.

This is the batched answer to the reference's single-instance CPU solves
(SURVEY.md §2.3): thousands of warm-started MPC instances solve concurrently
on one device. Each
instance may have its own initial guess AND its own constraint right-hand sides
(e.g. per-instance initial state x0 arrives through the boundary-constraint
bounds), so the batch axis maps over (z0, cl, cu) — and optionally (zl, zu).

Divergent iteration counts across the batch are handled by the IPM's fixed-shape
while_loop: converged instances simply mask out (SURVEY.md §7.3.3); the batch
completes when the slowest instance does, so warm-started batches should share a
modest max_iter.

Sharding: pass a mesh axis name and the solver will annotate batch inputs with a
NamedSharding over that axis, so one jit call scales over all devices of a
`jax.sharding.Mesh` (data-parallel axis over ICI)."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ctdirect_tpu.solver.ipm import IPMOptions, ipm_solve, make_spec
from ctdirect_tpu.transcription.docp import DOCP


class BatchSolver:
    """Compiled batched solver for one DOCP structure.

    Call signature: solver(z0_batch, cl_batch, cu_batch) -> IPMResult with a
    leading batch axis on every field. Bounds default to the DOCP's static
    bounds broadcast across the batch.
    """

    def __init__(
        self,
        docp: DOCP,
        options: IPMOptions = IPMOptions(),
        mesh: Optional[Mesh] = None,
        batch_axis: str = "batch",
        kkt: Optional[object] = None,
    ):
        self.docp = docp
        self.options = options
        self.mesh = mesh
        self.batch_axis = batch_axis
        spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)

        if kkt is None and options.kkt_mode == "structured":
            from ctdirect_tpu.solver.structured_kkt import StructuredKKT

            kkt = StructuredKKT(docp)
        kw = {} if kkt is None else {"kkt": kkt}

        def solve_one(z0, zl, zu, cl, cu):
            return ipm_solve(
                docp.nlp_objective,
                docp.constraints,
                spec,
                z0,
                zl,
                zu,
                cl,
                cu,
                options=options,
                **kw,
            )

        vsolve = jax.vmap(solve_one, in_axes=(0, 0, 0, 0, 0))

        if mesh is not None:
            sharding = NamedSharding(mesh, P(batch_axis))

            def sharded(z0, zl, zu, cl, cu):
                args = [
                    jax.lax.with_sharding_constraint(a, sharding)
                    for a in (z0, zl, zu, cl, cu)
                ]
                return vsolve(*args)

            self._fn = jax.jit(sharded)
        else:
            self._fn = jax.jit(vsolve)

    def __call__(self, z0_batch, cl_batch=None, cu_batch=None, zl_batch=None, zu_batch=None):
        """Every per-instance quantity may vary across the batch: the initial
        guess, the constraint rhs (cl/cu — e.g. per-instance x0 through the
        boundary rows) AND the variable boxes (zl/zu — e.g. per-instance
        actuator limits, BASELINE configs 4–5). Unsupplied bounds broadcast
        from the DOCP's static ones."""
        B = z0_batch.shape[0]

        def bc(given, default):
            if given is not None:
                return given
            default = jnp.asarray(default)
            return jnp.broadcast_to(default, (B,) + default.shape)

        return self._fn(
            z0_batch,
            bc(zl_batch, self.docp._z_lb),
            bc(zu_batch, self.docp._z_ub),
            bc(cl_batch, self.docp._c_lb),
            bc(cu_batch, self.docp._c_ub),
        )


def make_batch_solver(docp, options=IPMOptions(), mesh=None, kkt=None) -> BatchSolver:
    return BatchSolver(docp, options=options, mesh=mesh, kkt=kkt)
