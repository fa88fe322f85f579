"""Batched receding-horizon MPC driver (BASELINE.json configs: "cart-pole
swing-up receding-horizon MPC, 1k warm-started batched instances per chip").

The reference has no MPC driver; its analogue is the warm-start/continuation
pattern (SURVEY.md §5 checkpoint/resume). Here the whole control loop is a
compiled program: per tick, every batched instance gets its measured state x0
injected through the boundary-constraint right-hand sides, the previous
optimal state is SHIFTED one step (the classic MPC warm start), and a
fixed-iteration resolve (solver/resolve.py) returns the new plan. One jit
call advances thousands of controllers."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ctdirect_tpu.solver.ipm import IPMOptions, ipm_solve, make_spec
from ctdirect_tpu.solver.resolve import WarmState, make_resolver, warm_state_from_result
from ctdirect_tpu.solver.structured_kkt import StructuredKKT
from ctdirect_tpu.transcription.docp import DOCP


def shift_state(docp: DOCP, st: WarmState) -> WarmState:
    """Shift the plan one step forward (duplicate the last step) — the MPC
    warm start between consecutive horizons."""

    def shift_z(z):
        V = docp.unpack(z)
        X = jnp.concatenate([V.X[1:], V.X[-1:]], axis=0)
        U = jnp.concatenate([V.U[1:], V.U[-1:]], axis=0)
        K = None
        if V.K is not None:
            K = jnp.concatenate([V.K[1:], V.K[-1:]], axis=0)
        return docp.pack(X, U, K, V.v)

    def shift_rows(arr, width):
        rows = arr[: docp.N * width].reshape(docp.N, width)
        shifted = jnp.concatenate([rows[1:], rows[-1:]], axis=0)
        return jnp.concatenate([shifted.reshape(-1), arr[docp.N * width :]])

    return WarmState(
        z=shift_z(st.z),
        s=shift_rows(st.s, docp.cw),
        lam=shift_rows(st.lam, docp.cw),
        wL=shift_rows(st.wL, docp.bw),
        wU=shift_rows(st.wU, docp.bw),
        yL=shift_rows(st.yL, docp.cw),
        yU=shift_rows(st.yU, docp.cw),
    )


class MPCController:
    """Compiled batched MPC loop over one DOCP structure.

    The initial-state boundary rows to retarget are located via
    `x0_boundary_rows`: indices (into the boundary-constraint rows) holding the
    equality x(t0) == x0, in state-component order."""

    def __init__(
        self,
        docp: DOCP,
        x0_boundary_rows: np.ndarray,
        resolve_iters: int = 3,
        mu: float = 1e-6,
        shift: bool = True,
        kkt_algorithm: str = "scan",
        kkt_solve_dtype=None,
        kkt_equilibrate: bool = False,
        kkt_pivot: bool = True,
        kkt_assemble_dtype=None,
        resolve_loop: str = "unroll",
        mesh: Optional[Mesh] = None,
        batch_axis: str = "batch",
        time_axis: Optional[str] = None,
        kkt_factory=None,
    ):
        """mesh + batch_axis: shard the instance batch (data-parallel tick).
        mesh + batch_axis + time_axis: 2-D mesh — instances sharded over
        batch_axis AND each instance's KKT chain solved by distributed CR over
        time_axis (the BASELINE batch x time multi-host configuration).
        kkt_factory(docp) -> KKT operator overrides the default construction
        (e.g. a custom preconditioned solver)."""
        self.docp = docp
        self.shift = shift
        spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        if kkt_factory is not None:
            kkt = kkt_factory(docp)
        elif mesh is not None and time_axis is not None:
            from ctdirect_tpu.parallel.time_shard import InsideTimeShardKKT

            kkt = InsideTimeShardKKT(
                docp, time_axis, mesh.shape[time_axis], solve_dtype=kkt_solve_dtype
            )
        else:
            # equilibration default OFF on the tick: the warm RTI resolve is
            # mildly conditioned by construction (it reaches machine-level
            # kkt at f32 without it), so the extra scaling passes would cost
            # memory traffic for nothing. Cold/ill-conditioned solves
            # (interface.solve path) default it ON instead.
            kkt = StructuredKKT(
                docp, algorithm=kkt_algorithm, solve_dtype=kkt_solve_dtype,
                equilibrate=kkt_equilibrate, pivot=kkt_pivot,
                assemble_dtype=kkt_assemble_dtype,
            )
        resolve = make_resolver(
            docp.nlp_objective,
            docp.constraints,
            spec,
            kkt,
            iters=resolve_iters,
            mu=mu,
            loop=resolve_loop,
        )
        rows = docp.boundary_row_indices()[np.asarray(x0_boundary_rows)]
        cl0 = jnp.asarray(docp._c_lb)
        cu0 = jnp.asarray(docp._c_ub)
        zl = jnp.asarray(docp._z_lb)
        zu = jnp.asarray(docp._z_ub)

        def tick(st: WarmState, x0):
            cl = cl0.at[rows].set(x0)
            cu = cu0.at[rows].set(x0)
            if shift:
                st = shift_state(docp, st)
            res = resolve(st, zl, zu, cl, cu)
            V = docp.unpack(res.state.z)
            u0 = docp.scheme.node_controls(V.U)[0]
            return res.state, u0, res.kkt_error, res.constraints_violation

        vtick = jax.vmap(tick)
        if mesh is not None and time_axis is not None:
            # 2-D batch x time mesh: one shard_map over the WHOLE mesh. The
            # instance batch is sharded over batch_axis; inside the body the
            # KKT chain solve runs distributed CR over time_axis (the
            # InsideTimeShardKKT built above issues the ppermute/psum/
            # all_gather collectives), while everything else is replicated
            # over time_axis.
            smap = jax.shard_map(
                vtick,
                mesh=mesh,
                in_specs=(P(batch_axis), P(batch_axis)),
                out_specs=(P(batch_axis), P(batch_axis), P(batch_axis), P(batch_axis)),
                check_vma=False,
            )
            self._tick = jax.jit(smap)
        elif mesh is not None:
            # shard the batch (data-parallel) axis over the mesh: the resolve
            # is embarrassingly parallel across instances, so XLA partitions
            # the whole tick with zero collectives on the hot path
            sharding = NamedSharding(mesh, P(batch_axis))

            def sharded_tick(st, x0):
                st = jax.tree_util.tree_map(
                    lambda a: jax.lax.with_sharding_constraint(a, sharding), st
                )
                x0 = jax.lax.with_sharding_constraint(x0, sharding)
                return vtick(st, x0)

            self._tick = jax.jit(sharded_tick)
        else:
            self._tick = jax.jit(vtick)

    def __call__(self, states, x0_batch):
        """Advance all controllers one tick. states: batched WarmState;
        x0_batch: (B, len(rows)). Returns (new_states, u0, kkt_err, viol)."""
        return self._tick(states, x0_batch)

    def cold_start(self, options: Optional[IPMOptions] = None, init=None) -> WarmState:
        """One full-IPM solve to seed the warm state (unbatched)."""
        from ctdirect_tpu.solver.interface import _get_solver

        docp = self.docp
        opts = options or IPMOptions(tol=1e-8)
        solver = _get_solver(docp, opts)
        z0 = docp.initial_guess(init)
        res, _post = solver(z0, docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        return warm_state_from_result(res)


def broadcast_state(st: WarmState, batch: int) -> WarmState:
    """Tile an unbatched warm state across a batch axis."""
    return WarmState(*(jnp.broadcast_to(a, (batch,) + a.shape).copy() for a in st))
