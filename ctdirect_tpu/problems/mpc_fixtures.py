"""BASELINE.json fixture problems: cart-pole swing-up and planar orbit transfer.

These two problems anchor BASELINE.json configs 3 and 4 (cart-pole receding-
horizon MPC with 1k warm-started batched instances; fuel-min free-tf orbit
transfer with 10k batched initial-condition scenarios). They do not exist in
the reference test/problems/ tree — the reference objectives below were
computed with this package's dense-KKT oracle at high tolerance and cross-
checked against the structured and cyclic-reduction paths (tests/test_all_ocp.py,
tests/test_accuracy.py) plus, for the orbit transfer, the impulsive Hohmann
lower bound (Δv = 0.1816 for r: 1 → 1.5, μ = 1)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ctdirect_tpu.model.init import InitialGuess
from ctdirect_tpu.model.ocp import PreOCP
from ctdirect_tpu.problems import Problem, register


def cartpole_dynamics(mc: float = 1.0, mp: float = 0.3, l: float = 0.5, g: float = 9.81):
    """Cart-pole ODE right-hand side; theta = 0 is the DOWN (stable) position,
    theta = pi upright. States [x, dx, th, dth], control [force]."""

    def dyn(t, x, u, v):
        _, dx, th, dth = x
        sth, cth = jnp.sin(th), jnp.cos(th)
        denom = mc + mp * sth**2
        ddx = (u[0] + mp * sth * (l * dth**2 + g * cth)) / denom
        ddth = (-u[0] * cth - mp * l * dth**2 * cth * sth - (mc + mp) * g * sth) / (
            l * denom
        )
        return jnp.array([dx, ddx, dth, ddth])

    return dyn


@register
def cartpole() -> Problem:
    """Cart-pole swing-up: hanging (th=0) to upright (th=pi) in T=2s, min energy.

    BASELINE.json config 3 fixture. Active constraints at the optimum: the cart
    position box |x| <= 0.7 and the force box |u| <= 12 both saturate during the
    swing, so warm-started MPC on this problem tracks a switching active set
    (the robustness property an MPC benchmark needs)."""
    pre = PreOCP("cartpole")
    pre.state(4).control(1)
    pre.time(t0=0.0, tf=2.0)
    pre.dynamics(cartpole_dynamics())
    pre.objective(lagrange=lambda t, x, u, v: u[0] ** 2)
    pre.state_bounds(lb=[-0.7], ub=[0.7], rg=[0])
    pre.control_bounds(lb=[-12.0], ub=[12.0])
    pre.initial_state([0.0, 0.0, 0.0, 0.0])
    pre.final_state([0.0, 0.0, np.pi, 0.0])
    init = InitialGuess(
        state=lambda t: [0.0, 0.0, np.pi * (t / 2.0) ** 2, np.pi * t],
        control=[0.0],
    )
    # dense-oracle objective at N=200 trapeze, tol 1e-10 (self-computed; no
    # reference value exists — see module docstring)
    return Problem(pre.build(), 70.365571, "cartpole", init=init)


@register
def orbit_transfer() -> Problem:
    """Planar low-thrust orbit transfer, fuel-min (smoothed L1), free tf.

    BASELINE.json config 4 fixture. Normalized units mu = 1: start on the
    circular orbit r = 1 at (1, 0) with v = (0, 1); finish on the circular
    orbit r = 1.5 (radius, tangential-flight and circular-speed boundary rows;
    phase free). Thrust magnitude path-constrained: |u|^2 <= Tmax^2 with
    Tmax = 0.1.

    Oracle design: the problem is multi-modal by
    revolution count — every extra revolution buys marginally less fuel — so
    the tf deadline PINS the local optimum: at the optimum tf saturates the
    deadline and the revolution count is forced. The deadline is 11.0 (~1.75
    revolutions, matching the init spiral); the round-2 value 15.0 admitted a
    second, more-revolutions basin (obj 0.1684 vs 0.19157) that the solver
    sometimes reached, making the stored objective irreproducible. The test
    additionally checks the UNSMOOTHED fuel integral of the returned control
    against the impulsive Hohmann lower bound (integral |u| dt >= 0.1816),
    which no smoothing artifact can undershoot (tests/test_all_ocp.py).

    Stored objective: smoothed-fuel optimum at the tf=11 deadline, certified
    by SIX independent cells (benchmarks/recompute_oracles.py, committed as
    ORACLES_r03.json): dense N=120/160 midpoint (0.172618 / 0.172430),
    structured N=120/300 midpoint (0.172618 / 0.172258), cr N=300 midpoint
    (0.172258, agrees with scan to 4e-14), trapeze N=300 structured
    (0.172010) — all Solve_Succeeded at tf = 11.0 with unsmoothed fuel
    integral 0.1823–0.1829 (Hohmann bound 0.1816 respected). The stored value
    is the N=300 cross-path figure; the rtol-1e-2 suite oracle covers every
    cell and the continuum extrapolation (~0.1721)."""
    mu = 1.0
    rf = 1.5
    tmax = 0.1
    # L1 smoothing: |u| ~ sqrt(u.u + eps^2) - eps. The -eps shift keeps the
    # integrand ~0 on coast arcs (instead of +eps), so the smoothed objective
    # stays within O(eps^2/Tmax * tf) ~ 1e-5 of the true fuel integral while
    # the Hessian stays bounded by 1/eps (the bare eps=1e-6 version needs 3x
    # the IPM iterations for the same answer).
    eps = 1e-3

    def dyn(t, x, u, v):
        px, py, vx, vy = x
        r3 = (px**2 + py**2) ** 1.5
        return jnp.array([vx, vy, -mu * px / r3 + u[0], -mu * py / r3 + u[1]])

    pre = PreOCP("orbit_transfer")
    pre.state(4).control(2).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(dyn)
    pre.objective(
        lagrange=lambda t, x, u, v: jnp.sqrt(u[0] ** 2 + u[1] ** 2 + eps**2) - eps
    )
    # tf in [2, 11]: fuel-min with a deadline. Without the deadline the
    # problem is ill-posed-flat in tf (more revolutions -> marginally less
    # fuel, forever); at the optimum tf sits on the deadline, which pins the
    # revolution count (see docstring). NB: no component boxes on u — they
    # would be redundant with the thrust-circle path row and make the active
    # set rank-deficient wherever thrust is axis-aligned.
    pre.variable_bounds(lb=[2.0], ub=[11.0])
    pre.path_constraint(
        lambda t, x, u, v: jnp.array([u[0] ** 2 + u[1] ** 2]),
        lb=[-np.inf],
        ub=[tmax**2],
    )
    pre.initial_state([1.0, 0.0, 0.0, 1.0])

    def final_orbit(x0, xf, v):
        px, py, vx, vy = xf
        r2 = px**2 + py**2
        return jnp.array(
            [
                r2 - rf**2,  # final radius
                px * vx + py * vy,  # no radial velocity
                vx**2 + vy**2 - mu / rf,  # circular speed
            ]
        )

    pre.boundary_constraint(final_orbit, lb=[0.0, 0.0, 0.0], ub=[0.0, 0.0, 0.0])

    # init: spiral outward over ~1.75 revolutions, tangential quarter-thrust
    tfi = 11.0

    def state0(t):
        s = t / tfi
        r = 1.0 + 0.5 * s
        ang = 2 * np.pi * 1.75 * s
        vmag = 1.0 / np.sqrt(r)
        return [
            r * np.cos(ang),
            r * np.sin(ang),
            -vmag * np.sin(ang),
            vmag * np.cos(ang),
        ]

    init = InitialGuess(state=state0, control=[0.0, 0.02], variable=[tfi])
    return Problem(pre.build(), 0.172258, "orbit_transfer", init=init)


@register
def swimmer2() -> Problem:
    """Alias of `swimmer`: the reference keeps a second dialect
    (test/problems/swimmer2.jl) only because its Exa path needs component-wise
    `∂(x_i)(t) ==` dynamics; this framework has ONE transcription (SURVEY.md
    §3.5 note), so the variant is mathematically identical."""
    from ctdirect_tpu.problems.vehicles import swimmer

    p = swimmer()
    return Problem(p.ocp, p.obj, "swimmer2", init=p.init)
