"""Planar quadrotor (birotor) — a third benchmark family, and the showcase
for the autodiff lane bridge.

Unlike the pendcart and LTI families (which mirror the reference's problems,
``src/system_pendcart.jl``, ``src/demo_linear.jl``, and ship hand-written
analytic derivative tiles), this model deliberately defines ONLY its
:class:`~..ops.pallas.forward_kernel.LanesModel` — the Pallas tier gets its
in-kernel derivative expansion from
:func:`~..ops.pallas.autodiff_tiles.autodiff_derivs_tiles`, demonstrating
the intended workflow for user models: write the dynamics/cost once, as
elementwise tile expressions, and everything else is derived.

Physics (planar birotor, the standard underactuated testbed):

    state  x = [px, vx, pz, vz, θ, ω]        control u = [u₁, u₂] ≥ 0
    v̇x = -(u₁+u₂)·sinθ/mass
    v̇z =  (u₁+u₂)·cosθ/mass − g
    ω̇  =  arm·(u₁−u₂)/inertia

Euler-discretized with step ``h``; diagonal quadratic cost to a hover goal
with the control penalized around the hover thrust u_h = mass·g/2 (a plain
u² penalty fights gravity). Thrust limits (0, u_max) make the problem
control-limited with an ACTIVE lower bound at rest — the m=2 in-kernel
9-configuration box-QP enumeration path at fleet scale.
"""
from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp

from ..problem import Problem


@dataclasses.dataclass(frozen=True)
class QuadrotorSpec:
    mass: float = 0.5
    inertia: float = 0.01
    arm: float = 0.17
    g: float = 9.81
    h: float = 0.02            # integration step
    u_max: float = 5.0         # per-rotor thrust limit; hover needs 2.45
    Q: tuple = (1.0, 0.1, 1.0, 0.1, 0.5, 0.05)
    R: float = 0.05
    goal: tuple = (0.0, 0.0, 1.0, 0.0, 0.0, 0.0)

    @property
    def u_hover(self) -> float:
        return self.mass * self.g / 2.0

    @property
    def lims(self):
        return ((0.0, self.u_max), (0.0, self.u_max))


def _step_scalars(spec: QuadrotorSpec, x, u):
    """One Euler step on per-dimension scalars/tiles (shared by both tiers —
    elementwise, so it broadcasts identically over jnp vectors and
    lane tiles)."""
    px, vx, pz, vz, th, om = x
    u1, u2 = u
    thrust = u1 + u2
    s, c = jnp.sin(th), jnp.cos(th)
    ax = -thrust * s / spec.mass
    az = thrust * c / spec.mass - spec.g
    al = spec.arm * (u1 - u2) / spec.inertia
    h = spec.h
    return [px + h * vx, vx + h * ax, pz + h * vz, vz + h * az,
            th + h * om, om + h * al]


def _cost_scalars(spec: QuadrotorSpec, x, u):
    c = None
    for i in range(6):
        dx = x[i] - spec.goal[i]
        term = 0.5 * spec.Q[i] * dx * dx
        c = term if c is None else c + term
    for j in range(2):
        du = u[j] - spec.u_hover
        c = c + 0.5 * spec.R * du * du
    return c


def _terminal_scalars(spec: QuadrotorSpec, x):
    c = None
    for i in range(6):
        dx = x[i] - spec.goal[i]
        term = 0.5 * spec.Q[i] * dx * dx
        c = term if c is None else c + term
    return c


@functools.lru_cache(maxsize=32)
def quadrotor_lanes(spec: QuadrotorSpec = QuadrotorSpec()):
    """Lane-tile model (n=6, m=2). Pair with
    ``autodiff_derivs_tiles(quadrotor_lanes(spec))`` for the backward
    kernel — there is intentionally no hand-written tile generator."""
    from ..ops.pallas.forward_kernel import LanesModel

    def dynamics(x, u, t):
        return _step_scalars(spec, x, u)

    def cost(x, u, t):
        return _cost_scalars(spec, x, u)

    def terminal(x):
        return _terminal_scalars(spec, x)

    return LanesModel(n=6, m=2, dynamics=dynamics, cost=cost,
                      terminal=terminal)


def make_quadrotor_problem(spec: QuadrotorSpec = QuadrotorSpec(),
                           dtype=jnp.float32) -> Problem:
    """XLA-tier :class:`Problem` (derivatives via autodiff) — the same math
    as :func:`quadrotor_lanes`, for cross-tier parity tests and f64 runs."""

    def dynamics(x, u, t):
        return jnp.stack(_step_scalars(spec, [x[i] for i in range(6)],
                                       [u[0], u[1]])).astype(dtype)

    def cost(x, u, t):
        return _cost_scalars(spec, [x[i] for i in range(6)], [u[0], u[1]])

    def traj_cost(x, u):
        """Per-step costs with the appended terminal evaluation — (T+1,),
        the same convention as the pendcart family (the forward kernel's
        terminal slot)."""
        run = _cost_scalars(spec, [x[:, i] for i in range(6)],
                            [u[:, 0], u[:, 1]])
        term = _terminal_scalars(spec, [x[-1, i] for i in range(6)])
        return jnp.concatenate([run, term[None]])

    return Problem(dynamics=dynamics, cost=cost, traj_cost=traj_cost)


def default_x0(dtype=jnp.float32):
    """Displaced start: 1 m sideways, on the ground, slight tilt."""
    return jnp.asarray([1.0, 0.0, 0.0, 0.0, 0.3, 0.0], dtype)
