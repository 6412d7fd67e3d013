"""Pendulum-on-a-cart swing-up: the nonlinear control-limited benchmark.

Reference: ``src/system_pendcart.jl`` — continuous dynamics (``:75-80``),
Euler discretization ``dfsys`` (``:83-89``), quadratic cost with appended
terminal term (``:92-106``), analytic Jacobians + ZoH discretization via
matrix exponential (``:137-154``), LQR baseline via CARE (``:3-25``), and the
closed-loop LQG simulation that *fails* under control limits (``:162-188``) —
the story the control-limited iLQG run then fixes (``:197-206``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import expm

from ..problem import Problem
from ..policy import Derivs

# reference constants (src/system_pendcart.jl:42-60)
GRAV = 9.82
POLE_LEN = 0.35
DT = 0.01
DAMP = 0.99


@dataclasses.dataclass(frozen=True)
class PendCartSpec:
    Q: Tuple[float, ...] = (10.0, 1.0, 2.0, 1.0)   # state weights (diagonal)
    R: float = 1.0
    goal: Tuple[float, ...] = (np.pi, 0.0, 0.0, 0.0)
    g: float = GRAV
    l: float = POLE_LEN
    h: float = DT
    d: float = DAMP


def dynamics_continuous(x, u, spec: PendCartSpec):
    """xd = [θ̇, -g/l sinθ + u/l cosθ - d θ̇, ṗ, u] (src/system_pendcart.jl:75-80)."""
    return jnp.stack([
        x[1],
        -spec.g / spec.l * jnp.sin(x[0]) + u[0] / spec.l * jnp.cos(x[0])
        - spec.d * x[1],
        x[3],
        u[0],
    ])


def make_pendcart_problem(spec: PendCartSpec = PendCartSpec(),
                          derivs: str = "zoh",
                          dtype=jnp.float32) -> Problem:
    """Build the pendcart :class:`Problem`.

    ``derivs``:
      - ``"zoh"`` — the reference's scheme: analytic continuous Jacobians,
        zero-order-hold discretized per timestep via a 5×5 matrix exponential
        (``src/system_pendcart.jl:137-154``), vmapped over T.
      - ``"autodiff"`` — the default style: exact Jacobians of the
        Euler step by jacfwd. (The reference mixes Euler rollout with ZoH
        derivatives; autodiff is self-consistent and converges comparably.)
      - ``"euler"`` — hand-written exact Jacobians of the Euler step (same
        values as ``"autodiff"``, pure elementwise trig — the cheapest
        derivative path; used by the throughput benchmark).
    """
    Q = jnp.diag(jnp.asarray(spec.Q, dtype))
    R = jnp.asarray([[spec.R]], dtype)
    goal = jnp.asarray(spec.goal, dtype)
    h, g, l, d = spec.h, spec.g, spec.l, spec.d

    def dynamics(x, u, t):
        """Euler step (``dfsys``, src/system_pendcart.jl:83-89)."""
        return x + h * dynamics_continuous(x, u, spec)

    def cost(x, u, t):
        dx = x - goal
        return 0.5 * (dx @ (Q @ dx) + u @ (R @ u))

    def traj_cost(x_traj, u_traj):
        """Per-step costs with the reference's appended terminal evaluation
        at zero control (src/system_pendcart.jl:97-106): returns (T+1,)."""
        dx = x_traj - goal
        c_run = 0.5 * (jnp.einsum('ti,ij,tj->t', dx, Q, dx)
                       + jnp.einsum('ti,ij,tj->t', u_traj, R, u_traj))
        dT = x_traj[-1] - goal
        c_term = 0.5 * (dT @ (Q @ dT))
        return jnp.concatenate([c_run, c_term[None]])

    if derivs == "zoh":
        def deriv_fn(x_traj, u_traj):
            T = u_traj.shape[0]

            def per_step(x, u):
                fxc = jnp.array([
                    [0.0, 1.0, 0.0, 0.0],
                    [-g / l * jnp.cos(x[0]) - u[0] / l * jnp.sin(x[0]),
                     -d, 0.0, 0.0],
                    [0.0, 0.0, 0.0, 1.0],
                    [0.0, 0.0, 0.0, 0.0],
                ], dtype).at[1, 0].set(
                    -g / l * jnp.cos(x[0]) - u[0] / l * jnp.sin(x[0]))
                fuc = jnp.array([[0.0], [0.0], [0.0], [1.0]], dtype
                                ).at[1, 0].set(jnp.cos(x[0]) / l)
                # ZoH sampling: expm([[fxc h, fuc h], [0, 0]])
                # (src/system_pendcart.jl:148)
                M = jnp.zeros((5, 5), dtype)
                M = M.at[:4, :4].set(fxc * h).at[:4, 4:].set(fuc * h)
                ABd = expm(M)
                return ABd[:4, :4], ABd[:4, 4:]

            fx, fu = jax.vmap(per_step)(x_traj[:T], u_traj)
            dxg = x_traj[:T] - goal
            return Derivs(
                fx=fx, fu=fu,
                cx=dxg @ Q.T, cu=u_traj @ R.T,
                cxx=jnp.broadcast_to(Q, (T, 4, 4)),
                cxu=jnp.zeros((T, 4, 1), dtype),
                cuu=jnp.broadcast_to(R, (T, 1, 1)))

    elif derivs == "euler":
        def deriv_fn(x_traj, u_traj):
            """Exact Jacobians of the Euler step, written elementwise so the
            whole derivative stack is a handful of fused elementwise ops per
            trajectory point (no per-step matrix construction)."""
            T = u_traj.shape[0]
            th = x_traj[:T, 0]
            u0 = u_traj[:, 0]
            a21 = h * (-g / l * jnp.cos(th) - u0 / l * jnp.sin(th))  # (T,)
            z = jnp.zeros_like(th)
            o = jnp.ones_like(th)
            hh = jnp.full_like(th, h)
            dd = jnp.full_like(th, 1.0 - h * d)
            # fx = I + h*fxc  (rows: [1,h,0,0; a21,1-hd,0,0; 0,0,1,h; 0,0,0,1])
            fx = jnp.stack([
                jnp.stack([o, hh, z, z], -1),
                jnp.stack([a21, dd, z, z], -1),
                jnp.stack([z, z, o, hh], -1),
                jnp.stack([z, z, z, o], -1),
            ], -2)                                            # (T, 4, 4)
            fu = jnp.stack([z, h * jnp.cos(th) / l, z, hh], -1)[..., None]
            dxg = x_traj[:T] - goal
            return Derivs(
                fx=fx, fu=fu,
                cx=dxg @ Q.T, cu=u_traj @ R.T,
                cxx=jnp.broadcast_to(Q, (T, 4, 4)),
                cxu=jnp.zeros((T, 4, 1), dtype),
                cuu=jnp.broadcast_to(R, (T, 1, 1)))

    elif derivs == "autodiff":
        deriv_fn = None
    else:
        raise ValueError(f"unknown derivs scheme {derivs!r}")

    return Problem(dynamics=dynamics, cost=cost, derivs=deriv_fn,
                   traj_cost=traj_cost)


@functools.lru_cache(maxsize=32)
def pendcart_lanes(spec: PendCartSpec = PendCartSpec()):
    """Lane-tile model for the Pallas forward kernel: dynamics/cost on lists
    of lane tiles (one per state/control dim). Same math as
    :func:`make_pendcart_problem` (Euler step + diagonal quadratic cost +
    terminal evaluation, ``src/system_pendcart.jl:75-106``)."""
    from ..ops.pallas.forward_kernel import LanesModel
    g, l, h, d = spec.g, spec.l, spec.h, spec.d
    Q = tuple(float(q) for q in spec.Q)
    R = float(spec.R)
    goal = tuple(float(v) for v in spec.goal)

    def dynamics(x, u, t):
        th, thd, p, pd = x
        f = u[0]
        thdd = (-g / l) * jnp.sin(th) + (f / l) * jnp.cos(th) - d * thd
        return [th + h * thd, thd + h * thdd, p + h * pd, pd + h * f]

    def cost(x, u, t):
        c = 0.5 * R * u[0] * u[0]
        for i in range(4):
            dx = x[i] - goal[i]
            c = c + 0.5 * Q[i] * dx * dx
        return c

    def terminal(x):
        c = None
        for i in range(4):
            dx = x[i] - goal[i]
            term = 0.5 * Q[i] * dx * dx
            c = term if c is None else c + term
        return c

    return LanesModel(n=4, m=1, dynamics=dynamics, cost=cost,
                      terminal=terminal)


@functools.lru_cache(maxsize=32)
def pendcart_packed_derivs(spec: PendCartSpec = PendCartSpec()):
    """Lane-layout derivative generator for the Pallas backward kernel:
    ``(x_lanes (T, n, ...), u_lanes (T, m, ...)) → packed (T, D+m, ...)``
    (slot order per ``ops.pallas.pack.DerivLayout`` + controls). Pure
    elementwise trig on lane tiles — no transposes, no autodiff. Same values
    as the ``"euler"`` analytic scheme."""
    g, l, h, d = spec.g, spec.l, spec.h, spec.d
    Q = tuple(float(q) for q in spec.Q)
    R = float(spec.R)
    goal = tuple(float(v) for v in spec.goal)

    def packed(x_lanes, u_lanes):
        th = x_lanes[:, 0]
        u0 = u_lanes[:, 0]
        z = jnp.zeros_like(th)
        o = jnp.ones_like(th)
        a21 = h * (-g / l * jnp.cos(th) - u0 / l * jnp.sin(th))
        # fx = I + h*fxc, row-major 4x4
        fx = [o, h * o, z, z,
              a21, (1.0 - h * d) * o, z, z,
              z, z, o, h * o,
              z, z, z, o]
        fu = [z, h * jnp.cos(th) / l, z, h * o]
        cx = [Q[i] * (x_lanes[:, i] - goal[i]) for i in range(4)]
        cu = [R * u0]
        cxx = [Q[i] * o if i == j else z
               for i in range(4) for j in range(4)]
        cxu = [z] * 4
        cuu = [R * o]
        return jnp.stack(fx + fu + cx + cu + cxx + cxu + cuu + [u0], axis=1)

    return packed


@functools.lru_cache(maxsize=32)
def pendcart_derivs_tiles(spec: PendCartSpec = PendCartSpec()):
    """In-kernel derivative tiles for the Pallas backward kernel: computes
    the analytic Euler-step Jacobians and cost expansions per timestep from
    (x, u) lane tiles — the backward kernel then streams only the 5-slot
    trajectory instead of the 47-slot packed derivatives."""
    g, l, h, d = spec.g, spec.l, spec.h, spec.d
    Q = tuple(float(q) for q in spec.Q)
    R = float(spec.R)
    goal = tuple(float(v) for v in spec.goal)

    def tiles(x, u, t):
        th = x[0]
        u0 = u[0]
        z = jnp.zeros_like(th)
        o = jnp.ones_like(th)
        a21 = h * (-g / l * jnp.cos(th) - u0 / l * jnp.sin(th))
        fx = [[o, h * o, z, z],
              [a21, (1.0 - h * d) * o, z, z],
              [z, z, o, h * o],
              [z, z, z, o]]
        fu = [[z], [h * jnp.cos(th) / l], [z], [h * o]]
        cx = [Q[i] * (x[i] - goal[i]) for i in range(4)]
        cu = [R * u0]
        cxx = [[Q[i] * o if i == j else z for j in range(4)]
               for i in range(4)]
        cxu = [[z] for _ in range(4)]
        cuu = [[R * o]]
        return dict(fx=fx, fu=fu, cx=cx, cu=cu, cxx=cxx, cxu=cxu, cuu=cuu)

    return tiles


@functools.lru_cache(maxsize=32)
def pendcart_derivs_tiles_so(spec: PendCartSpec = PendCartSpec()):
    """Second-order derivative tiles (full DDP on the lane tier): the
    first-order tiles plus the Euler step's nonzero dynamics Hessians —
    only f₁ = θ̇ + h·θ̈ is nonlinear, with ∂²f₁/∂θ² = h(g/l·sinθ − u/l·cosθ)
    and ∂²f₁/∂θ∂u = −(h/l)sinθ. Layouts per the backward kernel:
    ``fxx[a][i][j]``, ``fxu[a][j][mi]``, ``fuu[a][mi][mj]``."""
    g, l, h, d = spec.g, spec.l, spec.h, spec.d
    first = pendcart_derivs_tiles(spec)

    def tiles(x, u, t):
        out = dict(first(x, u, t))
        th = x[0]
        u0 = u[0]
        z = jnp.zeros_like(th)
        d2_thth = h * (g / l * jnp.sin(th) - u0 / l * jnp.cos(th))
        d2_thu = -h / l * jnp.sin(th)
        fxx = [[[z] * 4 for _ in range(4)] for _ in range(4)]
        fxx[1][0][0] = d2_thth
        fxu = [[[z] for _ in range(4)] for _ in range(4)]
        fxu[1][0][0] = d2_thu
        fuu = [[[z]] for _ in range(4)]
        out.update(fxx=fxx, fxu=fxu, fuu=fuu)
        return out

    return tiles


@functools.lru_cache(maxsize=32)
def pendcart_lanes_param(spec: PendCartSpec = PendCartSpec()):
    """Parametrized lane model: per-scenario pole length and damping
    (``params = [l, d]`` lane tiles) — heterogeneous pendcart fleets in one
    compile. Other constants from ``spec``."""
    from ..ops.pallas.forward_kernel import LanesModel
    g, h = spec.g, spec.h
    Q = tuple(float(q) for q in spec.Q)
    R = float(spec.R)
    goal = tuple(float(v) for v in spec.goal)

    def dynamics(x, u, t, par):
        l, d = par
        th, thd, p, pd = x
        f = u[0]
        thdd = (-g / l) * jnp.sin(th) + (f / l) * jnp.cos(th) - d * thd
        return [th + h * thd, thd + h * thdd, p + h * pd, pd + h * f]

    def cost(x, u, t, par):
        c = 0.5 * R * u[0] * u[0]
        for i in range(4):
            dx = x[i] - goal[i]
            c = c + 0.5 * Q[i] * dx * dx
        return c

    def terminal(x, par):
        c = None
        for i in range(4):
            dx = x[i] - goal[i]
            term = 0.5 * Q[i] * dx * dx
            c = term if c is None else c + term
        return c

    return LanesModel(n=4, m=1, dynamics=dynamics, cost=cost,
                      terminal=terminal, n_params=2)


@functools.lru_cache(maxsize=32)
def pendcart_derivs_tiles_param(spec: PendCartSpec = PendCartSpec()):
    """In-kernel derivative tiles with per-scenario ``params = [l, d]``."""
    g, h = spec.g, spec.h
    Q = tuple(float(q) for q in spec.Q)
    R = float(spec.R)
    goal = tuple(float(v) for v in spec.goal)

    def tiles(x, u, t, par):
        l, d = par
        th = x[0]
        u0 = u[0]
        z = jnp.zeros_like(th)
        o = jnp.ones_like(th)
        a21 = h * (-g / l * jnp.cos(th) - u0 / l * jnp.sin(th))
        fx = [[o, h * o, z, z],
              [a21, 1.0 - h * d, z, z],
              [z, z, o, h * o],
              [z, z, z, o]]
        fu = [[z], [h * jnp.cos(th) / l], [z], [h * o]]
        cx = [Q[i] * (x[i] - goal[i]) for i in range(4)]
        cu = [R * u0]
        cxx = [[Q[i] * o if i == j else z for j in range(4)]
               for i in range(4)]
        cxu = [[z] for _ in range(4)]
        cuu = [[R * o]]
        return dict(fx=fx, fu=fu, cx=cx, cu=cu, cxx=cxx, cxu=cxu, cuu=cuu)

    return tiles


def default_lims(dtype=jnp.float32) -> jax.Array:
    """±5 control limits (src/system_pendcart.jl:45)."""
    return jnp.array([[-5.0, 5.0]], dtype)


def default_x0(dtype=jnp.float32) -> jax.Array:
    """x0 = [π - 0.6, 0, 0, 0] (src/system_pendcart.jl:42)."""
    return jnp.array([np.pi - 0.6, 0.0, 0.0, 0.0], dtype)


# ---------------------------------------------------------------------------
# LQR baseline (host-side; reference care/lqr, src/system_pendcart.jl:3-25)
# ---------------------------------------------------------------------------

def care(A, B, Q, R):
    """Continuous algebraic Riccati equation via ordered Schur decomposition
    of the Hamiltonian (reference ``care``, src/system_pendcart.jl:3-20).
    Host-side numpy/scipy — used only to build the LQG baseline."""
    import scipy.linalg
    A, B, Q, R = (np.asarray(a, np.float64) for a in (A, B, Q, R))
    G = B @ np.linalg.inv(R) @ B.T
    Z = np.block([[A, -G], [-Q, -A.T]])
    S, U, _ = scipy.linalg.schur(Z, sort=lambda w: w.real < 0)
    n = A.shape[0]
    U11 = U[:n, :n]
    U21 = U[n:, :n]
    return U21 @ np.linalg.inv(U11)


def lqr(A, B, Q, R):
    """LQR state feedback from CARE (src/system_pendcart.jl:21-25)."""
    S = care(A, B, Q, R)
    return np.linalg.solve(np.asarray(R, np.float64),
                           np.asarray(B, np.float64).T @ S)


def linearized_upright(spec: PendCartSpec = PendCartSpec()):
    """Continuous-time linearization around the upright equilibrium used for
    the LQG baseline (src/system_pendcart.jl:55-59)."""
    A = np.array([[0.0, 1.0, 0.0, 0.0],
                  [spec.g / spec.l, -spec.d, 0.0, 0.0],
                  [0.0, 0.0, 0.0, 1.0],
                  [0.0, 0.0, 0.0, 0.0]])
    B = np.array([[0.0], [-1.0 / spec.l], [0.0], [1.0]])
    return A, B


def simulate_pendcart(x0, L, spec: PendCartSpec, T: int, lims,
                      dtype=jnp.float32):
    """Closed-loop simulation under the (limit-clamped) LQG law — the failure
    baseline of the demo (src/system_pendcart.jl:162-188)."""
    L = jnp.asarray(L, dtype)
    problem = make_pendcart_problem(spec, dtype=dtype)

    def step(x, _):
        dx = x.at[0].add(-jnp.pi)
        u = -(L @ dx)
        if lims is not None:
            u = jnp.clip(u, lims[:, 0], lims[:, 1])
        x_next = problem.dynamics(x, u, 0)
        return x_next, (x, u)

    _, (xs, us) = jax.lax.scan(step, jnp.asarray(x0, dtype), None, length=T)
    cost = problem.trajectory_cost(xs, us)
    return xs, us, cost
