"""Forward rollout, line search, and covariance propagation.

Reference: ``forward_pass`` (``src/forward_pass.jl:9-33``) and
``forward_covariance`` (``src/forward_pass.jl:37-56``).

Design: the per-timestep loop is a ``lax.scan`` with jittable user
dynamics; the serial backtracking line search of the reference
(``src/iLQG.jl:266-281``) becomes a vmap over all α candidates evaluated in
parallel, then a select of the *first* (largest-α) acceptable one — identical
accept decision, no serial latency.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..policy import GaussianPolicy
from ..problem import Problem
from .precision import highest_precision


class Rollout(NamedTuple):
    x: jax.Array      # (T, n) — states visited (x[t] before applying u[t])
    u: jax.Array      # (T, m) — applied (possibly clamped) controls
    cost: jax.Array   # (T,)  — per-step costs


@highest_precision
def forward_pass(problem: Problem,
                 x0: jax.Array,
                 u: jax.Array,
                 x_old: Optional[jax.Array] = None,
                 alpha=1.0,
                 policy: Optional[GaussianPolicy] = None,
                 lims: Optional[jax.Array] = None) -> Rollout:
    """Roll out ``u_t = u[t] + α k_t + K_t (x_t - x_old[t])``, clamped to
    ``lims``, through ``problem.dynamics`` (``src/forward_pass.jl:16-30``).

    ``policy=None`` reproduces the reference's empty-policy rollout used for
    trajectory initialization (``src/iLQG.jl:185``).
    """
    T, m = u.shape
    dtype = u.dtype
    alpha = jnp.asarray(alpha, dtype)
    use_policy = policy is not None
    if lims is not None:
        lims = jnp.asarray(lims, dtype)
    if x_old is None:
        x_old = jnp.zeros((T,) + x0.shape, dtype)

    def step(x_t, inputs):
        u_t, k_t, K_t, xo_t, t = inputs
        if use_policy:
            dx = problem.diff(x_t, xo_t)
            u_new = u_t + alpha * k_t + K_t @ dx
        else:
            u_new = u_t
        if lims is not None:
            u_new = jnp.clip(u_new, lims[:, 0], lims[:, 1])
        x_next = problem.dynamics(x_t, u_new, t)
        return x_next, (x_t, u_new)

    if use_policy:
        ks, Ks = policy.k, policy.K
    else:
        n = x0.shape[0]
        ks = jnp.zeros((T, m), dtype)
        Ks = jnp.zeros((T, m, n), dtype)

    _, (x_traj, u_traj) = lax.scan(
        step, x0, (u, ks, Ks, x_old, jnp.arange(T)))
    cost = problem.trajectory_cost(x_traj, u_traj)
    return Rollout(x=x_traj, u=u_traj, cost=cost)


class LineSearchOut(NamedTuple):
    done: jax.Array           # any α accepted
    alpha: jax.Array          # accepted α (NaN if none)
    x: jax.Array
    u: jax.Array
    cost: jax.Array           # (T,) per-step costs of chosen candidate
    dcost: jax.Array          # Δcost = old - new
    expected: jax.Array       # -α(dV₁ + α dV₂)
    reduce_ratio: jax.Array


@highest_precision
def line_search(problem: Problem, x0, u, x_old, cost_old_total, policy,
                dV, alphas, lims=None,
                reduce_ratio_min=0.0) -> LineSearchOut:
    """Backtracking line search (``src/iLQG.jl:267-281``): all α candidates
    roll out in parallel; the first (reference = serial first-success) with
    ``reduce_ratio > reduce_ratio_min`` is selected."""
    dtype = u.dtype
    alphas = jnp.asarray(alphas, dtype)

    rollouts = jax.vmap(
        lambda a: forward_pass(problem, x0, u, x_old, a, policy, lims)
    )(alphas)

    totals = jnp.sum(rollouts.cost, axis=-1)
    dcost = cost_old_total - totals
    expected = -alphas * (dV[0] + alphas * dV[1])
    # reference: negative expected reduction "should not occur" → use
    # sign(Δcost) (src/iLQG.jl:271-276)
    ratio = jnp.where(expected > 0, dcost / expected, jnp.sign(dcost))
    ok = ratio > reduce_ratio_min
    done = jnp.any(ok)
    idx = jnp.argmax(ok)  # first True (α sorted descending, like reference)

    pick = lambda a: a[idx]
    return LineSearchOut(
        done=done,
        alpha=jnp.where(done, alphas[idx], jnp.nan),
        x=pick(rollouts.x), u=pick(rollouts.u), cost=pick(rollouts.cost),
        dcost=dcost[idx], expected=expected[idx], reduce_ratio=ratio[idx])


@highest_precision
def forward_covariance(fx: jax.Array, R1: jax.Array,
                       policy: GaussianPolicy) -> jax.Array:
    """Propagate the joint state-control covariance by a discrete Lyapunov
    iteration (``src/forward_pass.jl:37-56``):

        Σxx[0] = R1;  Σxx[t+1] = fx[t] Σxx[t] fx[t]' + R1
        Σux[t] = K Σxx[t];  Σuu[t] = K Σxx[t] K' + Σ

    Returns ``(T, n+m, n+m)``. The reference leaves the last step's u-blocks
    undefined; we fill them (only the xx block is consumed by
    ``kl_div_wiki``, ``src/klutils.jl:77``).
    """
    T = fx.shape[0]
    n = fx.shape[1]
    m = policy.m

    def step(sigma_xx, inputs):
        fx_t, K_t, sig_t = inputs
        ux = K_t @ sigma_xx
        uu = ux @ K_t.T + sig_t
        full = jnp.block([[sigma_xx, ux.T], [ux, uu]])
        sigma_next = fx_t @ sigma_xx @ fx_t.T + R1
        return sigma_next, full

    _, out = lax.scan(step, R1, (fx, policy.K, policy.sigma))
    return out
