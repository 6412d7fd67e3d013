"""Problem definition: the user-facing contract of the framework.

The reference's "plugin interface" is three callbacks ``f, costfun, df``
(``src/iLQG.jl:63-92``). The re-expression here: pure jittable functions
on per-timestep vectors, with derivatives produced by JAX autodiff *by
default* (``jax.jacfwd`` / hessians) — the reference makes users hand-write
``df``; autodiff is the upgrade. A hand-written ``derivs`` override
is supported for parity testing against the reference's analytic Jacobians
(e.g. ``src/system_pendcart.jl:137-154``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .policy import Derivs


def _default_diff(x_new, x_old):
    return x_new - x_old


@dataclasses.dataclass(frozen=True)
class Problem:
    """A finite-horizon optimal-control problem.

        minimize   sum_t cost(x_t, u_t, t)        (t = 0..T-1)
        subject to x_{t+1} = dynamics(x_t, u_t, t)

    matching the reference problem statement at ``src/iLQG.jl:58-61``.

    Fields (all static w.r.t. jit; array-valued data such as control limits is
    passed to the solvers separately):

    - ``dynamics(x, u, t) -> x_next``: single-step dynamics on vectors
      (reference ``f(x,u,i)``, ``src/iLQG.jl:67-71``).
    - ``cost(x, u, t) -> scalar``: running cost per timestep (reference
      ``costfun``, ``src/iLQG.jl:73-76``).
    - ``derivs(x_traj, u_traj) -> Derivs`` or None: derivative stack along a
      trajectory (reference ``df``, ``src/iLQG.jl:77-84``). ``None`` selects
      autodiff.
    - ``traj_cost(x_traj, u_traj) -> (T,) costs`` or None: full-trajectory
      cost override, used by demo problems whose reference cost functions
      append extra terminal terms (``src/system_pendcart.jl:97-106``).
    - ``diff(x_new, x_old) -> dx``: state difference used by the feedback term
      in the forward pass (reference ``diff_fun`` kwarg, ``src/iLQG.jl:131``;
      override for e.g. angle wrapping).
    - ``second_order``: build ``fxx/fxu/fuu`` via autodiff → full DDP. The
      reference switches on this via empty-array sentinels (``src/iLQG.jl:231``).
    """

    dynamics: Callable
    cost: Callable
    derivs: Optional[Callable] = None
    traj_cost: Optional[Callable] = None
    diff: Callable = _default_diff
    second_order: bool = False

    def make_derivs(self) -> Callable:
        """Return a ``(x_traj, u_traj) -> Derivs`` function."""
        if self.derivs is not None:
            return self.derivs
        return make_autodiff_derivs(self.dynamics, self.cost,
                                    second_order=self.second_order)

    def trajectory_cost(self, x_traj: jax.Array, u_traj: jax.Array) -> jax.Array:
        """Per-step costs ``(T,)`` along a trajectory (reference forward-pass
        cost evaluation, ``src/forward_pass.jl:30``)."""
        if self.traj_cost is not None:
            return self.traj_cost(x_traj, u_traj)
        T = u_traj.shape[0]
        ts = jnp.arange(T)
        return jax.vmap(self.cost)(x_traj, u_traj, ts)


def make_autodiff_derivs(dynamics: Callable, cost: Callable,
                         second_order: bool = False) -> Callable:
    """Build the derivative stack with JAX autodiff, vmapped over time.

    Replaces the reference's hand-written ``df`` contract
    (``src/iLQG.jl:77-84``). Uses forward-mode for the (small) Jacobians —
    n, m are tiny so jacfwd is one pass of n+m tangents.
    """

    fx_fn = jax.jacfwd(dynamics, argnums=0)
    fu_fn = jax.jacfwd(dynamics, argnums=1)
    cx_fn = jax.grad(cost, argnums=0)
    cu_fn = jax.grad(cost, argnums=1)
    cxx_fn = jax.jacfwd(cx_fn, argnums=0)
    cxu_fn = jax.jacfwd(cx_fn, argnums=1)   # (n, m)
    cuu_fn = jax.jacfwd(cu_fn, argnums=1)

    if second_order:
        fxx_fn = jax.jacfwd(fx_fn, argnums=0)  # (n, n, n): [a, i, j]
        fxu_fn = jax.jacfwd(fx_fn, argnums=1)  # (n, n, m)
        fuu_fn = jax.jacfwd(fu_fn, argnums=1)  # (n, m, m)

    def per_step(x, u, t):
        d = dict(
            fx=fx_fn(x, u, t), fu=fu_fn(x, u, t),
            cx=cx_fn(x, u, t), cu=cu_fn(x, u, t),
            cxx=cxx_fn(x, u, t), cxu=cxu_fn(x, u, t), cuu=cuu_fn(x, u, t),
        )
        if second_order:
            d.update(fxx=fxx_fn(x, u, t), fxu=fxu_fn(x, u, t),
                     fuu=fuu_fn(x, u, t))
        return d

    def derivs(x_traj, u_traj):
        T = u_traj.shape[0]
        ts = jnp.arange(T)
        d = jax.vmap(per_step)(x_traj[:T], u_traj, ts)
        return Derivs(**d)

    return derivs


def broadcast_derivs(T: int, fx, fu, cx, cu, cxx, cxu, cuu,
                     fxx=None, fxu=None, fuu=None) -> Derivs:
    """Materialize possibly time-invariant derivative arrays to ``(T, ...)``.

    This is the replacement for the reference's
    dispatch-on-array-rank selection of specialized backward passes
    (``src/iLQG.jl:82-84``; the 5 ``back_pass`` methods in
    ``src/backward_pass.jl``): broadcast once, run one kernel.
    """
    def bc(a, core_ndim):
        if a is None:
            return None
        a = jnp.asarray(a)
        if a.ndim == core_ndim:          # time-invariant: add T axis
            return jnp.broadcast_to(a, (T,) + a.shape)
        assert a.shape[0] == T, f"leading axis must be T={T}, got {a.shape}"
        return a

    return Derivs(
        fx=bc(fx, 2), fu=bc(fu, 2),
        cx=bc(cx, 1), cu=bc(cu, 1),
        cxx=bc(cxx, 2), cxu=bc(cxu, 2), cuu=bc(cuu, 2),
        fxx=bc(fxx, 3), fxu=bc(fxu, 3), fuu=bc(fuu, 3),
    )
