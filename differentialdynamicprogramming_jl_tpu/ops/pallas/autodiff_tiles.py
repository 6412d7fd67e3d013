"""Autodiff derivative tiles: the lane fast path for ANY user model.

The Pallas backward kernel's preferred input mode is a ``derivs_tiles``
function computing the per-step derivative expansion in-register from
(x, u) lane tiles (``backward_kernel.read_derivs``). The built-in models
hand-write these (``models/pendcart.py:234``, ``models/linear.py``); this
module derives them AUTOMATICALLY from a :class:`~.forward_kernel.LanesModel`
with forward-mode autodiff, so a user who has written their dynamics/cost
once (as elementwise scalar expressions over lane tiles — the same functions
the forward kernel already requires) gets the full Pallas tier without any
hand-written Jacobians.

This is the lane-tier analogue of the reference making ``df`` optional:
the reference requires hand-written derivatives (``src/iLQG.jl:77-84``);
the XLA tier here autodiffs ``Problem`` functions (``problem.py``), and this
module closes the same gap on the lane tier.

Why this lowers through Triton safely: ``jax.jvp`` is a trace-time
transform —
the tangent program of elementwise tile arithmetic is again elementwise tile
arithmetic, exactly the op set the hand-written tile functions use. One jvp
per input dimension yields a Jacobian column (n+m jvps for fx/fu/cx/cu);
forward-over-forward per direction pair yields the Hessian tiles
((n+m)(n+m+1)/2 double-jvps, mirrored by symmetry). At lane-tier sizes
(n ≲ 12) this is a handful of extra fused elementwise ops per step; the
analytic generators remain the documented fast path when they exist.

Terminal-cost convention: identical to the hand-written generators — the
boundary expansion differentiates the RUNNING cost at t = T-1 (the built-in
models' terminal quadratics coincide with their running state cost, matching
the reference's zero-control final evaluation,
``src/system_pendcart.jl:97-106``).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from .pack import DerivLayout
from .forward_kernel import LanesModel


def _fc_factory(model: LanesModel, t, par):
    """(xu list) → (f list, c) with the model's params threading."""
    n = model.n

    def fc(xu):
        xs, us = xu[:n], xu[n:]
        if model.n_params:
            return (list(model.dynamics(xs, us, t, par)),
                    model.cost(xs, us, t, par))
        return list(model.dynamics(xs, us, t)), model.cost(xs, us, t)

    return fc


def autodiff_derivs_tiles(model: LanesModel,
                          second_order: bool = False) -> Callable:
    """See :func:`_autodiff_derivs_tiles`. This thin wrapper normalizes the
    argument spelling so ``f(m)``, ``f(m, False)`` and
    ``f(m, second_order=False)`` all hit the same cache entry (an lru_cache
    directly on the public function keys positional/keyword spellings
    differently, which would silently hand out distinct — recompiling —
    function objects)."""
    return _autodiff_derivs_tiles(model, bool(second_order))


@functools.lru_cache(maxsize=64)
def _autodiff_derivs_tiles(model: LanesModel,
                           second_order: bool = False) -> Callable:
    """Build a ``derivs_tiles`` function for :func:`~.backward_kernel.
    backward_lanes` from ``model``'s dynamics/cost alone.

    ``second_order=True`` additionally emits the dynamics Hessian tiles
    (``fxx``/``fxu``/``fuu``) — full DDP on the lane tier — from the same
    double-jvp sweep that produces the cost Hessian, at no extra jvp count.

    The result is a plain function (hashable, no captured arrays beyond the
    model's own constants) used as a static jit argument of the lane
    drivers; this builder is ``lru_cache``d by model, so repeated calls
    with the same (cached) model return the SAME function object and hit
    the drivers' jit cache (CLAUDE.md jit-cache discipline).
    """
    n, m = model.n, model.m
    nm = n + m

    def tiles(x, u, t, par=None):
        fc = _fc_factory(model, t, par)
        xu0 = list(x) + list(u)

        def unit(i):
            # per-dim ones/zeros: tangent dtype/shape must match each
            # primal's exactly (x and u tiles may differ)
            return [jnp.ones_like(xu0[j]) if j == i
                    else jnp.zeros_like(xu0[j]) for j in range(nm)]

        # first order: one jvp per input dim = Jacobian column + cost grad
        dfs, dcs = [], []
        for i in range(nm):
            _, (df, dc) = jax.jvp(fc, (xu0,), (unit(i),))
            dfs.append(df)
            dcs.append(dc)
        out = dict(
            fx=[[dfs[i][a] for i in range(n)] for a in range(n)],
            fu=[[dfs[n + mi][a] for mi in range(m)] for a in range(n)],
            cx=dcs[:n],
            cu=dcs[n:],
        )

        # second order: forward-over-forward per direction pair (i ≤ j),
        # mirrored by symmetry of the Hessians
        def d_dir(j):
            uj = unit(j)

            def g(xu):
                if second_order:
                    _, tangents = jax.jvp(fc, (xu,), (uj,))
                    return tangents                    # (df list, dc)
                _, (_, dc) = jax.jvp(fc, (xu,), (uj,))
                return dc

            return g

        H = [[None] * nm for _ in range(nm)]           # cost Hessian
        Hf = ([[[None] * nm for _ in range(nm)] for _ in range(n)]
              if second_order else None)               # per-output f Hessians
        for j in range(nm):
            gj = d_dir(j)
            for i in range(j + 1):
                _, d2 = jax.jvp(gj, (xu0,), (unit(i),))
                if second_order:
                    d2f, d2c = d2
                    for a in range(n):
                        Hf[a][i][j] = Hf[a][j][i] = d2f[a]
                else:
                    d2c = d2
                H[i][j] = H[j][i] = d2c

        out["cxx"] = [[H[i][j] for j in range(n)] for i in range(n)]
        out["cxu"] = [[H[i][n + mi] for mi in range(m)] for i in range(n)]
        out["cuu"] = [[H[n + mi][n + mj] for mj in range(m)]
                      for mi in range(m)]
        if second_order:
            # kernel layouts (backward_kernel.py full-DDP contractions):
            # fxx[a][i][j], fxu[a][j][mi], fuu[a][mi][mj]
            out["fxx"] = [[[Hf[a][i][j] for j in range(n)]
                           for i in range(n)] for a in range(n)]
            out["fxu"] = [[[Hf[a][j][n + mi] for mi in range(m)]
                           for j in range(n)] for a in range(n)]
            out["fuu"] = [[[Hf[a][n + mi][n + mj] for mj in range(m)]
                           for mi in range(m)] for a in range(n)]
        return out

    return tiles


@functools.lru_cache(maxsize=64)
def autodiff_packed_derivs(model: LanesModel) -> Callable:
    """Build a ``packed_derivs`` generator — ``(x_lanes (T, n, ...),
    u_lanes (T, m, ...)) → (T, D+m, ...)`` slots per
    :class:`~.pack.DerivLayout` plus the nominal controls — from the model:
    the out-of-kernel input mode of the backward kernel, for models whose
    derivative stream should be cached across λ retries. Same autodiff
    construction as :func:`autodiff_derivs_tiles`."""
    n, m = model.n, model.m
    lay = DerivLayout(n, m)

    def packed(x_lanes, u_lanes):
        T = u_lanes.shape[0]
        tiles = autodiff_derivs_tiles(model)
        x = [x_lanes[:, i] for i in range(n)]
        u = [u_lanes[:, mi] for mi in range(m)]
        # t enters only through the model functions; lane models take a
        # traced scalar — broadcast a per-step index vector shaped like the
        # leading T axis so closures over t stay elementwise
        t = jnp.arange(T).reshape((T,) + (1,) * (x_lanes.ndim - 2))
        d = tiles(x, u, t)
        slots = ([d["fx"][a][i] for a in range(n) for i in range(n)]
                 + [d["fu"][a][mi] for a in range(n) for mi in range(m)]
                 + d["cx"] + d["cu"]
                 + [d["cxx"][i][j] for i in range(n) for j in range(n)]
                 + [d["cxu"][i][mi] for i in range(n) for mi in range(m)]
                 + [d["cuu"][mi][mj] for mi in range(m) for mj in range(m)]
                 + u)
        slots = [jnp.broadcast_to(s, x_lanes.shape[:1] + x_lanes.shape[2:])
                 for s in slots]
        assert len(slots) == lay.D + m
        return jnp.stack(slots, axis=1)

    return packed
