"""Autodiff derivative tiles (ops/pallas/autodiff_tiles.py): the generic
LanesModel → derivs_tiles bridge must reproduce the hand-written analytic
generators and drive the lane tier end-to-end.

The reference requires hand-written derivatives (``src/iLQG.jl:77-84``);
the XLA tier autodiffs ``Problem`` functions; this closes the same gap on
the Pallas tier.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    PendCartSpec, pendcart_lanes, pendcart_derivs_tiles,
    pendcart_derivs_tiles_so, pendcart_packed_derivs, default_x0)
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles, autodiff_packed_derivs)
from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import TILE
from differentialdynamicprogramming_jl_tpu.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
    ILQGConfig, default_alphas)

B, T = 8, 9
DTYPE = jnp.float32
LIMS = ((-5.0, 5.0),)


def _rand_tiles(n, m, key=0):
    k = jax.random.PRNGKey(key)
    x = [jax.random.normal(jax.random.fold_in(k, i), TILE, DTYPE)
         for i in range(n)]
    u = [jax.random.normal(jax.random.fold_in(k, 100 + i), TILE, DTYPE)
         for i in range(m)]
    return x, u


@pytest.mark.parametrize("second_order", [False, True])
def test_tiles_match_analytic(second_order):
    spec = PendCartSpec()
    model = pendcart_lanes(spec)
    ana = (pendcart_derivs_tiles_so(spec) if second_order
           else pendcart_derivs_tiles(spec))
    ad = autodiff_derivs_tiles(model, second_order=second_order)
    x, u = _rand_tiles(4, 1)
    t = jnp.int32(3)
    a, b = ana(x, u, t), ad(x, u, t)
    assert sorted(a.keys()) == sorted(b.keys())
    for key in a:
        la = jax.tree_util.tree_leaves(a[key])
        lb = jax.tree_util.tree_leaves(b[key])
        assert len(la) == len(lb)
        for i, (p, q) in enumerate(zip(la, lb)):
            np.testing.assert_allclose(
                np.asarray(p), np.asarray(q), rtol=2e-5, atol=2e-5,
                err_msg=f"{key}[{i}]")


def test_packed_matches_analytic():
    spec = PendCartSpec()
    model = pendcart_lanes(spec)
    x, u = _rand_tiles(4, 1)
    xl = jnp.stack(x)[None] * jnp.linspace(
        0.5, 1.5, 6, dtype=DTYPE).reshape(6, 1, 1, 1)
    xl = xl.reshape((6, 4, 1) + TILE)
    ul = jnp.broadcast_to(jnp.stack(u)[None], (6, 1) + TILE
                          ).reshape((6, 1, 1) + TILE)
    np.testing.assert_allclose(
        np.asarray(pendcart_packed_derivs(spec)(xl, ul)),
        np.asarray(autodiff_packed_derivs(model)(xl, ul)),
        rtol=2e-5, atol=2e-5)


def test_lane_driver_with_autodiff_tiles():
    """End-to-end: the lane driver solves the control-limited pendcart fleet
    with the autodiff tiles inside the Pallas kernel (interpret mode) and
    matches the analytic-tiles solve (same math up to float reassociation —
    compare solver-level outcomes, CLAUDE.md numerics note)."""
    spec = PendCartSpec()
    model = pendcart_lanes(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                     lam_max=1e15, max_iter=3)
    x0 = default_x0(DTYPE)
    x0s = x0[None, :] + (0.1 * jax.random.normal(
        jax.random.PRNGKey(0), (B, 4), DTYPE)
        * jnp.asarray([1, 0, 0, 0], DTYPE))
    u0s = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), DTYPE)

    kw = dict(lims=LIMS, cfg=cfg, kt_backward=3, kt_forward=3,
              interpret=True)
    ref = ilqg_batch_lanes(model, None, x0s, u0s,
                           derivs_tiles=pendcart_derivs_tiles(spec), **kw)
    out = ilqg_batch_lanes(model, None, x0s, u0s,
                           derivs_tiles=autodiff_derivs_tiles(model), **kw)
    np.testing.assert_allclose(np.asarray(out.cost_total),
                               np.asarray(ref.cost_total),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out.reason),
                                  np.asarray(ref.reason))
    np.testing.assert_allclose(np.asarray(out.Vx), np.asarray(ref.Vx),
                               rtol=5e-3, atol=5e-3)
