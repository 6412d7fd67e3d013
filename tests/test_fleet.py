"""Fleet scheduler (solvers/fleet.py): chunked + straggler-compacted solves
must reproduce the single lock-step solve exactly (the resume entry carries
λ/dλ/accepted counters, so composition is semantically one solve)."""
import jax
import jax.numpy as jnp
import numpy as np

from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    PendCartSpec, default_x0, pendcart_lanes, pendcart_derivs_tiles)
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
    ILQGConfig, default_alphas)
from differentialdynamicprogramming_jl_tpu.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu.solvers.fleet import ilqg_fleet
import pytest


@pytest.mark.smoke
def test_fleet_matches_lockstep():
    B, T = 8, 6
    spec = PendCartSpec()
    x0s = (default_x0(jnp.float32)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4),
                                     jnp.float32))
    u0s = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1),
                                  jnp.float32)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=6, iter_cap=10)
    kw = dict(lims=((-5.0, 5.0),), cfg=cfg,
              derivs_tiles=pendcart_derivs_tiles(spec),
              kt_backward=2, kt_forward=2, interpret=True)
    ref = ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s, **kw)
    fl = ilqg_fleet(pendcart_lanes(spec), None, x0s, u0s, chunk_iters=2,
                    **kw)
    np.testing.assert_allclose(np.asarray(fl.cost_total),
                               np.asarray(ref.cost_total), rtol=2e-4)
    np.testing.assert_array_equal(np.asarray(fl.reason),
                                  np.asarray(ref.reason))
    np.testing.assert_array_equal(np.asarray(fl.n_accepted),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_allclose(np.asarray(fl.u), np.asarray(ref.u),
                               atol=1e-4)
    # total loop iterations across chunks ≥ the lock-step count per scenario
    assert np.all(np.asarray(fl.n_iters) >= np.asarray(ref.n_iters))


def test_fleet_sharded_matches_lockstep():
    """ilqg_fleet_sharded over an 8-device mesh: per-shard straggler
    compaction must reproduce the lock-step solve exactly (the
    straggler win once evaporated under sharding)."""
    from differentialdynamicprogramming_jl_tpu.solvers.fleet import (
        ilqg_fleet_sharded)
    from differentialdynamicprogramming_jl_tpu.parallel.mesh import make_mesh
    B, T = 8, 6
    spec = PendCartSpec()
    x0s = (default_x0(jnp.float32)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4),
                                     jnp.float32))
    u0s = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1),
                                  jnp.float32)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=6, iter_cap=10)
    kw = dict(lims=((-5.0, 5.0),), cfg=cfg,
              derivs_tiles=pendcart_derivs_tiles(spec),
              kt_backward=2, kt_forward=2, interpret=True)
    ref = ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s, **kw)
    mesh = make_mesh()
    fl = ilqg_fleet_sharded(pendcart_lanes(spec), None, x0s, u0s,
                            chunk_iters=2, mesh=mesh, **kw)
    np.testing.assert_allclose(np.asarray(fl.cost_total),
                               np.asarray(ref.cost_total), rtol=2e-4)
    np.testing.assert_array_equal(np.asarray(fl.reason),
                                  np.asarray(ref.reason))
    np.testing.assert_array_equal(np.asarray(fl.n_accepted),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_array_equal(np.asarray(fl.n_iters),
                                  np.asarray(ref.n_iters))
    np.testing.assert_allclose(np.asarray(fl.u), np.asarray(ref.u),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(fl.x), np.asarray(ref.x),
                               atol=1e-4)
    # outputs stay device-sharded
    assert len({s.device for s in fl.u.addressable_shards}) == 8


def test_fleet_trace_stitching():
    """record_trace=True on ilqg_fleet stitches per-chunk traces at each
    scenario's global iteration offset: rows 1..n_iters must match the
    lock-step driver's trace exactly (rows past a scenario's n_iters are
    padding in both drivers and not compared)."""
    from differentialdynamicprogramming_jl_tpu.solvers.batch import BatchTrace
    B, T = 8, 6
    spec = PendCartSpec()
    x0s = (default_x0(jnp.float32)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4),
                                     jnp.float32))
    u0s = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1),
                                  jnp.float32)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=6, iter_cap=10)
    kw = dict(lims=((-5.0, 5.0),), cfg=cfg,
              derivs_tiles=pendcart_derivs_tiles(spec),
              kt_backward=2, kt_forward=2, interpret=True,
              record_trace=True)
    ref = ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s, **kw)
    fl = ilqg_fleet(pendcart_lanes(spec), None, x0s, u0s, chunk_iters=2,
                    **kw)
    assert fl.trace is not None
    n_it = np.asarray(fl.n_iters)
    np.testing.assert_array_equal(n_it, np.asarray(ref.n_iters))
    for f in BatchTrace._fields:
        a = np.asarray(getattr(fl.trace, f))
        b = np.asarray(getattr(ref.trace, f))
        for i in range(B):
            np.testing.assert_allclose(
                a[i, :n_it[i] + 1], b[i, :n_it[i] + 1], rtol=2e-4,
                atol=1e-6, err_msg=f"trace field {f}, scenario {i}")


def test_fleet_sharded_trace_stitching():
    """record_trace=True on ilqg_fleet_sharded: per-process local stitching
    must reproduce the lock-step driver's per-scenario trace (the
    sharded scheduler once dropped traces)."""
    from differentialdynamicprogramming_jl_tpu.solvers.batch import BatchTrace
    from differentialdynamicprogramming_jl_tpu.solvers.fleet import (
        ilqg_fleet_sharded)
    from differentialdynamicprogramming_jl_tpu.parallel.mesh import make_mesh
    B, T = 8, 6
    spec = PendCartSpec()
    x0s = (default_x0(jnp.float32)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4),
                                     jnp.float32))
    u0s = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1),
                                  jnp.float32)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=6, iter_cap=10)
    kw = dict(lims=((-5.0, 5.0),), cfg=cfg,
              derivs_tiles=pendcart_derivs_tiles(spec),
              kt_backward=2, kt_forward=2, interpret=True,
              record_trace=True)
    ref = ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s, **kw)
    mesh = make_mesh()
    fl = ilqg_fleet_sharded(pendcart_lanes(spec), None, x0s, u0s,
                            chunk_iters=2, mesh=mesh, **kw)
    assert fl.trace is not None
    n_it = np.asarray(fl.n_iters)
    np.testing.assert_array_equal(n_it, np.asarray(ref.n_iters))
    for f in BatchTrace._fields:
        a = np.asarray(getattr(fl.trace, f))
        b = np.asarray(getattr(ref.trace, f))
        for i in range(B):
            np.testing.assert_allclose(
                a[i, :n_it[i] + 1], b[i, :n_it[i] + 1], rtol=2e-4,
                atol=1e-6, err_msg=f"trace field {f}, scenario {i}")
