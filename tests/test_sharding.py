"""Multi-device tests on a virtual 8-device CPU mesh (SURVEY.md §4: the
fake-multi-device trick; conftest sets
``--xla_force_host_platform_device_count=8``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu import ILQGConfig
from differentialdynamicprogramming_jl_tpu.models.linear import (
    random_lti, make_lti_problem)
from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
    make_mesh, ilqg_batched, ilqg_sharded)


@pytest.fixture(scope="module")
def problem_batch():
    key = jax.random.PRNGKey(0)
    T, B = 60, 16
    spec = random_lti(key, n=6, m=2, T=T, dtype=jnp.float64)
    prob = make_lti_problem(spec, T)
    x0s = jnp.tile(spec.x0, (B, 1)) * jnp.linspace(0.5, 2.0, B)[:, None]
    u0s = jnp.tile(spec.u0, (B, 1, 1))
    return prob, x0s, u0s


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_matches_vmap(problem_batch):
    """shard_map over 8 devices gives the same solves as single-device vmap."""
    prob, x0s, u0s = problem_batch
    cfg = ILQGConfig(max_iter=20)
    ref = ilqg_batched(prob, x0s, u0s, cfg=cfg)
    mesh = make_mesh()
    shd = ilqg_sharded(prob, x0s, u0s, cfg=cfg, mesh=mesh)
    np.testing.assert_allclose(np.array(shd.u), np.array(ref.u), atol=1e-9)
    np.testing.assert_allclose(np.array(jnp.sum(shd.cost, -1)),
                               np.array(jnp.sum(ref.cost, -1)), rtol=1e-12)
    np.testing.assert_array_equal(np.array(shd.reason), np.array(ref.reason))


def test_sharded_with_psum_stats(problem_batch):
    """reduce_stats=True psums fleet-wide convergence stats over the mesh."""
    prob, x0s, u0s = problem_batch
    cfg = ILQGConfig(max_iter=20)
    mesh = make_mesh()
    res, stats = ilqg_sharded(prob, x0s, u0s, cfg=cfg, mesh=mesh,
                              reduce_stats=True)
    total_cost = float(jnp.sum(res.cost))
    np.testing.assert_allclose(float(stats[0]), total_cost, rtol=1e-12)
    assert float(stats[1]) == float(jnp.sum(res.n_iters))


@pytest.fixture(scope="module")
def lane_batch():
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, default_x0, pendcart_lanes, pendcart_derivs_tiles)
    dtype = jnp.float32
    B, T = 8, 6
    spec = PendCartSpec()
    x0s = (default_x0(dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    return pendcart_lanes(spec), pendcart_derivs_tiles(spec), x0s, u0s


@pytest.mark.smoke
def test_sharded_lanes_matches_single_device(lane_batch):
    """The flagship Pallas lane tier under shard_map (8 devices, interpret
    mode) produces the same solves as the single-device lane driver."""
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        default_alphas)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
        ilqg_batch_sharded)
    model, dtiles, x0s, u0s = lane_batch
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=2, iter_cap=3)
    lims = ((-5.0, 5.0),)
    ref = ilqg_batch_lanes(model, None, x0s, u0s, lims=lims, cfg=cfg,
                           derivs_tiles=dtiles, kt_backward=2, kt_forward=2,
                           interpret=True)
    mesh = make_mesh()
    out, stats = ilqg_batch_sharded(
        model, None, x0s, u0s, lims=lims, cfg=cfg, mesh=mesh,
        derivs_tiles=dtiles, kt_backward=2, kt_forward=2,
        reduce_stats=True, interpret=True)
    # compiled-vs-interpret of the same kernel is bit-exact (CLAUDE.md);
    # sharding only re-tiles the batch axis, so solves must agree exactly
    np.testing.assert_allclose(np.asarray(out.cost_total),
                               np.asarray(ref.cost_total), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.reason),
                                  np.asarray(ref.reason))
    np.testing.assert_array_equal(np.asarray(out.n_accepted),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               atol=1e-5)
    # psum'd fleet stats agree with the per-scenario outputs
    np.testing.assert_allclose(float(stats[0]),
                               float(jnp.sum(out.cost_total)), rtol=1e-5)
    assert float(stats[1]) == float(jnp.sum(out.n_iters))
    # outputs stay device-sharded
    assert len({s.device for s in out.u.addressable_shards}) == 8


def test_output_is_sharded(problem_batch):
    """Outputs stay device-sharded (no gather to host layout)."""
    prob, x0s, u0s = problem_batch
    mesh = make_mesh()
    res = ilqg_sharded(prob, x0s, u0s, cfg=ILQGConfig(max_iter=5), mesh=mesh)
    shard_devs = {s.device for s in res.u.addressable_shards}
    assert len(shard_devs) == 8


def test_sharded_kl_lanes_matches_single_device():
    """The GPS/KL lane tier under shard_map (8 devices, interpret mode)
    produces the same solves as the single-device ilqgkl_batch_lanes."""
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, make_pendcart_problem, default_x0, pendcart_lanes,
        pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.ops.forward import forward_pass
    from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy
    from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
        ILQGKLConfig)
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
        ilqgkl_batch_sharded)

    dtype = jnp.float32
    B, T = 8, 10
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    x0s = (jnp.asarray([0.0, 3.0, 0.0, 0.0], dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b))(x0s, u0s)
    prev = GaussianPolicy.zeros(T, 4, 1, dtype)
    prev = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), prev)
    prev = prev._replace(k=ro.u)
    d = jax.vmap(problem.make_derivs())(ro.x, ro.u)
    cost0 = jnp.sum(ro.cost, -1)
    cfg = ILQGKLConfig(kl_step=2.0, max_iter=3)
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)

    ref = ilqgkl_batch_lanes(model, tiles, ro.x, prev, d.fx, cost0,
                             cfg=cfg, kt=4, interpret=True)
    mesh = make_mesh()
    out, stats = ilqgkl_batch_sharded(
        model, tiles, ro.x, prev, d.fx, cost0, cfg=cfg, kt=4, mesh=mesh,
        reduce_stats=True, interpret=True)
    # sharding only re-tiles the batch axis — solves must agree exactly
    # (compiled-vs-interpret of the same kernel is bit-exact, CLAUDE.md)
    np.testing.assert_allclose(np.asarray(out.cost_total),
                               np.asarray(ref.cost_total), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.eta), np.asarray(ref.eta),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.satisfied),
                                  np.asarray(ref.satisfied))
    np.testing.assert_array_equal(np.asarray(out.n_iters),
                                  np.asarray(ref.n_iters))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               atol=1e-5)
    # psum'd fleet stats agree with the per-scenario outputs
    np.testing.assert_allclose(float(stats[0]),
                               float(jnp.sum(out.cost_total)), rtol=1e-5)
    assert float(stats[1]) == float(jnp.sum(out.n_iters))
    assert float(stats[2]) == float(jnp.sum(out.satisfied))
    # outputs stay device-sharded
    assert len({s.device for s in out.u.addressable_shards}) == 8
