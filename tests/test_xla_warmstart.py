"""Warm-start / resume on the XLA batched tier:
``ilqg_batched`` / ``ilqg_sharded`` accept pre-rolled trajectories +
``cost0`` and the (λ, dλ, accepted) resume counters, mirroring the lane
tier's entries — a chunked solve composes to the uninterrupted one
(reference warm-start semantics, ``src/iLQG.jl:85-87,193-197``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    PendCartSpec, make_pendcart_problem, default_x0)
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
    ILQGConfig, default_alphas)
from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
    ilqg_batched, ilqg_sharded, make_mesh)

B, T = 8, 6


def _setup(dtype=jnp.float64):
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    x0s = (default_x0(dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    lims = jnp.array([[-5.0, 5.0]], dtype)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=6, iter_cap=40)
    return problem, x0s, u0s, lims, cfg


def test_batched_resume_composes_to_one_solve():
    problem, x0s, u0s, lims, cfg = _setup()
    ref = ilqg_batched(problem, x0s, u0s, lims=lims, cfg=cfg)

    cfg1 = dataclasses.replace(cfg, max_iter=2)
    part = ilqg_batched(problem, x0s, u0s, lims=lims, cfg=cfg1)
    res = ilqg_batched(problem, part.x, part.u, lims=lims, cfg=cfg,
                       cost0=part.cost,
                       lam0=part.lam, dlam0=part.dlam,
                       accepted0=part.n_accepted)

    np.testing.assert_allclose(np.asarray(jnp.sum(res.cost, -1)),
                               np.asarray(jnp.sum(ref.cost, -1)),
                               rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(res.reason),
                                  np.asarray(ref.reason))
    np.testing.assert_array_equal(np.asarray(res.n_accepted),
                                  np.asarray(ref.n_accepted))
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(ref.u),
                               rtol=1e-10, atol=1e-12)
    # part 1 genuinely stopped early
    assert int(np.max(np.asarray(part.n_accepted))) <= 2
    assert int(np.max(np.asarray(ref.n_accepted))) > 2


def test_sharded_resume_matches_batched():
    """The resume counters ride P(axis) through shard_map — fleet resumes
    work on the portable tier at mesh scale."""
    problem, x0s, u0s, lims, cfg = _setup()
    cfg1 = dataclasses.replace(cfg, max_iter=2)
    part = ilqg_batched(problem, x0s, u0s, lims=lims, cfg=cfg1)

    ref = ilqg_batched(problem, part.x, part.u, lims=lims, cfg=cfg,
                       cost0=part.cost, lam0=part.lam, dlam0=part.dlam,
                       accepted0=part.n_accepted)
    mesh = make_mesh()
    out = ilqg_sharded(problem, part.x, part.u, lims=lims, cfg=cfg,
                       mesh=mesh, cost0=part.cost, lam0=part.lam,
                       dlam0=part.dlam, accepted0=part.n_accepted)
    np.testing.assert_allclose(np.asarray(jnp.sum(out.cost, -1)),
                               np.asarray(jnp.sum(ref.cost, -1)),
                               rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(out.reason),
                                  np.asarray(ref.reason))
    np.testing.assert_array_equal(np.asarray(out.n_accepted),
                                  np.asarray(ref.n_accepted))
    assert len({s.device for s in out.u.addressable_shards}) == 8


def test_batched_per_scenario_lims():
    """(B, m, 2) lims vmap over the XLA tier (the lane tier's parity
    anchor for heterogeneous fleets, tests/test_heterogeneous_lims.py)."""
    problem, x0s, u0s, lims, cfg = _setup()
    hi = jnp.linspace(0.8, 6.0, B, dtype=x0s.dtype)
    lims_b = jnp.stack([-hi, hi], axis=-1)[:, None, :]
    out = ilqg_batched(problem, x0s, u0s, lims=lims_b, cfg=cfg)
    u = np.asarray(out.u)
    hi_np = np.asarray(hi)
    for i in range(B):
        assert np.max(np.abs(u[i])) <= hi_np[i] + 1e-9
    # sharded variant accepts per-scenario lims too
    mesh = make_mesh()
    out_s = ilqg_sharded(problem, x0s, u0s, lims=lims_b, cfg=cfg, mesh=mesh)
    np.testing.assert_allclose(np.asarray(jnp.sum(out_s.cost, -1)),
                               np.asarray(jnp.sum(out.cost, -1)),
                               rtol=1e-12)
