"""Lane-layout iLQGkl driver (solvers/batch_kl.py) vs the generic XLA
ilqg_kl — tiny shapes, interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np

from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    PendCartSpec, make_pendcart_problem, default_x0, pendcart_lanes,
    pendcart_derivs_tiles)
from differentialdynamicprogramming_jl_tpu.models.linear import SimpleLTVModel
from differentialdynamicprogramming_jl_tpu.ops.forward import forward_pass
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
    ilqg_kl, ILQGKLConfig)
from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
    ilqgkl_batch_lanes)
from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy
import pytest

B, T = 8, 10


def test_batch_kl_per_step_eta_matches_xla_driver():
    """Per-timestep-η ADAM variant (reference ``constrain_per_step``,
    ``src/iLQGkl.jl:185-236``)."""
    dtype = jnp.float32
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    x0s = (default_x0(dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b))(x0s, u0s)
    prev = GaussianPolicy.zeros(T, 4, 1, dtype)
    prev = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), prev)
    prev = prev._replace(k=ro.u)
    d = jax.vmap(problem.make_derivs())(ro.x, ro.u)
    cfg = ILQGKLConfig(kl_step=2.0, max_iter=3, constrain_per_step=True,
                       gd_alpha=0.01)

    ref = jax.vmap(lambda xt, pv, fxm, ct: ilqg_kl(
        problem, xt, pv,
        SimpleLTVModel(fx=fxm, fu=jnp.zeros((T, 4, 1), dtype)), ct, cfg=cfg)
    )(ro.x, prev, d.fx, ro.cost)
    out = ilqgkl_batch_lanes(
        pendcart_lanes(spec), pendcart_derivs_tiles(spec),
        ro.x, prev, d.fx, jnp.sum(ro.cost, -1), cfg=cfg,
        kt=4, interpret=True)
    np.testing.assert_allclose(np.asarray(out.cost_total),
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=5e-3)
    np.testing.assert_allclose(np.asarray(out.eta),
                               np.asarray(jnp.mean(ref.eta, axis=-1)),
                               rtol=1e-2)


@pytest.mark.smoke
def test_batch_kl_matches_xla_driver():
    dtype = jnp.float32
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    x0s = (default_x0(dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b))(x0s, u0s)
    prev = GaussianPolicy.zeros(T, 4, 1, dtype)
    prev = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), prev)
    prev = prev._replace(k=ro.u)
    d = jax.vmap(problem.make_derivs())(ro.x, ro.u)
    cfg = ILQGKLConfig(kl_step=2.0, max_iter=4)

    ref = jax.vmap(lambda xt, pv, fxm, ct: ilqg_kl(
        problem, xt, pv,
        SimpleLTVModel(fx=fxm, fu=jnp.zeros((T, 4, 1), dtype)), ct, cfg=cfg)
    )(ro.x, prev, d.fx, ro.cost)
    out = ilqgkl_batch_lanes(
        pendcart_lanes(spec), pendcart_derivs_tiles(spec),
        ro.x, prev, d.fx, jnp.sum(ro.cost, -1), cfg=cfg,
        kt=4, interpret=True, record_trace=True)

    np.testing.assert_allclose(np.asarray(out.cost_total),
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=5e-3)
    np.testing.assert_allclose(np.asarray(out.eta), np.asarray(ref.eta),
                               rtol=1e-2)
    np.testing.assert_allclose(np.asarray(out.divergence),
                               np.asarray(ref.divergence), rtol=1e-2)
    np.testing.assert_array_equal(np.asarray(out.satisfied),
                                  np.asarray(ref.satisfied))
    assert np.all(np.isfinite(np.asarray(out.u)))
    # the returned POLICY comes from the post-loop backward replay at the
    # carried eta_used (round 3 — the stream is no longer carried); it must
    # match the XLA tier's last-backward policy, which pins eta_used ==
    # the η every lane's final backward actually ran with
    np.testing.assert_allclose(np.asarray(out.policy.K),
                               np.asarray(ref.policy.K),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(out.policy.sigma),
                               np.asarray(ref.policy.sigma),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(out.policy.sigma_inv),
                               np.asarray(ref.policy.sigma_inv),
                               rtol=5e-3, atol=5e-3)
    # trace parity row-for-row: both tiers measure Δcost against the FIXED
    # pre-rolled cost (the reference never moves x/u/cost inside its loop,
    # src/iLQGkl.jl:137-140,239-240)
    k = cfg.max_iter + 1
    np.testing.assert_allclose(
        np.asarray(out.trace.reduce_ratio[:, :k]),
        np.asarray(ref.trace.reduce_ratio[:, :k]), rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(out.trace.improvement[:, :k]),
        np.asarray(ref.trace.improvement[:, :k]), rtol=1e-2, atol=1e-4)


def test_logdet_tiles_general_m():
    """_logdet_tiles m>2 (unrolled Cholesky diagonal) vs numpy slogdet."""
    import numpy as np
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        _logdet_tiles)
    from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import TILE
    rng = np.random.default_rng(0)
    T_, m, L = 5, 3, (1,) + TILE
    A = rng.standard_normal((T_, *L, m, m)).astype(np.float32)
    S = np.einsum('t...ij,t...kj->t...ik', A, A) + 0.5 * np.eye(
        m, dtype=np.float32)
    # slot stream layout (T, m², L)
    S_stream = jnp.asarray(np.moveaxis(
        S.reshape(T_, *L, m * m), -1, 1))
    out, ok = _logdet_tiles(S_stream, m)
    ref = np.linalg.slogdet(S.astype(np.float64))[1]
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)
    assert np.all(np.asarray(ok))
    # an indefinite matrix must flag ok=False (not silently clamp)
    S_bad = S.copy()
    S_bad[0] = S_bad[0] - 10.0 * np.eye(m, dtype=np.float32)
    S_bad_stream = jnp.asarray(np.moveaxis(
        S_bad.reshape(T_, *L, m * m), -1, 1))
    _, ok_bad = _logdet_tiles(S_bad_stream, m)
    ok_bad = np.asarray(ok_bad)
    assert not np.all(ok_bad[0])
    assert np.all(ok_bad[1:])


def test_batch_kl_pd_failure_flagged():
    """A scenario handed an indefinite previous Σ must come back flagged
    (``pd_failed``) and not ``satisfied``, on BOTH tiers, and the tiers must
    agree per scenario — before round 3 the lane tier silently clamped the
    logdet. Reference: Julia ``logdet`` raises a
    DomainError on indefinite input inside ``kl_div_wiki``
    (``src/klutils.jl:84``)."""
    dtype = jnp.float32
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    x0s = (default_x0(dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b))(x0s, u0s)
    prev = GaussianPolicy.zeros(T, 4, 1, dtype)
    prev = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), prev)
    # scenarios 2 and 5: Σ_prev (and its stored inverse) NEGATIVE definite —
    # det > 0 for m=1, so a sign-of-det check would NOT catch it
    sig = np.ones((B, T, 1, 1), np.float32)
    sig[2], sig[5] = -1.0, -2.0
    prev = prev._replace(k=ro.u, sigma=jnp.asarray(sig),
                         sigma_inv=jnp.asarray(1.0 / sig))
    d = jax.vmap(problem.make_derivs())(ro.x, ro.u)
    cfg = ILQGKLConfig(kl_step=2.0, max_iter=4)

    ref = jax.vmap(lambda xt, pv, fxm, ct: ilqg_kl(
        problem, xt, pv,
        SimpleLTVModel(fx=fxm, fu=jnp.zeros((T, 4, 1), dtype)), ct, cfg=cfg)
    )(ro.x, prev, d.fx, ro.cost)
    out = ilqgkl_batch_lanes(
        pendcart_lanes(spec), pendcart_derivs_tiles(spec),
        ro.x, prev, d.fx, jnp.sum(ro.cost, -1), cfg=cfg,
        kt=4, interpret=True)

    bad = np.zeros(B, bool)
    bad[[2, 5]] = True
    np.testing.assert_array_equal(np.asarray(out.pd_failed), bad)
    np.testing.assert_array_equal(np.asarray(ref.pd_failed), bad)
    # tier agreement on the termination flags
    np.testing.assert_array_equal(np.asarray(out.satisfied),
                                  np.asarray(ref.satisfied))
    assert not np.any(np.asarray(out.satisfied)[bad])
    # flagged lanes terminate immediately (first KL measurement)
    assert np.all(np.asarray(out.n_iters)[bad] == 1)


def test_covariance_lanes_matches_forward_covariance():
    """The lane-layout Σxx propagation (a plain lax.scan) equals the xx
    block of ops/forward.forward_covariance per scenario (reference
    forward_covariance, src/forward_pass.jl:37-56)."""
    from differentialdynamicprogramming_jl_tpu.ops.forward import (
        forward_covariance)
    from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import (
        to_lanes, from_lanes)
    from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        covariance_lanes)
    B_, T_, n, m = 5, 7, 3, 1
    fx = 0.4 * jax.random.normal(jax.random.PRNGKey(0), (B_, T_, n, n),
                                 jnp.float32) + jnp.eye(n, dtype=jnp.float32)
    r1 = ((1.0, 0.2, 0.0), (0.2, 0.5, 0.1), (0.0, 0.1, 2.0))
    got = from_lanes(covariance_lanes(
        to_lanes(fx.reshape(B_, T_, n * n), B_), n=n, r1=r1), B_, (n, n))
    pol = GaussianPolicy.zeros(T_, n, m, jnp.float32)
    R1 = jnp.asarray(r1, jnp.float32)
    ref = jax.vmap(lambda f: forward_covariance(f, R1, pol))(fx)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref[..., :n, :n]),
                               rtol=1e-5, atol=1e-5)
