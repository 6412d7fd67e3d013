"""Lane-layout batch driver (solvers/batch.py) vs the generic vmap driver —
tiny shapes, interpret mode (compile time dominates; one thorough test).

Full-scale agreement (B=4096, T=500) on a CUDA GPU is checked by
chip_smoke.py (kernel parity and the card-only tests in tests/test_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    PendCartSpec, make_pendcart_problem, default_x0, pendcart_lanes,
    pendcart_derivs_tiles, pendcart_packed_derivs)
from differentialdynamicprogramming_jl_tpu.ops.forward import forward_pass
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
    ilqg, ILQGConfig, default_alphas)
from differentialdynamicprogramming_jl_tpu.solvers.batch import (
    ilqg_batch_lanes)

B, T = 8, 6


@pytest.fixture(scope="module")
def pend_setup():
    dtype = jnp.float32
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    x0s = (default_x0(dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=2, iter_cap=3)
    return spec, problem, x0s, u0s, cfg


@pytest.mark.smoke
def test_batch_lanes_matches_vmap_driver():
    dtype = jnp.float32
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    lims = jnp.array([[-5.0, 5.0]], dtype)
    x0s = (default_x0(dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     max_iter=2, iter_cap=3)

    ref = jax.vmap(lambda a, b: ilqg(problem, a, b, lims=lims, cfg=cfg)
                   )(x0s, u0s)
    out = ilqg_batch_lanes(
        pendcart_lanes(spec), None, x0s, u0s, lims=((-5.0, 5.0),), cfg=cfg,
        derivs_tiles=pendcart_derivs_tiles(spec),
        kt_backward=2, kt_forward=2, record_trace=True, interpret=True)

    rc = np.asarray(jnp.sum(ref.cost, -1))
    oc = np.asarray(out.cost_total)
    np.testing.assert_allclose(oc, rc, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(ref.reason),
                                  np.asarray(out.reason))
    np.testing.assert_array_equal(np.asarray(ref.n_accepted),
                                  np.asarray(out.n_accepted))
    assert out.x.shape == (B, T, 4) and out.u.shape == (B, T, 1)
    assert np.all(np.isfinite(np.asarray(out.x)))
    # trace: iteration-0 cost equals the initial rollout; costs non-increasing
    tr = out.trace
    assert tr is not None and tr.cost.shape[0] == B
    c = np.asarray(tr.cost)
    it = np.asarray(out.n_iters)
    for b in range(B):
        vals = c[b, :it[b] + 1]
        assert np.all(np.diff(vals) <= 1e-5), vals


def test_batch_lanes_pre_rolled_matches_xla(pend_setup):
    """Warm-start entry: a pre-rolled (B, T, n) trajectory + cost0 skips the
    initial α-sweep and matches the XLA solver's pre-rolled path
    (reference src/iLQG.jl:193-197)."""
    spec, problem, x0s, u0s, cfg = pend_setup
    lims = jnp.array([[-5.0, 5.0]], jnp.float32)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b, lims=lims)
                  )(x0s, u0s)
    ref = jax.vmap(lambda xt, ut, ct: ilqg(
        problem, xt, ut, lims=lims, cfg=cfg, cost0=ct))(ro.x, ro.u, ro.cost)
    rc = np.asarray(jnp.sum(ref.cost, -1))
    kw = dict(lims=((-5.0, 5.0),), cfg=cfg,
              derivs_tiles=pendcart_derivs_tiles(spec),
              kt_backward=2, kt_forward=2, interpret=True)
    out = ilqg_batch_lanes(pendcart_lanes(spec), None, ro.x, ro.u,
                           cost0=ro.cost, **kw)
    np.testing.assert_allclose(np.asarray(out.cost_total), rc, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(out.reason),
                                  np.asarray(ref.reason))
    # cost0 omitted → per-step costs evaluated with the model's lane fns
    out2 = ilqg_batch_lanes(pendcart_lanes(spec), None, ro.x, ro.u, **kw)
    np.testing.assert_allclose(np.asarray(out2.cost_total), rc, rtol=1e-4)


def test_batch_lanes_warm_start_alpha1(pend_setup):
    """warm_start=True rolls the plan at α=1 with no sweep; from a benign
    plan it solves like the swept entry."""
    spec, problem, x0s, u0s, cfg = pend_setup
    kw = dict(lims=((-5.0, 5.0),), cfg=cfg,
              derivs_tiles=pendcart_derivs_tiles(spec),
              kt_backward=2, kt_forward=2, interpret=True)
    warm = ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s,
                            warm_start=True, **kw)
    assert np.all(np.isfinite(np.asarray(warm.cost_total)))
    assert np.all(np.asarray(warm.reason) != 5)
    # α=1 is in the sweep set only implicitly; compare against an explicit
    # α-sweep whose first candidate rolls ~u0s — costs must be comparable
    ref = ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s, **kw)
    assert np.all(np.asarray(warm.cost_total)
                  <= np.asarray(ref.cost_total) * 1.5 + 1.0)


def test_batch_lanes_packed_derivs_stream_cache(pend_setup):
    """The packed-derivs tier (cached stream carried across iterations,
    flg_change semantics src/iLQG.jl:226-229) matches the in-kernel
    derivs_tiles tier."""
    spec, problem, x0s, u0s, cfg = pend_setup
    kw = dict(lims=((-5.0, 5.0),), cfg=cfg,
              kt_backward=2, kt_forward=2, interpret=True)
    tiles = ilqg_batch_lanes(pendcart_lanes(spec), None, x0s, u0s,
                             derivs_tiles=pendcart_derivs_tiles(spec), **kw)
    packed = ilqg_batch_lanes(pendcart_lanes(spec),
                              pendcart_packed_derivs(spec), x0s, u0s, **kw)
    np.testing.assert_allclose(np.asarray(packed.cost_total),
                               np.asarray(tiles.cost_total), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(packed.reason),
                                  np.asarray(tiles.reason))
    np.testing.assert_array_equal(np.asarray(packed.n_accepted),
                                  np.asarray(tiles.n_accepted))


def test_batch_lanes_m3_limits():
    """m>2 control limits through the FULL lane driver (the in-kernel
    masked projected-Newton boxQP) vs the vmapped XLA solver."""
    from differentialdynamicprogramming_jl_tpu.models.linear import (
        random_lti, make_lti_problem, lti_lanes, lti_derivs_tiles)
    n, m, T_, B_ = 4, 3, 6, 8
    spec = random_lti(jax.random.PRNGKey(3), n=n, m=m, T=T_,
                      dtype=jnp.float32)
    prob = make_lti_problem(spec, T_)
    lims_arr = jnp.array([[-0.05, 0.05]] * m, jnp.float32)
    x0s = (jnp.ones((B_, n), jnp.float32)
           * jnp.linspace(0.5, 2.0, B_, dtype=jnp.float32)[:, None])
    u0s = jnp.tile(spec.u0, (B_, 1, 1)) * 3.0
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=1,
                     max_iter=3, iter_cap=4)
    ref = jax.vmap(lambda a, b: ilqg(prob, a, b, lims=lims_arr, cfg=cfg)
                   )(x0s, u0s)
    out = ilqg_batch_lanes(
        lti_lanes(spec), None, x0s, u0s,
        lims=tuple((float(lo), float(hi)) for lo, hi in
                   np.asarray(lims_arr)),
        cfg=cfg, derivs_tiles=lti_derivs_tiles(spec),
        kt_backward=2, kt_forward=2, interpret=True)
    np.testing.assert_allclose(np.asarray(out.cost_total),
                               np.asarray(jnp.sum(ref.cost, -1)), rtol=2e-4)
    np.testing.assert_array_equal(np.asarray(out.reason),
                                  np.asarray(ref.reason))
    # limits must actually bind
    assert np.any(np.abs(np.asarray(out.u)) > 0.049)


def test_batch_lanes_init_divergence_frozen():
    """Scenarios whose initial rollout diverges (reason 5) must come back
    with the FROZEN initial rollout and a zero policy — not NaN. Before the
    round-3 fix, the unconditional `traj_n = fb.traj` re-rolled done lanes
    every iteration and the α=0 retrace computed K·(Inf−Inf) = NaN on their
    Inf-bearing trajectories. Reference: the initial-rollout
    divergence guard exits with the initial trajectory and no policy
    (src/iLQG.jl:181-210)."""
    from differentialdynamicprogramming_jl_tpu.models.linear import (
        LTISpec, lti_lanes, lti_derivs_tiles)
    n, m, T_, B_ = 1, 1, 8, 2
    one = jnp.ones((1, 1), jnp.float32)
    # wildly unstable open-loop dynamics: x' = 1e30·x + u → the u0=0
    # α-sweep rollout hits Inf by t=2 whenever x0 ≠ 0
    spec = LTISpec(A=1e30 * one, B=one, Q=one, R=one,
                   x0=jnp.zeros((1,), jnp.float32),
                   u0=jnp.zeros((T_, 1), jnp.float32))
    x0s = jnp.array([[0.0], [100.0]], jnp.float32)   # lane 1 diverges
    u0s = jnp.zeros((B_, T_, m), jnp.float32)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=1,
                     max_iter=2, iter_cap=3)
    res = ilqg_batch_lanes(lti_lanes(spec), None, x0s, u0s, cfg=cfg,
                           derivs_tiles=lti_derivs_tiles(spec),
                           kt_backward=2, kt_forward=2, interpret=True)
    reason = np.asarray(res.reason)
    assert reason[1] == 5, reason
    assert reason[0] != 5, reason
    # frozen initial rollout: u ≡ 0 (α=0), x = open-loop from x0 — Inf is
    # expected on the diverged lane, NaN is the bug
    assert not np.any(np.isnan(np.asarray(res.u))), res.u
    assert not np.any(np.isnan(np.asarray(res.x[0]))), res.x[0]
    np.testing.assert_array_equal(np.asarray(res.u[1]), 0.0)
    np.testing.assert_array_equal(np.asarray(res.x[1][0]), [100.0])
    # zero policy on the diverged lane (XLA-tier parity: policy0 zeros,
    # whose covariance is the IDENTITY — policy.py:47-55 — so downstream
    # GPS/KL consumers never see a singular Σ)
    np.testing.assert_array_equal(np.asarray(res.policy.K[1]), 0.0)
    eye = np.broadcast_to(np.eye(1, dtype=np.float32), (T_, 1, 1))
    np.testing.assert_array_equal(np.asarray(res.policy.sigma[1]), eye)
    np.testing.assert_array_equal(np.asarray(res.policy.sigma_inv[1]), eye)
    assert not np.any(np.isnan(np.asarray(res.Vxx[1])))
    # the healthy lane is untouched by the restore
    assert np.all(np.isfinite(np.asarray(res.x[0])))
    assert np.all(np.isfinite(float(res.cost_total[0])))


def test_batch_lanes_prerolled_init_divergence():
    """The reason-5 restore covers the PRE-ROLLED entry too: a supplied
    trajectory with non-finite states/costs must come back verbatim (the
    reference keeps user trajectories on reject, src/iLQG.jl:193-197)
    with the zero-gain unit-covariance policy — not the NaN the kernels
    compute from its Inf-bearing stream."""
    from differentialdynamicprogramming_jl_tpu.models.linear import (
        LTISpec, lti_lanes, lti_derivs_tiles)
    T_, B_ = 8, 2
    one = jnp.ones((1, 1), jnp.float32)
    spec = LTISpec(A=one, B=one, Q=one, R=one,
                   x0=jnp.zeros((1,), jnp.float32),
                   u0=jnp.zeros((T_, 1), jnp.float32))
    x0s = jnp.ones((B_, T_, 1), jnp.float32)
    x0s = x0s.at[1, 5, 0].set(jnp.inf)           # lane 1: Inf state
    u0s = jnp.zeros((B_, T_, 1), jnp.float32)
    cost0 = jnp.full((B_, T_), 0.5, jnp.float32)
    cost0 = cost0.at[1, 5].set(jnp.inf)          # ... and Inf cost
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=1,
                     max_iter=2, iter_cap=3)
    res = ilqg_batch_lanes(lti_lanes(spec), None, x0s, u0s, cost0=cost0,
                           cfg=cfg, derivs_tiles=lti_derivs_tiles(spec),
                           kt_backward=2, kt_forward=2, interpret=True)
    reason = np.asarray(res.reason)
    assert reason[1] == 5, reason
    assert reason[0] != 5, reason
    # the user-supplied trajectory comes back verbatim (Inf included)
    np.testing.assert_array_equal(np.asarray(res.x[1]), np.asarray(x0s[1]))
    np.testing.assert_array_equal(np.asarray(res.u[1]), 0.0)
    # zero-gain unit-covariance policy, finite value expansion
    np.testing.assert_array_equal(np.asarray(res.policy.K[1]), 0.0)
    eye = np.broadcast_to(np.eye(1, dtype=np.float32), (T_, 1, 1))
    np.testing.assert_array_equal(np.asarray(res.policy.sigma[1]), eye)
    np.testing.assert_array_equal(np.asarray(res.policy.sigma_inv[1]), eye)
    assert not np.any(np.isnan(np.asarray(res.policy.K)))
    assert not np.any(np.isnan(np.asarray(res.Vxx[1])))
    # the healthy lane still solves
    assert np.all(np.isfinite(np.asarray(res.x[0])))
    assert np.all(np.isfinite(float(res.cost_total[0])))


def test_iteration_lanes_step(pend_setup):
    """ilqg_iteration_lanes: the MPC per-step hot path. Asserts (a) the
    fleet cost is non-increasing over steps (accepted lanes improve,
    rejected lanes alpha=0-retrace to the same total), (b) the step is
    DETERMINISTIC when re-run from the same inputs — a regression guard on
    the donated-carry in-place trajectory update (a stale-buffer aliasing
    bug shows up exactly here), and (c) cost totals track the stream's own
    running-cost slot + terminal."""
    from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel \
        import forward_lanes
    from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import \
        to_lanes
    from differentialdynamicprogramming_jl_tpu.solvers.batch import \
        ilqg_iteration_lanes

    spec, problem, x0s, u0s, cfg = pend_setup
    dtype = jnp.float32
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    lims = ((-5.0, 5.0),)

    traj0_xu = jnp.zeros((T, 5) + to_lanes(u0s, B).shape[2:], dtype)
    gains0 = jnp.concatenate(
        [to_lanes(u0s, B), jnp.zeros((T, 4) + traj0_xu.shape[2:], dtype)],
        axis=1)
    x0_l = to_lanes(x0s[:, None, :], B)[0]
    fb0 = forward_lanes(traj0_xu, gains0, x0_l,
                        jnp.ones((1,) + x0_l.shape[1:], dtype),
                        model=model, lims=lims, gk=0, gK=1,
                        emit_traj=True, k_t=3, interpret=True)
    traj, tot = fb0.traj, fb0.totals[0]

    step = ilqg_iteration_lanes(model, None, lims, cfg,
                                derivs_tiles=tiles, kt_backward=3,
                                kt_forward=3, interpret=True)

    t1a, c1a, l1a = step(traj, tot, jnp.full(tot.shape, cfg.lam, dtype))
    t1b, c1b, l1b = step(traj, tot, jnp.full(tot.shape, cfg.lam, dtype))
    np.testing.assert_array_equal(np.asarray(t1a), np.asarray(t1b))
    np.testing.assert_array_equal(np.asarray(c1a), np.asarray(c1b))
    np.testing.assert_array_equal(np.asarray(l1a), np.asarray(l1b))

    # run a short chain; fleet cost must never increase (real lanes only)
    tr, ct, lm = t1a, c1a, l1a
    prev = np.asarray(ct).reshape(-1)[:B]
    for _ in range(2):
        tr, ct, lm = step(tr, ct, lm)
        cur = np.asarray(ct).reshape(-1)[:B]
        assert (cur <= prev + 1e-4 * np.abs(prev)).all(), (cur, prev)
        prev = cur
    # the first step must strictly improve somewhere (fresh rollout)
    first = np.asarray(c1a).reshape(-1)[:B]
    tot0 = np.asarray(tot).reshape(-1)[:B]
    assert (first < tot0).any()
