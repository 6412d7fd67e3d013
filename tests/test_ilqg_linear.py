"""End-to-end iLQG on the linear benchmark: the reference's Monte-Carlo cost
oracle (``test/test_readme.jl:3-70``) plus convergence-quality checks the
reference lacks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu import ilqg, ILQGConfig
from differentialdynamicprogramming_jl_tpu.models.linear import (
    random_lti, make_lti_problem)


def run_one(key, T=1000, dtype=jnp.float64, lims=None, use_autodiff=False,
            cfg=None):
    spec = random_lti(key, n=10, m=2, T=T, dtype=dtype)
    prob = make_lti_problem(spec, T, use_autodiff=use_autodiff)
    cfg = cfg or ILQGConfig()
    res = ilqg(prob, spec.x0, spec.u0, lims=lims, cfg=cfg)
    return spec, res


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_monte_carlo_cost_bounds(key, dtype):
    """Reference oracle (test/test_readme.jl:68-70): over 10 random LTI
    problems (n=10, m=2, T=1000), max total cost < 25, mean < 10, min < 5."""
    costs = []
    for i in range(10):
        _, res = run_one(jax.random.fold_in(key, i), dtype=dtype)
        costs.append(float(jnp.sum(res.cost)))
    costs = np.array(costs)
    assert costs.max() < 25, costs
    assert costs.mean() < 10, costs
    assert costs.min() < 5, costs


@pytest.mark.smoke
def test_converges_to_lqr_cost(key):
    """The iLQG solution of the LQR problem must match the closed-form
    optimal cost (a sharper oracle than the reference's bounds)."""
    T = 200
    spec, res = run_one(key, T=T)
    A, B = np.array(spec.A), np.array(spec.B)
    Q, R = np.array(spec.Q), np.array(spec.R)
    # optimal cost with the same boundary convention: P[T-1] = Q and last
    # control free at u=α·u0... the reference freezes the last control, whose
    # cost contribution is negligible; compute the exact Riccati cost for the
    # truncated problem and compare loosely.
    P = Q.copy()
    for t in range(T - 2, -1, -1):
        Quu = R + B.T @ P @ B
        Qux = B.T @ P @ A
        K = np.linalg.solve(Quu, Qux)
        P = Q + A.T @ P @ A - Qux.T @ K
        P = 0.5 * (P + P.T)
    x0 = np.array(spec.x0)
    opt = 0.5 * x0 @ P @ x0
    achieved = float(jnp.sum(res.cost))
    assert achieved < opt * 1.02 + 1e-6, (achieved, opt)


def test_pre_rolled_trajectory(key):
    """Pre-rolled (T,n) x0 path (src/iLQG.jl:193-197)."""
    from differentialdynamicprogramming_jl_tpu import forward_pass
    T = 100
    spec = random_lti(key, T=T)
    prob = make_lti_problem(spec, T)
    ro = forward_pass(prob, spec.x0, spec.u0)
    res = ilqg(prob, ro.x, spec.u0, cfg=ILQGConfig(max_iter=100))
    assert float(jnp.sum(res.cost)) < float(jnp.sum(ro.cost))
    # supplying cost0 gives the same result
    res2 = ilqg(prob, ro.x, spec.u0, cfg=ILQGConfig(max_iter=100),
                cost0=ro.cost)
    np.testing.assert_allclose(float(jnp.sum(res2.cost)),
                               float(jnp.sum(res.cost)), rtol=1e-9)


def test_control_limited(key):
    """Control-limited LTI (the commented-out reference configuration,
    src/demo_linear.jl:22: lims = ±0.6): solver must respect limits and
    still reduce cost."""
    T = 300
    lims = jnp.array([[-0.6, 0.6], [-0.6, 0.6]])
    spec, res = run_one(key, T=T, lims=lims,
                        cfg=ILQGConfig(max_iter=100))
    assert bool(jnp.all(res.u >= -0.6 - 1e-9))
    assert bool(jnp.all(res.u <= 0.6 + 1e-9))
    assert float(jnp.sum(res.cost)) < float(res.trace.cost[0])
    # oracle: the box-constrained solution beats naively clamping the
    # unconstrained optimum into the box
    from differentialdynamicprogramming_jl_tpu import forward_pass
    spec2, res_unc = run_one(key, T=T, cfg=ILQGConfig(max_iter=100))
    prob = make_lti_problem(spec2, T)
    u_clamped = jnp.clip(res_unc.u, -0.6, 0.6)
    ro = forward_pass(prob, spec2.x0, u_clamped)
    assert float(jnp.sum(res.cost)) <= float(jnp.sum(ro.cost)) + 1e-9


def test_autodiff_matches_analytic(key):
    """Autodiff derivative stack gives the same solve as analytic derivatives."""
    T = 100
    _, res_a = run_one(key, T=T, use_autodiff=False,
                       cfg=ILQGConfig(max_iter=50))
    _, res_b = run_one(key, T=T, use_autodiff=True,
                       cfg=ILQGConfig(max_iter=50))
    np.testing.assert_allclose(float(jnp.sum(res_a.cost)),
                               float(jnp.sum(res_b.cost)), rtol=1e-6)
    np.testing.assert_allclose(np.array(res_a.u), np.array(res_b.u),
                               atol=1e-6)


def test_trace_and_policy_contract(key):
    """When the solver exits on an accepted step (reason 2), the returned
    policy has k == u (src/iLQG.jl:303 — only the accept branch copies u into
    traj_new.k; rejected iterations overwrite traj_new with the latest
    backward pass, src/iLQG.jl:236). Trace cost decreases on accepts."""
    T = 100
    # large tol_fun forces a cost-convergence (accepting) exit
    spec, res = run_one(key, T=T, cfg=ILQGConfig(max_iter=50, tol_fun=1e-3))
    assert int(res.reason) == 2
    np.testing.assert_allclose(np.array(res.policy.k), np.array(res.u))
    tr = res.trace
    n_it = int(res.n_iters)
    costs = np.array(tr.cost[:n_it + 1])
    accepted = np.array(tr.accepted[:n_it + 1])
    # accepted-iteration costs are monotonically non-increasing
    acc_costs = costs[accepted.astype(bool)]
    assert np.all(np.diff(acc_costs) <= 1e-9)
    assert int(res.reason) in (1, 2, 3, 4)


def test_vmap_batched_solver(key):
    """The full solver vmaps over a scenario batch of initial states."""
    T, B = 100, 8
    spec = random_lti(key, T=T, dtype=jnp.float64)
    prob = make_lti_problem(spec, T)
    x0s = jnp.tile(spec.x0, (B, 1)) * jnp.linspace(0.5, 2.0, B)[:, None]
    res = jax.vmap(lambda x0: ilqg(prob, x0, spec.u0,
                                   cfg=ILQGConfig(max_iter=30)))(x0s)
    assert res.u.shape == (B, T, 2)
    totals = jnp.sum(res.cost, axis=-1)
    initials = res.trace.cost[:, 0]
    assert bool(jnp.all(totals <= initials))


def _fixed_lti_spec(dtype, T):
    """Deterministic reference-construction LTI spec (src/demo_linear.jl:
    9-26) generated in NumPy f64 and cast, so every dtype solves the SAME
    problem (jax.random draws differ between f32 and f64). MUST stay in
    sync with tools/probe_f32_drift._lti_spec (same rng(7) construction):
    this test pins the problem whose pre-fix f32 stall that tool showed."""
    import scipy.linalg
    from differentialdynamicprogramming_jl_tpu.models.linear import LTISpec
    n, m, h = 10, 2, 0.01
    rng = np.random.default_rng(7)
    M = rng.standard_normal((n, n))
    A = scipy.linalg.expm(h * (M - M.T))
    Bm = h * rng.standard_normal((n, m))
    u0 = 0.1 * np.random.default_rng(12345).standard_normal((T, m))
    return LTISpec(A=jnp.asarray(A, dtype), B=jnp.asarray(Bm, dtype),
                   Q=jnp.asarray(h * np.eye(n), dtype),
                   R=jnp.asarray(0.1 * h * np.eye(m), dtype),
                   x0=2.0 * jnp.ones((n,), dtype),
                   u0=jnp.asarray(u0, dtype))


def test_f32_exits_on_cost_convergence():
    """The cost-change exit threshold is floored at the dtype's cost
    resolution (`tol_fun_effective`): an f32 solve must terminate via a
    clean convergence exit at the f32 noise floor instead of stalling
    there and escalating λ to λmax. On this pinned problem the pre-fix
    behavior was reason 3 (λ>λmax) after ~41 total iterations vs ~14
    accepted (measured via tools/probe_f32_drift.py); post-fix it exits
    reason 2 with no rejection tail, at the f64 optimum of the same
    problem."""
    T = 1000
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        default_alphas)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=100, iter_cap=200)
    spec32 = _fixed_lti_spec(jnp.float32, T)
    spec64 = _fixed_lti_spec(jnp.float64, T)

    r32 = ilqg(make_lti_problem(spec32, T), spec32.x0, spec32.u0,
               lims=jnp.array([[-0.6, 0.6]] * 2, jnp.float32), cfg=cfg)
    r64 = ilqg(make_lti_problem(spec64, T), spec64.x0, spec64.u0,
               lims=jnp.array([[-0.6, 0.6]] * 2, jnp.float64), cfg=cfg)

    # a clean cost-convergence exit, NOT the λ>λmax abort (pre-fix: 3)
    assert int(r32.reason) == 2, int(r32.reason)
    # no λ-escalation tail (pre-fix: ~27 rejected iterations)
    assert int(r32.n_iters) - int(r32.n_accepted) <= 12
    c32, c64 = float(jnp.sum(r32.cost)), float(jnp.sum(r64.cost))
    np.testing.assert_allclose(c32, c64, rtol=1e-4)
    # f64 semantics unchanged: floor ≈ 1.8e-15·|cost| is inactive
    assert int(r64.reason) in (1, 2)
