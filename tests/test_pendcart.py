"""Pendulum-on-cart: the reference's nonlinear control-limited benchmark
(``src/system_pendcart.jl``).

Physics note (established by analysis + a bit-exact independent NumPy oracle,
``tests/oracle.py``): with the reference's constants (damping d=0.99,
``src/system_pendcart.jl:54``) and limits ±5, the upright goal θ=+π is
dynamically unreachable from x0=[π-0.6,0,0,0] — holding against gravity at
0.6 rad needs |u| > g·tan(0.6) ≈ 6.7, and the heavy damping destroys ~95% of
swing energy per fall, capping pump-up rises at θ≈2.0. The reference demo
configuration therefore converges to the hanging local optimum (total cost
29341.0035; its test suite only smoke-runs the demo, ``test/runtests.jl:10``).
We assert THAT exact parity, and demonstrate the swing-up capability at
feasible limits (±10).

Provenance caveat (what "parity" rests on): the Julia reference has never
been EXECUTED in this environment (no Julia runtime). The 29341.0035 claim
rests on (a) the independent NumPy oracle (``tests/oracle.py`` —
structurally independent, but a translation of the same reference source,
so it shares any *semantic misreading* of ``src/system_pendcart.jl``),
(b) the static-torque infeasibility argument above, and (c) the
reference's own MC cost bounds holding on the linear benchmark. If a Julia
runtime ever becomes available, run ``demo_pendcart()`` there and record
the true outputs into ``tests/golden.npz`` (tools/record_golden.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu import ilqg, ILQGConfig, default_alphas
from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    PendCartSpec, make_pendcart_problem, default_lims, default_x0,
    lqr, linearized_upright, simulate_pendcart)


def pendcart_cfg(max_iter=1000):
    """Reference demo configuration (src/system_pendcart.jl:197-206)."""
    return ILQGConfig(
        alphas=default_alphas(0.2, -3.0, 6),
        reg_type=2, lam_max=1e15, tol_fun=1e-8, tol_grad=1e-8,
        max_iter=max_iter)


def solve(T=600, dtype=jnp.float64, derivs="zoh", lims_val=5.0,
          max_iter=1000, u0=None, x0=None):
    spec = PendCartSpec()
    prob = make_pendcart_problem(spec, derivs=derivs, dtype=dtype)
    if x0 is None:
        x0 = default_x0(dtype)
    lims = jnp.array([[-lims_val, lims_val]], dtype)
    if u0 is None:
        u0 = jnp.zeros((T, 1), dtype)
    return ilqg(prob, x0, u0, lims=lims, cfg=pendcart_cfg(max_iter))


def test_reference_demo_parity():
    """Exact reference demo settings (±5 limits): the solver must land on the
    same solution as the reference algorithm — verified against the
    independent eager-numpy oracle to 6+ digits (hanging local optimum)."""
    res = solve()
    assert abs(float(jnp.sum(res.cost)) - 29341.00350907285) < 0.01
    assert int(res.reason) in (2, 3)
    assert bool(jnp.all(jnp.abs(res.u) <= 5.0 + 1e-9))


def test_matches_numpy_oracle_exactly():
    """Bit-level parity with tests/oracle.py on a shortened horizon: same
    accepted-cost sequence, same control trajectory."""
    import scipy.linalg
    from oracle import ilqg_np
    spec = PendCartSpec()
    g_, l, h, d = spec.g, spec.l, spec.h, spec.d
    Q = np.diag(spec.Q)
    R = np.array([[spec.R]])
    goal = np.array(spec.goal)
    T = 150

    def dyn(x, u, i):
        return x + h * np.array([
            x[1], -g_ / l * np.sin(x[0]) + u[0] / l * np.cos(x[0]) - d * x[1],
            x[3], u[0]])

    def traj_cost(xs, us):
        dxs = xs - goal
        c = 0.5 * (np.einsum('ti,ij,tj->t', dxs, Q, dxs)
                   + np.einsum('ti,ij,tj->t', us, R, us))
        dT = xs[-1] - goal
        return np.concatenate([c, [0.5 * dT @ Q @ dT]])

    def derivs_fn(xs, us):
        Tl = us.shape[0]
        fx = np.zeros((Tl, 4, 4))
        fu = np.zeros((Tl, 4, 1))
        for i in range(Tl):
            fxc = np.array([[0, 1, 0, 0],
                            [-g_ / l * np.cos(xs[i, 0])
                             - us[i, 0] / l * np.sin(xs[i, 0]), -d, 0, 0],
                            [0, 0, 0, 1], [0, 0, 0, 0.]])
            fuc = np.array([[0], [np.cos(xs[i, 0]) / l], [0], [1.]])
            M = np.zeros((5, 5))
            M[:4, :4] = fxc * h
            M[:4, 4:] = fuc * h
            ABd = scipy.linalg.expm(M)
            fx[i] = ABd[:4, :4]
            fu[i] = ABd[:4, 4:]
        return (fx, fu, (xs - goal) @ Q.T, us @ R.T,
                np.broadcast_to(Q, (Tl, 4, 4)), np.zeros((Tl, 4, 1)),
                np.broadcast_to(R, (Tl, 1, 1)))

    x0 = np.array([np.pi - 0.6, 0, 0, 0.])
    u0 = np.zeros((T, 1))
    lims = np.array([[-5., 5.]])
    ref = ilqg_np(dyn, traj_cost, derivs_fn, x0, u0, lims=lims,
                  alphas=10.0 ** np.linspace(0.2, -3, 6), reg_type=2,
                  lam_max=1e15, tol_fun=1e-8, tol_grad=1e-8, max_iter=1000)
    res = solve(T=T)
    np.testing.assert_allclose(float(jnp.sum(res.cost)), ref["cost"].sum(),
                               rtol=1e-9)
    np.testing.assert_allclose(np.array(res.u), ref["u"], atol=1e-7)


def test_swingup_at_feasible_limits():
    """At ±10 (holding torque 6.7 < 10) the control-limited solver reaches
    the upright goal and beats the clamped-LQG baseline."""
    res = solve(lims_val=10.0)
    xf = np.array(res.x[-1])
    assert abs(xf[0] - np.pi) < 0.05, xf
    assert abs(xf[1]) < 0.3, xf
    assert bool(jnp.all(jnp.abs(res.u) <= 10.0 + 1e-9))
    # clamped-LQG baseline at the same limits
    spec = PendCartSpec()
    A, B = linearized_upright(spec)
    L = lqr(A, B, np.diag(spec.Q), np.array([[spec.R]]))
    xs, us, c_lqg = simulate_pendcart(default_x0(jnp.float64), L, spec, 600,
                                      jnp.array([[-10.0, 10.0]]), jnp.float64)
    assert float(jnp.sum(res.cost)) < float(jnp.sum(c_lqg))


def test_warm_start_from_baseline_controller():
    """Warm-starting from the clamped-LQG rollout (pre-rolled trajectory API,
    src/iLQG.jl:85-87): iLQG improves on the baseline at ±8 where the
    cold-started solve falls into the hanging basin."""
    spec = PendCartSpec()
    A, B = linearized_upright(spec)
    L = lqr(A, B, np.diag(spec.Q), np.array([[spec.R]]))
    lims = jnp.array([[-8.0, 8.0]])
    T = 600
    xs, us, c_lqg = simulate_pendcart(default_x0(jnp.float64), L, spec, T,
                                      lims, jnp.float64)
    prob = make_pendcart_problem(spec, derivs="zoh", dtype=jnp.float64)
    res = ilqg(prob, xs, us, lims=lims, cfg=pendcart_cfg())
    assert float(jnp.sum(res.cost)) < float(jnp.sum(c_lqg))
    assert abs(float(res.x[-1, 0]) - np.pi) < 0.05


@pytest.mark.parametrize("derivs", ["zoh", "autodiff"])
def test_derivs_schemes_agree(derivs):
    """Both derivative schemes solve the feasible swing-up."""
    res = solve(lims_val=10.0, derivs=derivs, max_iter=300)
    assert abs(float(res.x[-1, 0]) - np.pi) < 0.1


def test_f32_matches_f64_solution():
    """Lane-tier dtype: f32 solve lands on the same optimum basin with
    comparable cost."""
    r64 = solve(lims_val=10.0, max_iter=300)
    r32 = solve(lims_val=10.0, dtype=jnp.float32, max_iter=300)
    assert r32.u.dtype == jnp.float32
    c64, c32 = float(jnp.sum(r64.cost)), float(jnp.sum(r32.cost))
    assert abs(c64 - c32) / c64 < 0.02, (c64, c32)


def test_zoh_vs_autodiff_jacobians():
    """ZoH-discretized Jacobians ≈ Euler autodiff Jacobians to O(h)."""
    spec = PendCartSpec()
    pz = make_pendcart_problem(spec, derivs="zoh", dtype=jnp.float64)
    pa = make_pendcart_problem(spec, derivs="autodiff", dtype=jnp.float64)
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (5, 4), jnp.float64)
    u = jax.random.normal(jax.random.fold_in(key, 1), (5, 1), jnp.float64)
    dz = pz.make_derivs()(x, u)
    da = pa.make_derivs()(x, u)
    np.testing.assert_allclose(np.array(dz.fx), np.array(da.fx), atol=5e-3)
    np.testing.assert_allclose(np.array(dz.fu), np.array(da.fu), atol=5e-3)
    np.testing.assert_allclose(np.array(dz.cx), np.array(da.cx), atol=1e-12)


def test_batched_swingup_vmap():
    """Batched solves over varied initial angles — the MPC-style workload of
    BASELINE.json — all reach upright at feasible limits."""
    T, B = 300, 4
    spec = PendCartSpec()
    prob = make_pendcart_problem(spec, derivs="autodiff", dtype=jnp.float64)
    lims = jnp.array([[-12.0, 12.0]])
    x0s = jnp.stack([default_x0(jnp.float64).at[0].add(dd)
                     for dd in jnp.linspace(0.0, 0.2, B)])
    u0 = jnp.zeros((T, 1), jnp.float64)
    res = jax.vmap(lambda x0: ilqg(prob, x0, u0, lims=lims,
                                   cfg=pendcart_cfg(200)))(x0s)
    assert res.x.shape == (B, T, 4)
    finals = np.array(res.x[:, -1, 0])
    assert np.all(np.abs(finals - np.pi) < 0.2), finals
