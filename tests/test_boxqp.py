"""boxQP unit tests — the reference has only a smoke run (``demoQP``,
``test/runtests.jl:12``); we add oracle comparisons (SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu import boxqp, boxqp_1d, demo_qp


def rand_qp(key, n, dtype=jnp.float64):
    kh, kg, kx = jax.random.split(key, 3)
    A = jax.random.normal(kh, (n, n), dtype)
    H = A @ A.T + 0.1 * jnp.eye(n, dtype=dtype)
    g = jax.random.normal(kg, (n,), dtype)
    x0 = jax.random.normal(kx, (n,), dtype)
    return H, g, x0


def test_unconstrained_interior(key):
    """With wide bounds the solution is the Newton point -H⁻¹g."""
    H, g, x0 = rand_qp(key, 6)
    lower, upper = -1e6 * jnp.ones(6), 1e6 * jnp.ones(6)
    out = boxqp(H, g, lower, upper, x0)
    assert out.result >= 1
    x_star = -jnp.linalg.solve(H, g)
    np.testing.assert_allclose(out.x, x_star, atol=1e-6)
    assert bool(jnp.all(out.free))


@pytest.mark.smoke
def test_matches_scipy_oracle(key):
    """Objective value matches a trusted bounded optimizer (L-BFGS-B)."""
    from scipy.optimize import minimize
    for i in range(5):
        H, g, x0 = rand_qp(jax.random.fold_in(key, i), 8)
        lower, upper = -0.5 * jnp.ones(8), 0.5 * jnp.ones(8)
        out = boxqp(H, g, lower, upper, x0)
        assert out.result >= 1
        Hn, gn = np.array(H), np.array(g)
        f = lambda x: x @ gn + 0.5 * x @ Hn @ x
        ref = minimize(f, np.zeros(8), jac=lambda x: gn + Hn @ x,
                       bounds=[(-0.5, 0.5)] * 8, method="L-BFGS-B",
                       options=dict(ftol=1e-14, gtol=1e-12))
        assert float(out.value) <= ref.fun + 1e-6
        np.testing.assert_allclose(out.x, ref.x, atol=1e-4)


def test_all_clamped():
    """Strong linear term pushes every dim to a bound → result 6
    (src/boxQP.jl:98-101)."""
    H = jnp.eye(3)
    g = jnp.array([10.0, 10.0, 10.0])
    out = boxqp(H, g, -jnp.ones(3), jnp.ones(3), jnp.zeros(3))
    assert out.result == 6
    np.testing.assert_allclose(out.x, -jnp.ones(3))
    assert not bool(jnp.any(out.free))


def test_non_pd_hessian():
    """Indefinite H → result -1 (reference throws, src/boxQP.jl:111)."""
    H = -jnp.eye(3)
    g = jnp.array([0.1, -0.2, 0.05])
    # x0=0 keeps every dim free (grad signs don't clamp at interior start)
    out = boxqp(H, g, -jnp.ones(3), jnp.ones(3), jnp.zeros(3))
    assert out.result == -1


def test_demo_qp_n500():
    """Reference demoQP scale (src/boxQP.jl:190-199)."""
    out = demo_qp(n=500, seed=0)
    assert out.result >= 1
    # KKT check: for free dims gradient ~ 0; for clamped, gradient points out
    # (can't verify without H/g here — covered by oracle test); just verify
    # bounds hold
    assert bool(jnp.all(out.x >= -1.0)) and bool(jnp.all(out.x <= 1.0))


def test_boxqp_1d_matches_general(key):
    """The closed-form m=1 fast path agrees with the general solver."""
    for i in range(20):
        k = jax.random.fold_in(key, i)
        h = jnp.abs(jax.random.normal(k, ())) + 0.1
        g = jax.random.normal(jax.random.fold_in(k, 1), (1,)) * 2
        H = h[None, None]
        lower, upper = -jnp.ones(1), jnp.ones(1)
        a = boxqp_1d(H, g, lower, upper)
        b = boxqp(H, g, lower, upper, jnp.zeros(1))
        assert a.result >= 1 and b.result >= 1
        np.testing.assert_allclose(a.x, b.x, atol=1e-8)
        assert bool(a.free[0]) == bool(b.free[0])


def test_vmap_batched(key):
    """Batched over many QPs (how the backward pass consumes it)."""
    n, B = 4, 64
    keys = jax.random.split(key, B)
    Hs, gs, x0s = jax.vmap(lambda k: rand_qp(k, n))(keys)
    lower = -0.3 * jnp.ones((B, n))
    upper = 0.3 * jnp.ones((B, n))
    out = jax.vmap(lambda H, g, lo, up, x0: boxqp(H, g, lo, up, x0))(
        Hs, gs, lower, upper, x0s)
    assert bool(jnp.all(out.result >= 1))
    assert bool(jnp.all(out.x >= -0.3 - 1e-12))
    assert bool(jnp.all(out.x <= 0.3 + 1e-12))


def test_warm_start_converges_fast(key):
    """Warm-started solve (the backward-pass usage, src/backward_pass.jl:49)
    terminates in very few iterations."""
    H, g, _ = rand_qp(key, 4)
    lower, upper = -jnp.ones(4), jnp.ones(4)
    out1 = boxqp(H, g, lower, upper, jnp.zeros(4))
    out2 = boxqp(H, g, lower, upper, out1.x)
    assert out2.result >= 1
    assert int(out2.iters) <= 3
    np.testing.assert_allclose(out1.x, out2.x, atol=1e-6)


def test_f32_dtype(key):
    """f32 path (the lane-tier dtype) stays correct on well-conditioned QPs."""
    H, g, x0 = rand_qp(key, 4, dtype=jnp.float32)
    out = boxqp(H, g, -jnp.ones(4, jnp.float32), jnp.ones(4, jnp.float32), x0)
    assert out.result >= 1
    assert out.x.dtype == jnp.float32
