"""Tests for the auxiliary ring: KL formulations vs closed form + Monte
Carlo, serialization round-trips, the profiled driver, and plotting."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu import (
    GaussianPolicy, ILQGConfig, ilqg, kl_div_gaussian, kl_div_wiki)
from differentialdynamicprogramming_jl_tpu.models.linear import (
    random_lti, make_lti_problem)
from differentialdynamicprogramming_jl_tpu.utils import serialization as ser
from differentialdynamicprogramming_jl_tpu.utils.profiling import (
    ilqg_profiled)

T, N, M = 6, 3, 2


def _rand_pd(key, m, scale=1.0):
    A = jax.random.normal(key, (T, m, m), jnp.float64)
    return scale * (jnp.einsum('tij,tkj->tik', A, A)
                    + 0.5 * jnp.eye(m, dtype=jnp.float64))


@pytest.fixture
def policies(key):
    ks = jax.random.split(key, 6)
    Sp = _rand_pd(ks[0], M)
    Sn = _rand_pd(ks[1], M, 0.7)
    kp = jax.random.normal(ks[2], (T, M), jnp.float64)
    kn = jax.random.normal(ks[3], (T, M), jnp.float64)
    zK = jnp.zeros((T, M, N), jnp.float64)
    prev = GaussianPolicy(K=zK, k=kp, sigma=Sp, sigma_inv=jnp.linalg.inv(Sp))
    new = GaussianPolicy(K=zK, k=kn, sigma=Sn, sigma_inv=jnp.linalg.inv(Sn))
    return prev, new, kp, kn, Sp, Sn


def _kl_closed_form(kp, kn, Sp, Sn):
    """Exact KL(N(kn,Sn) || N(kp,Sp)) per timestep, straight NumPy."""
    Sip = np.linalg.inv(np.asarray(Sp))
    d = np.asarray(kn - kp)
    tr = np.einsum('tij,tji->t', Sip, np.asarray(Sn))
    quad = np.einsum('ti,tij,tj->t', d, Sip, d)
    ld = (np.linalg.slogdet(np.asarray(Sp))[1]
          - np.linalg.slogdet(np.asarray(Sn))[1])
    return 0.5 * (tr + quad - M + ld)


def test_kl_div_wiki_matches_closed_form(policies):
    """With K_new == K_prev and x_new == x_old the wiki formula reduces to
    the standard Gaussian KL (src/klutils.jl:70-100)."""
    prev, new, kp, kn, Sp, Sn = policies
    x = jnp.zeros((T, N), jnp.float64)
    sigma_joint = jnp.zeros((T, N + M, N + M), jnp.float64)
    kl = kl_div_wiki(x, x, sigma_joint, new, prev)
    np.testing.assert_allclose(np.asarray(kl),
                               np.maximum(_kl_closed_form(kp, kn, Sp, Sn), 0),
                               rtol=1e-10)


def test_kl_div_gaussian_matches_closed_form(policies):
    """The alternative kl_div formulation (src/klutils.jl:39-65) evaluated
    at the new policy mean with the control block of the joint covariance
    equals the exact Gaussian KL (derivation: the quadratic expansion is
    exact for Gaussians when the u-covariance is supplied)."""
    prev, new, kp, kn, Sp, Sn = policies
    x = jnp.zeros((T, N), jnp.float64)
    # reference convention src/klutils.jl:51: kn = traj_new.k + traj_prev.k
    new_rel = new._replace(k=kn - kp)
    sigma_joint = jnp.zeros((T, N + M, N + M), jnp.float64)
    sigma_joint = sigma_joint.at[:, N:, N:].set(Sn)
    kl = kl_div_gaussian(x, x, kn, sigma_joint, new_rel, prev)
    np.testing.assert_allclose(np.asarray(kl),
                               np.maximum(_kl_closed_form(kp, kn, Sp, Sn), 0),
                               rtol=1e-9)


def test_kl_div_wiki_matches_monte_carlo(policies):
    """MC oracle: KL ≈ E_{u~N(kn,Sn)}[log p_new(u) - log p_prev(u)]."""
    prev, new, kp, kn, Sp, Sn = policies
    rng = np.random.default_rng(0)
    S = 200_000
    t = 2  # one representative timestep
    Ln = np.linalg.cholesky(np.asarray(Sn[t]))
    u = np.asarray(kn[t]) + rng.standard_normal((S, M)) @ Ln.T

    def logpdf(u, mu, Sig):
        d = u - mu
        Si = np.linalg.inv(Sig)
        return (-0.5 * np.einsum('si,ij,sj->s', d, Si, d)
                - 0.5 * np.linalg.slogdet(Sig)[1]
                - 0.5 * M * np.log(2 * np.pi))

    mc = np.mean(logpdf(u, np.asarray(kn[t]), np.asarray(Sn[t]))
                 - logpdf(u, np.asarray(kp[t]), np.asarray(Sp[t])))
    x = jnp.zeros((T, N), jnp.float64)
    sigma_joint = jnp.zeros((T, N + M, N + M), jnp.float64)
    kl = kl_div_wiki(x, x, sigma_joint, new, prev)
    assert abs(float(kl[t]) - mc) < 0.05 * max(1.0, abs(mc)), (
        float(kl[t]), mc)


def test_kl_identical_policies_zero(policies):
    prev, _, kp, _, Sp, _ = policies
    x = jnp.zeros((T, N), jnp.float64)
    sj = jnp.zeros((T, N + M, N + M), jnp.float64)
    np.testing.assert_allclose(
        np.asarray(kl_div_wiki(x, x, sj, prev, prev)), 0.0, atol=1e-12)
    prev_rel = prev._replace(k=jnp.zeros_like(prev.k))
    sj2 = sj.at[:, N:, N:].set(Sp)
    np.testing.assert_allclose(
        np.asarray(kl_div_gaussian(x, x, kp, sj2, prev_rel, prev)),
        0.0, atol=1e-9)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_solve():
    spec = random_lti(jax.random.PRNGKey(0), n=4, m=2, T=30,
                      dtype=jnp.float64)
    prob = make_lti_problem(spec, 30)
    res = ilqg(prob, spec.x0, spec.u0, cfg=ILQGConfig(max_iter=8))
    return spec, prob, res


def test_serialization_policy_roundtrip(tmp_path, small_solve):
    _, _, res = small_solve
    p = str(tmp_path / "policy.npz")
    ser.save_policy(p, res.policy)
    back = ser.load_policy(p)
    for a, b in zip(res.policy, back):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serialization_pytree_roundtrip(tmp_path, small_solve):
    """Full ILQGResult pytree (nested GaussianPolicy + Trace) survives a
    save/load round trip bit-exactly."""
    _, _, res = small_solve
    p = str(tmp_path / "result.npz")
    ser.save_pytree(p, res)
    back = ser.load_pytree(p, like=res)
    la, lb = jax.tree_util.tree_leaves(res), jax.tree_util.tree_leaves(back)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # flat-list mode without a structure template
    flat = ser.load_pytree(p)
    assert len(flat) == len(la)


def test_serialization_warm_start_roundtrip(tmp_path, small_solve):
    _, prob, res = small_solve
    p = str(tmp_path / "warm.npz")
    ser.save_warm_start(p, res.x, res.u, res.cost)
    x, u, cost = ser.load_warm_start(p)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(res.x))
    # and it actually warm-starts the solver (pre-rolled entry)
    res2 = ilqg(prob, x, u, cfg=ILQGConfig(max_iter=3), cost0=cost)
    assert float(jnp.sum(res2.cost)) <= float(jnp.sum(res.cost)) + 1e-9


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_ilqg_profiled_matches_solver(capsys):
    spec = random_lti(jax.random.PRNGKey(0), n=4, m=2, T=30,
                      dtype=jnp.float64)
    prob = make_lti_problem(spec, 30)
    cfg = ILQGConfig(max_iter=20)
    x, u, tm = ilqg_profiled(prob, spec.x0, spec.u0, cfg=cfg, verbose=True)
    res = ilqg(prob, spec.x0, spec.u0, cfg=cfg)
    cost_prof = float(jnp.sum(prob.trajectory_cost(x, u)))
    assert abs(cost_prof - float(jnp.sum(res.cost))) < 1e-6
    # timing sanity: all phases measured, sum bounded by total
    assert tm["iters"] >= 1
    for k in ("derivs", "backward", "forward"):
        assert tm[k] > 0.0
    assert tm["derivs"] + tm["backward"] + tm["forward"] <= tm["total"]
    out = capsys.readouterr().out
    assert "time [%]" in out and "per iteration" in out


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------

def test_plotting_writes_files(tmp_path, small_solve, monkeypatch):
    import matplotlib
    matplotlib.use("Agg")
    from differentialdynamicprogramming_jl_tpu.utils.plotting import (
        plot_linear, plotting_available)
    assert plotting_available()
    _, _, res = small_solve
    path = str(tmp_path / "lin.png")
    plot_linear(res, path=path)
    assert os.path.getsize(path) > 0
