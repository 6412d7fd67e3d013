"""Card-only tests: the compiled Triton kernels and the compiled lane driver
against the interpreter and the XLA tier. They take the ``gpu_device``
fixture, so they skip on the CPU; on a card ``python chip_smoke.py --phase
gpu_tests`` calls them in its own process (a second JAX process on the card
would fail for want of memory)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    PendCartSpec, default_x0, make_pendcart_problem, pendcart_lanes,
    pendcart_derivs_tiles)
from differentialdynamicprogramming_jl_tpu.ops.forward import forward_pass
from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel import (
    backward_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    linesearch_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import (
    to_lanes, vec_to_lanes)
from differentialdynamicprogramming_jl_tpu.parallel.mesh import ilqg_batched
from differentialdynamicprogramming_jl_tpu.solvers.batch import (
    ilqg_batch_lanes)
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
    ILQGConfig, default_alphas)

B, T = 300, 40            # a ragged last tile, a horizon the unroll splits
LIMS = ((-5.0, 5.0),)
SPEC = PendCartSpec()


def _fleet():
    prob = make_pendcart_problem(SPEC, derivs="euler", dtype=jnp.float32)
    x0s = default_x0(jnp.float32)[None, :] + 0.2 * jax.random.normal(
        jax.random.PRNGKey(0), (B, 4), jnp.float32)
    u0s = 0.4 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1),
                                  jnp.float32)
    lims = jnp.asarray(LIMS, jnp.float32)
    ro = jax.vmap(lambda a, b: forward_pass(prob, a, b, lims=lims))(x0s, u0s)
    traj = to_lanes(jnp.concatenate([ro.x, ro.u, ro.cost[:, :T, None]], -1),
                    B)
    return prob, x0s, u0s, ro, traj


@pytest.mark.gpu
def test_compiled_backward_matches_interpreter(gpu_device):
    _, _, _, _, traj = _fleet()
    lam = vec_to_lanes(jnp.ones((B,), jnp.float32))
    kw = dict(n=4, m=1, reg_type=2, lims=LIMS, k_t=3,
              derivs_tiles=pendcart_derivs_tiles(SPEC))
    got = backward_lanes(traj, lam, **kw)
    ref = backward_lanes(traj, lam, interpret=True, **kw)
    np.testing.assert_allclose(np.asarray(got.out), np.asarray(ref.out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.stats), np.asarray(ref.stats),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_compiled_linesearch_matches_interpreter(gpu_device):
    _, x0s, _, _, traj = _fleet()
    lam = vec_to_lanes(jnp.ones((B,), jnp.float32))
    gains = backward_lanes(traj, lam, n=4, m=1, reg_type=2, lims=LIMS,
                           derivs_tiles=pendcart_derivs_tiles(SPEC),
                           emit="gains").out
    x0_l = to_lanes(x0s[:, None, :], B)[0]
    sel = jnp.stack([-jnp.ones_like(lam), jnp.zeros_like(lam),
                     jnp.full_like(lam, 1e3), jnp.ones_like(lam)])
    kw = dict(model=pendcart_lanes(SPEC), lims=LIMS, gk=0, gK=1, g_slots=5,
              alphas=tuple(default_alphas(0.2, -3.0, 4)))
    got = linesearch_lanes(traj, gains, x0_l, sel, **kw)
    ref = linesearch_lanes(traj, gains, x0_l, sel, interpret=True, **kw)
    for a, b in ((got.traj, ref.traj), (got.echo, ref.echo),
                 (got.ls, ref.ls)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_compiled_lane_driver_matches_xla_tier(gpu_device):
    """Solver-level agreement on the card: bitwise parity does not hold at
    long horizons (box-QP active-set chatter amplifies f32 noise), so the
    outcomes are compared — costs, and exit reasons on most scenarios."""
    prob, x0s, _, _, _ = _fleet()
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=20, iter_cap=24)
    u0 = jnp.zeros((B, T, 1), jnp.float32)
    lane = ilqg_batch_lanes(pendcart_lanes(SPEC), None, x0s, u0, lims=LIMS,
                            cfg=cfg, derivs_tiles=pendcart_derivs_tiles(SPEC))
    xla = ilqg_batched(prob, x0s, u0, lims=jnp.asarray(LIMS, jnp.float32),
                       cfg=cfg)
    c_l = np.asarray(lane.cost_total, np.float64)
    c_x = np.asarray(jnp.sum(xla.cost, -1), np.float64)
    assert np.all(np.isfinite(c_l))
    np.testing.assert_allclose(np.median(c_l), np.median(c_x), rtol=1e-3)
    same = np.asarray(lane.reason) == np.asarray(xla.reason)
    assert np.mean(same) > 0.9, np.mean(same)
