"""Pallas kernel parity tests (interpret mode on CPU).

The backward kernel (ops/pallas/backward_kernel.py) and forward kernel
(ops/pallas/forward_kernel.py) are validated against the XLA reference path
(ops/backward.py, ops/forward.py) on small shapes; the compiled Triton
kernels are checked against the interpreter on the card by tests/test_gpu.py
and at full size by chip_smoke.py. Shapes are kept tiny — interpret mode
compile time grows with n⁴·k_t.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    PendCartSpec, make_pendcart_problem, default_x0, pendcart_lanes,
    pendcart_packed_derivs)
from differentialdynamicprogramming_jl_tpu.ops.backward import backward_pass
from differentialdynamicprogramming_jl_tpu.ops.forward import forward_pass
from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel import (
    backward_pass_pallas, pack_backward_inputs, backward_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    forward_lanes, linesearch_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import (
    to_lanes, from_lanes, vec_to_lanes)
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import default_alphas

B, T = 8, 13
DTYPE = jnp.float32
LIMS = ((-5.0, 5.0),)


@pytest.fixture(scope="module")
def pend():
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=DTYPE)
    lims = jnp.array([[-5.0, 5.0]], DTYPE)
    x0 = default_x0(DTYPE)
    key = jax.random.PRNGKey(0)
    x0s = x0[None, :] + (0.2 * jax.random.normal(key, (B, 4), DTYPE)
                         * jnp.array([1, 0, 0, 0], DTYPE))
    u0s = 0.4 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), DTYPE)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b, lims=lims)
                  )(x0s, u0s)
    d = jax.vmap(problem.make_derivs())(ro.x, ro.u)
    return spec, problem, lims, x0s, ro, d


def _cmp(ref, out, tol=3e-4):
    for name, a, b in (("k", ref.policy.k, out.policy.k),
                       ("K", ref.policy.K, out.policy.K),
                       ("Vx", ref.Vx, out.Vx),
                       ("Vxx", ref.Vxx, out.Vxx),
                       ("dV", ref.dV, out.dV),
                       ("sigma", ref.policy.sigma, out.policy.sigma),
                       ("diverged", ref.diverged, out.diverged)):
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32),
            rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("reg_type,use_limits",
                         [(1, False), (2, True)])
def test_backward_kernel_parity(pend, reg_type, use_limits):
    _, _, lims, _, ro, d = pend
    lam = jnp.ones((B,), DTYPE)
    ref = jax.vmap(lambda dd, uu, ll: backward_pass(
        dd, uu, lam=ll, reg_type=reg_type,
        lims=lims if use_limits else None, use_limits=use_limits)
    )(d, ro.u, lam)
    out = backward_pass_pallas(
        d, ro.u, lam, reg_type=reg_type,
        lims=np.asarray(lims) if use_limits else None,
        use_limits=use_limits, k_t=4, interpret=True)
    _cmp(ref, out)


def test_backward_kernel_divergence_latch(pend):
    _, _, _, _, ro, d = pend
    d_bad = d._replace(cuu=-d.cuu)          # concave in u → non-PD Quu
    lam0 = jnp.zeros((B,), DTYPE)
    ref = jax.vmap(lambda dd, uu, ll: backward_pass(dd, uu, lam=ll,
                                                    reg_type=1)
                   )(d_bad, ro.u, lam0)
    out = backward_pass_pallas(d_bad, ro.u, lam0, reg_type=1, k_t=4,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(ref.diverged),
                                  np.asarray(out.diverged))
    np.testing.assert_array_equal(np.asarray(ref.diverge_idx),
                                  np.asarray(out.diverge_idx))
    assert bool(out.diverged.all())


def test_forward_kernel_line_search_parity(pend):
    spec, problem, lims, x0s, ro, d = pend
    model = pendcart_lanes(spec)
    bp = jax.vmap(lambda dd, uu: backward_pass(
        dd, uu, lam=1.0, reg_type=2, lims=lims, use_limits=True))(d, ro.u)
    alphas = jnp.asarray(default_alphas(0.2, -3.0, 4), DTYPE)
    A = alphas.shape[0]

    traj = to_lanes(jnp.concatenate([ro.x, ro.u], axis=-1), B)
    gains = to_lanes(jnp.concatenate(
        [bp.policy.k, bp.policy.K.reshape(B, T, -1)], axis=-1), B)
    x0_l = to_lanes(x0s[:, None, :], B)[0]
    al = jnp.broadcast_to(alphas.reshape(A, 1, 1, 1),
                          (A,) + x0_l.shape[1:]).astype(DTYPE)

    out = forward_lanes(traj, gains, x0_l, al, model=model, lims=LIMS,
                        gk=0, gK=1, k_t=4, interpret=True)
    tot = out.totals.reshape(A, -1)[:, :B]

    ro_a = jax.vmap(lambda a: jax.vmap(
        lambda x_i, u_i, pol: forward_pass(problem, x_i[0], u_i, x_i, a,
                                           pol, lims)
    )(ro.x, ro.u, bp.policy))(alphas)
    tot_ref = jnp.sum(ro_a.cost, axis=-1)
    np.testing.assert_allclose(np.asarray(tot_ref), np.asarray(tot),
                               rtol=2e-5, atol=1e-4)


def test_forward_kernel_traj_emission(pend):
    spec, problem, lims, x0s, ro, d = pend
    model = pendcart_lanes(spec)
    bp = jax.vmap(lambda dd, uu: backward_pass(
        dd, uu, lam=1.0, reg_type=2, lims=lims, use_limits=True))(d, ro.u)
    al_b = 0.5 * jnp.ones((B,), DTYPE)

    traj = to_lanes(jnp.concatenate([ro.x, ro.u], axis=-1), B)
    gains = to_lanes(jnp.concatenate(
        [bp.policy.k, bp.policy.K.reshape(B, T, -1)], axis=-1), B)
    x0_l = to_lanes(x0s[:, None, :], B)[0]

    out = forward_lanes(traj, gains, x0_l, vec_to_lanes(al_b)[None],
                        model=model, lims=LIMS, gk=0, gK=1, k_t=4,
                        emit_traj=True, interpret=True)
    xb = from_lanes(out.traj[:, :4], B, (4,))
    ub = from_lanes(out.traj[:, 4:5], B, (1,))
    cb = from_lanes(out.traj[:, 5:6], B, ())

    ref = jax.vmap(lambda x_i, u_i, pol, a: forward_pass(
        problem, x_i[0], u_i, x_i, a, pol, lims)
    )(ro.x, ro.u, bp.policy, al_b)
    np.testing.assert_allclose(np.asarray(ref.x), np.asarray(xb),
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.u), np.asarray(ub),
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.cost[:, :T]), np.asarray(cb),
                               rtol=2e-5, atol=1e-4)
    term = out.terminal.reshape(-1)[:B]
    np.testing.assert_allclose(np.asarray(ref.cost[:, T]), np.asarray(term),
                               rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("use_limits", [False, True])
def test_backward_kernel_gps_mode(pend, use_limits):
    """GPS/KL-augmented recursion (reference ``back_pass_gps``,
    ``src/backward_pass.jl:259-350``) vs the XLA gps path."""
    from differentialdynamicprogramming_jl_tpu.ops.kl import grad_kl
    from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy

    _, _, lims, _, ro, d = pend
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    prev = GaussianPolicy(
        K=0.3 * jax.random.normal(k1, (B, T, 1, 4), DTYPE),
        k=0.2 * jax.random.normal(k2, (B, T, 1), DTYPE),
        sigma=jnp.broadcast_to(0.5 * jnp.eye(1, dtype=DTYPE), (B, T, 1, 1)),
        sigma_inv=jnp.broadcast_to(2.0 * jnp.eye(1, dtype=DTYPE),
                                   (B, T, 1, 1)))
    eta_bt = 0.5 + jax.random.uniform(jax.random.PRNGKey(9), (B, T), DTYPE)

    ref = jax.vmap(lambda dd, uu, pv, et: backward_pass(
        dd, uu, lam=0.0, reg_type=1, lims=lims if use_limits else None,
        use_limits=use_limits, eta=et, kl_terms=grad_kl(pv), gps_mode=True)
    )(d, ro.u, prev, eta_bt)
    out = backward_pass_pallas(
        d, ro.u, jnp.zeros((B,), DTYPE), reg_type=1,
        lims=np.asarray(lims) if use_limits else None,
        use_limits=use_limits, k_t=4, eta=eta_bt, traj_prev=prev,
        interpret=True)
    _cmp(ref, out)


def test_derivs_tiles_backward_matches_packed(pend):
    """In-kernel derivative computation (derivs_tiles) vs the packed
    derivative stream path."""
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel \
        import backward_lanes
    spec, _, lims, _, ro, d = pend
    lam = vec_to_lanes(jnp.ones((B,), DTYPE))
    dp = pack_backward_inputs(d, ro.u, B)
    traj = to_lanes(jnp.concatenate([ro.x, ro.u], axis=-1), B)
    a = backward_lanes(dp, lam, n=4, m=1, reg_type=2, lims=LIMS, k_t=4,
                       interpret=True)
    b = backward_lanes(traj, lam, n=4, m=1, reg_type=2, lims=LIMS, k_t=4,
                       derivs_tiles=pendcart_derivs_tiles(spec),
                       interpret=True)
    # real lanes only: the paths see different data on zero-padded lanes
    ao = np.asarray(a.out).reshape(T, a.out.shape[1], -1)[..., :B]
    bo = np.asarray(b.out).reshape(T, b.out.shape[1], -1)[..., :B]
    np.testing.assert_allclose(ao, bo, rtol=1e-5, atol=1e-5)
    ast = np.asarray(a.stats).reshape(4, -1)[:, :B]
    bst = np.asarray(b.stats).reshape(4, -1)[:, :B]
    np.testing.assert_allclose(ast, bst, rtol=1e-5, atol=1e-5)


def test_packed_derivs_matches_euler(pend):
    spec, problem, _, _, ro, d = pend
    packed = pendcart_packed_derivs(spec)
    x_l = to_lanes(ro.x, B)
    u_l = to_lanes(ro.u, B)
    dp = packed(x_l, u_l)
    ref_dp = pack_backward_inputs(d, ro.u, B)
    # compare real lanes only: the generators differ on zero-padded lanes
    # (pack pads the output with zeros; the analytic generator evaluates the
    # formulas at x=0), which are discarded on unpack
    a = np.asarray(dp).reshape(T, 47, -1)[:, :, :B]
    b = np.asarray(ref_dp).reshape(T, 47, -1)[:, :, :B]
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [3, 4])
def test_backward_kernel_limits_m_gt_2(m):
    """m>2 control limits in-kernel: the masked projected-Newton boxQP
    (_boxqp_masked, reference src/boxQP.jl:71-165) matches the XLA tier's
    boxqp-based backward pass on a random LTI problem with active clamps.

    n=6 keeps interpret-mode tracing tractable in CI; the same parity was
    verified at the reference scale n=10, m=3, T=9 (340 s interpret run,
    rtol 5e-4, 40% of steps clamped) during development."""
    from differentialdynamicprogramming_jl_tpu.models.linear import (
        random_lti, make_lti_problem)
    n, T_, B_ = 6, 7, 8
    spec = random_lti(jax.random.PRNGKey(2), n=n, m=m, T=T_, dtype=DTYPE)
    prob = make_lti_problem(spec, T_)
    lims = jnp.array([[-0.05, 0.05]] * m, DTYPE)   # tight → clamps active
    x0s = (jnp.tile(spec.x0, (B_, 1))
           * jnp.linspace(0.5, 2.0, B_, dtype=DTYPE)[:, None])
    u0s = jnp.tile(spec.u0, (B_, 1, 1)) * 3.0
    ro = jax.vmap(lambda a, b: forward_pass(prob, a, b, lims=lims)
                  )(x0s, u0s)
    d = jax.vmap(prob.make_derivs())(ro.x, ro.u)
    lam = jnp.full((B_,), 0.1, DTYPE)
    ref = jax.vmap(lambda dd, uu, ll: backward_pass(
        dd, uu, lam=ll, reg_type=1, lims=lims, use_limits=True)
    )(d, ro.u, lam)
    out = backward_pass_pallas(d, ro.u, lam, reg_type=1,
                               lims=np.asarray(lims), use_limits=True,
                               k_t=1, interpret=True)
    _cmp(ref, out, tol=5e-4)
    # the limits must actually bind somewhere, or this test proves nothing
    u_new = np.asarray(ro.u) + np.asarray(out.policy.k)
    assert np.any(np.abs(u_new) > 0.049), "no clamp was ever active"


def test_backward_kernel_full_ddp_parity(pend):
    """Full DDP on the lane tier: second-order dynamics tiles
    (pendcart_derivs_tiles_so) match the XLA backward pass fed autodiff
    fxx/fxu/fuu (reference vectens terms, src/backward_pass.jl full-DDP
    variants)."""
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        pendcart_derivs_tiles, pendcart_derivs_tiles_so)
    from differentialdynamicprogramming_jl_tpu.problem import (
        make_autodiff_derivs)
    spec, problem, _, _, ro, _ = pend
    derivs_fn = jax.vmap(make_autodiff_derivs(problem.dynamics,
                                              problem.cost,
                                              second_order=True))
    d2 = derivs_fn(ro.x, ro.u)
    assert d2.fxx is not None
    lam = jnp.full((B,), 0.5, DTYPE)
    ref = jax.vmap(lambda dd, uu, ll: backward_pass(dd, uu, lam=ll,
                                                    reg_type=1))(
        d2, ro.u, lam)

    traj = to_lanes(jnp.concatenate(
        [ro.x, ro.u, jnp.zeros((B, T, 1), DTYPE)], axis=-1), B)
    out = backward_lanes(traj, vec_to_lanes(lam), n=4, m=1, reg_type=1,
                         k_t=4, derivs_tiles=pendcart_derivs_tiles_so(),
                         interpret=True)
    from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel \
        import OutLayout
    lay = OutLayout(4, 1)
    k = from_lanes(out.out[:, lay.k:lay.k + 1], B, (1,))
    K = from_lanes(out.out[:, lay.K:lay.K + 4], B, (1, 4))
    Vx = from_lanes(out.out[:, lay.Vx:lay.Vx + 4], B, (4,))
    np.testing.assert_allclose(np.asarray(k), np.asarray(ref.policy.k),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(K), np.asarray(ref.policy.K),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(Vx), np.asarray(ref.Vx),
                               rtol=3e-4, atol=3e-4)
    # and the second-order terms actually matter: against the full-DDP XLA
    # reference, first-order tiles must be measurably worse than the
    # second-order tiles (effect ≫ parity error)
    out1 = backward_lanes(traj, vec_to_lanes(lam), n=4, m=1, reg_type=1,
                          k_t=4,
                          derivs_tiles=pendcart_derivs_tiles(),
                          interpret=True)
    k1 = from_lanes(out1.out[:, lay.k:lay.k + 1], B, (1,))
    err_fo = float(np.max(np.abs(np.asarray(k1) - np.asarray(ref.policy.k))))
    err_so = float(np.max(np.abs(np.asarray(k) - np.asarray(ref.policy.k))))
    assert err_fo > 5.0 * max(err_so, 1e-7), (err_fo, err_so)


def test_backward_kernel_emission_modes(pend):
    """The "gains"/"policy" emission streams must equal the corresponding
    slot prefix of the "full" stream bit-for-bit — the hot-loop drivers
    (solvers/batch.py, solvers/batch_kl.py) rely on the emission gating
    changing WHICH slots are written, never the arithmetic that produces
    them (OutLayout docs)."""
    from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel \
        import OutLayout
    _, _, _, _, ro, d = pend
    lam_l = vec_to_lanes(jnp.ones((B,), DTYPE))
    dp = pack_backward_inputs(d, ro.u, B)
    n, m = 4, 1
    full = backward_lanes(dp, lam_l, n=n, m=m, reg_type=2, lims=LIMS,
                          k_t=4, interpret=True)
    lay_f = OutLayout(n, m, "full")
    for emit in ("gains", "policy"):
        out = backward_lanes(dp, lam_l, n=n, m=m, reg_type=2, lims=LIMS,
                             k_t=4, emit=emit, interpret=True)
        lay = OutLayout(n, m, emit)
        assert out.out.shape[1] == lay.S
        np.testing.assert_array_equal(
            np.asarray(out.out[:, :m + m * n]),
            np.asarray(full.out[:, :m + m * n]), err_msg=f"{emit} gains")
        if lay.quu is not None:
            np.testing.assert_array_equal(
                np.asarray(out.out[:, lay.quu:lay.quui + m * m]),
                np.asarray(full.out[:, lay_f.quu:lay_f.quui + m * m]),
                err_msg="policy quu/quui")
        np.testing.assert_array_equal(np.asarray(out.stats),
                                      np.asarray(full.stats),
                                      err_msg=f"{emit} stats")


@pytest.mark.parametrize("rr_min", [0.0, 0.6])
def test_fused_linesearch_matches_two_phase(pend, rr_min):
    """linesearch_lanes (one-launch per-α totals + in-register accept +
    accepted-α re-roll, solvers/batch.py STEP 3) must equal the pre-fusion
    two-phase expression (forward_lanes totals -> XLA accept glue ->
    forward_lanes re-roll) bit-for-bit: the fusion moved the accept
    decision (src/iLQG.jl:269-280) into the kernel, between its two loops, without
    touching any arithmetic. rr_min=0.6 forces the ladder to descend past
    rejected candidates; half the lanes have allow=0 (masked out)."""
    spec, problem, lims, x0s, ro, d = pend
    model = pendcart_lanes(spec)
    bp = jax.vmap(lambda dd, uu: backward_pass(
        dd, uu, lam=1.0, reg_type=2, lims=lims, use_limits=True))(d, ro.u)
    alphas = tuple(float(a) for a in default_alphas(0.2, -3.0, 4))

    # driver-realistic loop-state stream WITH the running-cost slot
    # ((T, n+m+1, ...)) — with in_place=True this exercises the fused
    # kernel's input/output trajectory aliasing (zero-copy carry update)
    traj = to_lanes(jnp.concatenate(
        [ro.x, ro.u, ro.cost[:, :T, None]], axis=-1), B)
    gains = to_lanes(jnp.concatenate(
        [bp.policy.k, bp.policy.K.reshape(B, T, -1)], axis=-1), B)
    x0_l = to_lanes(x0s[:, None, :], B)[0]
    L = x0_l.shape[1:]

    ctot = vec_to_lanes(jnp.sum(ro.cost, axis=1).astype(DTYPE))
    dv1 = vec_to_lanes(bp.dV[:, 0].astype(DTYPE))
    dv2 = vec_to_lanes(bp.dV[:, 1].astype(DTYPE))
    allow = vec_to_lanes((jnp.arange(B) % 2 == 0).astype(DTYPE))
    sel = jnp.stack([dv1, dv2, ctot, allow])

    fused = linesearch_lanes(traj, gains, x0_l, sel, model=model,
                             alphas=alphas, reduce_ratio_min=rr_min,
                             lims=LIMS, gk=0, gK=1, in_place=True, k_t=4,
                             interpret=True)

    # phase A: per-candidate totals
    al_tiles = jnp.stack([jnp.full(L, a, DTYPE) for a in alphas])
    pa = forward_lanes(traj, gains, x0_l, al_tiles, model=model, lims=LIMS,
                       gk=0, gK=1, k_t=4, interpret=True)
    # accept glue: the pre-fusion driver expression, identical op order to
    # the kernel's pass-boundary block
    al_sel = dc_sel = rt_sel = found = None
    for a_i, a in enumerate(alphas):
        a = np.float32(a)       # the kernel's ladder is f32; keep the glue
        #                         f32 under the suite's x64 config
        dcost = ctot - pa.totals[a_i]
        expected = (-a) * (dv1 + a * dv2)
        ratio = jnp.where(expected > 0, dcost / expected, jnp.sign(dcost))
        ok = ratio > rr_min
        if a_i == 0:
            dc_sel, rt_sel, found = dcost, ratio, ok
            al_sel = jnp.where(ok, a, np.float32(0))
        else:
            take = ok & (~found)
            al_sel = jnp.where(take, a, al_sel)
            dc_sel = jnp.where(take, dcost, dc_sel)
            rt_sel = jnp.where(take, ratio, rt_sel)
            found = found | ok
    al_eff = jnp.where(found & (allow > 0.5), al_sel, 0.0)
    # phase B: accepted-alpha re-roll + entry echo
    pb = forward_lanes(traj, gains, x0_l, al_eff[None], model=model,
                       lims=LIMS, gk=0, gK=1, k_t=4, emit_traj=True,
                       emit_echo=True, interpret=True)

    np.testing.assert_array_equal(np.asarray(fused.traj),
                                  np.asarray(pb.traj))
    np.testing.assert_array_equal(np.asarray(fused.echo),
                                  np.asarray(pb.echo))
    np.testing.assert_array_equal(np.asarray(fused.ls[0]),
                                  np.asarray(al_sel), err_msg="al_sel")
    np.testing.assert_array_equal(
        np.asarray(fused.ls[1]),
        np.asarray(jnp.where(found, 1.0, 0.0)), err_msg="any_ok")
    np.testing.assert_array_equal(np.asarray(fused.ls[2]),
                                  np.asarray(dc_sel), err_msg="dcost_sel")
    # ratio = dcost/expected: `expected = (-a)(dV1 + a dV2)` may or may not
    # be FMA-contracted depending on the surrounding XLA program, so the
    # reported ratio can differ by 1 ulp even though the accept DECISIONS
    # above are bit-identical — compare to a few ulps
    np.testing.assert_allclose(np.asarray(fused.ls[3]),
                               np.asarray(rt_sel), rtol=1e-5, atol=1e-6,
                               err_msg="ratio_sel")
    np.testing.assert_array_equal(np.asarray(fused.ls[4]),
                                  np.asarray(pb.totals[0]),
                                  err_msg="total_new")
