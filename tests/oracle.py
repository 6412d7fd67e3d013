"""Independent NumPy implementation of the iLQG algorithm with the exact
reference semantics (Tassa/Mansard/Todorov ICRA 2014; reference behavior in
the reference's ``src/iLQG.jl``, ``backward_pass.jl``, ``boxQP.jl``,
``forward_pass.jl``) — used ONLY as a parity oracle for tests. Plain Python
loops, eager numpy, exceptions for non-PD: deliberately the *opposite* of the
jitted, batched design, so the two implementations share no code or
structure and agreement is meaningful evidence of correctness.

Conventions match the framework (time-major, 0-based): x (T,n), u (T,m),
K (T,m,n).
"""
import numpy as np


def boxqp_np(H, g, lower, upper, x0, max_iter=100, min_grad=1e-8,
             min_rel_improve=1e-8, step_dec=0.6, min_step=1e-22, armijo=0.1):
    n = len(g)
    clamped = np.zeros(n, bool)
    free = np.ones(n, bool)
    Hfree = np.zeros((n, n))
    oldvalue = 0.0
    result = 0
    x = np.clip(x0, lower, upper)
    value = x @ g + 0.5 * x @ H @ x
    it = 1
    while it <= max_iter:
        if result != 0:
            break
        if it > 1 and (oldvalue - value) < min_rel_improve * abs(oldvalue):
            result = 4
            break
        oldvalue = value
        grad = g + H @ x
        old_clamped = clamped
        clamped = ((x == lower) & (grad > 0)) | ((x == upper) & (grad < 0))
        free = ~clamped
        if clamped.all():
            result = 6
            break
        if it == 1 or (old_clamped != clamped).any():
            try:
                Hfree = np.linalg.cholesky(H[np.ix_(free, free)]).T  # upper
            except np.linalg.LinAlgError:
                result = -1
                break
        gnorm = np.linalg.norm(grad[free])
        if gnorm < min_grad:
            result = 5
            break
        grad_clamped = g + H @ (x * clamped)
        search = np.zeros(n)
        search[free] = -np.linalg.solve(
            Hfree, np.linalg.solve(Hfree.T, grad_clamped[free])) - x[free]
        sdotg = search @ grad
        if sdotg >= 0:
            break
        step = 1.0
        xc = np.clip(x + step * search, lower, upper)
        vc = xc @ g + 0.5 * xc @ H @ xc
        while (vc - oldvalue) / (step * sdotg) < armijo:
            step *= step_dec
            xc = np.clip(x + step * search, lower, upper)
            vc = xc @ g + 0.5 * xc @ H @ xc
            if step < min_step:
                result = 2
                break
        x, value = xc, vc
        it += 1
    if result == 0 and it > max_iter:
        result = 1
    return x, result, Hfree, free


def back_pass_np(derivs, u, lam, reg_type, lims):
    """Backward recursion, eager numpy, exceptions-as-control-flow."""
    fx, fu, cx, cu, cxx, cxu, cuu = derivs
    T, m = u.shape
    n = cx.shape[1]
    k = np.zeros((T, m))
    K = np.zeros((T, m, n))
    Vx = np.zeros((T, n))
    Vxx = np.zeros((T, n, n))
    Quu_all = np.zeros((T, m, m))
    dV = np.zeros(2)
    Vx[T - 1] = cx[T - 1]
    Vxx[T - 1] = cxx[T - 1]
    Quu_all[T - 1] = cuu[T - 1]
    for i in range(T - 2, -1, -1):
        Qu = cu[i] + fu[i].T @ Vx[i + 1]
        Qx = cx[i] + fx[i].T @ Vx[i + 1]
        Qux = cxu[i].T + fu[i].T @ Vxx[i + 1] @ fx[i]
        Quu = cuu[i] + fu[i].T @ Vxx[i + 1] @ fu[i]
        Qxx = cxx[i] + fx[i].T @ Vxx[i + 1] @ fx[i]
        Vxx_reg = Vxx[i + 1] + (lam * np.eye(n) if reg_type == 2 else 0)
        Qux_reg = cxu[i].T + fu[i].T @ Vxx_reg @ fx[i]
        QuuF = cuu[i] + fu[i].T @ Vxx_reg @ fu[i] \
            + (lam * np.eye(m) if reg_type == 1 else 0)
        if lims is None:
            try:
                R = np.linalg.cholesky(0.5 * (QuuF + QuuF.T))
            except np.linalg.LinAlgError:
                return i + 1, (k, K), Vx, Vxx, dV
            k_i = -np.linalg.solve(R.T, np.linalg.solve(R, Qu))
            K_i = -np.linalg.solve(R.T, np.linalg.solve(R, Qux_reg))
        else:
            lower = lims[:, 0] - u[i]
            upper = lims[:, 1] - u[i]
            k_i, result, Hfree, free = boxqp_np(
                QuuF, Qu, lower, upper, k[min(i + 1, T - 2)])
            if result < 1:
                return i + 1, (k, K), Vx, Vxx, dV
            K_i = np.zeros((m, n))
            if free.any():
                K_i[free] = -np.linalg.solve(
                    Hfree, np.linalg.solve(Hfree.T, Qux_reg[free]))
        Quuk = Quu @ k_i
        dV += [k_i @ Qu, 0.5 * k_i @ Quuk]
        Vx[i] = Qx + K_i.T @ Quuk + K_i.T @ Qu + Qux.T @ k_i
        Vxx[i] = Qxx + K_i.T @ Quu @ K_i + K_i.T @ Qux + Qux.T @ K_i
        Vxx[i] = 0.5 * (Vxx[i] + Vxx[i].T)
        k[i] = k_i
        K[i] = K_i
        Quu_all[i] = Quu
    return 0, (k, K), Vx, Vxx, dV


def forward_np(dyn, traj_cost, x0, u, x_old, alpha, policy, lims):
    T, m = u.shape
    n = len(x0)
    xnew = np.zeros((T, n))
    unew = u.copy()
    xi = x0.copy()
    for i in range(T):
        xnew[i] = xi
        if policy is not None:
            k, K = policy
            unew[i] = unew[i] + alpha * k[i] + K[i] @ (xnew[i] - x_old[i])
        if lims is not None:
            unew[i] = np.clip(unew[i], lims[:, 0], lims[:, 1])
        xi = dyn(xi, unew[i], i)
    return xnew, unew, traj_cost(xnew, unew)


def ilqg_np(dyn, traj_cost, derivs_fn, x0, u0, lims=None,
            alphas=10.0 ** np.linspace(0, -3, 11), tol_fun=1e-7,
            tol_grad=1e-4, max_iter=500, lam=1.0, dlam=1.0, lam_factor=1.6,
            lam_max=1e10, lam_min=1e-6, reg_type=1, reduce_ratio_min=0.0,
            log=None):
    """Direct eager-numpy iLQG with the reference's exact control flow."""
    u = u0.copy()
    # initial rollout
    diverged = True
    for a in alphas:
        x, un, cost = forward_np(dyn, traj_cost, x0, a * u, None, 1.0,
                                 None, lims)
        if np.all(np.abs(x) < 1e8):
            u = un
            diverged = False
            break
    assert not diverged, "initial rollout diverged"

    flg_change = True
    derivs = None
    it = accepted = 1
    Vx = Vxx = None
    while accepted <= max_iter:
        if flg_change:
            derivs = derivs_fn(x, u)
            flg_change = False
        # backward with retry
        back_done = False
        while not back_done:
            div, (k, K), Vx, Vxx, dV = back_pass_np(derivs, u, lam,
                                                    reg_type, lims)
            if div > 0:
                dlam, lam = max(dlam * lam_factor, lam_factor), \
                    max(lam * dlam, lam_min)
                if lam > lam_max:
                    break
                continue
            back_done = True
        g_norm = np.mean(np.max(np.abs(k) / (np.abs(u) + 1), axis=1))
        if g_norm < tol_grad and lam < 1e-5:
            if log is not None:
                log.append(dict(reason="grad", it=it))
            break
        fwd_done = False
        if back_done:
            for a in alphas:
                xnew, unew, costnew = forward_np(dyn, traj_cost, x0, u, x, a,
                                                 (k, K), lims)
                dcost = cost.sum() - costnew.sum()
                expected = -a * (dV[0] + a * dV[1])
                ratio = dcost / expected if expected > 0 else np.sign(dcost)
                if ratio > reduce_ratio_min:
                    fwd_done = True
                    break
        if fwd_done:
            dlam = min(dlam / lam_factor, 1 / lam_factor)
            lam = max(lam * dlam, lam_min)
            x, u, cost = xnew, unew, costnew
            flg_change = True
            if log is not None:
                log.append(dict(it=it, cost=cost.sum(), dcost=dcost,
                                lam=lam, alpha=a, accept=True))
            if dcost < tol_fun:
                break
            accepted += 1
        else:
            dlam, lam = max(dlam * lam_factor, lam_factor), \
                max(lam * dlam, lam_min)
            if log is not None:
                log.append(dict(it=it, cost=cost.sum(), lam=lam,
                                accept=False))
            if lam > lam_max:
                break
        it += 1
    return dict(x=x, u=u, cost=cost, k=k, K=K, Vx=Vx, Vxx=Vxx,
                iters=it, accepted=accepted, g_norm=g_norm, lam=lam)


# ---------------------------------------------------------------------------
# GPS / iLQGkl oracle (reference src/iLQGkl.jl, back_pass_gps, klutils.jl)
# ---------------------------------------------------------------------------

def grad_kl_np(Kp, kp, Sip):
    """∇kl (src/klutils.jl:8-23): cx=K'Σ⁻¹k, cu=-Σ⁻¹k, cxx=K'Σ⁻¹K,
    cxu=-Σ⁻¹K, cuu=Σ⁻¹ per timestep."""
    T, m, n = Kp.shape
    cx = np.zeros((T, n)); cu = np.zeros((T, m))
    cxx = np.zeros((T, n, n)); cxu = np.zeros((T, m, n))
    cuu = np.zeros((T, m, m))
    for t in range(T):
        Sik = Sip[t] @ kp[t]
        cx[t] = Kp[t].T @ Sik
        cu[t] = -Sik
        cxx[t] = Kp[t].T @ Sip[t] @ Kp[t]
        cxu[t] = -Sip[t] @ Kp[t]
        cuu[t] = Sip[t]
    return cx, cu, cxx, cxu, cuu


def back_pass_gps_np(derivs, u, eta, lims, kl):
    """back_pass_gps (src/backward_pass.jl:259-350): Q terms scaled 1/η and
    augmented with the KL expansion; no λ; Σ=Quu⁻¹, Σi=Quu. ``eta`` may be
    a scalar or a per-timestep (T,) vector (the reference's η::Vector
    overload used by the constrain_per_step branch)."""
    fx, fu, cx, cu, cxx, cxu, cuu = derivs
    cxkl, cukl, cxxkl, cxukl, cuukl = kl
    T, m = u.shape
    n = cx.shape[1]
    eta_t = (lambda i: eta[i]) if np.ndim(eta) else (lambda i: eta)
    k = np.zeros((T, m)); K = np.zeros((T, m, n))
    Vx = np.zeros((T, n)); Vxx = np.zeros((T, n, n))
    Quu_all = np.zeros((T, m, m)); Quui_all = np.zeros((T, m, m))
    dV = np.zeros(2)
    Vx[T - 1] = cx[T - 1]
    Vxx[T - 1] = cxx[T - 1]
    Quu_all[T - 1] = cuu[T - 1] / eta_t(T - 1) + cuukl[T - 1]
    Quui_all[T - 1] = np.linalg.inv(Quu_all[T - 1])
    for i in range(T - 2, -1, -1):
        eta_i = eta_t(i)
        Qu = cu[i] + fu[i].T @ Vx[i + 1]
        Qx = cx[i] + fx[i].T @ Vx[i + 1]
        Qux = cxu[i].T + fu[i].T @ Vxx[i + 1] @ fx[i]
        Quu = cuu[i] + fu[i].T @ Vxx[i + 1] @ fu[i]
        Qxx = cxx[i] + fx[i].T @ Vxx[i + 1] @ fx[i]
        Qu = Qu / eta_i + cukl[i]
        Qux = Qux / eta_i + cxukl[i]
        Quu = Quu / eta_i + cuukl[i]
        Qx = Qx / eta_i + cxkl[i]
        Qxx = Qxx / eta_i + cxxkl[i]
        Quu = 0.5 * (Quu + Quu.T)
        if lims is None:
            try:
                R = np.linalg.cholesky(Quu)
            except np.linalg.LinAlgError:
                return i + 1, (k, K, Quu_all, Quui_all), Vx, Vxx, dV
            k_i = -np.linalg.solve(R.T, np.linalg.solve(R, Qu))
            K_i = -np.linalg.solve(R.T, np.linalg.solve(R, Qux))
        else:
            lower = lims[:, 0] - u[i]
            upper = lims[:, 1] - u[i]
            k_i, result, Hfree, free = boxqp_np(
                Quu, Qu, lower, upper, k[min(i + 1, T - 2)])
            if result < 1:
                return i + 1, (k, K, Quu_all, Quui_all), Vx, Vxx, dV
            K_i = np.zeros((m, n))
            if free.any():
                K_i[free] = -np.linalg.solve(
                    Hfree, np.linalg.solve(Hfree.T, Qux[free]))
        dV += [k_i @ Qu, 0.5 * k_i @ Quu @ k_i]
        Vx[i] = Qx + K_i.T @ Quu @ k_i + K_i.T @ Qu + Qux.T @ k_i
        Vxx[i] = Qxx + K_i.T @ Quu @ K_i + K_i.T @ Qux + Qux.T @ K_i
        Vxx[i] = 0.5 * (Vxx[i] + Vxx[i].T)
        k[i] = k_i; K[i] = K_i
        Quu_all[i] = Quu
        Quui_all[i] = np.linalg.inv(Quu)
    return 0, (k, K, Quu_all, Quui_all), Vx, Vxx, dV


def forward_cov_np(fx, R1, K, Sigma):
    """forward_covariance (src/forward_pass.jl:37-56): joint (n+m)² state-
    control covariance by iterated discrete Lyapunov."""
    T, n, _ = fx.shape
    m = K.shape[1]
    S = np.zeros((T, n + m, n + m))
    S[0, :n, :n] = R1
    for i in range(T - 1):
        Sxx = S[i, :n, :n]
        S[i + 1, :n, :n] = fx[i] @ Sxx @ fx[i].T + R1
        S[i, n:, :n] = K[i] @ Sxx
        S[i, :n, n:] = Sxx @ K[i].T
        S[i, n:, n:] = K[i] @ Sxx @ K[i].T + Sigma[i]
    return S


def kl_div_wiki_np(xnew, xold, Snew, kn, Kn, Sn, kp, Kp, Sp, Sip):
    """kl_div_wiki (src/klutils.jl:70-100)."""
    T, n = xnew.shape
    m = kn.shape[1]
    out = np.zeros(T)
    for t in range(T):
        mu = xnew[t] - xold[t]
        St = Snew[t, :n, :n]
        kd = kp[t] - kn[t]
        Kd = Kp[t] - Kn[t]
        v = 0.5 * (np.trace(Sip[t] @ Sn[t]) + kd @ Sip[t] @ kd - m
                   + np.linalg.slogdet(Sp[t])[1]
                   - np.linalg.slogdet(Sn[t])[1])
        v += 0.5 * (mu @ Kd.T @ Sip[t] @ Kd @ mu
                    + np.trace(Kd.T @ Sip[t] @ Kd @ St))
        v += kd @ Sip[t] @ Kd @ mu
        out[t] = max(0.0, v)
    return out


def ilqgkl_np(dyn, traj_cost, derivs_fn, x, traj_prev, cost0, fx_model, R1,
              kl_step=1.0, max_iter=50, eta_bracket=(1e-8, 1.0, 1e16),
              del0=1e-4, lims=None):
    """Scalar-η iLQGkl with the reference's exact control flow
    (src/iLQGkl.jl:25-181): nominal (x, u) fixed for the whole loop,
    derivatives once, α=1 forward passes, η bracketing via calc_η,
    unconditional acceptance of the last iterate."""
    kp_orig = traj_prev["k"].copy()
    u = kp_orig.copy()
    T, m = u.shape
    kp = np.zeros_like(u)                          # src/iLQGkl.jl:51-52
    Kp, Sp, Sip = traj_prev["K"], traj_prev["sigma"], traj_prev["sigma_inv"]
    kl = grad_kl_np(Kp, kp, Sip)
    derivs = derivs_fn(x, u)                       # once (src/iLQGkl.jl:88)
    eb = np.array(eta_bracket, float)
    delta = float(del0)
    cost = np.asarray(cost0, float)
    xnew = unew = costnew = None
    divergence = 0.0
    satisfied = False
    it = 0
    for it in range(1, max_iter + 1):
        while True:                                # η-inflation retry
            div, pol, Vx, Vxx, dV = back_pass_gps_np(derivs, u, eb[1],
                                                     lims, kl)
            if div == 0:
                break
            eb[1] += delta                         # src/iLQGkl.jl:104-106
            delta *= 2.0
            assert eb[1] <= eb[2], "eta escalation exhausted the bracket"
        k, K, Quu, Quui = pol
        xnew, unew, costnew = forward_np(dyn, traj_cost, x[0], u, x, 1.0,
                                         (k, K), lims)
        Snew = forward_cov_np(fx_model, R1, K, Quui)   # traj.Σ = Quu⁻¹
        kn = k + kp                                # src/iLQGkl.jl:137
        div_t = kl_div_wiki_np(xnew, x, Snew, kn, K, Quui, kp, Kp, Sp, Sip)
        divergence = float(np.mean(div_t))
        violation = divergence - kl_step           # calc_η, klutils.jl:110
        satisfied = abs(violation) < 0.1 * kl_step
        if not satisfied:
            if violation < 0:                      # η too big
                eb[2] = eb[1]
                eb[1] = max(np.sqrt(eb[0] * eb[2]), 0.1 * eb[2])
            else:                                  # η too small
                eb[0] = eb[1]
                eb[1] = min(np.sqrt(eb[0] * eb[2]), 10.0 * eb[0])
        if satisfied:
            break
        if eb[1] > 0.999 * eb[2]:
            break
    # unconditional acceptance (src/iLQGkl.jl:239-241)
    return dict(x=xnew, u=unew, cost=costnew, eta=eb[1], bracket=eb,
                divergence=divergence, satisfied=satisfied, iters=it)


def ilqgkl_perstep_np(dyn, traj_cost, derivs_fn, x, traj_prev, cost0,
                      fx_model, R1, kl_step=1.0, max_iter=50,
                      eta_bracket=(1e-8, 1.0, 1e16), del0=1e-4,
                      gd_alpha=0.005, lims=None):
    """Per-timestep-η iLQGkl (the reference ``constrain_per_step`` branch,
    src/iLQGkl.jl:185-236): η is a (T,) dual vector updated by ADAM in log
    space (src/klutils.jl:186-210) against the per-step constraint
    violation; the η-inflation retry escalates only the diverged timestep
    and its increments reset each outer iteration (src/iLQGkl.jl:189)."""
    kp_orig = traj_prev["k"].copy()
    u = kp_orig.copy()
    T, m = u.shape
    kp = np.zeros_like(u)                          # src/iLQGkl.jl:51-52
    Kp, Sp, Sip = traj_prev["K"], traj_prev["sigma"], traj_prev["sigma_inv"]
    kl = grad_kl_np(Kp, kp, Sip)
    derivs = derivs_fn(x, u)                       # once (src/iLQGkl.jl:88)
    lo = np.full(T, eta_bracket[0])
    eta = np.full(T, eta_bracket[1])
    hi = np.full(T, eta_bracket[2])
    b1, b2, eps = 0.9, 0.999, 1e-8
    m_a = np.zeros(T); v_a = np.zeros(T)
    xnew = unew = costnew = None
    div_t = np.zeros(T)
    satisfied = False
    it = 0
    for it in range(1, max_iter + 1):
        delta = np.full(T, del0)                   # reset (src/iLQGkl.jl:189)
        while True:                                # per-step η retry
            div, pol, Vx, Vxx, dV = back_pass_gps_np(derivs, u, eta,
                                                     lims, kl)
            if div == 0:
                break
            d = div - 1                            # 1-based diverge index
            eta[d] += delta[d]                     # src/iLQGkl.jl:194-196
            delta[d] *= 2.0
            assert not np.all(eta > 0.999 * hi), "η escalation exhausted"
        k, K, Quu, Quui = pol
        xnew, unew, costnew = forward_np(dyn, traj_cost, x[0], u, x, 1.0,
                                         (k, K), lims)
        Snew = forward_cov_np(fx_model, R1, K, Quui)
        kn = k + kp                                # src/iLQGkl.jl:207
        div_t = kl_div_wiki_np(xnew, x, Snew, kn, K, Quui, kp, Kp, Sp, Sip)
        violation = div_t - kl_step                # (T,)
        g = -violation                             # src/iLQGkl.jl:213-218
        m_a = b1 * m_a + (1 - b1) * g
        v_a = b2 * v_a + (1 - b2) * g * g
        m_hat = m_a / (1 - b1 ** it)
        v_hat = v_a / (1 - b2 ** it)
        eta = np.exp(np.log(eta) - gd_alpha * m_hat / (np.sqrt(v_hat)
                                                       + eps))
        eta = np.clip(eta, lo, hi)
        if (np.all(div_t < 2.0 * kl_step)
                and np.mean(violation) < 0.1 * kl_step):
            satisfied = True
            break
    # unconditional acceptance (src/iLQGkl.jl:239-241)
    return dict(x=xnew, u=unew, cost=costnew, eta=eta,
                divergence=div_t, satisfied=satisfied, iters=it)
