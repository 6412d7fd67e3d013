"""Record golden regression fixtures from the INDEPENDENT NumPy oracle.

Provenance: the fixtures are produced by
``tests/oracle.py`` — the eager-NumPy reimplementation of the reference's
exact control flow that shares no code with the JAX framework — so
``tests/test_golden.py`` catches a hypothetical shared bug in the JAX path,
not just drift against itself. Problem CONSTANTS (matrices, seeds) come from
the framework's model builders (they are data, not solver behavior).

Cases: demo-linear LTI, control-limited pendcart swing-up (ZoH derivatives),
boxQP across its result codes, and a scalar-η iLQGkl run.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import scipy.linalg

from differentialdynamicprogramming_jl_tpu.models.linear import random_lti
from differentialdynamicprogramming_jl_tpu.models.pendcart import PendCartSpec
from oracle import boxqp_np, ilqg_np, ilqgkl_np


def lti_numpy(spec):
    A, B, Q, R = map(np.asarray, (spec.A, spec.B, spec.Q, spec.R))
    n, m = B.shape

    def dyn(x, u, i):
        return A @ x + B @ u

    def traj_cost(xs, us):
        return 0.5 * (np.einsum('ti,ij,tj->t', xs, Q, xs)
                      + np.einsum('ti,ij,tj->t', us, R, us))

    def derivs_fn(xs, us):
        Tl = us.shape[0]
        return (np.broadcast_to(A, (Tl, n, n)).copy(),
                np.broadcast_to(B, (Tl, n, m)).copy(),
                xs @ Q.T, us @ R.T,
                np.broadcast_to(Q, (Tl, n, n)).copy(),
                np.zeros((Tl, n, m)),
                np.broadcast_to(R, (Tl, m, m)).copy())

    return dyn, traj_cost, derivs_fn, A, B


def pendcart_numpy(spec):
    g_, l, h, d = spec.g, spec.l, spec.h, spec.d
    Q = np.diag(spec.Q)
    R = np.array([[spec.R]])
    goal = np.array(spec.goal)

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

    return dyn, traj_cost, derivs_fn


def quadrotor_numpy(spec):
    """Planar birotor with analytic Jacobians (the framework's quadrotor
    uses autodiff on both tiers — an independent hand-derived oracle)."""
    m_, I_, arm = spec.mass, spec.inertia, spec.arm
    g_, h = spec.g, spec.h
    Q = np.array(spec.Q)
    R = spec.R
    goal = np.array(spec.goal)
    uh = spec.u_hover

    def dyn(x, u, i):
        px, vx, pz, vz, th, om = x
        thrust = u[0] + u[1]
        s, c = np.sin(th), np.cos(th)
        return np.array([px + h * vx, vx + h * (-thrust * s / m_),
                         pz + h * vz, vz + h * (thrust * c / m_ - g_),
                         th + h * om, om + h * arm * (u[0] - u[1]) / I_])

    def traj_cost(xs, us):
        dxs = xs - goal
        c = (0.5 * np.sum(Q * dxs * dxs, axis=1)
             + 0.5 * R * np.sum((us - uh) ** 2, axis=1))
        dT = xs[-1] - goal
        return np.concatenate([c, [0.5 * np.sum(Q * dT * dT)]])

    def derivs_fn(xs, us):
        Tl = us.shape[0]
        fx = np.zeros((Tl, 6, 6))
        fu = np.zeros((Tl, 6, 2))
        for i in range(Tl):
            th = xs[i, 4]
            thrust = us[i, 0] + us[i, 1]
            s, c = np.sin(th), np.cos(th)
            J = np.zeros((6, 6))
            J[0, 1] = J[2, 3] = J[4, 5] = 1.0
            J[1, 4] = -thrust * c / m_
            J[3, 4] = -thrust * s / m_
            fx[i] = np.eye(6) + h * J
            fu[i] = h * np.array([[0, 0], [-s / m_, -s / m_], [0, 0],
                                  [c / m_, c / m_], [0, 0],
                                  [arm / I_, -arm / I_]])
        return (fx, fu, (xs - goal) * Q, (us - uh) * R,
                np.broadcast_to(np.diag(Q), (Tl, 6, 6)),
                np.zeros((Tl, 6, 2)),
                np.broadcast_to(R * np.eye(2), (Tl, 2, 2)))

    return dyn, traj_cost, derivs_fn


def boxqp_cases():
    """Inputs chosen to land on distinct reference result codes
    (src/boxQP.jl:172-179)."""
    key = jax.random.PRNGKey(0)
    A = np.asarray(jax.random.normal(key, (50, 50), jnp.float64))
    H50 = A @ A.T + 0.1 * np.eye(50)
    g50 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (50,),
                                       jnp.float64))
    eye3 = np.eye(3)
    return {
        "n50": dict(H=H50, g=g50, lower=-np.ones(50), upper=np.ones(50),
                    x0=np.zeros(50)),
        # all dims pushed hard onto the bounds → result 6
        "all_clamped": dict(H=eye3, g=np.array([10., -10., 10.]),
                            lower=-np.ones(3), upper=np.ones(3),
                            x0=np.zeros(3)),
        # interior optimum reached exactly → gradient exit (5)
        "interior": dict(H=2.0 * eye3, g=np.array([0.5, -0.25, 0.1]),
                         lower=-np.ones(3), upper=np.ones(3),
                         x0=np.zeros(3)),
        # non-PD Hessian → result -1
        "non_pd": dict(H=np.diag([1.0, -1.0, 1.0]),
                       g=np.array([1.0, 1.0, 1.0]),
                       lower=-np.ones(3), upper=np.ones(3),
                       x0=np.zeros(3)),
    }


def main():
    out = {}

    # ---- linear (demo_linear construction, T=400)
    T = 400
    spec = random_lti(jax.random.PRNGKey(0), n=10, m=2, T=T,
                      dtype=jnp.float64)
    dyn, tc, dfn, A, B = lti_numpy(spec)
    r = ilqg_np(dyn, tc, dfn, np.asarray(spec.x0), np.asarray(spec.u0),
                max_iter=100)
    out["linear_cost"] = r["cost"].sum()
    out["linear_u_sum"] = r["u"].sum()
    out["linear_u_abs"] = np.abs(r["u"]).sum()

    # ---- pendcart swing-up at ±10, ZoH derivatives, T=300
    pspec = PendCartSpec()
    pdyn, ptc, pdfn = pendcart_numpy(pspec)
    x0 = np.array([np.pi - 0.6, 0, 0, 0.])
    pr = ilqg_np(pdyn, ptc, pdfn, x0, np.zeros((300, 1)),
                 lims=np.array([[-10., 10.]]),
                 alphas=10.0 ** np.linspace(0.2, -3, 6), reg_type=2,
                 lam_max=1e15, tol_fun=1e-8, tol_grad=1e-8, max_iter=300)
    out["pendcart_cost"] = pr["cost"].sum()
    out["pendcart_angle"] = pr["x"][-1, 0]
    out["pendcart_u_abs"] = np.abs(pr["u"]).sum()

    # ---- boxQP result-code cases
    for name, case in boxqp_cases().items():
        x, result, _, free = boxqp_np(case["H"], case["g"], case["lower"],
                                      case["upper"], case["x0"])
        val = x @ case["g"] + 0.5 * x @ case["H"] @ x
        out[f"boxqp_{name}_value"] = val
        out[f"boxqp_{name}_result"] = result
        out[f"boxqp_{name}_x_sum"] = x.sum()
    # legacy keys for the n=50 case
    out["boxqp_value"] = out["boxqp_n50_value"]
    out["boxqp_result"] = out["boxqp_n50_result"]
    out["boxqp_x_sum"] = out["boxqp_n50_x_sum"]

    # ---- iLQGkl (scalar η), LTI T=60 n=4 m=2
    Tk, nk, mk = 60, 4, 2
    kspec = random_lti(jax.random.PRNGKey(0), n=nk, m=mk, T=Tk,
                       dtype=jnp.float64)
    kdyn, ktc, kdfn, kA, kB = lti_numpy(kspec)
    # pre-roll u0 open-loop
    xs = np.zeros((Tk, nk))
    xi = np.asarray(kspec.x0)
    u0 = np.asarray(kspec.u0)
    for i in range(Tk):
        xs[i] = xi
        xi = kdyn(xi, u0[i], i)
    cost0 = ktc(xs, u0)
    tp = dict(k=u0, K=np.zeros((Tk, mk, nk)),
              sigma=np.broadcast_to(np.eye(mk), (Tk, mk, mk)).copy(),
              sigma_inv=np.broadcast_to(np.eye(mk), (Tk, mk, mk)).copy())
    fxm = np.broadcast_to(kA, (Tk, nk, nk)).copy()
    kr = ilqgkl_np(kdyn, ktc, kdfn, xs, tp, cost0, fxm, np.eye(nk),
                   kl_step=2.0, max_iter=30)
    out["ilqgkl_cost"] = np.sum(kr["cost"])
    out["ilqgkl_eta"] = kr["eta"]
    out["ilqgkl_divergence"] = kr["divergence"]
    out["ilqgkl_iters"] = kr["iters"]
    out["ilqgkl_satisfied"] = int(kr["satisfied"])

    # ---- iLQGkl per-timestep-η ADAM branch (src/iLQGkl.jl:185-236),
    #      same LTI setup as the scalar-η case
    from oracle import ilqgkl_perstep_np
    # kl_step well below the η=1 divergence so the ADAM dual loop actually
    # iterates (a loose step is satisfied at iteration 1 — no anchor)
    pr2 = ilqgkl_perstep_np(kdyn, ktc, kdfn, xs, tp, cost0, fxm,
                            np.eye(nk), kl_step=1e-5, max_iter=15,
                            gd_alpha=0.3)
    out["ilqgkl_ps_cost"] = np.sum(pr2["cost"])
    out["ilqgkl_ps_eta_mean"] = np.mean(pr2["eta"])
    out["ilqgkl_ps_div_mean"] = np.mean(pr2["divergence"])
    out["ilqgkl_ps_iters"] = pr2["iters"]
    out["ilqgkl_ps_satisfied"] = int(pr2["satisfied"])

    # ---- quadrotor hover (the round-3 autodiff-tiles family), thrust
    #      limits active at rest
    from differentialdynamicprogramming_jl_tpu.models.quadrotor import (
        QuadrotorSpec)
    qspec = QuadrotorSpec()
    qdyn, qtc, qdfn = quadrotor_numpy(qspec)
    qx0 = np.array([1.0, 0.0, 0.0, 0.0, 0.3, 0.0])
    qr = ilqg_np(qdyn, qtc, qdfn, qx0,
                 np.full((150, 2), qspec.u_hover),
                 lims=np.array([[0.0, qspec.u_max]] * 2),
                 alphas=10.0 ** np.linspace(0.2, -3, 6), reg_type=2,
                 lam_max=1e15, max_iter=200)
    out["quadrotor_cost"] = qr["cost"].sum()
    out["quadrotor_u_abs"] = np.abs(qr["u"]).sum()
    out["quadrotor_xT"] = qr["x"][-1]

    out["provenance_oracle"] = 1  # recorded from tests/oracle.py, not JAX

    path = os.path.join(_ROOT, "tests", "golden.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})
    for k, v in out.items():
        print(f"{k}: {v}")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
