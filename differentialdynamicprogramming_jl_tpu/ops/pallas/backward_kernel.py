"""Pallas kernel (Triton route) for the batched backward pass
(Riccati-like recursion).

This is the framework's hottest op (reference hot loop: ``for i = N-1:-1:1``
at ``src/backward_pass.jl:102-126`` plus the per-step gain solve / boxQP at
``:28-79`` and ``src/boxQP.jl:71-165``). The XLA expression (vmap over B of a
``lax.scan``, ``ops/backward.py``) launches small kernels for every timestep
and every box-QP iteration. This kernel flips the layout — **scenario batch
on the lanes** (see ``pack.py``): every small-matrix entry is one lane tile
of ``W`` scenarios, and the whole per-step recursion unrolls over the tiny
n/m dims as elementwise tile arithmetic.

Structure:
- the grid is the batch axis only: one program per lane-tile column, which
  runs the whole time recursion in a ``lax.fori_loop`` from t=T-1 down to 0;
- the value function (Vx, Vxx), the expected-reduction sums, the divergence
  latch and (m>2) the box-QP warm start are loop carries, i.e. registers;
  the t=T-1 boundary is evaluated before the loop;
- ``k_t`` is the static unroll of the time loop; the loads of step t never
  depend on the recursion, so Triton's pipelining keeps them in flight;
- per-scenario λ regularization (reg_type 1/2, ``src/backward_pass.jl:119-123``)
  — λ is a lane vector, so the λ-retry driver escalates each scenario
  independently in a single kernel relaunch;
- control limits: m==1 closed-form clamped Newton; m==2 exact 9-configuration
  active-set enumeration (every box-QP active set of a 2-D strictly convex
  QP) with the free set derived from the KKT gradient conditions exactly like
  the reference (``src/boxQP.jl:92-94``); m>2 fixed-iteration masked
  projected-Newton (:func:`_boxqp_masked`) warm-started from the next
  timestep's k, like the reference's per-step boxQP
  (``src/backward_pass.jl:49``, ``src/boxQP.jl:71-165``);
- "Cholesky failed" (``src/backward_pass.jl:36-38``) = per-lane PD flag; the
  first failing timestep is latched like the reference's ``diverge`` index.

GPS/KL mode (reference ``back_pass_gps``) activates via the ``prev``/``eta``
inputs: Q terms scaled by 1/η and augmented with the KL expansion computed
in-register from the previous-policy stream (``src/backward_pass.jl:293-299``,
``src/klutils.jl:8-23``).

Full DDP (second-order dynamics terms) is supported on the
``derivs_tiles`` input path: when the model's tile function also returns
``fxx``/``fxu``/``fuu`` tile lists, their V'-contractions are added
in-register (the packed-stream path stays first-order). The kernel is
float32; f64 solves use the XLA tier (``ops/backward.py`` vmapped).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from .pack import (DerivLayout, compiler_params, lane_spec, time_loop,
                   to_lanes, from_lanes, vec_to_lanes)
from ...policy import Derivs, GaussianPolicy
from ..backward import BackwardOut


class OutLayout:
    """Slot offsets of the packed backward outputs, row-major flattened.

    ``emit`` selects which blocks the kernel writes — the solve loops only
    ever consume a prefix of the full stream, and every written slot is
    T × B floats of device-memory traffic (n=4, m=1: 27 slots × T × B ≈
    221 MB per call at B=4096, T=500):

    - ``"full"``: k, K, Vx, Vxx, Quu, Quu⁻¹ (everything — the result
      materialization and the batch-major parity wrapper).
    - ``"gains"``: k, K only — all the iLQG loop's forward passes and the
      gradient-norm exit need (``solvers/batch.py``); 5 of 27 slots at
      pendcart size.
    - ``"policy"``: k, K, Quu, Quu⁻¹ — what the GPS/KL loop's measured-KL
      step additionally needs (``solvers/batch_kl.py``); skips the n + n²
      Vx/Vxx slots (110 of 140 at LTI n=10, m=2).

    Absent blocks have offset ``None``. The k/K prefix is layout-identical
    across modes, so the forward kernel's ``gk``/``gK`` offsets never change.
    """

    def __init__(self, n: int, m: int, emit: str = "full"):
        assert emit in ("full", "gains", "policy"), emit
        self.n, self.m, self.emit = n, m, emit
        self.k = 0
        self.K = m
        off = self.K + m * n
        if emit == "full":
            self.Vx = off
            self.Vxx = off + n
            off += n + n * n
        else:
            self.Vx = self.Vxx = None
        if emit in ("full", "policy"):
            self.quu = off
            self.quui = off + m * m
            off += 2 * m * m
        else:
            self.quu = self.quui = None
        self.S = off


class InLayout(DerivLayout):
    """Packed derivatives + nominal control slots."""

    @property
    def u(self) -> int:
        return self.D

    @property
    def DU(self) -> int:
        return self.D + self.m


# ---------------------------------------------------------------------------
# tiny-matrix helpers: matrices are Python lists of lane tiles
# ---------------------------------------------------------------------------

def _tiny_chol(Q, mm):
    """Unrolled Cholesky of an mm×mm tile-matrix. Returns (L, ok) where ok is
    a boolean tile (all leading minors positive — the reference's
    ``isposdef`` check, ``src/backward_pass.jl:35-38``)."""
    L = [[None] * mm for _ in range(mm)]
    ok = None
    for j in range(mm):
        d = Q[j][j]
        for p in range(j):
            d = d - L[j][p] * L[j][p]
        okj = d > 0
        ok = okj if ok is None else ok & okj
        Ljj = jnp.sqrt(jnp.maximum(d, 1e-30))
        L[j][j] = Ljj
        for i in range(j + 1, mm):
            s = Q[i][j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s / Ljj
    return L, ok


def _tiny_chol_solve(L, b, mm):
    """Solve L Lᵀ x = b (lists of tiles)."""
    y = [None] * mm
    for i in range(mm):
        s = b[i]
        for p in range(i):
            s = s - L[i][p] * y[p]
        y[i] = s / L[i][i]
    x = [None] * mm
    for i in reversed(range(mm)):
        s = y[i]
        for p in range(i + 1, mm):
            s = s - L[p][i] * x[p]
        x[i] = s / L[i][i]
    return x


def _tiny_inv(Q, mm):
    """Inverse via unrolled Cholesky solves against unit vectors."""
    L, ok = _tiny_chol(Q, mm)
    cols = []
    for j in range(mm):
        e = [jnp.full_like(Q[0][0], 1.0 if i == j else 0.0)
             for i in range(mm)]
        cols.append(_tiny_chol_solve(L, e, mm))
    inv = [[cols[j][i] for j in range(mm)] for i in range(mm)]
    return inv, ok


def _boxqp_m1(quu, qu, lo, hi):
    """Closed-form 1-D box QP: min ½ quu x² + qu x s.t. lo ≤ x ≤ hi.
    Returns (x, free, ok)."""
    ok = quu > 0
    xn = -qu / quu
    x = jnp.clip(xn, lo, hi)
    grad = qu + quu * x
    clamped = ((x <= lo) & (grad > 0)) | ((x >= hi) & (grad < 0))
    return x, ~clamped, ok


def _boxqp_m2(Q, g, lo, hi):
    """Exact 2-D box QP by enumerating all 9 active-set configurations
    (each dim ∈ {lower, free, upper}), branchless. The free set of the
    minimizer is then derived from the KKT gradient conditions (reference
    clamp rule, ``src/boxQP.jl:92-94``). Returns (x0, x1, free0, free1, ok).
    """
    a, b, c = Q[0][0], Q[0][1], Q[1][1]
    g0, g1 = g[0], g[1]
    det = a * c - b * b
    det_s = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    a_s = jnp.where(jnp.abs(a) > 1e-30, a, 1e-30)
    c_s = jnp.where(jnp.abs(c) > 1e-30, c, 1e-30)

    def val(x0, x1):
        return (x0 * g0 + x1 * g1
                + 0.5 * (a * x0 * x0 + 2.0 * b * x0 * x1 + c * x1 * x1))

    cands = [((-g0 * c + g1 * b) / det_s, (g0 * b - g1 * a) / det_s)]
    for v0 in (lo[0], hi[0]):            # dim0 clamped, dim1 free
        cands.append((v0, -(g1 + b * v0) / c_s))
    for v1 in (lo[1], hi[1]):            # dim1 clamped, dim0 free
        cands.append((-(g0 + b * v1) / a_s, v1))
    for v0 in (lo[0], hi[0]):            # both clamped
        for v1 in (lo[1], hi[1]):
            cands.append((v0, v1))

    best_x0 = best_x1 = best_v = None
    for (x0, x1) in cands:
        x0 = jnp.clip(x0, lo[0], hi[0])
        x1 = jnp.clip(x1, lo[1], hi[1])
        v = val(x0, x1)
        if best_v is None:
            best_x0, best_x1, best_v = x0, x1, v
        else:
            take = v < best_v
            best_x0 = jnp.where(take, x0, best_x0)
            best_x1 = jnp.where(take, x1, best_x1)
            best_v = jnp.minimum(v, best_v)

    # KKT-based clamp detection at the minimizer (src/boxQP.jl:92-94)
    gr0 = g0 + a * best_x0 + b * best_x1
    gr1 = g1 + b * best_x0 + c * best_x1
    cl0 = ((best_x0 <= lo[0]) & (gr0 > 0)) | ((best_x0 >= hi[0]) & (gr0 < 0))
    cl1 = ((best_x1 <= lo[1]) & (gr1 > 0)) | ((best_x1 >= hi[1]) & (gr1 < 0))
    f0, f1 = ~cl0, ~cl1
    both = f0 & f1
    ok = ((both & (a > 0) & (det > 0))
          | (f0 & ~f1 & (a > 0))
          | (~f0 & f1 & (c > 0))
          | (~f0 & ~f1))
    return best_x0, best_x1, f0, f1, ok


def _boxqp_masked(H, g, lo, hi, x0, mm, n_iter):
    """Fixed-iteration masked projected-Newton box QP on tile lists — the
    ``ops/boxqp.py`` algorithm (reference ``src/boxQP.jl:71-165``) with the
    active set as boolean tiles and the free-subspace Cholesky as the
    masked-identity-padded factorization, fully unrolled over ``mm`` (the
    in-kernel gain solve for m > 2 control limits).

    Per iteration: KKT clamp detection (``src/boxQP.jl:92-94``), masked
    Cholesky, Newton step on the free dims, and a 3-candidate backtracking
    pick (α ∈ {1, ½, ¼} — the cheap in-register stand-in for the reference's
    Armijo loop; each extra candidate is ~mm² multiply-adds per scenario).

    Returns ``(x, free, L, ok)``: solution tiles, final free mask, the final
    free-set Cholesky factor (for the feedback-gain solve,
    ``src/backward_pass.jl:55-60``), and the accumulated PD flag (any failed
    factorization along the way latches ok=False — the caller's λ-escalation
    retry handles it exactly like a reference ``result=-1``).
    """
    def val(x):
        v = sum(x[i] * g[i] for i in range(mm))
        for i in range(mm):
            for j in range(mm):
                v = v + 0.5 * x[i] * H[i][j] * x[j]
        return v

    def kkt_masks(x, grad):
        clamped = [((x[i] <= lo[i]) & (grad[i] > 0))
                   | ((x[i] >= hi[i]) & (grad[i] < 0)) for i in range(mm)]
        return [~c for c in clamped]

    def masked_chol(free):
        Hm = [[jnp.where(free[i] & free[j], H[i][j], 0.0)
               + (jnp.where(free[i], 0.0, 1.0) if i == j else 0.0)
               for j in range(mm)] for i in range(mm)]
        return _tiny_chol(Hm, mm)

    x = [jnp.clip(x0[i], lo[i], hi[i]) for i in range(mm)]
    ok = jnp.zeros_like(g[0]) < 1.0          # all-True tile (qp_iters=0 safe)
    improved = None                          # did the LAST iteration descend?
    for _ in range(n_iter):
        grad = [g[i] + sum(H[i][j] * x[j] for j in range(mm))
                for i in range(mm)]
        free = kkt_masks(x, grad)
        L, okc = masked_chol(free)
        ok = ok & okc
        gf = [jnp.where(free[i], grad[i], 0.0) for i in range(mm)]
        dx = _tiny_chol_solve(L, [-v for v in gf], mm)
        dx = [jnp.where(free[i], dx[i], 0.0) for i in range(mm)]
        vb = val(x)
        xb = x
        improved = jnp.zeros_like(g[0]) > 1.0   # all-False tile
        for a in (1.0, 0.5, 0.25):
            xc = [jnp.clip(x[i] + a * dx[i], lo[i], hi[i])
                  for i in range(mm)]
            vc = val(xc)
            take = vc < vb
            improved = improved | take
            xb = [jnp.where(take, xc[i], xb[i]) for i in range(mm)]
            vb = jnp.minimum(vc, vb)
        x = xb

    # final KKT clamp set + free-subspace factor at the solution
    grad = [g[i] + sum(H[i][j] * x[j] for j in range(mm)) for i in range(mm)]
    free = kkt_masks(x, grad)
    L, okf = masked_chol(free)
    ok = ok & okf
    if improved is not None:
        # "no descent direction found" (the reference's result=0 failure,
        # src/boxQP.jl:134,172-179, which src/backward_pass.jl:48-52 treats
        # as a divergence → λ-escalation): the last Newton iteration made no
        # progress while the free-subspace gradient is still far from the
        # KKT point. A converged solve has gf≈0, so this never fires on
        # success; result=1 (iteration cap with descent still happening) is
        # NOT a reference failure and stays accepted.
        gf2 = sum(jnp.where(free[i], grad[i], 0.0) ** 2 for i in range(mm))
        g2 = sum(g[i] * g[i] for i in range(mm))
        stuck = (gf2 > 1e-6 * (g2 + 1e-30)) & (~improved)
        ok = ok & (~stuck)
    return x, free, L, ok


# ---------------------------------------------------------------------------
# kernel body
# ---------------------------------------------------------------------------

def _make_kernel(n: int, m: int, T: int, k_t: int, reg_type: int,
                 lims: Optional[Tuple[Tuple[float, float], ...]],
                 derivs_tiles=None, gps: bool = False, n_params: int = 0,
                 qp_iters: int = 8, emit: str = "full",
                 dyn_lims: bool = False):
    lay = InLayout(n, m)
    out = OutLayout(n, m, emit)
    use_limits = (lims is not None) or dyn_lims
    warm = use_limits and m > 2     # carried k warm start for the boxQP

    def kernel(*refs):
        refs = list(refs)
        dp_ref, lam_ref = refs[:2]
        rest = refs[2:]
        if gps:
            prev_ref, eta_ref = rest[:2]
            rest = rest[2:]
        params_ref = rest.pop(0) if n_params else None
        lims_ref = rest.pop(0) if dyn_lims else None
        o_ref, stat_ref = rest
        lam = lam_ref[...]
        zero = jnp.zeros_like(lam)
        par = [params_ref[p] for p in range(n_params)] if n_params else None
        # control limits: static floats or per-scenario lane tiles (slot
        # order [lo_0, hi_0, ...]) — the reference's runtime-data lims
        # (src/iLQG.jl:124, src/backward_pass.jl:45-49)
        if dyn_lims:
            limt = [(lims_ref[2 * mi], lims_ref[2 * mi + 1])
                    for mi in range(m)]
        else:
            limt = lims

        def read_derivs(t):
            """Per-step derivative tiles: either sliced from the packed
            stream or computed in-register from (x, u) by the model's
            ``derivs_tiles`` (saving ~90% of the backward input traffic)."""
            def mat(off, r, c):
                return [[dp_ref[t, off + i * c + j] for j in range(c)]
                        for i in range(r)]

            if derivs_tiles is None:
                return dict(
                    fx=mat(lay.fx, n, n), fu=mat(lay.fu, n, m),
                    cx=[dp_ref[t, lay.cx + i] for i in range(n)],
                    cu=[dp_ref[t, lay.cu + mi] for mi in range(m)],
                    cxx=mat(lay.cxx, n, n), cxu=mat(lay.cxu, n, m),
                    cuu=mat(lay.cuu, m, m),
                    u=[dp_ref[t, lay.u + mi] for mi in range(m)])
            x_t = [dp_ref[t, i] for i in range(n)]
            u_t = [dp_ref[t, n + mi] for mi in range(m)]
            d = (derivs_tiles(x_t, u_t, t, par) if n_params
                 else derivs_tiles(x_t, u_t, t))
            d["u"] = u_t
            return d

        def read_kl(t):
            """GPS mode: η dual tile + KL cost-expansion tiles computed from
            the previous-policy stream [k_prev(m), K_prev(m·n), Σ⁻¹_prev(m²)]
            (``∇kl``, ``src/klutils.jl:8-23``)."""
            eta = eta_ref[t, 0]
            kp = [prev_ref[t, mi] for mi in range(m)]
            Kp = [[prev_ref[t, m + mi * n + j] for j in range(n)]
                  for mi in range(m)]
            Si = [[prev_ref[t, m + m * n + mi * m + mj] for mj in range(m)]
                  for mi in range(m)]
            Sik = [sum(Si[mi][mj] * kp[mj] for mj in range(m))
                   for mi in range(m)]
            SiK = [[sum(Si[mi][mj] * Kp[mj][j] for mj in range(m))
                    for j in range(n)] for mi in range(m)]
            return dict(
                eta=eta,
                cx=[sum(Kp[mi][i] * Sik[mi] for mi in range(m))
                    for i in range(n)],
                cu=[-Sik[mi] for mi in range(m)],
                cxx=[[sum(Kp[mi][i] * SiK[mi][j] for mi in range(m))
                      for j in range(n)] for i in range(n)],
                cxu=[[-SiK[mi][j] for j in range(n)] for mi in range(m)],
                cuu=Si)

        def write(t, k_t_, K_t_, Vx, Vxx, Quu):
            for mi in range(m):
                o_ref[t, out.k + mi] = k_t_[mi]
                for j in range(n):
                    o_ref[t, out.K + mi * n + j] = K_t_[mi][j]
            if out.Vx is not None:
                for i in range(n):
                    o_ref[t, out.Vx + i] = Vx[i]
                    for j in range(n):
                        o_ref[t, out.Vxx + i * n + j] = Vxx[i][j]
            if out.quu is not None:
                Quu_inv, _ok = _tiny_inv(Quu, m)
                for mi in range(m):
                    for mj in range(m):
                        o_ref[t, out.quu + mi * m + mj] = Quu[mi][mj]
                        o_ref[t, out.quui + mi * m + mj] = Quu_inv[mi][mj]

        # ---- boundary t = T-1 (src/backward_pass.jl:97-99, 280-283)
        t_end = jnp.int32(T - 1)
        d = read_derivs(t_end)
        if gps:
            kl = read_kl(t_end)
            cuu = [[d["cuu"][mi][mj] / kl["eta"] + kl["cuu"][mi][mj]
                    for mj in range(m)] for mi in range(m)]
        else:
            cuu = d["cuu"]
        write(t_end, [zero] * m, [[zero] * n for _ in range(m)],
              d["cx"], d["cxx"], cuu)
        # boxQP warm start: k[:, min(i+1, N-1)] with k[N-1]=0
        # (src/backward_pass.jl:49)
        state0 = (list(d["cx"]), [list(r) for r in d["cxx"]],
                  zero, zero, zero, zero, [zero] * m if warm else [])

        def step(t, st):
            """One timestep t < T-1: returns the state for step t-1."""
            Vx, Vxx, dv1, dv2, was_div, divt, kw = st
            d = read_derivs(t)
            fx, fu = d["fx"], d["fu"]
            cx, cu = d["cx"], d["cu"]
            cxx, cxu, cuu = d["cxx"], d["cxu"], d["cuu"]   # cxu: (n, m)
            u_t = d["u"]

            # Q expansions (src/backward_pass.jl:103-123)
            Qx = [cx[i] + sum(fx[a][i] * Vx[a] for a in range(n))
                  for i in range(n)]
            Qu = [cu[mi] + sum(fu[a][mi] * Vx[a] for a in range(n))
                  for mi in range(m)]
            W_ = [[sum(Vxx[a][b] * fx[b][j] for b in range(n))
                   for j in range(n)] for a in range(n)]
            U = [[sum(Vxx[a][b] * fu[b][mi] for b in range(n))
                  for mi in range(m)] for a in range(n)]
            Qxx = [[cxx[i][j] + sum(fx[a][i] * W_[a][j] for a in range(n))
                    for j in range(n)] for i in range(n)]
            Quu = [[cuu[mi][mj] + sum(fu[a][mi] * U[a][mj] for a in range(n))
                    for mj in range(m)] for mi in range(m)]
            Qux = [[cxu[j][mi] + sum(fu[a][mi] * W_[a][j] for a in range(n))
                    for j in range(n)] for mi in range(m)]

            if "fxx" in d:
                # full DDP: second-order dynamics contractions with V'_{t+1}
                # (reference vectens terms; layouts as ops/backward.py:154-159
                # — fxx[a][i][j]=∂²f_a/∂x_i∂x_j, fxu[a][j][mi],
                # fuu[a][mi][mj]). Added before the regularization branches,
                # so reg_type 2's Qux_r/QuuF inherit them exactly like the XLA
                # path (:178-179).
                fxx, fxu, fuu = d["fxx"], d["fxu"], d["fuu"]
                Qxx = [[Qxx[i][j]
                        + sum(Vx[a] * fxx[a][i][j] for a in range(n))
                        for j in range(n)] for i in range(n)]
                Qux = [[Qux[mi][j]
                        + sum(Vx[a] * fxu[a][j][mi] for a in range(n))
                        for j in range(n)] for mi in range(m)]
                Quu = [[Quu[mi][mj]
                        + sum(Vx[a] * fuu[a][mi][mj] for a in range(n))
                        for mj in range(m)] for mi in range(m)]

            if gps:
                # GPS mode: η is the only regularizer; Q terms scaled by 1/η
                # and augmented with the KL expansion
                # (src/backward_pass.jl:293-299)
                kl = read_kl(t)
                ie = 1.0 / kl["eta"]
                Qx = [Qx[i] * ie + kl["cx"][i] for i in range(n)]
                Qu = [Qu[mi] * ie + kl["cu"][mi] for mi in range(m)]
                Qxx = [[Qxx[i][j] * ie + kl["cxx"][i][j] for j in range(n)]
                       for i in range(n)]
                Qux = [[Qux[mi][j] * ie + kl["cxu"][mi][j] for j in range(n)]
                       for mi in range(m)]
                Quu_g = [[Quu[mi][mj] * ie + kl["cuu"][mi][mj]
                          for mj in range(m)] for mi in range(m)]
                Quu = [[0.5 * (Quu_g[mi][mj] + Quu_g[mj][mi])
                        for mj in range(m)] for mi in range(m)]
                Qux_r, QuuF = Qux, Quu
            # regularized gain matrices (src/backward_pass.jl:119-123)
            elif reg_type == 2:
                fuTfx = [[sum(fu[a][mi] * fx[a][j] for a in range(n))
                          for j in range(n)] for mi in range(m)]
                fuTfu = [[sum(fu[a][mi] * fu[a][mj] for a in range(n))
                          for mj in range(m)] for mi in range(m)]
                Qux_r = [[Qux[mi][j] + lam * fuTfx[mi][j]
                          for j in range(n)] for mi in range(m)]
                QuuF = [[Quu[mi][mj] + lam * fuTfu[mi][mj]
                         for mj in range(m)] for mi in range(m)]
            else:
                Qux_r = Qux
                QuuF = [[Quu[mi][mj] + (lam if mi == mj else 0.0)
                         for mj in range(m)] for mi in range(m)]

            # ---- gain solve
            if not use_limits:
                L, ok = _tiny_chol(QuuF, m)
                k_t_ = _tiny_chol_solve(L, [-Qu[mi] for mi in range(m)], m)
                K_t_ = [[None] * n for _ in range(m)]
                for j in range(n):
                    col = _tiny_chol_solve(
                        L, [-Qux_r[mi][j] for mi in range(m)], m)
                    for mi in range(m):
                        K_t_[mi][j] = col[mi]
            elif m == 1:
                lo = limt[0][0] - u_t[0]
                hi = limt[0][1] - u_t[0]
                x, free, ok = _boxqp_m1(QuuF[0][0], Qu[0], lo, hi)
                k_t_ = [x]
                quu_s = jnp.where(jnp.abs(QuuF[0][0]) > 1e-30,
                                  QuuF[0][0], 1e-30)
                K_t_ = [[jnp.where(free, -Qux_r[0][j] / quu_s, 0.0)
                         for j in range(n)]]
            elif m == 2:
                lo = [limt[0][0] - u_t[0], limt[1][0] - u_t[1]]
                hi = [limt[0][1] - u_t[0], limt[1][1] - u_t[1]]
                x0, x1, f0, f1, ok = _boxqp_m2(QuuF, Qu, lo, hi)
                both = f0 & f1
                k_t_ = [x0, x1]
                a, b, c = QuuF[0][0], QuuF[0][1], QuuF[1][1]
                det = a * c - b * b
                det_s = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
                a_s = jnp.where(jnp.abs(a) > 1e-30, a, 1e-30)
                c_s = jnp.where(jnp.abs(c) > 1e-30, c, 1e-30)
                K_t_ = [[None] * n for _ in range(2)]
                for j in range(n):
                    q0, q1 = Qux_r[0][j], Qux_r[1][j]
                    kb0 = (-q0 * c + q1 * b) / det_s
                    kb1 = (q0 * b - q1 * a) / det_s
                    K_t_[0][j] = jnp.where(
                        both, kb0, jnp.where(f0, -q0 / a_s, 0.0))
                    K_t_[1][j] = jnp.where(
                        both, kb1, jnp.where(f1, -q1 / c_s, 0.0))
            else:
                # m > 2: masked projected-Newton boxQP in-register,
                # warm-started from the next timestep's k
                # (src/backward_pass.jl:49); feedback gains solved on the
                # final free subspace (src/backward_pass.jl:55-60)
                lo = [limt[mi][0] - u_t[mi] for mi in range(m)]
                hi = [limt[mi][1] - u_t[mi] for mi in range(m)]
                k_t_, free, Lq, ok = _boxqp_masked(QuuF, Qu, lo, hi, kw, m,
                                                   qp_iters)
                K_t_ = [[None] * n for _ in range(m)]
                for j in range(n):
                    col = _tiny_chol_solve(
                        Lq, [jnp.where(free[mi], -Qux_r[mi][j], 0.0)
                             for mi in range(m)], m)
                    for mi in range(m):
                        K_t_[mi][j] = jnp.where(free[mi], col[mi], 0.0)

            # sanitize diverged lanes so downstream consumers see zeros
            k_t_ = [jnp.where(ok, v, 0.0) for v in k_t_]
            K_t_ = [[jnp.where(ok, v, 0.0) for v in row] for row in K_t_]

            # ---- value update with unregularized terms
            #      (src/backward_pass.jl:63-72)
            Quu_k = [sum(Quu[mi][mj] * k_t_[mj] for mj in range(m))
                     for mi in range(m)]
            dv1 = dv1 + sum(k_t_[mi] * Qu[mi] for mi in range(m))
            dv2 = dv2 + 0.5 * sum(k_t_[mi] * Quu_k[mi] for mi in range(m))
            QuuK = [[sum(Quu[mi][mj] * K_t_[mj][j] for mj in range(m))
                     for j in range(n)] for mi in range(m)]
            Vx_n = [Qx[i]
                    + sum(K_t_[mi][i] * (Quu_k[mi] + Qu[mi])
                          for mi in range(m))
                    + sum(Qux[mi][i] * k_t_[mi] for mi in range(m))
                    for i in range(n)]
            Vxx_raw = [[Qxx[i][j]
                        + sum(K_t_[mi][i] * QuuK[mi][j] for mi in range(m))
                        + sum(K_t_[mi][i] * Qux[mi][j] for mi in range(m))
                        + sum(Qux[mi][i] * K_t_[mi][j] for mi in range(m))
                        for j in range(n)] for i in range(n)]
            Vxx_n = [[0.5 * (Vxx_raw[i][j] + Vxx_raw[j][i])
                      for j in range(n)] for i in range(n)]

            # ---- divergence latch (reference: diverge = first bad t,
            #      1-based; src/backward_pass.jl:36-38)
            bad = (~ok).astype(jnp.float32)
            newly = bad * (1.0 - was_div)
            tf = (t + 1).astype(jnp.float32)
            divt = divt * (1.0 - newly) + newly * tf
            div = jnp.maximum(was_div, bad)

            write(t, k_t_, K_t_, Vx_n, Vxx_n, Quu)
            return (Vx_n, Vxx_n, dv1, dv2, div, divt,
                    k_t_ if warm else [])

        _, _, dv1, dv2, div, divt, _ = time_loop(step, state0, T - 2, T - 1,
                                                 k_t)
        stat_ref[0] = dv1
        stat_ref[1] = dv2
        stat_ref[2] = div
        stat_ref[3] = divt

    return kernel


class BackwardLanesOut(NamedTuple):
    """Lane-layout backward-pass outputs (see ``pack.py``; ``out`` slots per
    :class:`OutLayout`)."""

    out: jax.Array      # (T, S, nB) + TILE
    stats: jax.Array    # (4, nB) + TILE: dV1, dV2, diverged, diverge_idx


def pack_backward_inputs(derivs: Derivs, u: jax.Array, B: int) -> jax.Array:
    """Batch-major ``Derivs`` + controls → packed input stream
    (T, D+m, nB) + TILE."""
    T = u.shape[1]
    parts = [derivs.fx, derivs.fu, derivs.cx, derivs.cu,
             derivs.cxx, derivs.cxu, derivs.cuu, u]
    flat = [p.astype(jnp.float32).reshape(B, T, -1) for p in parts]
    return to_lanes(jnp.concatenate(flat, axis=-1), B)


@functools.partial(
    jax.jit,
    static_argnames=("n", "m", "reg_type", "lims", "k_t", "derivs_tiles",
                     "qp_iters", "emit", "interpret"))
def backward_lanes(dp: jax.Array, lam: jax.Array,
                   *, n: int, m: int, reg_type: int = 1,
                   lims: Optional[Tuple[Tuple[float, float], ...]] = None,
                   k_t: int = 1,
                   derivs_tiles=None,
                   prev: Optional[jax.Array] = None,
                   eta: Optional[jax.Array] = None,
                   params: Optional[jax.Array] = None,
                   lims_lanes: Optional[jax.Array] = None,
                   qp_iters: int = 8,
                   emit: str = "full",
                   interpret: bool = False) -> BackwardLanesOut:
    """Run the backward kernel on a lane-layout input stream.

    Two input modes:
    - ``derivs_tiles=None``: ``dp`` is the packed derivative stream
      (T, D+m, nB) + TILE from :func:`pack_backward_inputs`.
    - ``derivs_tiles=fn``: ``dp`` is a trajectory stream with x in slots
      [0, n) and u in [n, n+m) (extra slots ignored); derivatives are
      computed in-register per step by ``fn(x_tiles, u_tiles, t) → dict``
      with keys fx/fu/cx/cu/cxx/cxu/cuu (lists of lane tiles; cxu is
      (n, m)). This cuts the input traffic ~9×.

    ``lam``: per-scenario λ (nB,) + TILE. ``lims``: static ((lo, hi),)*m or
    None; ``lims_lanes``: PER-SCENARIO limits as lane tiles
    (2m, nB) + TILE, slot order [lo_0, hi_0, ...] — overrides ``lims``
    (the reference takes lims as runtime data, ``src/iLQG.jl:124``).
    ``k_t``: static unroll of the in-kernel time loop. ``emit``:
    output-stream slot selection (see :class:`OutLayout`) — hot loops
    request only what they consume (``"gains"`` for the iLQG loop,
    ``"policy"`` for the GPS/KL loop).

    GPS mode (reference ``back_pass_gps``, ``src/backward_pass.jl:259-350``)
    activates when ``prev``/``eta`` are given: ``prev`` is the
    previous-policy stream (T, m + m·n + m², nB) + TILE holding
    [k_prev, K_prev, Σ⁻¹_prev] and ``eta`` the per-timestep per-scenario
    dual (T, 1, nB) + TILE; λ is then unused (``src/iLQGkl.jl:99``).

    Returns lane-layout outputs.
    """
    T, DU, nB = dp.shape[0], dp.shape[1], dp.shape[2]
    gps = prev is not None
    assert gps == (eta is not None)
    lay = InLayout(n, m)
    if derivs_tiles is None:
        assert DU == lay.DU, f"packed D={DU} != layout D={lay.DU}"
        in_slots = lay.DU
    else:
        assert DU >= n + m, f"traj stream needs >= n+m slots, got {DU}"
        in_slots = n + m
    assert T >= 2
    n_params = 0 if params is None else params.shape[0]
    dyn_lims = lims_lanes is not None
    S = OutLayout(n, m, emit).S
    kernel = _make_kernel(n, m, T, max(1, min(k_t, T)), reg_type, lims,
                          derivs_tiles, gps, n_params, qp_iters, emit,
                          dyn_lims)
    tile = dp.shape[3:]
    f32 = jnp.float32

    spec = functools.partial(lane_spec, width=tile[-1])
    in_specs = [spec((T, in_slots)), spec(())]
    inputs = [dp.astype(f32), lam.astype(f32)]
    if gps:
        # guard against 1/0 on zero-padded lanes (results sliced away)
        eta = jnp.where(eta == 0, 1.0, eta)
        in_specs += [spec((T, m + m * n + m * m)), spec((T, 1))]
        inputs += [prev.astype(f32), eta.astype(f32)]
    if n_params:
        in_specs.append(spec((n_params,)))
        inputs.append(params.astype(f32))
    if dyn_lims:
        assert lims_lanes.shape[0] == 2 * m, lims_lanes.shape
        in_specs.append(spec((2 * m,)))
        inputs.append(lims_lanes.astype(f32))

    o, stats = pl.pallas_call(
        kernel,
        grid=(nB,),
        in_specs=in_specs,
        out_shape=(
            jax.ShapeDtypeStruct((T, S, nB) + tile, f32),
            jax.ShapeDtypeStruct((4, nB) + tile, f32),
        ),
        out_specs=(spec((T, S)), spec((4,))),
        backend="triton",
        compiler_params=compiler_params(),
        interpret=interpret,
        name="backward_lanes",
    )(*inputs)
    return BackwardLanesOut(out=o, stats=stats)


def backward_pass_pallas(derivs: Derivs, u: jax.Array, lam: jax.Array,
                         reg_type: int = 1,
                         lims=None,
                         use_limits: bool = False,
                         k_t: int = 1,
                         eta=None,
                         traj_prev: Optional[GaussianPolicy] = None,
                         interpret: bool = False) -> BackwardOut:
    """Batch-major convenience wrapper (parity interface with
    ``ops.backward.backward_pass`` vmapped over B).

    ``derivs``: (B, T, ...) leaves; ``u``: (B, T, m); ``lam``: (B,).
    GPS mode: pass ``traj_prev`` (leaves (B, T, ...)) and ``eta`` of shape
    (B,) or (B, T). Packs to lane layout, runs the kernel, unpacks.
    """
    B, T, m = u.shape
    n = derivs.cx.shape[-1]
    if not use_limits:
        lims_t = None
    else:
        import numpy as np
        lims_np = np.asarray(lims, np.float32)
        lims_t = tuple((float(lo), float(hi)) for lo, hi in lims_np)

    prev_l = eta_l = None
    if traj_prev is not None:
        f32 = jnp.float32
        prev_l = to_lanes(jnp.concatenate(
            [traj_prev.k.astype(f32),
             traj_prev.K.astype(f32).reshape(B, T, -1),
             traj_prev.sigma_inv.astype(f32).reshape(B, T, -1)],
            axis=-1), B)
        eta = jnp.asarray(eta, f32)
        if eta.ndim == 1:
            eta = jnp.broadcast_to(eta[:, None], (B, T))
        eta_l = to_lanes(eta[:, :, None], B)

    dp = pack_backward_inputs(derivs, u, B)
    res = backward_lanes(dp, vec_to_lanes(lam.astype(jnp.float32)),
                         n=n, m=m, reg_type=reg_type, lims=lims_t,
                         k_t=k_t, prev=prev_l, eta=eta_l,
                         interpret=interpret)
    lay = OutLayout(n, m)
    o = res.out

    def take(off, size, shape):
        return from_lanes(o[:, off:off + size], B, shape)

    policy = GaussianPolicy(
        K=take(lay.K, m * n, (m, n)),
        k=take(lay.k, m, (m,)),
        sigma=take(lay.quui, m * m, (m, m)),
        sigma_inv=take(lay.quu, m * m, (m, m)),
    )
    stats = res.stats.reshape(4, -1)[:, :B]
    dV = jnp.transpose(stats[:2])                         # (B, 2)
    return BackwardOut(
        diverged=stats[2] > 0.5,
        diverge_idx=stats[3].astype(jnp.int32),
        policy=policy,
        Vx=take(lay.Vx, n, (n,)),
        Vxx=take(lay.Vxx, n * n, (n, n)),
        dV=dV,
    )
