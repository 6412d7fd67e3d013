"""Box-constrained QP via projected Newton — a jittable re-design.

Minimize ``0.5*x'Hx + x'g`` s.t. ``lower <= x <= upper``.

Reference: ``src/boxQP.jl:29-188`` (clamped-set detection ``:88-95``,
refactorize-on-clamp-change ``:103-117``, Newton step on free dims
``:126-129``, Armijo backtracking ``:137-151``, result codes ``:172-179``).

Design differences (accelerator-first, not a port):

- **No dynamic shapes / index sets.** The active set is a boolean mask; the
  free-subspace Cholesky is the factorization of the *masked-identity-padded*
  matrix ``H_masked = free⊗free * H + diag(clamped)``, which has fixed shape
  ``(m, m)`` and the same free-block factor.
- **No exceptions.** Non-PD is detected as NaN in the Cholesky factor
  (result ``-1``); the reference throws and the caller catches
  (``src/backward_pass.jl:48-52``).
- **Branchless early exits.** All reference ``break``s become a ``done`` flag
  in a ``lax.while_loop`` carry, so the solver jits, vmaps (batched over
  thousands of per-timestep QPs), and runs inside ``lax.scan``.

Deviation from the reference (documented): the reference's
``iter == maxIter → result=1`` check has an off-by-one (a loop that exhausts
``maxIter`` full passes leaves ``iter == maxIter+1`` and returns 0); we return
1 ("maximum iterations exceeded", a success code) on exhaustion, which is the
clear intent.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_solve
from .precision import highest_precision


class BoxQPResult(NamedTuple):
    """Outputs of :func:`boxqp` (reference return tuple ``src/boxQP.jl:187``).

    - ``x``: solution ``(m,)``
    - ``result``: int32 code, reference semantics (``src/boxQP.jl:172-179``):
      -1 non-PD Hessian, 0 no descent, 1 max iterations, 2 max line-search,
      4 improvement < tol, 5 gradient < tol, 6 all clamped. ``result >= 1``
      is success.
    - ``chol``: lower Cholesky factor of the masked free-subspace Hessian
      ``(m, m)`` (identity rows/cols on clamped dims)
    - ``free``: boolean free-dimension mask ``(m,)``
    - ``iters``: iterations executed
    - ``value``: final objective value
    - ``gnorm``: final free-gradient norm
    - ``nfactor``: number of Cholesky factorizations (reference trace field)
    """

    x: jax.Array
    result: jax.Array
    chol: jax.Array
    free: jax.Array
    iters: jax.Array
    value: jax.Array
    gnorm: jax.Array
    nfactor: jax.Array


class QPTrace(NamedTuple):
    """Fixed-shape per-iteration record of :func:`boxqp_traced` — the
    reference's ``QPTrace`` struct (``src/boxQP.jl:1-8``) as arrays of
    static length ``max_iter`` (entries past ``iters`` are zero padding)."""

    value: jax.Array       # (max_iter,) objective value
    gnorm: jax.Array       # (max_iter,) free-gradient norm
    n_clamped: jax.Array   # (max_iter,) active-set size
    factorized: jax.Array  # (max_iter,) bool: refactorized this iteration


class _QPState(NamedTuple):
    x: jax.Array
    value: jax.Array
    oldvalue: jax.Array
    clamped: jax.Array
    chol: jax.Array
    result: jax.Array
    done: jax.Array
    it: jax.Array
    gnorm: jax.Array
    nfactor: jax.Array
    ls_steps: jax.Array   # backtracking exponent of the LAST line search


def _masked_cholesky(H, free):
    """Cholesky factor of ``free⊗free * H + diag(~free)`` — fixed-shape
    equivalent of ``cholesky(H[free, free])`` (``src/boxQP.jl:111``)."""
    mask = jnp.outer(free, free)
    Hm = jnp.where(mask, H, 0.0) + jnp.diag(jnp.where(free, 0.0, 1.0))
    return jnp.linalg.cholesky(Hm)


@highest_precision
@functools.partial(jax.jit,
                   static_argnames=("max_iter", "min_grad",
                                    "min_rel_improve", "step_dec", "min_step",
                                    "armijo", "max_ls", "record_trace",
                                    "verbose"))
def boxqp(H, g, lower, upper, x0,
          max_iter: int = 100,
          min_grad: Optional[float] = None,
          min_rel_improve: Optional[float] = None,
          step_dec: float = 0.6,
          min_step: Optional[float] = None,
          armijo: float = 0.1,
          max_ls: int = 100,
          record_trace: bool = False,
          verbose: int = 0):
    """Solve one box QP. Batch by ``jax.vmap``; defaults match the reference
    (``src/boxQP.jl:29-43``): ``min_grad=1e-8``, ``min_rel_improve=1e-8``,
    ``min_step=1e-22`` — except on f32 inputs, where leaving them at ``None``
    selects f32-safe floors (1e-6 / 1e-6 / 1e-20): below f32 resolution the
    reference's "no descent direction" check (``src/boxQP.jl:133``) fires at
    the optimum (sdotg rounds to 0 before gnorm reaches 1e-8) and reads as a
    spurious hard failure no λ escalation can fix. Explicitly-passed
    tolerances are honored verbatim on any dtype. With ``record_trace=True``
    returns ``(BoxQPResult, QPTrace)`` — the reference's per-iteration trace
    (``src/boxQP.jl:1-8,75``)."""
    H = jnp.asarray(H)
    dtype = H.dtype
    g = jnp.asarray(g, dtype)
    lower = jnp.asarray(lower, dtype)
    upper = jnp.asarray(upper, dtype)
    m = g.shape[0]

    f32 = dtype == jnp.float32
    if min_grad is None:
        min_grad = 1e-6 if f32 else 1e-8
    if min_rel_improve is None:
        min_rel_improve = 1e-6 if f32 else 1e-8
    if min_step is None:
        min_step = 1e-20 if f32 else 1e-22

    def qval(x):
        return jnp.dot(x, g) + 0.5 * jnp.dot(x, H @ x)

    x = jnp.clip(jnp.asarray(x0, dtype), lower, upper)
    value0 = qval(x)

    if verbose > 0:
        # reference `print` kwarg behavior (src/boxQP.jl:65-66)
        from ..utils import printing as _pr
        _pr.boxqp_begin(m, value0)

    init = _QPState(
        x=x, value=value0, oldvalue=jnp.zeros((), dtype),
        clamped=jnp.zeros((m,), bool),
        chol=jnp.eye(m, dtype=dtype),
        result=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool),
        it=jnp.ones((), jnp.int32),
        gnorm=jnp.zeros((), dtype), nfactor=jnp.zeros((), jnp.int32),
        ls_steps=jnp.zeros((), jnp.int32),
    )

    def cond(c):
        s, _tr = c
        return (~s.done) & (s.it <= max_iter)

    def body(c):
        s, tr = c
        s_new = _step(s)
        if verbose > 1:
            # per-iteration line (src/boxQP.jl:153-156), incl. the
            # backtracking exponent (``linesearch stepDec^nstep``)
            from ..utils import printing as _pr
            _pr.boxqp_row(s.it, s_new.value, s_new.gnorm,
                          s_new.oldvalue - s_new.value,
                          step_dec, s_new.ls_steps,
                          jnp.sum(s_new.clamped, dtype=jnp.int32))
        if record_trace:
            idx = jnp.minimum(s.it - 1, max_iter - 1)
            tr = QPTrace(
                value=tr.value.at[idx].set(s_new.value),
                gnorm=tr.gnorm.at[idx].set(s_new.gnorm),
                n_clamped=tr.n_clamped.at[idx].set(jnp.sum(
                    s_new.clamped, dtype=jnp.int32).astype(jnp.int32)),
                factorized=tr.factorized.at[idx].set(
                    s_new.nfactor > s.nfactor))
        return (s_new, tr)

    def _step(s: _QPState) -> _QPState:
        # --- relative-improvement exit (src/boxQP.jl:78-81)
        stop4 = (s.it > 1) & ((s.oldvalue - s.value)
                              < min_rel_improve * jnp.abs(s.oldvalue))
        oldvalue = s.value

        # --- gradient & clamped set (src/boxQP.jl:85-95)
        grad = g + H @ s.x
        clamped = ((s.x == lower) & (grad > 0)) | ((s.x == upper) & (grad < 0))
        free = ~clamped
        all_clamped = jnp.all(clamped)

        # --- factorize only when the clamp set changed (src/boxQP.jl:103-117)
        changed = (s.it == 1) | jnp.any(clamped != s.clamped)
        chol = lax.cond(changed, lambda: _masked_cholesky(H, free),
                        lambda: s.chol)
        nfactor = s.nfactor + changed.astype(jnp.int32)
        notpd = jnp.any(jnp.isnan(chol))

        # --- free-gradient norm exit (src/boxQP.jl:120-124)
        gnorm = jnp.linalg.norm(grad * free)
        small_grad = gnorm < min_grad

        # --- Newton direction on free dims (src/boxQP.jl:126-129)
        grad_clamped = g + H @ (s.x * clamped)
        newton = cho_solve((chol, True), grad_clamped * free)
        search = (-newton - s.x) * free
        sdotg = jnp.sum(search * grad)
        no_descent = sdotg >= 0   # src/boxQP.jl:133 (result stays 0)

        # --- Armijo backtracking with clamping (src/boxQP.jl:137-151)
        def ls_cond(ls):
            step, xc, vc, fail, k = ls
            insufficient = (vc - oldvalue) / (step * sdotg) < armijo
            return insufficient & (~fail) & (k < max_ls)

        def ls_body(ls):
            step, xc, vc, fail, k = ls
            step = step * step_dec
            xc = jnp.clip(s.x + step * search, lower, upper)
            vc = qval(xc)
            fail = step < min_step
            return (step, xc, vc, fail, k + 1)

        xc0 = jnp.clip(s.x + search, lower, upper)
        step, xc, vc, ls_fail, nstep = lax.while_loop(
            ls_cond, ls_body,
            (jnp.ones((), dtype), xc0, qval(xc0), jnp.zeros((), bool),
             jnp.zeros((), jnp.int32)))

        # --- resolve exits in reference order
        exit_now = stop4 | all_clamped | notpd | small_grad | no_descent | ls_fail
        result = jnp.where(
            stop4, 4,
            jnp.where(all_clamped, 6,
                      jnp.where(notpd, -1,
                                jnp.where(small_grad, 5,
                                          jnp.where(no_descent, 0,
                                                    jnp.where(ls_fail, 2, 0))))))
        accept = ~(stop4 | all_clamped | notpd | small_grad | no_descent)

        return _QPState(
            x=jnp.where(accept, xc, s.x),
            value=jnp.where(accept, vc, s.value),
            oldvalue=oldvalue,
            clamped=jnp.where(stop4, s.clamped, clamped),
            chol=jnp.where(stop4, s.chol, chol),
            result=result.astype(jnp.int32),
            done=exit_now,
            it=s.it + accept.astype(jnp.int32),
            gnorm=jnp.where(stop4, s.gnorm, gnorm),
            nfactor=nfactor,
            ls_steps=nstep,
        )

    if record_trace:
        trace0 = QPTrace(value=jnp.zeros((max_iter,), dtype),
                         gnorm=jnp.zeros((max_iter,), dtype),
                         n_clamped=jnp.zeros((max_iter,), jnp.int32),
                         factorized=jnp.zeros((max_iter,), bool))
    else:
        trace0 = None
    s, trace = lax.while_loop(cond, body, (init, trace0))
    # exhausted max_iter without another exit → result 1
    result = jnp.where((~s.done) & (s.result == 0), 1, s.result)
    res = BoxQPResult(x=s.x, result=result.astype(jnp.int32), chol=s.chol,
                      free=~s.clamped, iters=s.it, value=s.value,
                      gnorm=s.gnorm, nfactor=s.nfactor)
    if verbose > 0:
        # final RESULT line with the reference's result strings
        # (src/boxQP.jl:172-184)
        from ..utils import printing as _pr
        _pr.boxqp_result(res.result, res.iters, res.gnorm, res.value,
                         res.nfactor)
    return (res, trace) if record_trace else res


def boxqp_1d(H, g, lower, upper) -> BoxQPResult:
    """Closed-form scalar box QP (m=1): the per-timestep QPs of the
    control-limited pendulum-cart benchmark (``src/system_pendcart.jl:197``)
    have m=1, where projected Newton reduces to one clamped division.
    This keeps the backward-scan hot path free of inner loops."""
    h = H[0, 0]
    dtype = H.dtype
    xn = -g[0] / h
    x = jnp.clip(xn, lower[0], upper[0])
    grad = g[0] + h * x
    clamped = ((x == lower[0]) & (grad > 0)) | ((x == upper[0]) & (grad < 0))
    free = ~clamped
    pd = h > 0
    chol_val = jnp.sqrt(jnp.where(pd, jnp.where(free, h, 1.0), jnp.nan))
    value = x * g[0] + 0.5 * x * h * x
    return BoxQPResult(
        x=x[None], result=jnp.where(pd, 5, -1).astype(jnp.int32),
        chol=chol_val[None, None], free=free[None],
        iters=jnp.ones((), jnp.int32), value=value,
        gnorm=jnp.abs(grad * free).astype(dtype),
        nfactor=jnp.ones((), jnp.int32))


def demo_qp(n: int = 500, seed: int = 0, dtype=jnp.float64, **kwargs):
    """Random PD box QP demo (reference ``demoQP``, ``src/boxQP.jl:190-199``)."""
    kx, kg, kh = jax.random.split(jax.random.PRNGKey(seed), 3)
    g = jax.random.normal(kg, (n,), dtype)
    A = jax.random.normal(kh, (n, n), dtype)
    H = A @ A.T
    lower = -jnp.ones((n,), dtype)
    upper = jnp.ones((n,), dtype)
    x0 = jax.random.normal(kx, (n,), dtype)
    return boxqp(H, g, lower, upper, x0, **kwargs)
