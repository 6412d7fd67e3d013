"""Pallas kernels (Triton route) for the batched forward rollout and the
multi-α line search.

Reference: ``forward_pass`` (``src/forward_pass.jl:9-33``) and the serial
backtracking line search (``src/iLQG.jl:266-281``). Design:

- scenario batch on the lanes (see ``pack.py``); the grid is the batch axis
  only, and each program runs the time loop over its tile column in a
  ``lax.fori_loop`` with the rollout state in registers (loop carries);
- ALL line-search α candidates are rolled out inside the kernel against the
  same per-step loads — trying 6 α's costs 6× (tiny) compute but 1× memory
  traffic;
- :func:`linesearch_lanes` fuses the line search into one launch: a first
  in-kernel loop gives the per-α totals, the accept decision is taken in
  registers between the loops, and a second loop re-rolls the accepted α and
  writes the trajectory.

The dynamics/cost are supplied as **lane functions** operating on lists of
lane tiles (one tile per state/control dimension) — see :class:`LanesModel`;
models provide hand-written instances (``models/pendcart.py``,
``models/linear.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from .pack import compiler_params, lane_spec, time_loop


@dataclasses.dataclass(frozen=True)
class LanesModel:
    """Batched-on-lanes problem functions for the Pallas kernels.

    - ``dynamics(x, u, t) -> x_next``: x list[n], u list[m] of lane tiles
      (elementwise over scenarios); ``t`` is a traced int32 timestep.
    - ``cost(x, u, t) -> tile``: running cost.
    - ``terminal(x) -> tile`` or None: extra terminal cost evaluated at the
      last state of the trajectory (the reference appends a zero-control
      evaluation, ``src/system_pendcart.jl:97-106``).
    - ``n``, ``m``: state/control dims.
    - ``n_params``: per-scenario dynamics/cost parameter count. When > 0,
      all three functions take a trailing ``params`` argument (list of
      ``n_params`` lane tiles, constant over the horizon) — heterogeneous
      fleets (varying masses, lengths, targets, ...) in one compile.
    - ``diff``: optional custom state difference ``diff(x, x_old) ->
      list[n]`` of tiles, used by the feedback term of the control law
      (reference ``diff_fun``, ``src/iLQG.jl:131``,
      ``src/forward_pass.jl:19`` — e.g. angle wrapping on attitude states).
      Default: elementwise subtraction. The lane-tier counterpart of
      ``Problem.diff`` on the XLA tier.
    """

    n: int
    m: int
    dynamics: Callable
    cost: Callable
    terminal: Optional[Callable] = None
    n_params: int = 0
    diff: Optional[Callable] = None


class ForwardLanesOut(NamedTuple):
    totals: jax.Array           # (A, nB) + TILE total cost per α candidate
    traj: Optional[jax.Array]   # (T, n+m+1, nB) + TILE: x, u, c — or None
    terminal: jax.Array         # (A, nB) + TILE terminal-cost component
    echo: Optional[jax.Array] = None  # (T, n+m, ...) input x/u slots echoed
    #                                   (emit_echo — see forward_lanes)


class _Rollout:
    """The per-program rollout arithmetic shared by both kernels: the
    model's functions bound to this program's parameter tiles, its control
    limits, and readers of the step-t nominal trajectory and gains."""

    def __init__(self, model: LanesModel, lims, gk: int, gK: int,
                 traj_ref, gains_ref, params_ref, lims_ref):
        n, m = model.n, model.m
        self.model, self.n, self.m = model, n, m
        self.gk, self.gK = gk, gK
        self.traj_ref, self.gains_ref = traj_ref, gains_ref
        par = ([params_ref[p] for p in range(model.n_params)]
               if model.n_params else None)
        if par is not None:
            self.dyn = lambda x, u, t: model.dynamics(x, u, t, par)
            self.cost = lambda x, u, t: model.cost(x, u, t, par)
            self.term = (None if model.terminal is None
                         else (lambda x: model.terminal(x, par)))
        else:
            self.dyn, self.cost, self.term = (model.dynamics, model.cost,
                                              model.terminal)
        # control limits: static floats, or per-scenario lane tiles read
        # from the lims input (slot order [lo_0, hi_0, lo_1, hi_1, ...]) —
        # heterogeneous actuator bounds stay on the fast path
        # (reference lims are runtime data, src/iLQG.jl:124,
        # src/forward_pass.jl:22-24)
        if lims_ref is not None:
            self.lo = [lims_ref[2 * mi] for mi in range(m)]
            self.hi = [lims_ref[2 * mi + 1] for mi in range(m)]
        elif lims is not None:
            self.lo = [lims[mi][0] for mi in range(m)]
            self.hi = [lims[mi][1] for mi in range(m)]
        else:
            self.lo = self.hi = None

    def read(self, t):
        """Nominal x/u and gains k/K at step t."""
        n, m = self.n, self.m
        x_old = [self.traj_ref[t, i] for i in range(n)]
        u_nom = [self.traj_ref[t, n + mi] for mi in range(m)]
        k = [self.gains_ref[t, self.gk + mi] for mi in range(m)]
        K = [[self.gains_ref[t, self.gK + mi * n + j] for j in range(n)]
             for mi in range(m)]
        return x_old, u_nom, k, K

    def control(self, x, alpha, x_old, u_nom, k, K):
        """u = u_nom + α k + K diff(x, x_old), clamped
        (src/forward_pass.jl:17-24; diff_fun src/iLQG.jl:131)."""
        if self.model.diff is not None:
            dx = self.model.diff(x, x_old)
        else:
            dx = [x[j] - x_old[j] for j in range(self.n)]
        u = []
        for mi in range(self.m):
            v = u_nom[mi] + alpha * k[mi]
            for j in range(self.n):
                v = v + K[mi][j] * dx[j]
            if self.lo is not None:
                v = jnp.clip(v, self.lo[mi], self.hi[mi])
            u.append(v)
        return u

    def rollout(self, x0, alphas, T: int, k_t: int, emit=None):
        """Roll every α in ``alphas`` from ``x0`` over the horizon. ``emit``
        (or None): ``emit(t, x, u, c, x_old, u_nom)`` writes candidate 0's
        step. Returns per-α (running cost sum, terminal cost)."""
        A = len(alphas)

        def step(t, st, last=False):
            xs, cs = st
            x_old, u_nom, k, K = self.read(t)
            xs_n, cs_n = [], []
            for a in range(A):
                u = self.control(xs[a], alphas[a], x_old, u_nom, k, K)
                c = self.cost(xs[a], u, t)
                if emit is not None and a == 0:
                    emit(t, xs[a], u, c, x_old, u_nom)
                cs_n.append(cs[a] + c)
                # the last state needs no successor: the terminal cost is
                # evaluated at x[T-1] (src/system_pendcart.jl:97-106)
                xs_n.append(xs[a] if last else list(self.dyn(xs[a], u, t)))
            return xs_n, cs_n

        zero = jnp.zeros_like(x0[0])
        st = ([list(x0) for _ in range(A)], [zero] * A)
        st = time_loop(step, st, 0, T - 1, k_t, direction=1)
        xs, cs = step(jnp.int32(T - 1), st, last=True)
        terms = [zero if self.term is None else self.term(xs[a])
                 for a in range(A)]
        return cs, terms


def _optional_refs(refs, flags):
    """Pop one ref per True flag from the front of ``refs`` (None for
    False)."""
    return [refs.pop(0) if f else None for f in flags]


@functools.partial(
    jax.jit,
    static_argnames=("model", "lims", "gk", "gK", "g_slots", "emit_traj",
                     "emit_echo", "k_t", "interpret"))
def forward_lanes(traj: jax.Array, gains: jax.Array, x0: jax.Array,
                  alphas: jax.Array,
                  params: Optional[jax.Array] = None,
                  lims_lanes: Optional[jax.Array] = None,
                  *, model: LanesModel,
                  lims: Optional[Tuple[Tuple[float, float], ...]] = None,
                  gk: int = 0, gK: Optional[int] = None,
                  g_slots: Optional[int] = None,
                  emit_traj: bool = False,
                  emit_echo: bool = False,
                  k_t: int = 1,
                  interpret: bool = False) -> ForwardLanesOut:
    """Run the forward kernel on lane-layout inputs.

    - ``traj``: (T, n+m, nB) + TILE — slots [x_old(n), u_nom(m)].
    - ``gains``: (T, Sg, nB) + TILE — any packed stream holding k at slot
      ``gk`` and K (row-major (m, n)) at slot ``gK`` (defaults consume a
      compact [k, K] stream; pass the backward kernel's ``out`` directly with
      its :class:`~.backward_kernel.OutLayout` offsets).
    - ``x0``: (n, nB) + TILE; ``alphas``: (A, nB) + TILE.
    - ``g_slots``: read only the first ``g_slots`` slots of ``gains`` (must
      cover gk/gK+m·n). Default: all slots.
    - ``emit_traj``: write the candidate-0 trajectory stream
      (T, n+m+1, nB) + TILE — use with A==1 and per-scenario α for the
      accepted-step re-roll.
    - ``lims_lanes``: optional PER-SCENARIO control limits as lane tiles
      (2m, nB) + TILE, slot order [lo_0, hi_0, ...] — overrides the static
      ``lims``; heterogeneous actuator bounds in one compile (the reference
      takes lims as runtime data, ``src/iLQG.jl:124``).
    - ``emit_echo`` (with ``emit_traj``): additionally write the INPUT
      trajectory's x/u slots to a second output — the entry-trajectory
      record the batch driver's backward replay needs, produced as a fresh
      kernel output instead of a carry-position rotation copy.
    - ``k_t``: static unroll of the in-kernel time loop.
    """
    n, m = model.n, model.m
    T, nB = traj.shape[0], traj.shape[2]
    A = alphas.shape[0]
    dyn_lims = lims_lanes is not None
    emit_echo = emit_echo and emit_traj
    if gK is None:
        gK = m
    if g_slots is None:
        g_slots = gains.shape[1]
    assert g_slots >= gK + m * n and g_slots >= gk + m
    assert T >= 1
    k_t = max(1, min(k_t, T))
    tile = traj.shape[3:]
    f32 = jnp.float32
    spec = functools.partial(lane_spec, width=tile[-1])

    def kernel(*refs):
        refs = list(refs)
        traj_ref, gains_ref, x0_ref, alpha_ref = refs[:4]
        rest = refs[4:]
        params_ref, lims_ref = _optional_refs(rest,
                                              (model.n_params, dyn_lims))
        totals_ref, term_ref = rest[:2]
        out_ref, echo_ref = _optional_refs(rest[2:], (emit_traj, emit_echo))
        ro = _Rollout(model, lims, gk, gK, traj_ref, gains_ref, params_ref,
                      lims_ref)

        def emit(t, x, u, c, x_old, u_nom):
            for i in range(n):
                out_ref[t, i] = x[i]
            for mi in range(m):
                out_ref[t, n + mi] = u[mi]
            out_ref[t, n + m] = c
            if echo_ref is not None:
                # echo the INPUT x/u slots — the entry trajectory the
                # driver's post-loop backward replay linearizes around
                for i in range(n):
                    echo_ref[t, i] = x_old[i]
                for mi in range(m):
                    echo_ref[t, n + mi] = u_nom[mi]

        cs, terms = ro.rollout([x0_ref[i] for i in range(n)],
                               [alpha_ref[a] for a in range(A)], T, k_t,
                               emit if emit_traj else None)
        for a in range(A):
            totals_ref[a] = cs[a] + terms[a]
            term_ref[a] = terms[a]

    out_shape = [jax.ShapeDtypeStruct((A, nB) + tile, f32),
                 jax.ShapeDtypeStruct((A, nB) + tile, f32)]
    out_specs = [spec((A,)), spec((A,))]
    if emit_traj:
        out_shape.append(jax.ShapeDtypeStruct((T, n + m + 1, nB) + tile, f32))
        out_specs.append(spec((T, n + m + 1)))
    if emit_echo:
        out_shape.append(jax.ShapeDtypeStruct((T, n + m, nB) + tile, f32))
        out_specs.append(spec((T, n + m)))

    in_specs = [spec((T, n + m)), spec((T, g_slots)), spec((n,)),
                spec((A,))]
    inputs = [traj, gains, x0, alphas]
    if model.n_params:
        assert params is not None and params.shape[0] == model.n_params
        in_specs.append(spec((model.n_params,)))
        inputs.append(params)
    if dyn_lims:
        assert lims_lanes.shape[0] == 2 * m, lims_lanes.shape
        in_specs.append(spec((2 * m,)))
        inputs.append(lims_lanes)

    # NOTE: no input/output aliasing here even when shapes allow it — the
    # one emit_traj call site with a cost-slot input is the KL driver,
    # whose input is the trust-region CENTER, deliberately kept live
    # across iterations (src/iLQGkl.jl:137-140); donating it would force
    # XLA to insert a protective full-stream copy per iteration. The iLQG
    # drivers' in-place update lives in linesearch_lanes.
    res = pl.pallas_call(
        kernel,
        grid=(nB,),
        in_specs=in_specs,
        out_shape=tuple(out_shape),
        out_specs=tuple(out_specs),
        backend="triton",
        compiler_params=compiler_params(),
        interpret=interpret,
        name="forward_lanes",
    )(*[x.astype(f32) for x in inputs])

    totals, term = res[:2]
    return ForwardLanesOut(totals=totals, terminal=term,
                           traj=res[2] if emit_traj else None,
                           echo=res[3] if emit_echo else None)


class LineSearchLanesOut(NamedTuple):
    traj: jax.Array             # (T, n+m+1, nB) + TILE accepted-α rollout
    echo: Optional[jax.Array]   # (T, n+m, ...) input x/u slots (entry traj)
    ls: jax.Array               # (5, nB) + TILE: al_sel, any_ok,
    #                             dcost_sel, ratio_sel, total_new


def _accept(alphas, totals, dv1, dv2, ctot, rr_min):
    """The line-search accept decision over the descending α ladder
    (src/iLQG.jl:269-280): the first α whose reduce ratio beats
    ``rr_min``. Returns (al_sel, found, dcost_sel, ratio_sel)."""
    al_sel = dc_sel = rt_sel = found = None
    for a_i, a in enumerate(alphas):
        dcost = ctot - totals[a_i]
        expected = (-a) * (dv1 + a * dv2)
        ratio = jnp.where(expected > 0, dcost / expected, jnp.sign(dcost))
        ok = ratio > rr_min
        if a_i == 0:
            dc_sel, rt_sel, found = dcost, ratio, ok
            al_sel = jnp.where(ok, a, 0.0)
        else:
            take = ok & (~found)
            al_sel = jnp.where(take, a, al_sel)
            dc_sel = jnp.where(take, dcost, dc_sel)
            rt_sel = jnp.where(take, ratio, rt_sel)
            found = found | ok
    return al_sel, found, dc_sel, rt_sel


@functools.partial(
    jax.jit,
    static_argnames=("model", "alphas", "reduce_ratio_min", "lims", "gk",
                     "gK", "g_slots", "emit_echo", "in_place", "k_t",
                     "interpret"))
def linesearch_lanes(traj: jax.Array, gains: jax.Array, x0: jax.Array,
                     sel: jax.Array,
                     params: Optional[jax.Array] = None,
                     lims_lanes: Optional[jax.Array] = None,
                     *, model: LanesModel,
                     alphas: Tuple[float, ...],
                     reduce_ratio_min: float = 0.0,
                     lims: Optional[Tuple[Tuple[float, float], ...]] = None,
                     gk: int = 0, gK: Optional[int] = None,
                     g_slots: Optional[int] = None,
                     emit_echo: bool = True,
                     in_place: bool = False,
                     k_t: int = 1,
                     interpret: bool = False) -> LineSearchLanesOut:
    """Fused line search: per-α totals + accept decision + accepted-α
    trajectory emission in one kernel launch (module docstring). Arguments
    as :func:`forward_lanes`, except:

    - ``alphas``: STATIC descending α ladder (folded into the kernel);
    - ``sel``: (4, nB) + TILE lane tiles [dV1, dV2, cost_old_total,
      allow] — ``allow`` (1.0/0.0) masks lanes permitted to accept
      (active ∧ backward OK ∧ not gradient-converged);
    - ``reduce_ratio_min``: STATIC accept threshold
      (``src/iLQG.jl:269-280``);
    - ``in_place``: alias the trajectory input with the trajectory output
      (zero-copy carry update). Requires a cost-slot input
      ((T, n+m+1, ...)) and that the CALLER never reads the input
      trajectory after this call — XLA inserts a protective full-stream
      copy otherwise.

    Returns the accepted-α rollout (α=0 retrace on non-accepted lanes),
    the input-echo stream, and the (5,)-slot per-lane line-search record
    [al_sel, any_ok, dcost_sel, ratio_sel, total_new].
    """
    n, m = model.n, model.m
    T, nB = traj.shape[0], traj.shape[2]
    dyn_lims = lims_lanes is not None
    if gK is None:
        gK = m
    if g_slots is None:
        g_slots = gains.shape[1]
    assert g_slots >= gK + m * n and g_slots >= gk + m
    alphas = tuple(float(a) for a in alphas)
    rr_min = float(reduce_ratio_min)
    k_t = max(1, min(k_t, T))
    tile = traj.shape[3:]
    f32 = jnp.float32
    spec = functools.partial(lane_spec, width=tile[-1])

    def kernel(*refs):
        refs = list(refs)
        traj_ref, gains_ref, x0_ref, sel_ref = refs[:4]
        rest = refs[4:]
        params_ref, lims_ref = _optional_refs(rest,
                                              (model.n_params, dyn_lims))
        out_ref, echo_ref = _optional_refs(rest, (True, emit_echo))
        (ls_ref,) = rest
        ro = _Rollout(model, lims, gk, gK, traj_ref, gains_ref, params_ref,
                      lims_ref)
        x0 = [x0_ref[i] for i in range(n)]

        # pass 1: per-α totals; nothing is written
        cs, terms = ro.rollout(x0, alphas, T, k_t)
        totals = [cs[a] + terms[a] for a in range(len(alphas))]

        # the accept decision, in registers between the two loops
        al_sel, found, dc_sel, rt_sel = _accept(
            alphas, totals, sel_ref[0], sel_ref[1], sel_ref[2], rr_min)
        al_eff = jnp.where(found & (sel_ref[3] > 0.5), al_sel, 0.0)

        # pass 2: re-roll the accepted α and write the trajectory. With the
        # trajectory aliased in place this is hazard-free: each program owns
        # a disjoint set of scenario columns, pass 1 only reads, and within
        # pass 2 step t reads its nominal x/u before writing step t, while
        # later steps read only positions not yet written.
        def emit(t, x, u, c, x_old, u_nom):
            for i in range(n):
                out_ref[t, i] = x[i]
            for mi in range(m):
                out_ref[t, n + mi] = u[mi]
            out_ref[t, n + m] = c
            if echo_ref is not None:
                for i in range(n):
                    echo_ref[t, i] = x_old[i]
                for mi in range(m):
                    echo_ref[t, n + mi] = u_nom[mi]

        cs2, terms2 = ro.rollout(x0, [al_eff], T, k_t, emit)
        ls_ref[0] = al_sel
        ls_ref[1] = jnp.where(found, 1.0, 0.0)
        ls_ref[2] = dc_sel
        ls_ref[3] = rt_sel
        ls_ref[4] = cs2[0] + terms2[0]

    in_specs = [spec((T, n + m)), spec((T, g_slots)), spec((n,)), spec((4,))]
    inputs = [traj, gains, x0, sel]
    if model.n_params:
        assert params is not None and params.shape[0] == model.n_params
        in_specs.append(spec((model.n_params,)))
        inputs.append(params)
    if dyn_lims:
        assert lims_lanes.shape[0] == 2 * m, lims_lanes.shape
        in_specs.append(spec((2 * m,)))
        inputs.append(lims_lanes)

    out_shape = [jax.ShapeDtypeStruct((T, n + m + 1, nB) + tile, f32)]
    out_specs = [spec((T, n + m + 1))]
    if emit_echo:
        out_shape.append(jax.ShapeDtypeStruct((T, n + m, nB) + tile, f32))
        out_specs.append(spec((T, n + m)))
    out_shape.append(jax.ShapeDtypeStruct((5, nB) + tile, f32))
    out_specs.append(spec((5,)))

    # In-place trajectory update: when the input stream carries the cost
    # slot (the drivers' loop state, (T, n+m+1, ...)), alias it with the
    # trajectory output so the kernel rewrites the carry buffer instead of
    # XLA copying a fresh output into the fixed carry position. Callers
    # must NOT use the input trajectory after the call (XLA would insert a
    # protective copy) — the drivers' rollout-entry loop body qualifies;
    # the pre-rolled path (which keeps c.traj live for the reject-select)
    # does not.
    alias = {0: 0} if in_place and traj.shape[1] == n + m + 1 else {}
    res = pl.pallas_call(
        kernel,
        grid=(nB,),
        in_specs=in_specs,
        out_shape=tuple(out_shape),
        out_specs=tuple(out_specs),
        input_output_aliases=alias,
        backend="triton",
        compiler_params=compiler_params(),
        interpret=interpret,
        name="linesearch_lanes",
    )(*[x.astype(f32) for x in inputs])

    if emit_echo:
        out, echo, ls = res
        return LineSearchLanesOut(traj=out, echo=echo, ls=ls)
    out, ls = res
    return LineSearchLanesOut(traj=out, echo=None, ls=ls)
