"""Lane layout for the Pallas hot-path kernels.

The scenario-batch axis is the parallel axis of this framework (SURVEY.md
§2: the reference is strictly sequential; we scale the batch), so the
kernels put **batch on the lanes**: every per-timestep scalar slot (one
entry of ``fx``, ``Vxx``, …) of ``W`` scenarios is one lane tile, a single
row of ``W`` values. A kernel program owns one tile column and runs the
whole time recursion over it; all small-matrix algebra unrolls over the tiny
state/control dims as elementwise operations on tiles.

Canonical lane layout of an array with per-scenario shape ``(T, s)``:

    (T, s, nB) + TILE   with TILE = (1, W), B = nB * W  (padded up)

Small matrices are flattened row-major into the slot axis ``s``. The packed
derivative stack concatenates all slots (layout computed by
:class:`DerivLayout`).

This module owns the layout decision: the tile width ``W`` and the Triton
launch shape of the kernels that walk it (:func:`compiler_params`).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ...policy import Derivs

# Scenarios per tile: Triton tensors are powers of two. One program per tile
# runs the sequential time loop with every small-matrix entry of its
# scenarios in registers; W=128 over 4 warps is one register per value per
# thread (the tile sweep in PERF.md chose it).
W = 128
TILE = (1, W)
B_TILE = W
NUM_WARPS = 4


def compiler_params() -> pl_triton.CompilerParams:
    """Triton launch parameters shared by the lane kernels. Triton's
    default ``num_stages`` pipelines the loads of the time loop, which never
    depend on the recursion."""
    return pl_triton.CompilerParams(num_warps=NUM_WARPS)


def lane_spec(lead: tuple, width: int) -> pl.BlockSpec:
    """BlockSpec of one program's tile column of a lane-layout array
    ``lead + (nB, 1, width)``: the leading dims whole, the batch-tile and
    row dims squeezed, so kernel values are ``(width,)`` vectors. The
    program index is the batch tile."""
    lead = tuple(lead)
    return pl.BlockSpec(lead + (None, None, width),
                        lambda b: (0,) * len(lead) + (b, 0, 0))


def time_loop(step, state, t_first: int, count: int, k_t: int,
              direction: int = -1):
    """In-kernel time loop: ``state = step(t, state)`` for ``count`` steps
    from ``t_first``, moving by ``direction``. A ``lax.fori_loop`` over
    blocks of ``k_t`` statically unrolled steps, then the static remainder
    (Triton lowers only loops without ``unroll``)."""
    nblk = count // k_t

    def blk(i, st):
        for kk in range(k_t):
            st = step(t_first + direction * (i * k_t + kk), st)
        return st

    if nblk:
        state = lax.fori_loop(0, nblk, blk, state)
    for j in range(nblk * k_t, count):
        state = step(jnp.int32(t_first + direction * j), state)
    return state


def padded_batch(B: int) -> int:
    return -(-B // B_TILE) * B_TILE


def lane_shape(B: int) -> tuple:
    """Shape of one per-scenario scalar in lane layout: ``(nB,) + TILE``."""
    return (padded_batch(B) // B_TILE,) + TILE


def lane_valid(B: int) -> jax.Array:
    """Boolean lane mask: True on the B real scenarios, False on padding."""
    return (jnp.arange(padded_batch(B)) < B).reshape(lane_shape(B))


@dataclasses.dataclass(frozen=True)
class DerivLayout:
    """Slot offsets of the packed derivative stack (row-major flattening).

    Mirrors the fields of :class:`Derivs` (first-order only — the packed
    stream covers iLQG; full-DDP second-order terms come from
    ``derivs_tiles`` or the XLA path).
    """

    n: int
    m: int

    @property
    def fx(self) -> int: return 0

    @property
    def fu(self) -> int: return self.n * self.n

    @property
    def cx(self) -> int: return self.fu + self.n * self.m

    @property
    def cu(self) -> int: return self.cx + self.n

    @property
    def cxx(self) -> int: return self.cu + self.m

    @property
    def cxu(self) -> int: return self.cxx + self.n * self.n

    @property
    def cuu(self) -> int: return self.cxu + self.n * self.m

    @property
    def D(self) -> int: return self.cuu + self.m * self.m


def to_lanes(a: jax.Array, B: int) -> jax.Array:
    """(B, T, ...) batch-major → (T, s, nB) + TILE lane layout (s = prod of
    the per-scenario trailing dims, row-major)."""
    T = a.shape[1]
    s = 1
    for d in a.shape[2:]:
        s *= d
    a = a.reshape(B, T, s)
    Bp = padded_batch(B)
    if Bp != B:
        a = jnp.concatenate(
            [a, jnp.zeros((Bp - B, T, s), a.dtype)], axis=0)
    a = jnp.transpose(a, (1, 2, 0))                       # (T, s, Bp)
    return a.reshape((T, s) + lane_shape(B))


def from_lanes(a: jax.Array, B: int, shape=()) -> jax.Array:
    """(T, s, nB) + TILE → (B, T, *shape)."""
    T, s = a.shape[0], a.shape[1]
    a = a.reshape(T, s, -1)[:, :, :B]                     # (T, s, B)
    a = jnp.transpose(a, (2, 0, 1))                       # (B, T, s)
    return a.reshape((B, T) + tuple(shape))


def vec_to_lanes(v: jax.Array) -> jax.Array:
    """(B,) → (nB,) + TILE."""
    B = v.shape[0]
    Bp = padded_batch(B)
    if Bp != B:
        v = jnp.concatenate([v, jnp.zeros((Bp - B,), v.dtype)])
    return v.reshape(lane_shape(B))


def vec_from_lanes(a: jax.Array, B: int) -> jax.Array:
    """(nB,) + TILE → (B,)."""
    return a.reshape(-1)[:B]


def pack_derivs(d: Derivs, B: int) -> jax.Array:
    """Batch-major :class:`Derivs` ((B, T, ...) leaves) → packed lane stack
    ``(T, D, nB) + TILE``."""
    parts = [d.fx, d.fu, d.cx, d.cu, d.cxx, d.cxu, d.cuu]
    T = d.fx.shape[1]
    flat = [p.reshape(B, T, -1) for p in parts]
    return to_lanes(jnp.concatenate(flat, axis=-1), B)
