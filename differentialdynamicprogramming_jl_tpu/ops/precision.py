"""Full-precision matrix products for the XLA tier.

A float32 matrix product on a GPU may run in TF32, which keeps about three
decimal digits. The XLA tier's products are n×n with n ≤ 12, far below a
shape where tensor cores pay, so TF32 would buy nothing and cost the digits
that make f32 on the card agree with f32 on the CPU."""
from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Trace ``fn`` with ``precision=HIGHEST`` on every matrix product it
    contains (``jax.default_matmul_precision("highest")``; the setting is
    part of the jit cache key, so a jitted ``fn`` keeps it)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped
