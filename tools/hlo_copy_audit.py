"""Audit XLA while-loop copy insertion in the compiled lane driver (CPU).

XLA while loops pin each carry element to a fixed buffer; a value that
moves between carry positions (rotation, e.g. ``traj_bwd = c.traj``) or a
kernel output landing in a carry position gets a materializing ``copy``.
These copies are invisible in the Python code and missing from naive
traffic arithmetic — this harness lowers the driver at toy shapes on CPU
and attributes every big copy op to its HLO computation, so driver-level
per-iteration copy traffic can be compared across checkouts.

Caveat: CPU interpret-mode Pallas inlines each kernel as its own XLA loop
region, inflating the total count — only copies in the MAIN driver loop
body (the region containing the trajectory-shaped carries) are meaningful
for the compiled driver; kernel-internal regions do not exist there
(a compiled kernel is one custom call).

Usage: python tools/hlo_copy_audit.py [--kl] <repo_root> [<repo_root2> ...]
(default audits the iLQG lane driver; --kl audits the GPS/KL lane driver)
"""
import math
import subprocess
import sys


def _report(root: str, txt: str, carried_shapes) -> None:
    cur = None
    rows = []
    for line in txt.splitlines():
        s = line.strip()
        if s.startswith("%") and s.endswith("{") and " = " not in s:
            cur = s.split(" ")[0]
        if s.startswith("ENTRY"):
            cur = "ENTRY"
        if " copy(" in s and "f32[" in s:
            shape = s.split("f32[")[1].split("]")[0]
            dims = [int(d) for d in shape.split(",") if d]
            nbytes = math.prod(dims) * 4
            if nbytes >= 100_000:          # big buffers only
                rows.append((cur, shape, nbytes, s[:110]))

    in_body = [r for r in rows if r[0] != "ENTRY"]
    # structural carry copies always copy a get-tuple-element (a carry
    # position's input); copies of pad/fusion outputs at the same shape are
    # interpret-mode Pallas operand prep (e.g. the forward kernel's
    # emit_traj stream matches the carried trajectory shape exactly) and
    # must NOT be counted — they have no compiled counterpart
    carried = [r for r in in_body
               if r[1] in carried_shapes
               and "copy(%get-tuple-element" in r[3]]
    print(f"{root}:")
    print(f"  big (>=100 kB) copies: {len(rows)} total, "
          f"{len(in_body)} inside loop bodies, "
          f"{len(carried)} GTE-operand copies at CARRIED-stream shapes "
          f"{sorted(carried_shapes)} <- only these are structural "
          f"evidence; the rest is mostly interpret-mode Pallas operand "
          f"prep")
    for region, shape, nbytes, s in rows:
        tag = ("  <== carried-stream GTE copy"
               if (region, shape, nbytes, s) in carried else "")
        print(f"  {region} :: f32[{shape}] ({nbytes} B) :: {s}{tag}")


def audit(root: str) -> None:
    sys.path.insert(0, root)

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")

    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, default_x0, pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        _ilqg_batch_lanes_jit)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)

    spec = PendCartSpec()
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                     lam_max=1e15, max_iter=2, iter_cap=3)
    # eight lane tiles: the carried streams clear the 100 kB line of _report
    from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import W
    B, T = 8 * W, 6
    x0s = default_x0(jnp.float32)[None, :].repeat(B, 0)
    u0s = jnp.zeros((B, T, 1), jnp.float32)
    lo = _ilqg_batch_lanes_jit.lower(
        model, None, x0s, u0s, lims=((-5.0, 5.0),), cfg=cfg,
        derivs_tiles=tiles, params=None, cost0=None, warm_start=False,
        lam0=None, dlam0=None, accepted0=None,
        max_steps=jnp.asarray(2, jnp.int32),
        kt_backward=2, kt_forward=2, record_trace=False, interpret=True)
    # carried trajectory stream (T, n+m+1, nB, 1, W): the traj /
    # traj_bwd carries — the rotation copy shows up at exactly this shape
    _report(root, lo.compile().as_text(), {f"{T},6,{B // W},1,{W}"})


def audit_kl(root: str) -> None:
    sys.path.insert(0, root)

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")

    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, make_pendcart_problem, default_x0, pendcart_lanes,
        pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.ops.forward import (
        forward_pass)
    from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
        ILQGKLConfig)

    from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import W
    B, T = 8 * W, 10
    dtype = jnp.float32
    spec = PendCartSpec()
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    x0s = (default_x0(dtype)[None, :]
           + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, 4), dtype))
    u0s = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b))(x0s, u0s)
    prev = GaussianPolicy.zeros(T, 4, 1, dtype)
    prev = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), prev)
    prev = prev._replace(k=ro.u)
    d = jax.vmap(problem.make_derivs())(ro.x, ro.u)
    cfg = ILQGKLConfig(kl_step=2.0, max_iter=4)
    # the public entry is a plain wrapper since the traced-loop-bound
    # refactor — lower the inner jit it delegates to
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        _ilqgkl_batch_lanes_jit)
    lo = _ilqgkl_batch_lanes_jit.lower(
        pendcart_lanes(spec), pendcart_derivs_tiles(spec), ro.x, prev,
        d.fx, jnp.sum(ro.cost, -1), lims=None, lims_batch=None, cfg=cfg,
        r1=None, kt=4, max_steps=jnp.int32(cfg.max_iter),
        it0=jnp.zeros((), jnp.int32), record_trace=False, interpret=True)
    # policy-emission stream (T, m + m·n + 2m² = 7, nB, 1, W): the shape
    # an earlier driver carried as `bo` (now replaced by eta_used)
    _report(root, lo.compile().as_text(), {f"{T},7,{B // W},1,{W}"})


if __name__ == "__main__":
    args = sys.argv[1:]
    kl = "--kl" in args
    roots = [a for a in args if a != "--kl"] or ["."]
    # one subprocess per root: each needs a clean import of the package
    if len(roots) > 1:
        for r in roots:
            subprocess.run([sys.executable, __file__]
                           + (["--kl"] if kl else []) + [r], check=False)
    else:
        (audit_kl if kl else audit)(roots[0])
