"""Differential dynamic programming / iLQG for fleets of problems on a GPU.

A from-scratch JAX/XLA/Pallas re-design with the full capability set of the
reference Julia package ``baggepinnen/DifferentialDynamicProgramming.jl``
(public API at ``src/DifferentialDynamicProgramming.jl:6``):

- :func:`ilqg` — iLQG/DDP solver (reference ``iLQG``, ``src/iLQG.jl:143``)
- :func:`ilqg_kl` — KL-constrained trust-region variant (reference
  ``iLQGkl``, ``src/iLQGkl.jl:25``)
- :func:`boxqp` — projected-Newton box QP (reference ``boxQP``,
  ``src/boxQP.jl:29``)
- :class:`GaussianPolicy` — time-varying affine-Gaussian controller
- model families: linear LTI, pendulum-on-cart, planar quadrotor (the
  autodiff-tiles showcase, :mod:`.models.quadrotor`)
- batched + multi-host execution: :mod:`.parallel`

Everything is jittable, vmappable over scenario batches, and shardable over
device meshes. The fleet fast path (the lane tier) runs Pallas kernels
compiled through Triton on a CUDA GPU; the XLA tier runs anywhere.
"""

from .policy import GaussianPolicy, Trace, Derivs, sym
from .problem import Problem, make_autodiff_derivs, broadcast_derivs
from .ops.boxqp import boxqp, boxqp_1d, demo_qp, BoxQPResult, QPTrace
from .ops.backward import backward_pass, BackwardOut, KLTerms
from .ops.forward import forward_pass, line_search, forward_covariance, Rollout
from .ops.riccati_scan import parallel_riccati
from .ops.kl import (grad_kl, kl_div_gaussian, kl_div_wiki, entropy, calc_eta,
                     AdamState, adam_init, adam_update)
from .solvers.ilqg import ilqg, ILQGConfig, ILQGResult, default_alphas
from .solvers.ilqgkl import ilqg_kl, ILQGKLConfig
from .solvers.batch import (ilqg_batch_lanes, ilqg_iteration_lanes,
                            mpc_rollout_lanes, BatchILQGResult,
                            BatchTrace)
from .solvers.batch_kl import (ilqgkl_batch_lanes, gps_rollout_lanes,
                               BatchKLResult, BatchKLTrace)
from .solvers.fleet import (ilqg_fleet, ilqg_fleet_sharded,
                            ilqgkl_fleet, ilqgkl_fleet_sharded)
from .ops.pallas.autodiff_tiles import (autodiff_derivs_tiles,
                                        autodiff_packed_derivs)
from .utils.aot import (export_solver, serialize_solver, deserialize_solver,
                        save_solver, load_solver)

__version__ = "0.1.0"

__all__ = [
    "GaussianPolicy", "Trace", "Derivs", "sym",
    "Problem", "make_autodiff_derivs", "broadcast_derivs",
    "boxqp", "boxqp_1d", "demo_qp", "BoxQPResult", "QPTrace",
    "backward_pass", "BackwardOut", "KLTerms",
    "forward_pass", "line_search", "forward_covariance", "Rollout",
    "grad_kl", "kl_div_gaussian", "kl_div_wiki", "entropy", "calc_eta",
    "AdamState", "adam_init", "adam_update",
    "parallel_riccati",
    "ilqg", "ILQGConfig", "ILQGResult", "default_alphas",
    "ilqg_kl", "ILQGKLConfig",
    "ilqg_batch_lanes", "ilqg_iteration_lanes", "mpc_rollout_lanes",
    "BatchILQGResult",
    "BatchTrace", "ilqgkl_batch_lanes", "gps_rollout_lanes", "BatchKLResult",
    "BatchKLTrace",
    "ilqg_fleet", "ilqg_fleet_sharded", "ilqgkl_fleet",
    "ilqgkl_fleet_sharded",
    "autodiff_derivs_tiles", "autodiff_packed_derivs",
    "export_solver", "serialize_solver", "deserialize_solver",
    "save_solver", "load_solver",
]
