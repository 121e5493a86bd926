"""lbfgs_ffnn — a quasi-Newton training framework in JAX.

From-scratch JAX/XLA re-design of the capability set of the C++/CUDA
reference ``SignorB/lbfgs-FFNN``: deterministic solvers (L-BFGS, BFGS, Newton,
GD) with Wolfe/Armijo line searches, stochastic solvers (SGD, S-LBFGS with
SVRG variance reduction and decoupled HVP curvature pairs), flat-parameter
dense-MLP and PINN objectives, iteration recording with CSV history output,
and data-parallel scaling over device meshes.

Design notes (vs. the reference):
  * Solvers are pure functions over NamedTuple states, driven by
    ``lax.while_loop`` inside a single jitted program — the whole iteration
    (direction, line search, update, history) lives on-device, unlike the
    reference CUDA path where every dot product synchronizes host<->device
    (reference: src/cuda/lbfgs.cuh:206-261).
  * Curvature history is a fixed-shape (m, n) ring with head/count indices,
    the functional mirror of the reference's RingBuffer
    (reference: src/minimizer/ring_buffer.hpp).
  * HVPs are exact ``jax.jvp`` of the gradient, replacing central finite
    differences (reference: src/minimizer/s_lbfgs.hpp:88-101).
  * Data parallelism is jax.sharding over a device Mesh with psum gradient
    reduction — the multi-device generalization of the reference's OpenMP
    sample-axis threading.
"""

from lbfgs_ffnn.types import (
    Problem,
    BatchProblem,
    SolveResult,
    make_problem,
    make_batch_problem,
)
from lbfgs_ffnn.solvers import (
    GDOptions,
    LBFGSOptions,
    BFGSOptions,
    NewtonOptions,
    SGDOptions,
    SLBFGSOptions,
    gradient_descent,
    lbfgs,
    bfgs,
    newton,
    sgd,
    slbfgs,
)

from lbfgs_ffnn.launcher import Launcher, UnifiedConfig

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "BatchProblem",
    "SolveResult",
    "make_problem",
    "make_batch_problem",
    "GDOptions",
    "LBFGSOptions",
    "BFGSOptions",
    "NewtonOptions",
    "SGDOptions",
    "SLBFGSOptions",
    "gradient_descent",
    "lbfgs",
    "bfgs",
    "newton",
    "sgd",
    "slbfgs",
    "Launcher",
    "UnifiedConfig",
]
