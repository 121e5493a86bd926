"""Deterministic solver suite: BFGS / LBFGS / BFGS+GMRES / Newton across
Rosenbrock, Ackley, Rastrigin — the reference's tests/main.cpp experiment,
with real convergence classification and per-run timing.

Usage: python experiments/run_deterministic_suite.py [--f32]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import argparse

import jax

from lbfgs_ffnn.utils.compile_cache import enable_compile_cache

parser = argparse.ArgumentParser()
parser.add_argument("--f32", action="store_true", help="run in float32")
args = parser.parse_args()
enable_compile_cache()
if not args.f32:
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lbfgs_ffnn.harness import TestCase, TestSuite  # noqa: E402
from lbfgs_ffnn.objectives.analytic import (  # noqa: E402
    ackley_problem, ackley_start,
    rastrigin_problem, rastrigin_start,
    rosenbrock_problem, rosenbrock_start,
)
from lbfgs_ffnn.solvers import (  # noqa: E402
    BFGSOptions, LBFGSOptions, NewtonOptions, bfgs, lbfgs, newton,
)

dtype = jnp.float32 if args.f32 else jnp.float64

suite = TestSuite()
suite.add_implementation(
    "BFGS", lambda p, x0: bfgs(p, x0, opts=BFGSOptions(max_iters=5000, tol=1e-12))
)
suite.add_implementation(
    "LBFGS", lambda p, x0: lbfgs(p, x0, opts=LBFGSOptions(max_iters=5000, tol=1e-12, m=16))
)
suite.add_implementation(
    "BFGS+GMRES",
    lambda p, x0: bfgs(p, x0, opts=BFGSOptions(max_iters=5000, tol=1e-12, linear_solver="gmres")),
)
suite.add_implementation(
    "Newton", lambda p, x0: newton(p, x0, opts=NewtonOptions(max_iters=5000, tol=1e-12))
)

suite.add_test(TestCase(
    "rosenbrock n=4", rosenbrock_problem(), rosenbrock_start(4, dtype),
    expected_min=np.ones(4), gtol=1e-8,
))
suite.add_test(TestCase(
    "ackley n=3", ackley_problem(), ackley_start(dtype), expected_min=np.zeros(3), gtol=1e-8,
))
suite.add_test(TestCase(
    "rastrigin n=500", rastrigin_problem(), rastrigin_start(500, dtype), gtol=1e-7,
))

suite.run()
