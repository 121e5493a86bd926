from lbfgs_ffnn.solvers.gd import GDOptions, gradient_descent
from lbfgs_ffnn.solvers.lbfgs import LBFGSOptions, lbfgs
from lbfgs_ffnn.solvers.bfgs import BFGSOptions, bfgs
from lbfgs_ffnn.solvers.newton import NewtonOptions, newton
from lbfgs_ffnn.solvers.sgd import SGDOptions, sgd
from lbfgs_ffnn.solvers.slbfgs import SLBFGSOptions, slbfgs, slbfgs_chunked

__all__ = [
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
    "slbfgs_chunked",
]
