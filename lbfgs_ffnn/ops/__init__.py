from lbfgs_ffnn.ops.linesearch import (
    wolfe_line_search,
    armijo_quad_line_search,
    armijo_batched_line_search,
)
from lbfgs_ffnn.ops.two_loop import two_loop, ring_push, empty_history_state

__all__ = [
    "wolfe_line_search",
    "armijo_quad_line_search",
    "armijo_batched_line_search",
    "two_loop",
    "ring_push",
    "empty_history_state",
]
