from lbfgs_ffnn.objectives.analytic import (
    rosenbrock_problem,
    ackley_problem,
    rastrigin_problem,
)
from lbfgs_ffnn.objectives.mlp import (
    MLPSpec,
    mlp_init,
    mlp_apply,
    mlp_problem,
    mlp_batch_problem,
    evaluate,
)

__all__ = [
    "rosenbrock_problem",
    "ackley_problem",
    "rastrigin_problem",
    "MLPSpec",
    "mlp_init",
    "mlp_apply",
    "mlp_problem",
    "mlp_batch_problem",
    "evaluate",
]
