"""Iteration history and CSV output.

The reference's IterationRecorder stores per-iteration (loss, ||grad||,
cumulative ms) and flushes ``<name>_history.csv`` strided by log_interval
(reference: src/iteration_recorder.hpp, src/unified_optimization.hpp:66-85).

Here the (loss, gnorm) columns are recorded *on device inside the jitted
solve* (SolveResult.loss_history / gnorm_history); wall-clock timing is
measured on the host around the compiled executable. Because the whole run
is a single XLA program there is no per-iteration host boundary to timestamp
— TimeMs is the measured post-compile wall time distributed uniformly over
the performed iterations (cumulative, like the reference's column). CSV
format is byte-compatible with the reference's plot tooling
(scripts/plot_results.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from lbfgs_ffnn.runtime import get_lib
from lbfgs_ffnn.types import SolveResult


@dataclasses.dataclass
class History:
    loss: np.ndarray     # (n,)
    gnorm: np.ndarray    # (n,)
    time_ms: np.ndarray  # (n,) cumulative

    @property
    def n(self) -> int:
        return int(self.loss.shape[0])


def history_from_result(result: SolveResult, total_time_s: float) -> History:
    """Trim NaN padding and synthesize the cumulative-ms column."""
    n = int(result.n_iters)
    loss = np.asarray(result.loss_history[:n], dtype=np.float64)
    gnorm = np.asarray(result.gnorm_history[:n], dtype=np.float64)
    if n > 0:
        time_ms = np.linspace(total_time_s * 1e3 / n, total_time_s * 1e3, n)
    else:
        time_ms = np.zeros((0,))
    return History(loss=loss, gnorm=gnorm, time_ms=time_ms)


def write_history_csv(
    path: str, history: History, log_interval: int = 1, extra: dict | None = None
) -> None:
    """Write ``Iteration,Loss,GradNorm,TimeMs`` rows strided by log_interval
    (reference: src/unified_optimization.hpp:77-84). Uses the native CSV
    writer when available. ``extra`` maps additional column names (e.g.
    ``TrainAcc`` — the reference's plot tooling shows accuracy panels when
    such columns exist) to per-iteration arrays."""
    if log_interval <= 0 or history.n == 0:
        return
    lib = get_lib()
    loss = np.ascontiguousarray(history.loss, dtype=np.float64)
    gnorm = np.ascontiguousarray(history.gnorm, dtype=np.float64)
    tms = np.ascontiguousarray(history.time_ms, dtype=np.float64)
    if not extra and lib is not None:
        p = ctypes.POINTER(ctypes.c_double)
        rc = lib.csv_write_history(
            str(path).encode(),
            loss.ctypes.data_as(p), gnorm.ctypes.data_as(p), tms.ctypes.data_as(p),
            history.n, int(log_interval),
        )
        if rc == 0:
            return
    extra = extra or {}
    cols = {k: np.asarray(v, dtype=np.float64) for k, v in extra.items()}
    with open(path, "w") as f:
        f.write("Iteration,Loss,GradNorm,TimeMs")
        for k in cols:
            f.write(f",{k}")
        f.write("\n")
        for i in range(0, history.n, log_interval):
            f.write(f"{i},{loss[i]:.17g},{gnorm[i]:.17g},{tms[i]:.17g}")
            for k in cols:
                f.write(f",{cols[k][i]:.17g}")
            f.write("\n")


def read_history_csv(path: str) -> History:
    data = np.genfromtxt(path, delimiter=",", names=True)
    data = np.atleast_1d(data)
    return History(
        loss=np.asarray(data["Loss"], dtype=np.float64),
        gnorm=np.asarray(data["GradNorm"], dtype=np.float64),
        time_ms=np.asarray(data["TimeMs"], dtype=np.float64),
    )
