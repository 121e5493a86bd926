"""Quantitative PINN-vs-FD-oracle validation for Burgers runs.

Reads a ``burgers_test_extrapolation.csv`` (the reference's x,t,u,type
format, written by experiments/run_burgers.py), solves the same PDE with
the fine-grid finite-difference oracle (scripts/burgers_fd.py), and prints
mean/max |u_PINN - u_FD| at the interpolation snapshots t = 0, 0.5, 1.0.

Pass/fail gate (the criterion set for the f32 run):
mean |u - u_FD| <= 0.02 at every snapshot.

Usage: python scripts/burgers_validate.py burgers_test_extrapolation.csv
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from burgers_fd import solve_burgers_fd


def validate(csv_path: str, mean_tol: float = 0.02) -> bool:
    rows = np.genfromtxt(csv_path, delimiter=",", names=True)
    x_fd, snaps = solve_burgers_fd(snapshot_times=(0.0, 0.5, 1.0))
    ok = True
    for t in (0.0, 0.5, 1.0):
        sel = (np.abs(rows["t"] - t) < 1e-9) & (rows["type"] == 0)
        xs, us = rows["x"][sel], rows["u"][sel]
        u_fd = np.interp(xs, x_fd, snaps[t])
        err = np.abs(us - u_fd)
        status = "ok" if err.mean() <= mean_tol else "FAIL"
        print(f"t={t:3.1f}: mean|u-u_FD|={err.mean():.4f}  "
              f"max={err.max():.4f}  [{status}, tol {mean_tol}]")
        ok &= err.mean() <= mean_tol
    return ok


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("csv")
    p.add_argument("--mean-tol", type=float, default=0.02)
    args = p.parse_args()
    sys.exit(0 if validate(args.csv, args.mean_tol) else 1)
