"""chip_smoke.py off the GPU: it refuses the CPU, its float64 references
agree with the package at small widths, and its phases pass at tiny sizes
(the four-GPU phase on four virtual CPU devices)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.ops.two_loop import (
    empty_history_state, ring_push, two_loop, two_loop_compact,
)

REPO = Path(__file__).resolve().parents[1]


def test_exits_nonzero_on_cpu_without_result_line():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not on a GPU" in out.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("dims,acts", [
    ([12, 7, 3], ["relu", "linear"]),
    ([5, 8, 6, 4], ["tanh", "relu", "linear"]),
])
def test_ref_mlp_loss_grad_matches_jax(dims, acts):
    spec = mlp_spec(dims, acts)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(33, dims[0]))
    y = rng.normal(size=(33, dims[-1]))
    w = mlp_init(spec, jax.random.PRNGKey(1), dtype=jnp.float64)
    f, g = mlp_problem(spec).value_and_grad(w, (jnp.asarray(x), jnp.asarray(y)))
    rf, rg = cs.ref_mlp_loss_grad(spec.dims, spec.activations, w, x, y)
    np.testing.assert_allclose(float(f), rf, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), rg, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("m,k", [(5, 0), (5, 3), (5, 8)])
@pytest.mark.parametrize("fn", [two_loop, two_loop_compact])
def test_ref_two_loop_matches_package(fn, m, k):
    n = 300
    S, Y = cs.curvature_pairs(k, n, seed=k)
    hist = empty_history_state(m, n, jnp.float64)
    for s, y in zip(S.astype(np.float64), Y.astype(np.float64)):
        s, y = jnp.asarray(s), jnp.asarray(y)
        hist = ring_push(hist, s, y, 1.0 / jnp.vdot(y, s), jnp.array(True))
    v = np.random.default_rng(9).normal(size=n)
    keep = min(k, m)
    ref = cs.ref_two_loop(S[k - keep:], Y[k - keep:], v)
    np.testing.assert_allclose(np.asarray(fn(jnp.asarray(v), hist)), ref,
                               rtol=1e-10, atol=1e-12)


def test_rel_err_and_checks_report_failures():
    assert cs.rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert cs.rel_err([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)
    check = cs.Checks()
    check("within", 1e-6, 1e-5, "highest")
    check("outside", 1e-4, 1e-5, "highest")
    check("nan", float("nan"), 1.0, "default")
    assert check.failed == ["outside", "nan"]


def test_correctness_phases_pass_at_small_widths():
    check = cs.Checks()
    cs.check_mlp(check, 256)
    cs.check_two_loop(check, 3000, ms=(4, 12))
    assert check.failed == []


def test_main_path_at_small_sizes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cs.main_path(n_train=512, n_sl=2048, lbfgs_iters=3, deep_iters=2,
                 sl_epochs=1, pinn_iters=2,
                 burgers_grid=dict(dx=0.1, dt=0.1, int_dx=0.2, int_dt=0.2))
    assert list(tmp_path.iterdir()) == []  # writes no history CSVs


def test_four_gpu_paths_on_four_virtual_devices():
    check = cs.Checks()
    cs.four_gpu_paths(check, jax.devices()[:4], n_train=512, lbfgs_iters=3,
                      deep_iters=2, sl_epochs=1, sl_batch=64)
    assert check.failed == []
