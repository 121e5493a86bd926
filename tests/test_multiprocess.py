"""Real multi-process distributed init: 2 CPU processes federate via
``parallel.distributed_init`` (gloo collectives) and a batch-sharded
gradient reduction crosses the process boundary.

This exercises the actual ``jax.distributed.initialize`` path — the piece a
virtual single-process device farm (conftest's 8 CPU devices) cannot reach.
Reference has nothing to compare against (SURVEY.md §2.6: no distributed
backend at all).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np


def _cpu_env() -> dict:
    """Worker env pinned to the CPU backend (the workers federate CPU
    processes; an accelerator in the parent's environment is not theirs)."""
    return {**os.environ, "JAX_PLATFORMS": "cpu"}

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]

sys.path.insert(0, os.getcwd())
from lbfgs_ffnn.parallel import distributed_init, make_mesh

distributed_init(coordinator_address=f"localhost:{port}",
                 num_processes=n, process_id=pid)
assert jax.process_count() == n, jax.process_count()
assert jax.device_count() == n, jax.device_count()

import jax.numpy as jnp
from jax.experimental import multihost_utils
from jax.sharding import NamedSharding, PartitionSpec as P

mesh = make_mesh(axis_name="data")

# Global batch split across processes; replicated weights; grad of the
# global mean-squared loss must equal the single-process value.
w = jnp.array([0.5, -1.0, 2.0])
x_local = jnp.arange(4 * 3, dtype=jnp.float32).reshape(4, 3) + 4 * 3 * pid
y_local = jnp.ones((4,), dtype=jnp.float32)
gx = multihost_utils.host_local_array_to_global_array(x_local, mesh, P("data"))
gy = multihost_utils.host_local_array_to_global_array(y_local, mesh, P("data"))

def loss(w, x, y):
    return 0.5 * jnp.mean((x @ w - y) ** 2)

g = jax.jit(jax.grad(loss),
            out_shardings=NamedSharding(mesh, P()))(w, gx, gy)
print(f"RESULT {pid} " + ",".join(f"{v:.8f}" for v in np.asarray(g)), flush=True)
import numpy as np  # noqa: E402 (used above via closure)
"""


_SOLVER_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]

sys.path.insert(0, os.getcwd())
from lbfgs_ffnn.parallel import distributed_init, make_mesh

distributed_init(coordinator_address=f"localhost:{port}",
                 num_processes=n, process_id=pid)

import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import PartitionSpec as P

from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs

spec = mlp_spec([6, 8, 3], ["relu", "linear"])
prob = mlp_problem(spec)
w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)

# Deterministic global dataset; each process holds its half.
rng = np.random.default_rng(42)
X = rng.normal(size=(32, 6))
Y = np.eye(3)[np.arange(32) % 3].astype(np.float64)
x_local = jnp.asarray(X[pid * 16:(pid + 1) * 16])
y_local = jnp.asarray(Y[pid * 16:(pid + 1) * 16])

mesh = make_mesh(axis_name="data")
gx = multihost_utils.host_local_array_to_global_array(x_local, mesh, P("data"))
gy = multihost_utils.host_local_array_to_global_array(y_local, mesh, P("data"))

# The solver runs UNCHANGED on process-sharded data: GSPMD inserts the
# cross-process gradient reduction.
res = lbfgs(prob, w0, aux=(gx, gy),
            opts=LBFGSOptions(max_iters=20, tol=1e-12, m=5, line_search="armijo"))
# res.x is replicated over the mesh; each process reads its local replica.
x_local_replica = np.asarray(jax.device_get(res.x.addressable_data(0)))
print("RESULT %d %d %.12e" % (pid, int(res.n_iters), float(res.final_loss)),
      flush=True)
print("XSUM %d %.12e" % (pid, float(np.abs(x_local_replica).sum())), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_gradient(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text("import numpy as np\n" + _WORKER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            cwd=str(Path(__file__).resolve().parent.parent),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_cpu_env(),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    grads = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, vec = line.split(" ", 2)
                grads[int(pid)] = np.array([float(v) for v in vec.split(",")])
    assert set(grads) == {0, 1}
    # Both processes hold the same replicated global gradient...
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6)
    # ...equal to the single-process oracle over the concatenated batch.
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    y = np.ones(8, dtype=np.float32)
    w = np.array([0.5, -1.0, 2.0], dtype=np.float32)
    r = x @ w - y
    oracle = (x * r[:, None]).mean(axis=0)
    np.testing.assert_allclose(grads[0], oracle, rtol=1e-5)


def test_two_process_lbfgs_matches_single_process(tmp_path):
    """The unchanged L-BFGS solver over process-sharded data converges to the
    same result as a single-process run on the concatenated dataset."""
    worker = tmp_path / "solver_worker.py"
    worker.write_text(_SOLVER_WORKER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            cwd=str(Path(__file__).resolve().parent.parent),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_cpu_env(),
        )
        for i in range(2)
    ]
    results, xsums = {}, {}
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n{err[-4000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, iters, loss = line.split()
                results[int(pid)] = (int(iters), float(loss))
            elif line.startswith("XSUM"):
                _, pid, s = line.split()
                xsums[int(pid)] = float(s)
    assert set(results) == {0, 1}
    assert results[0] == results[1]
    np.testing.assert_allclose(xsums[0], xsums[1], rtol=1e-12)

    # Single-process oracle on the concatenated data (same seeds/config).
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs

    spec = mlp_spec([6, 8, 3], ["relu", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
    rng = np.random.default_rng(42)
    X = jnp.asarray(rng.normal(size=(32, 6)))
    Y = jnp.asarray(np.eye(3)[np.arange(32) % 3])
    res = lbfgs(prob, w0, aux=(X, Y),
                opts=LBFGSOptions(max_iters=20, tol=1e-12, m=5,
                                  line_search="armijo"))
    assert int(res.n_iters) == results[0][0]
    np.testing.assert_allclose(float(res.final_loss), results[0][1], rtol=1e-9)


_SLBFGS_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]

sys.path.insert(0, os.getcwd())
from lbfgs_ffnn.parallel import distributed_init, make_mesh

distributed_init(coordinator_address=f"localhost:{port}",
                 num_processes=n, process_id=pid)

import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import PartitionSpec as P

from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
from lbfgs_ffnn.solvers import SLBFGSOptions, slbfgs

spec = mlp_spec([6, 8, 3], ["tanh", "linear"])
bp = mlp_batch_problem(spec, lam=1e-4)
w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)

rng = np.random.default_rng(42)
X = rng.normal(size=(32, 6))
Y = np.eye(3)[np.arange(32) % 3].astype(np.float64)
x_local = jnp.asarray(X[pid * 16:(pid + 1) * 16])
y_local = jnp.asarray(Y[pid * 16:(pid + 1) * 16])

mesh = make_mesh(axis_name="data")
gx = multihost_utils.host_local_array_to_global_array(x_local, mesh, P("data"))
gy = multihost_utils.host_local_array_to_global_array(y_local, mesh, P("data"))
gw = multihost_utils.host_local_array_to_global_array(w0, mesh, P())

opts = SLBFGSOptions(epochs=3, tol=1e-12, history=4, L=2,
                     batch_size=8, step_size=0.05, sampling="global")
res = slbfgs(bp, gw, gx, gy, opts, mesh=mesh)
lh = np.asarray(jax.device_get(res.loss_history.addressable_data(0)))[:3]
print("RESULT %d %d " % (pid, int(res.n_iters))
      + ",".join("%.12e" % v for v in lh), flush=True)
"""


def test_two_process_slbfgs_global_sampling_matches_single_process(tmp_path):
    """The flagship's explicit-sharded mode with layout-invariant sampling
    across a REAL process boundary: 2 OS processes federate via gloo, the
    batch axis is sharded across them, and the per-epoch loss trajectory
    matches the single-process run (the global batches are identical by
    construction)."""
    worker = tmp_path / "slbfgs_worker.py"
    worker.write_text(_SLBFGS_WORKER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            cwd=str(Path(__file__).resolve().parent.parent),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_cpu_env(),
        )
        for i in range(2)
    ]
    results = {}
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n{err[-4000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                parts = line.split()
                results[int(parts[1])] = (int(parts[2]), parts[3])
    assert set(results) == {0, 1}
    assert results[0] == results[1]  # replicated trajectory across processes

    # Single-process oracle: same data, seeds, config (sampling mode
    # irrelevant on one device — global batches are the 1-device batches).
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from lbfgs_ffnn.objectives.mlp import mlp_batch_problem, mlp_init, mlp_spec
    from lbfgs_ffnn.solvers import SLBFGSOptions, slbfgs

    spec = mlp_spec([6, 8, 3], ["tanh", "linear"])
    bp = mlp_batch_problem(spec, lam=1e-4)
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
    rng = np.random.default_rng(42)
    X = jnp.asarray(rng.normal(size=(32, 6)))
    Y = jnp.asarray(np.eye(3)[np.arange(32) % 3])
    res = slbfgs(bp, w0, X, Y,
                 SLBFGSOptions(epochs=3, tol=1e-12, history=4, L=2,
                               batch_size=8, step_size=0.05))
    assert int(res.n_iters) == results[0][0]
    lh_mp = np.asarray([float(v) for v in results[0][1].split(",")])
    np.testing.assert_allclose(
        np.asarray(res.loss_history[:3]), lh_mp, rtol=1e-9
    )


_DPTP_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]

sys.path.insert(0, os.getcwd())
from lbfgs_ffnn.parallel import distributed_init, make_mesh

distributed_init(coordinator_address=f"localhost:{port}",
                 num_processes=n, process_id=pid)
assert jax.process_count() == n, jax.process_count()
assert jax.device_count() == 4 * n, jax.device_count()

import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import NamedSharding, PartitionSpec as P

from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs

spec = mlp_spec([6, 8, 3], ["relu", "linear"])
prob = mlp_problem(spec)
w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)

rng = np.random.default_rng(42)
X = rng.normal(size=(32, 6))
Y = np.eye(3)[np.arange(32) % 3].astype(np.float64)
x_local = jnp.asarray(X[pid * 16:(pid + 1) * 16])
y_local = jnp.asarray(Y[pid * 16:(pid + 1) * 16])

# 2-D mesh: the data axis crosses the PROCESS boundary (row p = process
# p's four local devices), the model axis lives inside each process.
mesh = make_mesh((n, 4), ("data", "model"))
gx = multihost_utils.host_local_array_to_global_array(x_local, mesh, P("data"))
gy = multihost_utils.host_local_array_to_global_array(y_local, mesh, P("data"))

res = lbfgs(prob, w0, aux=(gx, gy),
            opts=LBFGSOptions(max_iters=15, tol=1e-12, m=5,
                              line_search="armijo"),
            mesh=mesh, shard_axis="model")

rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(res.x)
x_np = np.asarray(rep.addressable_data(0))
print("RESULT %d %d %.12e %.12e"
      % (pid, int(res.n_iters), float(res.final_loss),
         float(np.abs(x_np).sum())), flush=True)
"""


def test_two_process_dp_tp_lbfgs(tmp_path):
    """Multi-host dp x tp: 2 OS processes x 4 virtual local devices form a
    (2, 4) global mesh — data sharded across the process boundary (gradient
    all-reduce over gloo), solver state sharded over each process's local
    model axis. Matches the single-process unsharded run."""
    worker = tmp_path / "dptp_worker.py"
    worker.write_text(_DPTP_WORKER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            cwd=str(Path(__file__).resolve().parent.parent),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_cpu_env(),
        )
        for i in range(2)
    ]
    results = {}
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}\n{err[-4000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, iters, loss, xsum = line.split()
                results[int(pid)] = (int(iters), float(loss), float(xsum))
    assert set(results) == {0, 1}
    assert results[0][0] == results[1][0]
    np.testing.assert_allclose(results[0][1], results[1][1], rtol=1e-12)
    np.testing.assert_allclose(results[0][2], results[1][2], rtol=1e-12)

    # Single-process oracle on the concatenated data.
    import os
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from lbfgs_ffnn.objectives.mlp import mlp_init, mlp_problem, mlp_spec
    from lbfgs_ffnn.solvers import LBFGSOptions, lbfgs

    spec = mlp_spec([6, 8, 3], ["relu", "linear"])
    prob = mlp_problem(spec)
    w0 = mlp_init(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
    rng = np.random.default_rng(42)
    X = jnp.asarray(rng.normal(size=(32, 6)))
    Y = jnp.asarray(np.eye(3)[np.arange(32) % 3])
    ref = lbfgs(prob, w0, aux=(X, Y),
                opts=LBFGSOptions(max_iters=15, tol=1e-12, m=5,
                                  line_search="armijo"))
    assert int(ref.n_iters) == results[0][0]
    np.testing.assert_allclose(results[0][1], float(ref.final_loss),
                               rtol=1e-9)
    np.testing.assert_allclose(results[0][2],
                               float(jnp.abs(ref.x).sum()), rtol=1e-9)
