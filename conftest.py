# Test configuration: run the suite on a virtual 8-device CPU mesh so that
# multi-device sharding paths are exercised without accelerator hardware,
# and enable x64 so deterministic-solver tests can validate against the
# reference's float64 CPU oracle (reference uses double on CPU,
# src/common.hpp).
#
# jax.config.update takes effect as long as no backend has been initialized
# yet, so it also overrides a JAX_PLATFORMS set in the environment. Opt
# into the accelerator with LBFGS_DEVICE_TESTS=1: the platform is then left
# to JAX, and x64 stays on (a GPU has native float64).
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("LBFGS_DEVICE_TESTS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The full suite compiles ~250 distinct whole-training-run XLA CPU
    programs (many of them 8-virtual-device SPMD). Letting them all stay
    live segfaulted the XLA CPU compiler (inside
    ``backend_compile_and_load``) near the END of the suite — reproduced
    2/2 at the same test, which passes in isolation, with its whole file,
    and with multi-file prefixes (an accumulated
    compiler-state interaction, not OOM). Dropping executable references at
    module boundaries keeps the live-program population bounded; the
    next module recompiles what it needs (lru-cached solver wrappers hold
    ``jax.jit`` objects whose underlying executables repopulate on call).
    """
    yield
    jax.clear_caches()
