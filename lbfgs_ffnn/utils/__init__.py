from lbfgs_ffnn.utils.compile_cache import compile_cache_dir, enable_compile_cache
from lbfgs_ffnn.utils.diagnostics import check_parallelism, sync_time
from lbfgs_ffnn.utils.profiling import trace

__all__ = [
    "check_parallelism", "compile_cache_dir", "enable_compile_cache",
    "sync_time", "trace",
]
