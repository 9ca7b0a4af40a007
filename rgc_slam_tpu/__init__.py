"""JAX rebuild of RGC-SLAM (jax / XLA / Pallas / shard_map).

Precision policy: geometric solvers need true float32 products (squared
distances at map-scale coordinates, Gauss-Newton normal equations with
1e3-scaled ground residuals).  Reduced-precision matmul modes (bf16 passes,
or TF32 on the GPU's tensor cores, ~10 mantissa bits) corrupt them, so the
package pins ``jax_default_matmul_precision=highest``; the hot-path products
(ops/knn.py) set it explicitly as well.
"""
import os as _os

import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache.  Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and nothing is set here; otherwise the cache lives at
# one fixed, git-ignored directory inside the checkout (the path is part of
# the cache key, so it must not move between processes).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
