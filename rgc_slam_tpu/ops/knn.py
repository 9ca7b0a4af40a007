"""k-nearest-neighbor search for mapping association and loop ICP.

The reference uses FLANN kd-trees (``kdtreeCornerFromMap->nearestKSearch``,
RGC_mapping.cpp:1097,1203).  Trees are pointer-chasing structures that do not
vectorize; instead the distance matrix comes from the |a|^2 + |b|^2 - 2 a.b
expansion and is reduced with top_k, which vmaps across a fleet.  On the GPU,
shapes past the measured crossover take the fused Pallas Triton kernel
(ops/pallas/knn_kernel.py), which never writes the [Q, N] matrix to device
memory; both paths give the same outputs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def knn(
    queries: jax.Array,       # [Q, 3]
    points: jax.Array,        # [N, 3]
    points_mask: jax.Array,   # [N]
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Returns (sq_dists [Q, k], indices [Q, k]); masked points at +inf,
    ties to the lower index."""
    if use_kernel(queries.shape[0], points.shape[0], k):
        from .pallas.knn_kernel import knn_triton

        return knn_triton(queries, points, points_mask, k)
    return knn_xla(queries, points, points_mask, k)


def use_kernel(qn: int, n: int, k: int) -> bool:
    """Whether ``knn`` takes the fused kernel: on the GPU only, and only at
    shapes where it measured faster (``knn_kernel.kernel_pays``)."""
    if jax.default_backend() != "gpu":
        return False
    from .pallas.knn_kernel import kernel_pays

    return kernel_pays(qn, n, k)


def knn_xla(queries, points, points_mask, k: int):
    """The reference formulation: materialized distances + ``top_k``."""
    # center to keep |a|^2 - 2ab cancellation well-conditioned in f32
    center = jnp.mean(queries, axis=0, keepdims=True)
    queries = queries - center
    points = points - center
    q2 = jnp.sum(queries * queries, axis=-1, keepdims=True)          # [Q,1]
    p2 = jnp.sum(points * points, axis=-1)                           # [N]
    # full f32 precision: reduced-precision matmul modes (bf16 passes, TF32)
    # corrupt squared distances at map-scale coordinates
    cross = jnp.dot(
        queries, points.T,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                                                 # [Q,N]
    d2 = q2 + p2[None, :] - 2.0 * cross
    d2 = jnp.where(points_mask[None, :], d2, jnp.inf)
    neg, idx = jax.lax.top_k(-d2, k)
    return jnp.maximum(-neg, 0.0), idx
