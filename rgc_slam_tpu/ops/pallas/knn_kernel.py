"""Pallas Triton kernel: fused k-nearest-neighbor search for the GPU.

The XLA path (ops/knn.py) writes the [Q, N] squared-distance matrix to
device memory and reads it back for ``top_k``; at mapping-association scale
that intermediate is the pipeline's largest tensor (2048 x 32768 f32 =
256 MB per call).  The inner dimension is 3, so the product has no use for
the tensor cores and the call is bound by that memory traffic.

This kernel never writes the matrix.  Each block owns ``tq`` queries and one
segment of the point axis; it walks its segment in ``tn``-wide tiles with a
``fori_loop`` and carries the running top-k in registers (k separate [tq]
vectors, kept sorted).  Per tile it extracts row minima with ``argmin`` and
inserts them while any row still has a candidate below its current k-th
distance, so a tile that improves no row costs one reduction.  The grid is
parallel over query tiles and point segments (``vmap`` adds the robot
axis); segments are merged by a small ``top_k`` over ``splits * k``
candidates outside the kernel.

Numerics match ops/knn.py: centred f32 |a|^2 + |b|^2 - 2ab, masked points at
+inf, ties to the lower index.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Masked points sit at this finite sentinel inside the kernel so that a
# point already taken (+inf) can never be chosen again while masked points
# still tie among themselves at the lowest index, like XLA's top_k over inf.
_MASKED = 1e30
# Tiles and launch settings: the fastest of a 14-point sweep over query tile,
# point tile, warps, segments and pipeline stages at the pipeline's three kNN
# shapes on an H100 80GB HBM3 at 700 W (PERF.md).
TQ = 16            # queries per block
TN = 512           # points per loop step
MIN_BLOCKS = 528   # point segments are added until the grid has 4 per SM
NUM_WARPS = 4


def _knn_kernel(qx_ref, qy_ref, qz_ref, px_ref, py_ref, pz_ref, p2_ref,
                od_ref, oi_ref, *, k: int, tq: int, tn: int, n: int, qp: int,
                seg_tiles: int):
    qb = pl.program_id(0)
    seg = pl.program_id(1)
    rows = qb * tq + jnp.arange(tq)
    qx = plgpu.load(qx_ref.at[rows])
    qy = plgpu.load(qy_ref.at[rows])
    qz = plgpu.load(qz_ref.at[rows])
    q2 = (qx * qx + qy * qy + qz * qz)[:, None]
    lcol = jax.lax.broadcasted_iota(jnp.int32, (tq, tn), 1)

    def tile(t, run):
        run_d, run_i = run
        start = (seg * seg_tiles + t) * tn
        cols = start + jnp.arange(tn)
        valid = cols < n
        px = plgpu.load(px_ref.at[cols], mask=valid, other=0.0)
        py = plgpu.load(py_ref.at[cols], mask=valid, other=0.0)
        pz = plgpu.load(pz_ref.at[cols], mask=valid, other=0.0)
        p2 = plgpu.load(p2_ref.at[cols], mask=valid, other=jnp.inf)
        cross = (qx[:, None] * px[None, :] + qy[:, None] * py[None, :]
                 + qz[:, None] * pz[None, :])
        d = q2 + p2[None, :] - 2.0 * cross                  # [tq, tn]

        def more(c):
            _, m, _, s, rd, _ = c
            below = (m < rd[k - 1]).astype(jnp.int32)
            return (s < k) & (jnp.max(below) > 0)

        def insert(c):
            d, m, a, s, rd, ri = c
            # rank of m among the sorted running list; equal values already
            # held come from lower indices and stay in front
            pos = sum((r <= m).astype(jnp.int32) for r in rd)
            gi = start + a
            nd, ni = [], []
            for j in range(k):
                prev_d = rd[j - 1] if j else m
                prev_i = ri[j - 1] if j else gi
                nd.append(jnp.where(pos > j, rd[j],
                                    jnp.where(pos == j, m, prev_d)))
                ni.append(jnp.where(pos > j, ri[j],
                                    jnp.where(pos == j, gi, prev_i)))
            d = jnp.where(lcol == a[:, None], jnp.inf, d)
            return (d, jnp.min(d, axis=1), jnp.argmin(d, axis=1), s + 1,
                    tuple(nd), tuple(ni))

        init = (d, jnp.min(d, axis=1), jnp.argmin(d, axis=1),
                jnp.int32(0), run_d, run_i)
        _, _, _, _, run_d, run_i = jax.lax.while_loop(more, insert, init)
        return run_d, run_i

    run_d = tuple(jnp.full((tq,), jnp.inf, jnp.float32) for _ in range(k))
    run_i = tuple(jnp.full((tq,), n, jnp.int32) for _ in range(k))
    run_d, run_i = jax.lax.fori_loop(0, seg_tiles, tile, (run_d, run_i))
    for j in range(k):
        at = (seg * k + j) * qp + rows
        plgpu.store(od_ref.at[at], run_d[j])
        plgpu.store(oi_ref.at[at], run_i[j])


def kernel_pays(qn: int, n: int, k: int) -> bool:
    """Shapes at which the kernel beat the XLA formulation on the card.

    Crossover measured on an H100 80GB HBM3 at 700 W (PERF.md): the kernel
    took 1.9x XLA's time at 128 x 512 (65,536 pairs) and 0.88x at
    256 x 1024 (262,144 pairs), and won at every larger shape measured, k up
    to 20 (0.64x at 2560 x 2560, k=20)."""
    return qn * n >= (1 << 18) and k <= 20


def _splits(q_blocks: int, n_tiles: int, min_blocks: int) -> int:
    """Point segments per query tile: enough blocks to fill the card."""
    return max(1, min(n_tiles, -(-min_blocks // q_blocks)))


@functools.partial(jax.jit, static_argnames=("k", "tn", "min_blocks", "interpret"))
def knn_triton(queries, points, points_mask, k: int, *, tn: int = TN,
               min_blocks: int = MIN_BLOCKS, interpret: bool = False):
    """Drop-in equivalent of ops/knn.knn (same outputs, same tie rule).

    ``tn`` and ``min_blocks`` let tests reach several tiles and segments at
    small sizes; ``interpret`` runs the kernel on the CPU."""
    qn, n = queries.shape[0], points.shape[0]
    tq = TQ
    center = jnp.mean(queries, axis=0, keepdims=True)
    queries = queries - center
    points = points - center
    qp = -(-qn // tq) * tq
    n_tiles = -(-n // tn)
    splits = _splits(qp // tq, n_tiles, min_blocks)
    seg_tiles = -(-n_tiles // splits)
    splits = -(-n_tiles // seg_tiles)

    q = jnp.pad(queries, ((0, qp - qn), (0, 0)))
    p2 = jnp.where(points_mask, jnp.sum(points * points, axis=1), _MASKED)
    out_shape = (
        jax.ShapeDtypeStruct((splits * k * qp,), jnp.float32),
        jax.ShapeDtypeStruct((splits * k * qp,), jnp.int32),
    )
    d, i = pl.pallas_call(
        functools.partial(_knn_kernel, k=k, tq=tq, tn=tn, n=n, qp=qp,
                          seg_tiles=seg_tiles),
        grid=(qp // tq, splits),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="knn_triton",
    )(q[:, 0], q[:, 1], q[:, 2], points[:, 0], points[:, 1], points[:, 2], p2)
    # [splits, k, qp] -> [qp, splits * k], segment-major so that equal
    # distances keep ascending index order for the stable merge below
    d = d.reshape(splits, k, qp).transpose(2, 0, 1).reshape(qp, splits * k)
    i = i.reshape(splits, k, qp).transpose(2, 0, 1).reshape(qp, splits * k)
    if splits > 1:
        neg, pos = jax.lax.top_k(-d, k)
        d = -neg
        i = jnp.take_along_axis(i, pos, axis=1)
    d, i = d[:qn], i[:qn]
    d = jnp.where(d >= _MASKED, jnp.inf, jnp.maximum(d, 0.0))
    # unfilled slots (fewer than k points) carry index n: clamp into [0, n)
    # so consumers gating on mask[idx] read a real column, as on the XLA path
    return d, jnp.minimum(i, n - 1)
