"""Per-point covariance estimation for (V)GICP on organized scans.

The reference estimates per-point covariances from 20 kd-tree neighbors and
regularizes them to a plane distribution — SVD eigenvalues replaced by
(1, 1, 1e-3) (``impl/fast_gicp_impl.hpp:341-400``).  A kd-tree is hostile to
XLA; on an *organized* sweep the k nearest neighbors are (almost exactly) the
index-window neighbors along the ring plus the azimuth-matched points on the
adjacent rings — a static gather.  We take ±4 in-ring and ±2 around the
matched position on ring±1 (≈19 neighbors), then apply the same plane
regularization with a closed-form 3x3 eigendecomposition.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SlamConfig


def eigh3x3(A: jax.Array):
    """Batched symmetric 3x3 eigendecomposition (ascending eigenvalues).

    Uses the trigonometric closed form for eigenvalues and cross-product
    null-space extraction for eigenvectors — far cheaper than LAPACK-style
    iteration and fully vectorized.
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    # floor keeps inv_p**3 inside f32 range (a 1e-30 floor overflows to inf
    # on near-zero matrices and poisons downstream sums through 0*inf=NaN)
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-24))
    inv_p = 1.0 / p
    # det(B)/2 where B = (A - qI)/p
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    detB = (b00 * c00 - a01 * c01 + a02 * c02) * (inv_p * inv_p * inv_p)
    rr = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(rr) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)                      # largest
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3
    evals = jnp.stack([e3, e2, e1], axis=-1)  # ascending

    def eigvec(lam):
        # rows of (A - lam I); eigenvector is orthogonal to two independent rows
        r0 = jnp.stack([a00 - lam, a01, a02], axis=-1)
        r1 = jnp.stack([a01, a11 - lam, a12], axis=-1)
        r2 = jnp.stack([a02, a12, a22 - lam], axis=-1)
        c01_ = jnp.cross(r0, r1)
        c02_ = jnp.cross(r0, r2)
        c12_ = jnp.cross(r1, r2)
        n01 = jnp.sum(c01_ * c01_, axis=-1, keepdims=True)
        n02 = jnp.sum(c02_ * c02_, axis=-1, keepdims=True)
        n12 = jnp.sum(c12_ * c12_, axis=-1, keepdims=True)
        best = jnp.where(
            (n01 >= n02) & (n01 >= n12), c01_, jnp.where(n02 >= n12, c02_, c12_)
        )
        nrm = jnp.sqrt(jnp.maximum(jnp.sum(best * best, axis=-1, keepdims=True), 1e-30))
        return best / nrm

    v0 = eigvec(evals[..., 0])
    v2 = eigvec(evals[..., 2])
    # re-orthogonalize middle vector
    v1 = jnp.cross(v2, v0)
    # handle isotropic case (p ~ 0): fall back to identity basis
    iso = (p2 < 1e-18)[..., None]
    v0 = jnp.where(iso, jnp.array([1.0, 0, 0], A.dtype), v0)
    v1 = jnp.where(iso, jnp.array([0.0, 1, 0], A.dtype), v1)
    v2 = jnp.where(iso, jnp.array([0.0, 0, 1], A.dtype), v2)
    evecs = jnp.stack([v0, v1, v2], axis=-1)  # columns
    return evals, evecs


def plane_regularize(cov: jax.Array) -> jax.Array:
    """Replace eigenvalues with (1e-3, 1, 1) keeping eigenvectors.

    Matches fast_gicp's RegularizationMethod::PLANE
    (impl/fast_gicp_impl.hpp:380-398).
    """
    _, V = eigh3x3(cov)
    vals = jnp.array([1e-3, 1.0, 1.0], cov.dtype)
    return jnp.einsum("...ik,k,...jk->...ij", V, vals, V)


def norm_min_eig_regularize(cov: jax.Array, floor: float = 1e-3) -> jax.Array:
    """Normalize eigenvalues by the largest and floor them, keeping vectors.

    Matches fast_gicp's RegularizationMethod::NORMALIZED_MIN_EIG
    (impl/fast_gicp_impl.hpp:389-392).  Unlike PLANE this PRESERVES
    line-shaped distributions ([1e-3, 1e-3, 1]).  Measured trade-off (blank
    130 m corridor, pairwise at 0.4 m truth): WORSE than PLANE (0.02 vs
    0.16 recovered at 35 m) — ground points sampled along a ring become
    thin line Gaussians whose axes are SENSOR-relative (the concentric
    ring pattern moves with the robot), so the cost locks the pose to the
    ring pattern instead of the world.  PLANE's forced disc is immune to
    this ring-lock, which is why it is the reference default and ours."""
    evals, V = eigh3x3(cov)
    vals = jnp.maximum(evals / jnp.maximum(evals[..., 2:3], 1e-12), floor)
    return jnp.einsum("...ik,...k,...jk->...ij", V, vals, V)


def min_eig_regularize(cov: jax.Array, floor: float = 1e-3) -> jax.Array:
    """Absolute eigenvalue floor, keeping vectors — fast_gicp's
    RegularizationMethod::MIN_EIG (impl/fast_gicp_impl.hpp:385-388)."""
    evals, V = eigh3x3(cov)
    vals = jnp.maximum(evals, floor)
    return jnp.einsum("...ik,...k,...jk->...ij", V, vals, V)


def frobenius_regularize(cov: jax.Array, lam: float = 1e-3) -> jax.Array:
    """C = cov + λI; result = inv(C_inv / ||C_inv||_F) — fast_gicp's
    RegularizationMethod::FROBENIUS (impl/fast_gicp_impl.hpp:371-377)."""
    eye = jnp.eye(3, dtype=cov.dtype)
    C = cov + lam * eye
    C_inv = jnp.linalg.inv(C)
    nrm = jnp.sqrt(jnp.sum(C_inv * C_inv, axis=(-2, -1), keepdims=True))
    return jnp.linalg.inv(C_inv / jnp.maximum(nrm, 1e-30))


def regularize_covariances(cov: jax.Array, method: str) -> jax.Array:
    """Dispatch on cfg.cov_regularization — the fast_gicp
    RegularizationMethod set (gicp_settings.hpp):
    "plane" (default) | "min_eig" | "norm_min_eig" | "frobenius" | "none"."""
    if method == "plane":
        return plane_regularize(cov)
    if method == "min_eig":
        return min_eig_regularize(cov)
    if method == "norm_min_eig":
        return norm_min_eig_regularize(cov)
    if method == "frobenius":
        return frobenius_regularize(cov)
    if method == "none":
        return cov
    raise ValueError(f"unknown cov_regularization {method!r}")


def rbf_covariances(
    xyz: jax.Array,
    mask: jax.Array,
    kernel_width: float = 0.25,
    max_dist: float = 3.0,
    method: str = "plane",
    row_chunk: int = 2048,
    row_start=0,
    row_count: "int | None" = None,
) -> jax.Array:
    """G8: RBF-kernel covariance estimation (covariance_estimation_rbf.cu:
    1-153; selected by FastVGICPCuda's GPU_RBF_KERNEL neighbor search,
    fast_vgicp_cuda.hpp:21) — per-point Gaussian-weighted moments over ALL
    cloud points within ``max_dist``: w = exp(-kernel_width·d²) (the .cu uses
    the raw kernel_width as the exponent factor; defaults 0.25 / 3.0 from
    fast_vgicp_cuda.cu:25-26), mean = Σwx/Σw, cov = Σw·xxᵀ/Σw − mean·meanᵀ.

    Accelerator formulation: pairwise d² via the Gram identity (one [chunk,N]
    matmul), weights as a dense gated matrix, and every moment as ONE
    matmul W @ [1 | x | xxᵀ-flat] — all matrix-unit work, lax.map'd over row chunks
    to bound the [chunk, N] working set.  Deviation (documented): moments
    accumulate around the cloud centroid instead of raw sensor coordinates —
    mathematically identical (covariance is translation-invariant), but the
    reference's one-pass E[xx]−mmᵀ at |x|≈40 m cancels ~1e-4 absolute in
    f32; centering removes that (the repo-wide two-pass rule, CLAUDE.md).

    row_start/row_count restrict the QUERY rows to one block (sp feature
    sharding); the kernel keys stay the full cloud, so the block result
    equals the same rows of the full result.
    """
    n = xyz.shape[0]
    per = n if row_count is None else row_count
    dtype = xyz.dtype
    m = mask.astype(dtype)
    centroid = jnp.sum(xyz * m[:, None], axis=0) / jnp.maximum(jnp.sum(m), 1.0)
    x = (xyz - centroid) * m[:, None]
    sq = jnp.sum(x * x, axis=-1)
    xx = jnp.einsum("ni,nj->nij", x, x).reshape(n, 9)
    feats = jnp.concatenate([jnp.ones((n, 1), dtype), x, xx], axis=1)  # [N,13]
    max_d2 = jnp.asarray(max_dist * max_dist, dtype)
    kw = jnp.asarray(kernel_width, dtype)

    def rows(a):
        if per == n:
            return a
        return jax.lax.dynamic_slice_in_dim(a, row_start, per, axis=0)

    pad = (-per) % row_chunk
    xq = jnp.pad(rows(x), ((0, pad), (0, 0))).reshape(-1, row_chunk, 3)
    sqq = jnp.pad(rows(sq), (0, pad)).reshape(-1, row_chunk)

    def chunk_moments(args):
        xc, sc = args
        d2 = sc[:, None] + sq[None, :] - 2.0 * (xc @ x.T)
        w = jnp.where(
            (d2 <= max_d2) & mask[None, :], jnp.exp(-kw * d2), 0.0
        ).astype(dtype)
        return w @ feats                                  # [chunk, 13]

    moments = jax.lax.map(chunk_moments, (xq, sqq)).reshape(-1, 13)[:per]
    sw = jnp.maximum(moments[:, 0], 1e-12)
    mean = moments[:, 1:4] / sw[:, None]
    E = moments[:, 4:].reshape(per, 3, 3) / sw[:, None, None]
    cov = E - jnp.einsum("ni,nj->nij", mean, mean)
    cov = jnp.where(rows(mask)[:, None, None], cov, jnp.eye(3, dtype=dtype))
    return regularize_covariances(cov + 1e-6 * jnp.eye(3, dtype=dtype), method)


def scan_covariances(
    xyz: jax.Array,
    mask: jax.Array,
    ring: jax.Array,
    pos_in_ring: jax.Array,
    count_of_ring: jax.Array,
    cfg: SlamConfig,
    row_start=0,
    row_count: "int | None" = None,
) -> jax.Array:
    """Per-point plane-regularized covariances on the organized cloud.

    Returns [row_count, 3, 3] for the query rows [row_start,
    row_start+row_count) — the full cloud by default.  The gather operands
    stay the FULL arrays, so a block slice (sp feature sharding) only
    restricts the query rows and the block result equals the same rows of
    the full result."""
    n = xyz.shape[0]
    per = n if row_count is None else row_count

    def rows(a):
        if per == n:
            return a
        return jax.lax.dynamic_slice_in_dim(a, row_start, per, axis=0)

    idx = rows(jnp.arange(n))
    mask_r = rows(mask)
    ring_r = rows(ring)
    pos_r = rows(pos_in_ring)
    count_r = rows(count_of_ring)

    # neighbor index set: in-ring ±4, plus ±2 around the azimuth-matched
    # position on ring-1 and ring+1
    frac = jnp.where(
        count_r > 0, pos_r.astype(xyz.dtype) / jnp.maximum(count_r, 1), 0.0
    )
    # ring start/count must be recomputed here to avoid extra plumbing
    # (global tables — row-independent)
    counts = jax.ops.segment_sum(
        mask.astype(jnp.int32), jnp.where(mask, ring, cfg.n_scans),
        num_segments=cfg.n_scans + 1,
    )[: cfg.n_scans]
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])

    gather_idx = []
    gather_ok = []
    for o in range(-4, 5):
        j = idx + o
        ok = (
            mask_r
            & (pos_r + o >= 0)
            & (pos_r + o < count_r)
        )
        gather_idx.append(jnp.clip(j, 0, n - 1))
        gather_ok.append(ok)
    for dr in (-1, 1):
        r2 = ring_r + dr
        ok_ring = (r2 >= 0) & (r2 < cfg.n_scans) & mask_r
        r2c = jnp.clip(r2, 0, cfg.n_scans - 1)
        base = starts[r2c] + (frac * counts[r2c].astype(xyz.dtype)).astype(jnp.int32)
        for o in range(-2, 3):
            j = base + o
            pos2 = j - starts[r2c]
            ok = ok_ring & (pos2 >= 0) & (pos2 < counts[r2c])
            gather_idx.append(jnp.clip(j, 0, n - 1))
            gather_ok.append(ok)

    J = jnp.stack(gather_idx, axis=1)          # [N, K]
    OK = jnp.stack(gather_ok, axis=1) & mask[J]
    P = xyz[J]                                  # [N, K, 3]
    w = OK.astype(xyz.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.sum(P * w[..., None], axis=1) / wsum[:, None]
    d = (P - mean[:, None, :]) * w[..., None]
    cov = jnp.einsum("nki,nkj->nij", d, d) / wsum[:, None, None]
    # tiny isotropic floor keeps degenerate windows well-posed
    cov = cov + 1e-6 * jnp.eye(3, dtype=xyz.dtype)
    return regularize_covariances(cov, cfg.cov_regularization)
