"""Point-correspondence GICP and NDT registration variants.

Completes the fast_gicp library surface (SURVEY §2.3) beyond the VGICP used
at runtime:
  * ``gicp_register``   — G2/G3 ``FastGICP``: per-point 1-NN correspondences
    (kd-tree -> batched brute-force knn) with distribution-to-distribution Mahalanobis
    cost (impl/fast_gicp_impl.hpp:216-313).  The reference's single-thread /
    OpenMP split (G2 vs G3) is meaningless on an accelerator — one vectorized program
    covers both.
  * ``ndt_register``    — G13 ``NDTCuda``, BOTH NDTDistanceMode variants
    (ndt_settings.hpp:6): D2D voxel-Gaussians-vs-voxel-Gaussians and P2D
    points-vs-voxel-Gaussians, with the kernels' Cauchy robustifier
    (ndt/ndt_cuda.hpp, cuda/ndt_compute_derivatives.cu — in-tree but unbuilt
    in the reference; rebuilt here in JAX).

Both reuse the LsqRegistration LM driver through the same frozen-correspondence
structure as ops/registration.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..types import VoxelMap
from ..utils import math3d as m3
from . import knn as knn_ops
from . import voxelhash as vh
from .covariance import plane_regularize, regularize_covariances
from .registration import (
    Correspondences,
    RegistrationResult,
    _inv3_sym,
    _solve6,
    corr_cost,
    corr_linearize,
)


def knn_covariances(pts: jax.Array, mask: jax.Array, k: int = 20,
                    method: str = "plane") -> jax.Array:
    """Per-point regularized covariance from k nearest neighbors —
    ``FastGICP::calculate_covariances`` (impl/fast_gicp_impl.hpp:341-400) with
    the kd-tree replaced by the batched brute-force knn; ``method`` selects the
    RegularizationMethod ("plane" reference default | "norm_min_eig")."""
    d2, idx = knn_ops.knn(pts, pts, mask, k)
    near = pts[idx]                                    # [N, k, 3]
    ok = mask[idx] & jnp.isfinite(d2)
    w = ok.astype(pts.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.sum(near * w[..., None], axis=1) / wsum[:, None]
    d = (near - mean[:, None, :]) * w[..., None]
    cov = jnp.einsum("nki,nkj->nij", d, d) / wsum[:, None, None]
    return regularize_covariances(
        cov + 1e-6 * jnp.eye(3, dtype=pts.dtype), method
    )


def _gicp_correspondences(
    src, src_cov, src_mask, tgt, tgt_cov, tgt_mask, q, t, max_corr
) -> Correspondences:
    """1-NN correspondence + Mahalanobis (C_B + R C_A R^T)^-1 at pose (q,t)."""
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    d2, idx = knn_ops.knn(Tp, tgt, tgt_mask, 1)
    j = idx[:, 0]
    valid = src_mask & (d2[:, 0] < max_corr * max_corr)
    mean_B = tgt[j]
    cov_B = tgt_cov[j]
    R = m3.quat_to_mat(q)
    RCA = jnp.einsum("ij,njk,lk->nil", R, src_cov, R)
    Minv = _inv3_sym(cov_B + RCA)
    w = valid.astype(src.dtype)
    return Correspondences(mean_B=mean_B, Minv=Minv, w=w, valid=valid)


def _lm_drive(corr_fn, src, q0, t0, cfg: SlamConfig, max_iters: int,
              cauchy_k=None):
    """Shared LM loop (G1 semantics) over any frozen-correspondence builder.

    ``cauchy_k`` threads the NDT kernels' pose-dependent Cauchy robustifier
    into both the linearization and the accept-test cost (see
    registration._robust_w)."""
    dtype = src.dtype

    def is_converged(dq, dt_):
        dR = m3.quat_to_mat(dq) - jnp.eye(3, dtype=dtype)
        return (
            jnp.maximum(
                jnp.max(jnp.abs(dR)) / cfg.rotation_epsilon,
                jnp.max(jnp.abs(dt_)) / cfg.translation_epsilon,
            )
            < 1.0
        )

    def outer_cond(s):
        q, t, lam, conv, it = s
        return (~conv) & (it < max_iters)

    def outer_body(s):
        q, t, lam, conv, it = s
        corr = corr_fn(q, t)
        H, b, y0 = corr_linearize(corr, src, q, t, cauchy_k=cauchy_k)
        lam0 = jnp.where(
            lam < 0, cfg.lm_init_lambda_factor * jnp.max(jnp.abs(jnp.diag(H))), lam
        )

        def inner_body(c):
            (lam, nu, done, q_, t_, conv_, acc_), k = c
            d = _solve6(H, b, lam)
            dq = m3.quat_exp(d[:3])
            dt_ = d[3:]
            q_new = m3.quat_normalize(m3.quat_mul(dq, q))
            t_new = m3.quat_rotate(dq, t) + dt_
            yi = corr_cost(corr, src, q_new, t_new, cauchy_k=cauchy_k)
            denom = jnp.dot(d, lam * d - b)
            rho = (y0 - yi) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
            accept = rho > 0
            conv_now = is_converged(dq, dt_)
            lam_next = jnp.where(
                accept,
                lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                nu * lam,
            )
            nu_next = jnp.where(accept, 2.0, 2.0 * nu)
            return (
                (
                    lam_next,
                    nu_next,
                    done | accept | conv_now,
                    jnp.where(accept, q_new, q_),
                    jnp.where(accept, t_new, t_),
                    conv_ | conv_now,
                    acc_ | accept,
                ),
                k + 1,
            )

        def inner_cond(c):
            (lam, nu, done, q_, t_, conv_, acc_), k = c
            return (~done) & (k < cfg.lm_max_inner)

        init = ((lam0, jnp.asarray(2.0, dtype), jnp.asarray(False), q, t,
                 jnp.asarray(False), jnp.asarray(False)), 0)
        (lam_f, _, _, q_f, t_f, conv_f, acc_f), _ = jax.lax.while_loop(
            inner_cond, inner_body, init
        )
        return (q_f, t_f, lam_f, conv_f | (~acc_f), it + 1)

    s0 = (q0.astype(dtype), t0.astype(dtype), jnp.asarray(-1.0, dtype),
          jnp.asarray(False), jnp.asarray(0, jnp.int32))
    q, t, lam, conv, it = jax.lax.while_loop(outer_cond, outer_body, s0)
    corr = corr_fn(q, t)
    H, b, cost = corr_linearize(corr, src, q, t, cauchy_k=cauchy_k)
    return q, t, cost, jnp.sum(corr.valid), it, H


def gicp_register(
    src: jax.Array, src_mask: jax.Array,
    tgt: jax.Array, tgt_mask: jax.Array,
    q0: jax.Array, t0: jax.Array,
    cfg: SlamConfig,
    knn_k: int = 20,
    max_iters: int = 64,
) -> RegistrationResult:
    """FastGICP (G2): per-point D2D with kNN covariances on both clouds."""
    src_cov = knn_covariances(src, src_mask, knn_k)
    tgt_cov = knn_covariances(tgt, tgt_mask, knn_k)

    def corr_fn(q, t):
        return _gicp_correspondences(
            src, src_cov, src_mask, tgt, tgt_cov, tgt_mask, q, t,
            cfg.vgicp_max_corr_dist,
        )

    q, t, cost, n, it, H = _lm_drive(corr_fn, src, q0, t0, cfg, max_iters)
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    d2, _ = knn_ops.knn(Tp, tgt, tgt_mask, 1)
    match = src_mask & (d2[:, 0] < cfg.vgicp_max_corr_dist**2)
    fit = jnp.where(match, d2[:, 0], 0.0).sum() / jnp.maximum(jnp.sum(match), 1)
    return RegistrationResult(q=q, t=t, fitness=fit, n_corr=n, iterations=it, H=H)


def plane_normals(pts: jax.Array, mask: jax.Array, k: int = 20) -> jax.Array:
    """Per-point unit normals: smallest-eigenvalue direction of the k-NN
    covariance (the pcl::NormalEstimation analog, batched elementwise)."""
    from .covariance import eigh3x3

    d2, idx = knn_ops.knn(pts, pts, mask, k)
    near = pts[idx]
    ok = mask[idx] & jnp.isfinite(d2)
    w = ok.astype(pts.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.sum(near * w[..., None], axis=1) / wsum[:, None]
    d = (near - mean[:, None, :]) * w[..., None]
    cov = jnp.einsum("nki,nkj->nij", d, d) / wsum[:, None, None]
    _, V = eigh3x3(cov + 1e-9 * jnp.eye(3, dtype=pts.dtype))
    return V[..., 0]                                    # smallest-eig column


def p2plane_register(
    src: jax.Array, src_mask: jax.Array,
    tgt: jax.Array, tgt_mask: jax.Array,
    q0: jax.Array, t0: jax.Array,
    cfg: SlamConfig,
    knn_k: int = 20,
    max_iters: int = 64,
) -> RegistrationResult:
    """Point-to-plane ICP through the same frozen-correspondence LM driver.

    With ``Minv = n nᵀ`` the Mahalanobis form collapses to the point-to-plane
    cost w·(nᵀ(μ - Tp))² — a wider convergence basin than point-to-point from
    large loop drift (the reference uses pcl point-to-point,
    RGC_mapping.cpp:2050-2081; this is the opt-in upgrade,
    cfg.loop_icp_method="plane")."""
    nrm = plane_normals(tgt, tgt_mask, knn_k)

    def corr_fn(q, t):
        Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
        d2, idx = knn_ops.knn(Tp, tgt, tgt_mask, 1)
        j = idx[:, 0]
        valid = src_mask & (d2[:, 0] < cfg.vgicp_max_corr_dist**2)
        n = nrm[j]
        Minv = n[:, :, None] * n[:, None, :]
        return Correspondences(
            mean_B=tgt[j], Minv=Minv, w=valid.astype(src.dtype), valid=valid
        )

    q, t, cost, n, it, H = _lm_drive(corr_fn, src, q0, t0, cfg, max_iters)
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    d2, _ = knn_ops.knn(Tp, tgt, tgt_mask, 1)
    match = src_mask & (d2[:, 0] < cfg.vgicp_max_corr_dist**2)
    fit = jnp.where(match, d2[:, 0], 0.0).sum() / jnp.maximum(jnp.sum(match), 1)
    return RegistrationResult(q=q, t=t, fitness=fit, n_corr=n, iterations=it, H=H)


def gicp_mp_register(
    src: jax.Array, src_mask: jax.Array,
    tgt: jax.Array, tgt_mask: jax.Array,
    q0: jax.Array, t0: jax.Array,
    cfg: SlamConfig,
    knn_k: int = 20,
    radius: float = 0.5,
    fuse_k: int = 16,
    max_iters: int = 64,
) -> RegistrationResult:
    """FastGICPMultiPoints (G5, experimental/fast_gicp_mp_impl.hpp).

    Each source point fuses ALL target neighbors within ``radius`` into a
    single weighted Gaussian — weight ``clip(1 - d/r, 1e-3, 1)`` over the
    radius search (fast_gicp_mp_impl.hpp:138-195) — then minimizes the
    reference's experimental whitened residual ``M^-1 (mean_B - T mean_A)``
    with plain Gauss-Newton (no LM damping), recomputing correspondences
    every iteration (fast_gicp_mp_impl.hpp:92-108).  Update semantics mirror
    the reference exactly: ``R <- exp(-dr) R``, ``t <- t - dt``
    (fast_gicp_mp_impl.hpp:101-102 — note t is NOT rotated by the increment,
    unlike LsqRegistration), and the convergence test is the shared
    max(|exp(dr)-I|/rot_eps, |dt|/t_eps) < 1 (fast_gicp_mp_impl.hpp:117-127).

    Deviations: the unbounded radius search becomes a ``fuse_k``
    nearest-neighbor gather masked at ``radius`` (fixed shapes for jit; the
    weight profile already de-emphasizes far neighbors so truncation at
    fuse_k is benign), and the OpenMP point loop is one batched einsum
    program.  The reference never builds this class (dead experimental code,
    SURVEY §2.3 G5); it is provided for API completeness.
    """
    src_cov = knn_covariances(src, src_mask, knn_k)
    tgt_cov = knn_covariances(tgt, tgt_mask, knn_k)
    dtype = src.dtype
    eye6 = jnp.eye(6, dtype=dtype)
    r2 = jnp.asarray(radius * radius, dtype)

    def linearize(q, t):
        Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
        d2, idx = knn_ops.knn(Tp, tgt, tgt_mask, fuse_k)          # [N, k]
        ok = src_mask[:, None] & jnp.isfinite(d2) & (d2 <= r2)
        w = jnp.clip(1.0 - jnp.sqrt(jnp.maximum(d2, 0.0)) / radius, 1e-3, 1.0)
        w = jnp.where(ok, w, 0.0)
        wsum = jnp.sum(w, axis=1)
        has = wsum > 0                                            # ref: skip empty
        denom = jnp.maximum(wsum, 1e-6)
        mean_B = jnp.einsum("nk,nki->ni", w, tgt[idx]) / denom[:, None]
        cov_B = jnp.einsum("nk,nkij->nij", w, tgt_cov[idx]) / denom[:, None, None]
        R = m3.quat_to_mat(q)
        RCR = cov_B + jnp.einsum("ij,njk,lk->nil", R, src_cov, R)
        Minv = _inv3_sym(RCR)
        d = mean_B - Tp
        r = jnp.einsum("nij,nj->ni", Minv, d)                     # ref loss: M^-1 d
        # ref jlossexp = M^-1 [skew(Tp) | -I]  (fast_gicp_mp_impl.hpp:205-213)
        J = jnp.concatenate(
            [jnp.einsum("nij,njk->nik", Minv, m3.skew(Tp)), -Minv], axis=-1
        )                                                         # [N, 3, 6]
        wm = has.astype(dtype)
        H = jnp.einsum("n,nri,nrj->ij", wm, J, J)
        b = jnp.einsum("n,nri,nr->i", wm, J, r)
        cost = jnp.sum(wm * jnp.sum(r * r, axis=-1))
        return H, b, cost, jnp.sum(has)

    def is_converged(delta):
        dR = m3.quat_to_mat(m3.quat_exp(delta[:3])) - jnp.eye(3, dtype=dtype)
        return (
            jnp.maximum(
                jnp.max(jnp.abs(dR)) / cfg.rotation_epsilon,
                jnp.max(jnp.abs(delta[3:])) / cfg.translation_epsilon,
            )
            < 1.0
        )

    def cond(s):
        q, t, conv, it = s
        return (~conv) & (it < max_iters)

    def body(s):
        q, t, conv, it = s
        H, b, _, _ = linearize(q, t)
        delta = jnp.linalg.solve(H + 1e-9 * eye6, b)
        q_new = m3.quat_normalize(m3.quat_mul(m3.quat_exp(-delta[:3]), q))
        t_new = t - delta[3:]
        return (q_new, t_new, is_converged(delta), it + 1)

    s0 = (q0.astype(dtype), t0.astype(dtype), jnp.asarray(False),
          jnp.asarray(0, jnp.int32))
    q, t, conv, it = jax.lax.while_loop(cond, body, s0)
    H, b, cost, n = linearize(q, t)
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    d2, _ = knn_ops.knn(Tp, tgt, tgt_mask, 1)
    match = src_mask & (d2[:, 0] < r2)
    fit = jnp.where(match, d2[:, 0], 0.0).sum() / jnp.maximum(jnp.sum(match), 1)
    return RegistrationResult(q=q, t=t, fitness=fit, n_corr=n, iterations=it, H=H)


def build_ndt_voxelmap(
    pts: jax.Array, mask: jax.Array, resolution: float, cap: int,
    min_eig_ratio: float = 0.01, probes: int = 16, min_points: int = 5,
) -> VoxelMap:
    """NDT voxelmap: per-voxel mean + *positional* covariance with
    min-eigenvalue regularization (cuda/covariance_regularization.cu MIN_EIG;
    built for both sides of D2D and the target of P2D,
    ndt_cuda.cu:114-139).  Binning uses the GaussianVoxelMap half-shift so
    ``voxelmap_lookup`` (shared with the VGICP path) finds the right bins.
    ``min_points`` gates which voxels publish (reference: the derivative
    kernels skip target voxels with num_points <= 6,
    ndt_compute_derivatives.cu:60/132, while SOURCE voxels in D2D are used
    at any count — pass 1 for the source map)."""
    coords = vh.voxel_coords(pts, resolution, offset=0.5)
    keys = vh.pack_coords(coords, mask)
    ht = vh.build_hash_table(keys, cap, probes)
    slot = jnp.where(ht.slot_of_point >= 0, ht.slot_of_point, cap)
    w = jnp.where(slot < cap, 1.0, 0.0)
    counts = jax.ops.segment_sum(w, slot, num_segments=cap + 1)[:cap]
    s1 = jax.ops.segment_sum(pts * w[:, None], slot, num_segments=cap + 1)[:cap]
    denom = jnp.maximum(counts, 1.0)[:, None]
    mean = s1 / denom
    # second pass with per-voxel centering: the one-pass E[xx]-mm formula
    # cancels catastrophically in f32 at map-scale coordinates
    centered = pts - mean[jnp.clip(slot, 0, cap - 1)]
    cov = jax.ops.segment_sum(
        jnp.einsum("ni,nj->nij", centered, centered) * w[:, None, None],
        slot, num_segments=cap + 1,
    )[:cap] / denom[..., None]
    # min-eig floor relative to the largest eigenvalue
    from .covariance import eigh3x3

    evals, evecs = eigh3x3(cov + 1e-9 * jnp.eye(3, dtype=pts.dtype))
    floor = min_eig_ratio * evals[..., 2:3]
    evals = jnp.maximum(evals, floor)
    cov = jnp.einsum("...ik,...k,...jk->...ij", evecs, evals, evecs)
    # empty slots get identity covs so a masked gather can never leak NaN
    ok = counts >= min_points
    cov = jnp.where(ok[:, None, None], cov, jnp.eye(3, dtype=pts.dtype))
    return VoxelMap(
        keys=jnp.where(ok, ht.table_keys, vh.EMPTY),
        mean=jnp.where(ok[:, None], mean, 0.0),
        cov=cov,
        num_points=jnp.where(ok, counts, 0.0),
        resolution=jnp.asarray(resolution, pts.dtype),
    )


def ndt_register(
    src: jax.Array, src_mask: jax.Array,
    tgt: jax.Array, tgt_mask: jax.Array,
    q0: jax.Array, t0: jax.Array,
    cfg: SlamConfig,
    resolution: float = 1.0,
    max_iters: int = 30,
    distance_mode: str = "d2d",
) -> RegistrationResult:
    """NDTCuda (G13), both NDTDistanceMode variants (ndt_settings.hpp:6,
    ndt_cuda.cu:151-176):

      * "d2d" — source VOXEL Gaussians vs target voxel Gaussians,
        Mahalanobis (cov_B + R·cov_A·Rᵀ)⁻¹ with R frozen at the
        linearization pose (d2d kernel, ndt_compute_derivatives.cu:105-165;
        source voxels used at ANY count, ndt_cuda.cu:119-127).
      * "p2d" — source POINTS vs target voxel Gaussians, cov_B⁻¹ alone
        (p2d kernel, ndt_compute_derivatives.cu:33-103: the Biber IROS2003
        point-to-distribution MLE distance).

    Both gate target voxels at num_points > 6 and robustify with the
    pose-dependent Cauchy weight cauchy(resolution, |err|) recomputed at
    every evaluation (cauchy_k plumbing in the shared LM driver)."""
    vm = build_ndt_voxelmap(tgt, tgt_mask, resolution, cfg.max_voxels,
                            probes=cfg.hash_probes, min_points=7)
    eye = jnp.eye(3, dtype=src.dtype)
    if distance_mode == "d2d":
        svm = build_ndt_voxelmap(src, src_mask, resolution, cfg.max_voxels,
                                 probes=cfg.hash_probes, min_points=1)
        means, covs, mmask = svm.mean, svm.cov, svm.num_points > 0
    elif distance_mode == "p2d":
        means, covs, mmask = src, None, src_mask
    else:
        raise ValueError(f"unknown NDT distance_mode {distance_mode!r}")

    def corr_fn(q, t):
        Tp = m3.quat_rotate(q[None, :], means) + t[None, :]
        slots = vh.voxelmap_lookup(vm, Tp, cfg.hash_probes)
        found = (slots >= 0) & mmask
        sl = jnp.clip(slots, 0, vm.mean.shape[0] - 1)
        valid = found & (vm.num_points[sl] > 6)
        if covs is None:
            Minv = _inv3_sym(vm.cov[sl] + 1e-9 * eye)
        else:
            R = m3.quat_to_mat(q)
            RCR = jnp.einsum("ij,njk,lk->nil", R, covs, R)
            Minv = _inv3_sym(vm.cov[sl] + RCR + 1e-9 * eye)
        return Correspondences(
            mean_B=vm.mean[sl], Minv=Minv,
            w=valid.astype(src.dtype), valid=valid,
        )

    q, t, cost, n, it, H = _lm_drive(
        corr_fn, means, q0, t0, cfg, max_iters, cauchy_k=resolution
    )
    return RegistrationResult(
        q=q, t=t, fitness=cost / jnp.maximum(n, 1), n_corr=n, iterations=it, H=H
    )
