"""VGICP scan-to-submap registration — the JAX rebuild of fast_gicp.

Maps reference components (SURVEY §2.3):
  * G1 ``LsqRegistration`` Levenberg-Marquardt over SE(3)
    (impl/lsq_registration_impl.hpp:53-172)  ->  ``lm_register`` below, a
    ``lax.while_loop`` with the same λ-schedule (ρ gain ratio, ν doubling),
    so3_exp retraction and rot/trans convergence thresholds.
  * G4 ``FastVGICP`` voxelized correspondences + Mahalanobis D2D cost
    (impl/fast_vgicp_impl.hpp:73-180)  ->  ``vgicp_linearize``: voxel-hash
    lookup (DIRECT1), fused per-point residual/Jacobian/H/b computed batched
    and reduced with a single sum — the XLA analog of the OpenMP/thrust
    reductions (and of the unbuilt CUDA path G12).
  * G6-G12 CUDA backend  ->  this whole module *is* that accelerator design,
    re-expressed for XLA with static shapes.

Precision note: clouds stay f32; the 6x6 normal equations accumulate in f32
with residual centering (errors are O(voxel size)), and the tiny 6x6 solve is
done with an explicit Cholesky in f32 — conditioning is fine because the
Mahalanobis weights are bounded by the plane-regularized covariances.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..types import VoxelMap
from ..utils import math3d as m3
from . import voxelhash as vh


class RegistrationResult(NamedTuple):
    q: jax.Array              # [4] final rotation (target <- source)
    t: jax.Array              # [3] final translation
    fitness: jax.Array        # [] mean squared correspondence error (masked)
    n_corr: jax.Array         # [] number of correspondences at the solution
    iterations: jax.Array     # [] outer LM iterations executed
    H: jax.Array              # [6, 6] final Hessian (information matrix)


# ---------------------------------------------------------------------------
# linearization
# ---------------------------------------------------------------------------


def _solve6(H: jax.Array, b: jax.Array, damping: jax.Array) -> jax.Array:
    """Solve (H + damping*I) d = -b via Cholesky with jitter fallback."""
    A = H + damping * jnp.eye(6, dtype=H.dtype)
    L = jnp.linalg.cholesky(A + 1e-8 * jnp.eye(6, dtype=H.dtype))
    ok = jnp.all(jnp.isfinite(L))
    L = jnp.where(ok, L, jnp.eye(6, dtype=H.dtype))
    d = jax.scipy.linalg.cho_solve((L, True), -b)
    return jnp.where(ok, d, jnp.zeros(6, H.dtype))


def _inv3_sym(A: jax.Array) -> jax.Array:
    """Batched symmetric 3x3 inverse via adjugate (elementwise, batched)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e = A[..., 1, 1], A[..., 1, 2]
    f = A[..., 2, 2]
    A11 = d * f - e * e
    A12 = c * e - b * f
    A13 = b * e - c * d
    A22 = a * f - c * c
    A23 = b * c - a * e
    A33 = a * d - b * b
    det = a * A11 + b * A12 + c * A13
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    M = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A12, A22, A23], axis=-1),
            jnp.stack([A13, A23, A33], axis=-1),
        ],
        axis=-2,
    )
    return M * inv_det[..., None, None]


class Correspondences(NamedTuple):
    """Frozen correspondence set from one linearization point (the reference
    freezes ``voxel_correspondences_`` and ``voxel_mahalanobis_`` between
    ``linearize`` and the LM accept test ``compute_error`` —
    lsq_registration_impl.hpp:125-172, fast_vgicp_impl.hpp:182-214)."""

    mean_B: jax.Array         # [N, 3]
    Minv: jax.Array           # [N, 3, 3]
    w: jax.Array              # [N] sqrt(voxel count), 0 where invalid
    valid: jax.Array          # [N]


NEIGHBOR_OFFSETS = {
    # fast_vgicp's NeighborSearchMethod offset tables (fast_vgicp_voxel.hpp:94-128)
    1: [(0, 0, 0)],
    7: [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
        (0, 0, -1)],
    27: [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
         for dz in (-1, 0, 1)],
}


def find_correspondences(
    src: jax.Array,
    src_cov: jax.Array,
    src_mask: jax.Array,
    vm: VoxelMap,
    q: jax.Array,
    t: jax.Array,
    max_corr_dist: float,
    probes: int = 16,
    neighbors: int = 1,
) -> Correspondences:
    """Voxel lookup (DIRECT1/7/27) + Mahalanobis precompute at pose (q, t).

    With ``neighbors`` > 1 each source point matches the occupied voxels in
    its DIRECT-k neighborhood (arrays flattened to [N*k]) — the reference's
    multi-voxel correspondence mode that smooths voxel-discretization bias.
    """
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    offsets = jnp.asarray(NEIGHBOR_OFFSETS[neighbors], jnp.int32)  # [K, 3]
    coords = vh.voxel_coords(Tp, vm.resolution, offset=0.5)         # [N, 3]
    nb = coords[:, None, :] + offsets[None, :, :]                   # [N, K, 3]
    keys = vh.pack_coords(nb, src_mask[:, None])
    slots = vh.lookup_slots(vm.keys, keys.reshape(-1), probes)      # [N*K]
    found = (slots >= 0) & jnp.repeat(src_mask, offsets.shape[0])
    sl = jnp.clip(slots, 0, vm.mean.shape[0] - 1)
    Tp_r = jnp.repeat(Tp, offsets.shape[0], axis=0)                 # [N*K, 3]
    cov_r = jnp.repeat(src_cov, offsets.shape[0], axis=0)
    mean_B = vm.mean[sl]
    cov_B = vm.cov[sl]
    err = mean_B - Tp_r
    dist2 = jnp.sum(err * err, axis=-1)
    valid = found & (dist2 < max_corr_dist * max_corr_dist)
    w = jnp.where(valid, jnp.sqrt(jnp.maximum(vm.num_points[sl], 1.0)), 0.0)
    R = m3.quat_to_mat(q)
    RCA = jnp.einsum("ij,njk,lk->nil", R, cov_r, R)
    Minv = _inv3_sym(cov_B + RCA)
    return Correspondences(mean_B=mean_B, Minv=Minv, w=w, valid=valid)


def _expand_src(src: jax.Array, corr: Correspondences) -> jax.Array:
    """Repeat src to match multi-voxel correspondence arrays."""
    k = corr.mean_B.shape[0] // src.shape[0]
    return src if k == 1 else jnp.repeat(src, k, axis=0)


def _robust_w(w, err, cauchy_k):
    """Pose-dependent Cauchy robustifier used by the NDT kernels
    (ndt_compute_derivatives.cu:16-18: w = k²/(k² + |err|²) with k = the
    voxel resolution, recomputed at every evaluation pose — NOT frozen with
    the correspondences).  None = plain (VGICP/GICP) weighting."""
    if cauchy_k is None:
        return w
    k2 = jnp.asarray(cauchy_k * cauchy_k, err.dtype)
    return w * k2 / (k2 + jnp.sum(err * err, axis=-1))


def corr_cost(corr: Correspondences, src: jax.Array, q: jax.Array, t: jax.Array,
              psum_axis=None, cauchy_k=None):
    """Cost at (q, t) with frozen correspondences (ref ``compute_error``)."""
    src = _expand_src(src, corr)
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    err = corr.mean_B - Tp
    Me = jnp.einsum("nij,nj->ni", corr.Minv, err)
    cost = jnp.sum(_robust_w(corr.w, err, cauchy_k) * jnp.sum(err * Me, axis=-1))
    if psum_axis is not None:
        cost = jax.lax.psum(cost, psum_axis)
    return cost


def corr_linearize(corr: Correspondences, src: jax.Array, q: jax.Array, t: jax.Array,
                   psum_axis=None, cauchy_k=None):
    """H/b at (q, t) with frozen correspondences.  J = [skew(Tp) | -I].

    With ``psum_axis`` the local (point-sharded) partial sums are all-reduced
    over the named mesh axis — the device analog of the reference's OpenMP
    per-thread H/b partials merged at the end (fast_vgicp_impl.hpp:135-180).
    """
    src = _expand_src(src, corr)
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    err = corr.mean_B - Tp
    w, Minv = _robust_w(corr.w, err, cauchy_k), corr.Minv
    Me = jnp.einsum("nij,nj->ni", Minv, err)
    cost = jnp.sum(w * jnp.sum(err * Me, axis=-1))
    S = m3.skew(Tp)
    StM = jnp.einsum("nji,njk->nik", S, Minv)
    b = jnp.concatenate(
        [
            jnp.sum(w[:, None] * jnp.einsum("nik,nk->ni", StM, err), axis=0),
            jnp.sum(w[:, None] * (-Me), axis=0),
        ]
    )
    H_rr = jnp.einsum("n,nik,nkj->ij", w, StM, S)
    H_rt = -jnp.sum(w[:, None, None] * StM, axis=0)
    H_tt = jnp.einsum("n,nij->ij", w, Minv)
    H = jnp.block([[H_rr, H_rt], [H_rt.T, H_tt]])
    if psum_axis is not None:
        H = jax.lax.psum(H, psum_axis)
        b = jax.lax.psum(b, psum_axis)
        cost = jax.lax.psum(cost, psum_axis)
    return H, b, cost


def vgicp_linearize(
    src, src_cov, src_mask, vm, q, t, max_corr_dist, probes: int = 16,
    psum_axis=None, neighbors: int = 1,
):
    """Correspondence search + linearization at (q, t).  Returns (H, b, cost,
    n_corr, corr) with corr reusable for the LM accept test."""
    corr = find_correspondences(
        src, src_cov, src_mask, vm, q, t, max_corr_dist, probes, neighbors
    )
    H, b, cost = corr_linearize(corr, src, q, t, psum_axis)
    n = jnp.sum(corr.valid)
    if psum_axis is not None:
        n = jax.lax.psum(n, psum_axis)
    return H, b, cost, n, corr


def vgicp_fitness(src, src_mask, vm, q, t, max_corr_dist, probes: int = 16,
                  psum_axis=None):
    """Mean squared euclidean distance over matched points — the analog of
    ``pcl::Registration::getFitnessScore`` used as confidence ``vgicp_source``
    (RGC_odometer.cpp:1010)."""
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    slots = vh.voxelmap_lookup(vm, Tp, probes)
    found = (slots >= 0) & src_mask
    sl = jnp.clip(slots, 0, vm.mean.shape[0] - 1)
    err = vm.mean[sl] - Tp
    dist2 = jnp.sum(err * err, axis=-1)
    valid = found & (dist2 < max_corr_dist * max_corr_dist)
    n = jnp.sum(valid)
    tot = jnp.where(valid, dist2, 0.0).sum()
    if psum_axis is not None:
        n = jax.lax.psum(n, psum_axis)
        tot = jax.lax.psum(tot, psum_axis)
    return tot / jnp.maximum(n, 1), n


# ---------------------------------------------------------------------------
# LM driver (G1)
# ---------------------------------------------------------------------------


class _LMState(NamedTuple):
    q: jax.Array
    t: jax.Array
    lm_lambda: jax.Array
    converged: jax.Array
    it: jax.Array
    H: jax.Array
    # per-outer-iteration trace (parity instrument vs the C++ λ schedule,
    # tests/test_parity_oracles.py): cost at linearization, λ after the inner
    # loop, #rejected trials, accepted flag
    trace_y0: jax.Array       # [max_iterations]
    trace_lam: jax.Array      # [max_iterations]
    trace_rej: jax.Array      # [max_iterations] int32
    trace_acc: jax.Array      # [max_iterations] bool


def lm_register(
    src: jax.Array,
    src_cov: jax.Array,
    src_mask: jax.Array,
    vm: VoxelMap,
    q0: jax.Array,
    t0: jax.Array,
    cfg: SlamConfig,
    with_trace: bool = False,
):
    """FastVGICP::align — LM loop with the reference's λ schedule
    (lsq_registration_impl.hpp:125-172), jit-compiled via lax.while_loop.

    With ``with_trace=True`` (static) returns (result, trace dict of
    per-outer-iteration y0/λ/n_rejects/accepted arrays padded to
    ``vgicp_max_iterations``) for the λ-schedule parity test."""
    dtype = src.dtype
    max_corr = cfg.vgicp_max_corr_dist
    probes = cfg.hash_probes
    psum_axis = cfg.psum_axis

    def is_converged(dq, dt_):
        # reference compares |R - I| and |t| elementwise against epsilons
        dR = m3.quat_to_mat(dq) - jnp.eye(3, dtype=dtype)
        r_ok = jnp.max(jnp.abs(dR)) / cfg.rotation_epsilon
        t_ok = jnp.max(jnp.abs(dt_)) / cfg.translation_epsilon
        return jnp.maximum(r_ok, t_ok) < 1.0

    def outer_cond(s: _LMState):
        return (~s.converged) & (s.it < cfg.vgicp_max_iterations)

    def outer_body(s: _LMState):
        H, b, y0, _, corr = vgicp_linearize(
            src, src_cov, src_mask, vm, s.q, s.t, max_corr, probes, psum_axis,
            cfg.neighbor_search,
        )
        lam0 = jnp.where(
            s.lm_lambda < 0,
            cfg.lm_init_lambda_factor * jnp.max(jnp.abs(jnp.diag(H))),
            s.lm_lambda,
        )

        # inner LM: try/adapt lambda up to lm_max_inner times
        def inner_body(carry):
            lam, nu, done, q, t, conv, accepted = carry
            d = _solve6(H, b, lam)
            dq = m3.quat_exp(d[:3])
            dt_ = d[3:]
            q_new = m3.quat_normalize(m3.quat_mul(dq, s.q))
            t_new = m3.quat_rotate(dq, s.t) + dt_
            yi = corr_cost(corr, src, q_new, t_new, psum_axis)
            denom = jnp.dot(d, lam * d - b)
            rho = (y0 - yi) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
            accept = rho > 0
            conv_now = is_converged(dq, dt_)
            # on reject: inflate lambda; converged-on-reject also terminates
            lam_next = jnp.where(accept, lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), nu * lam)
            nu_next = jnp.where(accept, 2.0, 2.0 * nu)
            q_out = jnp.where(accept, q_new, q)
            t_out = jnp.where(accept, t_new, t)
            done_now = accept | conv_now
            return (
                lam_next,
                nu_next,
                done | done_now,
                q_out,
                t_out,
                conv | (accept & conv_now) | ((~accept) & conv_now),
                accepted | accept,
            )

        def inner_cond(carry):
            lam, nu, done, q, t, conv, accepted = carry
            return ~done

        init = (lam0, jnp.asarray(2.0, dtype), jnp.asarray(False), s.q, s.t,
                jnp.asarray(False), jnp.asarray(False))
        # bounded while: emulate `for i < lm_max_inner` with a counter
        def bounded_cond(c):
            (carry, k) = c
            return inner_cond(carry) & (k < cfg.lm_max_inner)

        def bounded_body(c):
            (carry, k) = c
            return (inner_body(carry), k + 1)

        ((lam, nu, done, q, t, conv, accepted), k) = jax.lax.while_loop(
            bounded_cond, bounded_body, (init, 0)
        )
        ti = jnp.clip(s.it, 0, cfg.vgicp_max_iterations - 1)
        return _LMState(
            q=q, t=t, lm_lambda=lam, converged=conv | (~accepted), it=s.it + 1, H=H,
            trace_y0=s.trace_y0.at[ti].set(y0),
            trace_lam=s.trace_lam.at[ti].set(lam),
            trace_rej=s.trace_rej.at[ti].set(k - accepted.astype(jnp.int32)),
            trace_acc=s.trace_acc.at[ti].set(accepted),
        )

    mi = cfg.vgicp_max_iterations
    s0 = _LMState(
        q=q0.astype(dtype),
        t=t0.astype(dtype),
        lm_lambda=jnp.asarray(-1.0, dtype),
        converged=jnp.asarray(False),
        it=jnp.asarray(0, jnp.int32),
        H=jnp.zeros((6, 6), dtype),
        trace_y0=jnp.full((mi,), jnp.nan, dtype),
        trace_lam=jnp.full((mi,), jnp.nan, dtype),
        trace_rej=jnp.zeros((mi,), jnp.int32),
        trace_acc=jnp.zeros((mi,), bool),
    )
    s = jax.lax.while_loop(outer_cond, outer_body, s0)
    mean_d2, n_corr = vgicp_fitness(src, src_mask, vm, s.q, s.t, max_corr, probes, psum_axis)
    # fitness: mean squared euclidean distance of matched points, like
    # pcl::Registration::getFitnessScore (used as confidence `vgicp_source`)
    result = RegistrationResult(
        q=s.q, t=s.t, fitness=mean_d2, n_corr=n_corr, iterations=s.it, H=s.H
    )
    if with_trace:
        return result, {
            "y0": s.trace_y0, "lam_after": s.trace_lam,
            "n_rejects": s.trace_rej, "accepted": s.trace_acc,
            "n_outer": s.it,
        }
    return result
