"""Mapping back-end: the JAX rebuild of the `RGC_mapping` node (A12-A13).

One jit-compiled step (SURVEY §3.3): surrounding-keyframe map assembly →
two-pose scan-to-map optimization (corner line fits + surf plane fits for the
current AND previous frames, IMU relative-rotation, absolute pitch/roll and
ground-plane factors) → map→odom transform update → keyframe gating.

Reference mechanics rebuilt here:
  * kd-tree 15 m radius keyframe extraction + cached submap assembly
    (RGC_mapping.cpp:1503-1616)  ->  top-K nearest keyframes by distance
    matrix, gathered and voxel-downsampled with static caps.
  * per-point 5-NN line/plane association (RGC_mapping.cpp:1093-1283)  ->
    batched brute-force knn + closed-form 3x3 eigen / normal-equation plane fits.
  * joint (q,t,q_last,t_last) Ceres solve with Huber(0.1) on lidar factors
    (RGC_mapping.cpp:1076-1354)  ->  12-dim tangent Gauss-Newton with frozen
    correspondences per outer iteration (2 outer x 6 inner like the ref).
  * groundidentify state machine (RGC_mapping.cpp:1723-1809).
  * saveKeyframeAndOdomFactor gating (RGC_mapping.cpp:1839-1943).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..types import GroundPlane
from ..utils import math3d as m3
from ..ops import factors as fac
from ..ops import knn as knn_ops
from ..ops import voxelhash as vh
from ..ops.covariance import eigh3x3
from ..utils import pytree
from .odometry import OdometryOutput

HIST_CAP = 64
RAD2DEG = 57.29577951308232

# Keyframe-store compaction headroom: when loop closure is enabled the
# compaction runs inside loop_closure_step, which the host must call at least
# every COMPACT_MARGIN scans (SlamSystem: every 10) so the store never hits
# capacity between calls.  At most one keyframe is added per scan.
COMPACT_MARGIN = 16


def worst_cadence_gap(loop_cadence: int, chunk: int) -> int:
    """Max scans between loop-closure/compaction opportunities when the
    cadence is only evaluated at chunk boundaries (SlamSystem.process_chunk,
    parallel.fleet.make_fleet_chunk_step's single-cond program).

    A cadence boundary ``b`` fires at the next chunk multiple, i.e.
    ``(-b) % chunk`` scans late.  With ``chunk >= loop_cadence`` every chunk
    contains a boundary, so firings come every ``chunk`` scans.  Otherwise,
    with ``r = loop_cadence % chunk != 0``, the delay shrinks by ``r`` per
    boundary until it wraps up by ``chunk - r``, so the worst gap is
    ``loop_cadence + chunk - r`` (e.g. cadence 10, chunk 8: delays cycle
    6,4,2,0 — max gap 16); a divisor chunk keeps the exact cadence.
    Safe iff the result is <= COMPACT_MARGIN: compaction leaves
    COMPACT_MARGIN free slots, one keyframe is added per scan, and the
    scan that fires also adds its keyframe before the loop call runs."""
    chunk = max(chunk, 1)
    if chunk >= loop_cadence:
        return chunk
    r = loop_cadence % chunk
    return loop_cadence + (chunk - r if r else 0)


@pytree.dataclass
class MappingState:
    # map -> odom correction (RGC_mapping.cpp transformUpdate)
    q_md: jax.Array           # [4] q_wmap_wodom
    t_md: jax.Array           # [3]

    # previous mapping results
    q_w_last: jax.Array
    t_w_last: jax.Array
    q_w_last2: jax.Array
    t_w_last2: jax.Array

    # previous-frame feature clouds (sensor frame, downsampled)
    last_corner: jax.Array    # [C, 3]
    last_corner_conf: jax.Array
    last_corner_mask: jax.Array
    last_surf: jax.Array      # [S, 3]
    last_surf_conf: jax.Array
    last_surf_mask: jax.Array

    # ground machine
    ground_last: GroundPlane
    ground_last2: GroundPlane
    gflag: jax.Array
    change_count: jax.Array
    q_w_delta: jax.Array
    hist_q: jax.Array         # [HIST_CAP, 4]
    hist_count: jax.Array

    imu_ypr_last: jax.Array   # [3] previous scan's IMU attitude (rad)
    count: jax.Array          # [] mapping_count

    # keyframe store
    kf_q: jax.Array           # [K, 4]
    kf_t: jax.Array           # [K, 3]
    kf_stamp: jax.Array       # [K]
    kf_travel: jax.Array      # [K] cumulative travel distance at creation
    kf_corner: jax.Array      # [K, C, 3] sensor frame
    kf_corner_conf: jax.Array # [K, C]
    kf_corner_mask: jax.Array # [K, C]
    kf_surf: jax.Array        # [K, S, 3]
    kf_surf_conf: jax.Array   # [K, S]
    kf_surf_mask: jax.Array   # [K, S]
    kf_count: jax.Array       # []
    travel_dist: jax.Array    # [] cumulative distance

    @classmethod
    def init(cls, cfg: SlamConfig, dtype=jnp.float32) -> "MappingState":
        K, C, S = cfg.max_keyframes, cfg.max_kf_corner, cfg.max_kf_surf
        qi = m3.quat_identity(dtype)
        return cls(
            q_md=qi, t_md=jnp.zeros(3, dtype),
            q_w_last=qi, t_w_last=jnp.zeros(3, dtype),
            q_w_last2=qi, t_w_last2=jnp.zeros(3, dtype),
            last_corner=jnp.zeros((C, 3), dtype),
            last_corner_conf=jnp.zeros((C,), dtype),
            last_corner_mask=jnp.zeros((C,), bool),
            last_surf=jnp.zeros((S, 3), dtype),
            last_surf_conf=jnp.zeros((S,), dtype),
            last_surf_mask=jnp.zeros((S,), bool),
            ground_last=GroundPlane.default(cfg.lidar_height, dtype),
            ground_last2=GroundPlane.default(cfg.lidar_height, dtype),
            gflag=jnp.asarray(0, jnp.int32),
            change_count=jnp.asarray(0, jnp.int32),
            q_w_delta=qi,
            hist_q=jnp.tile(qi, (HIST_CAP, 1)),
            hist_count=jnp.asarray(0, jnp.int32),
            imu_ypr_last=jnp.zeros(3, dtype),
            count=jnp.asarray(0, jnp.int32),
            kf_q=jnp.tile(qi, (K, 1)),
            kf_t=jnp.zeros((K, 3), dtype),
            kf_stamp=jnp.zeros((K,), dtype),
            kf_travel=jnp.zeros((K,), dtype),
            kf_corner=jnp.zeros((K, C, 3), dtype),
            kf_corner_conf=jnp.zeros((K, C), dtype),
            kf_corner_mask=jnp.zeros((K, C), bool),
            kf_surf=jnp.zeros((K, S, 3), dtype),
            kf_surf_conf=jnp.zeros((K, S), dtype),
            kf_surf_mask=jnp.zeros((K, S), bool),
            kf_count=jnp.asarray(0, jnp.int32),
            travel_dist=jnp.asarray(0.0, dtype),
        )


class MappingOutput(NamedTuple):
    q_w: jax.Array            # mapped world pose
    t_w: jax.Array
    q_md: jax.Array           # map->odom correction
    t_md: jax.Array
    kf_added: jax.Array       # [] bool
    n_corner_factors: jax.Array
    n_surf_factors: jax.Array


# ---------------------------------------------------------------------------
# keyframe-store compaction (long-session eviction)
# ---------------------------------------------------------------------------


def compact_keyframe_store(ms: MappingState, protect: jax.Array | None = None):
    """Free keyframe capacity by thinning the oldest half of the store.

    The reference's keyframe containers are unbounded std::maps
    (RGC_mapping.cpp:1839-1943); a static-shape store must evict.  Eviction =
    every other unprotected keyframe among the oldest half (temporal
    decimation): distant history keeps spatial coverage for loop closure at
    half density while the recent half — the working set of the local map —
    stays intact.  Temporal order is preserved, so the PGO odometry chain
    (rebuilt from current poses each solve) stays valid across compactions.

    ``protect`` ([K] bool) marks keyframes that must survive (loop anchors).
    If protection leaves nothing evictable, the unprotected rule is applied
    regardless and the caller must drop loop constraints whose endpoints died
    (see loop._maybe_compact).

    Returns (ms, keep [K] bool over OLD indices, new_of_old [K] int32).
    All-gather implementation: jit/vmap-safe, runs under lax.cond.
    """
    K = ms.kf_q.shape[0]
    idx = jnp.arange(K)
    valid = idx < ms.kf_count
    old_half = idx < (ms.kf_count - K // 2)

    def every_other(elig):
        rank = jnp.cumsum(elig.astype(jnp.int32)) - 1
        return elig & (rank % 2 == 1)

    prot = jnp.zeros(K, bool) if protect is None else protect
    evict1 = every_other(valid & old_half & ~prot)
    evict2 = every_other(valid & old_half)
    evict = jnp.where(jnp.sum(evict1) > 0, evict1, evict2)
    keep = valid & ~evict
    new_of_old = jnp.cumsum(keep.astype(jnp.int32)) - 1
    # kept entries packed to the front in temporal order; dead slots behind
    src = jnp.argsort(jnp.where(keep, idx, K + idx))
    ms = ms.replace(
        kf_q=ms.kf_q[src],
        kf_t=ms.kf_t[src],
        kf_stamp=ms.kf_stamp[src],
        kf_travel=ms.kf_travel[src],
        kf_corner=ms.kf_corner[src],
        kf_corner_conf=ms.kf_corner_conf[src],
        kf_corner_mask=ms.kf_corner_mask[src],
        kf_surf=ms.kf_surf[src],
        kf_surf_conf=ms.kf_surf_conf[src],
        kf_surf_mask=ms.kf_surf_mask[src],
        kf_count=jnp.sum(keep).astype(jnp.int32),
    )
    return ms, keep, new_of_old


# ---------------------------------------------------------------------------
# local map assembly
# ---------------------------------------------------------------------------


def assemble_local_map(state: MappingState, t_center: jax.Array, cfg: SlamConfig):
    """Top-K nearest keyframes within the search radius -> world-frame corner
    and surf maps, voxel-downsampled (replaces RGC_mapping.cpp:1503-1616).

    cfg.surrounding_keyframes bounds the gather; the reference takes ALL
    keyframes within 15 m (RGC_mapping.cpp:1536-1548) — the default of 32
    covers that radius at the 0.5 m keyframe gate for revisit-heavy maps."""
    K = state.kf_q.shape[0]
    k_near = min(cfg.surrounding_keyframes, K)
    kf_valid = jnp.arange(K) < state.kf_count
    d = jnp.linalg.norm(state.kf_t - t_center[None, :], axis=-1)
    d = jnp.where(kf_valid, d, jnp.inf)
    neg, sel = jax.lax.top_k(-d, k_near)
    sel_ok = (-neg) < cfg.surrounding_radius

    def gather(cloud, conf, mask):
        # [k_near, P, 3] world-frame
        q = state.kf_q[sel]
        t = state.kf_t[sel]
        pts = m3.quat_rotate(q[:, None, :], cloud[sel]) + t[:, None, :]
        msk = mask[sel] & sel_ok[:, None]
        P = pts.shape[1]
        return (
            pts.reshape(k_near * P, 3),
            conf[sel].reshape(k_near * P),
            msk.reshape(k_near * P),
        )

    c_pts, c_conf, c_mask = gather(
        state.kf_corner, state.kf_corner_conf, state.kf_corner_mask
    )
    s_pts, s_conf, s_mask = gather(
        state.kf_surf, state.kf_surf_conf, state.kf_surf_mask
    )
    # origin-shift for packable voxel coords, then downsample
    origin = jnp.floor(t_center)
    cm_pts, cm_mask, _ = vh.voxel_downsample(
        c_pts - origin, c_mask, cfg.map_corner_voxel, cfg.max_map_points // 4,
        probes=cfg.hash_probes,
    )
    sm_pts, sm_mask, _ = vh.voxel_downsample(
        s_pts - origin, s_mask, cfg.map_surf_voxel, cfg.max_map_points,
        probes=cfg.hash_probes,
    )
    return cm_pts + origin, cm_mask, sm_pts + origin, sm_mask


# ---------------------------------------------------------------------------
# correspondence fits (frozen per outer iteration)
# ---------------------------------------------------------------------------


class EdgeCorr(NamedTuple):
    pa: jax.Array             # [N, 3] line endpoint a (world)
    pb: jax.Array             # [N, 3]
    w: jax.Array              # [N] confidence (0 = invalid)


class PlaneCorr(NamedTuple):
    n: jax.Array              # [N, 3] unit normal
    d: jax.Array              # [N] offset
    w: jax.Array              # [N]


def edge_correspondences(pts_world, conf, mask, map_pts, map_mask, cfg):
    """5-NN PCA line fit per corner point (RGC_mapping.cpp:1097-1139)."""
    k = cfg.map_knn
    d2, idx = knn_ops.knn(pts_world, map_pts, map_mask, k)
    near = map_pts[idx]                                   # [N, k, 3]
    center = jnp.mean(near, axis=1)
    dd = near - center[:, None, :]
    cov = jnp.einsum("nki,nkj->nij", dd, dd)
    evals, evecs = eigh3x3(cov)
    unit = evecs[..., 2]                                  # largest eigvec
    is_line = evals[..., 2] > 3.0 * evals[..., 1]
    ok = mask & (d2[:, k - 1] < 1.0) & is_line
    pa = center + 0.1 * unit
    pb = center - 0.1 * unit
    return EdgeCorr(pa=pa, pb=pb, w=jnp.where(ok, conf, 0.0))


def _lstsq_qr(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched Householder-QR least squares: min ||A x - b|| for [N, k, m].

    The reference solves the plane fit with colPivHouseholderQr
    (RGC_mapping.cpp:1206) whose f.p. error grows with κ(A); the previous
    normal-equations solve grew with κ(A)² — for a 5-NN neighborhood of a
    plane far from the origin κ(A) ≈ |centroid|/noise can reach ~3e3, so
    κ² ≈ 1e7 swamped f32 entirely (measured: normals 30°+ wrong, valid wall
    points silently rejected by the 0.2 residual gate).  k and m are static
    (5 and 3): the reflections and back-substitution unroll into elementwise
    ops + tiny einsums — vmap/shard-safe, no custom calls."""
    N, k, m = A.shape
    R = A
    y = b
    rows = jnp.arange(k)
    for j in range(m):
        col = R[:, :, j]
        v = jnp.where(rows[None, :] >= j, col, jnp.zeros_like(col))
        alpha = jnp.linalg.norm(v, axis=1)
        sign = jnp.where(col[:, j] >= 0, 1.0, -1.0).astype(A.dtype)
        v = v.at[:, j].add(sign * alpha)
        vnorm2 = jnp.maximum(jnp.sum(v * v, axis=1, keepdims=True), 1e-30)
        coef = 2.0 / vnorm2
        proj = jnp.einsum("nk,nkm->nm", v, R) * coef
        R = R - v[:, :, None] * proj[:, None, :]
        y = y - v * (jnp.sum(v * y, axis=1, keepdims=True) * coef)
    x = jnp.zeros((N, m), A.dtype)
    for i in reversed(range(m)):
        num = y[:, i]
        if i + 1 < m:
            num = num - jnp.einsum("nj,nj->n", R[:, i, i + 1:], x[:, i + 1:])
        diag = R[:, i, i]
        safe = jnp.where(jnp.abs(diag) > 1e-20, diag, 1e-20)
        x = x.at[:, i].set(num / safe)
    return x


def plane_correspondences(pts_world, conf, mask, map_pts, map_mask, cfg):
    """5-NN plane fit solving A n = -1 by QR (RGC_mapping.cpp:1191-1283)."""
    k = cfg.map_knn
    d2, idx = knn_ops.knn(pts_world, map_pts, map_mask, k)
    A = map_pts[idx]                                      # [N, k, 3]
    n_raw = _lstsq_qr(A, -jnp.ones(A.shape[:2], A.dtype))
    nnorm = jnp.linalg.norm(n_raw, axis=-1)
    d = 1.0 / jnp.maximum(nnorm, 1e-9)
    n = n_raw / jnp.maximum(nnorm, 1e-9)[:, None]
    fit_ok = jnp.all(
        jnp.abs(jnp.einsum("nki,ni->nk", A, n) + d[:, None]) <= 0.2, axis=1
    )
    ok = mask & (d2[:, k - 1] < 2.0) & fit_ok
    return PlaneCorr(n=n, d=d, w=jnp.where(ok, conf, 0.0))


def _huber_weight(r2: jax.Array, delta: float = 0.1,
                  loss: str = "huber") -> jax.Array:
    """sqrt of Ceres HuberLoss rho'(s): w=1 for |r|<=delta, delta/|r| beyond.

    loss="huber" (reference parity, default): Huber has rho'' <= 0
    everywhere, so Ceres's loss corrector scales BOTH the residual and the
    jacobian by sqrt(rho') WITHOUT differentiating through the weight
    (corrector.cc's alpha=0 branch) — hence the stop_gradient; letting
    autodiff see the weight would bend the GN direction away from Ceres's.

    loss="l1" (documented deviation, cfg.mapping_loss): let autodiff
    differentiate through the weight.  GN on v(r) = √(δ/|r|)·r is exactly
    GN on ½Σδ|r| — an L1 M-estimator with harder outlier suppression than
    Huber's.  Measured: the degenerate-corridor stress scene (grazing-wall
    viewpoint-dependent picks) tracks at 0.20 m ATE under L1 vs 0.66 m
    under reference-exact Huber (tests/test_stress_configs.py)."""
    r = jnp.sqrt(jnp.maximum(r2, 1e-12))
    w = jnp.sqrt(jnp.where(r <= delta, 1.0, delta / r))
    if loss == "l1":
        return w
    return jax.lax.stop_gradient(w)


def _edge_residuals(q, t, pts, corr: EdgeCorr, loss: str = "huber"):
    lp = m3.quat_rotate(q[None, :], pts) + t[None, :]
    nu = jnp.cross(lp - corr.pa, lp - corr.pb)
    de = jnp.linalg.norm(corr.pa - corr.pb, axis=-1, keepdims=True)
    r = nu / jnp.maximum(de, 1e-9) * corr.w[:, None]
    hw = _huber_weight(jnp.sum(r * r, axis=-1), loss=loss)
    return (r * hw[:, None]).reshape(-1)


def _plane_residuals(q, t, pts, corr: PlaneCorr, loss: str = "huber"):
    pw = m3.quat_rotate(q[None, :], pts) + t[None, :]
    r = (jnp.einsum("ni,ni->n", pw, corr.n) + corr.d) * corr.w
    hw = _huber_weight(r * r, loss=loss)
    return r * hw


# ---------------------------------------------------------------------------
# the two-pose scan-to-map solve (extracted so the parity oracle can drive it
# directly on a fixed synthetic map — VERDICT r3 item 2)
# ---------------------------------------------------------------------------


def scan_to_map_solve(
    q0, t0, ql0, tl0,
    corner_q, corner_q_conf, corner_q_mask,
    cornl_q, cornl_q_conf, cornl_q_mask,
    surf_q, surf_q_conf, surf_q_mask,
    surfl_q, surfl_q_conf, surfl_q_mask,
    cm_pts, cm_mask, sm_pts, sm_mask,
    delta_q_imu, imu_cov, w_imu, imu_ypr, imu_ypr_last,
    ground_last: GroundPlane, ground_cur: GroundPlane,
    ground_last2: GroundPlane, q_w_last2, t_w_last2,
    q_w_curr_f, q_w_curr_f2, w_ground,
    rep_scale, gn_axis, cfg: SlamConfig,
    debug: bool = False,
):
    """The reference's two-outer-iteration joint (q,t,q_last,t_last) Ceres
    solve (RGC_mapping.cpp:1076-1354): per outer iteration the four clouds
    re-associate (5-NN line/plane fits, frozen for the inner solve), then a
    12-dim tangent Gauss-Newton runs 6 inner iterations (the reference's
    DENSE_QR max_num_iterations=6) over the corner/surf Huber(0.1) factors
    plus the NULL-loss RelativeR / PitchRoll / Ground_DeltaFactor_goable
    factors.

    The ground factor on the CURRENT pose snapshots the LAST pose at problem
    creation (last_q_q/last_t_t, RGC_mapping.cpp:1322-1326): the reference's
    q_w_last is an Eigen::Map onto para_q_last, so outer iteration 1 captures
    the outer-0-optimized last pose — hence the snapshot comes from the
    carry, not the pre-step state.

    Returns ((q, t, ql, tl), (n_edge[outer], n_plane[outer]), dbg) where dbg
    (debug=True only) carries the per-outer frozen correspondence sets for
    the parity oracle to compare against.
    """

    def outer(carry, _):
        q, t, ql, tl = carry
        pw_c = m3.quat_rotate(q[None, :], corner_q) + t[None, :]
        pw_cl = m3.quat_rotate(ql[None, :], cornl_q) + tl[None, :]
        pw_s = m3.quat_rotate(q[None, :], surf_q) + t[None, :]
        pw_sl = m3.quat_rotate(ql[None, :], surfl_q) + tl[None, :]

        ec = edge_correspondences(pw_c, corner_q_conf, corner_q_mask, cm_pts, cm_mask, cfg)
        ecl = edge_correspondences(
            pw_cl, cornl_q_conf, cornl_q_mask, cm_pts, cm_mask, cfg
        )
        pc = plane_correspondences(pw_s, surf_q_conf, surf_q_mask, sm_pts, sm_mask, cfg)
        pcl = plane_correspondences(
            pw_sl, surfl_q_conf, surfl_q_mask, sm_pts, sm_mask, cfg
        )

        def unpack(delta):
            qc = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[0:3]), q))
            tc = t + delta[3:6]
            qlc = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[6:9]), ql))
            tlc = tl + delta[9:12]
            return qc, tc, qlc, tlc

        def lidar_residuals(delta):
            qc, tc, qlc, tlc = unpack(delta)
            loss = cfg.mapping_loss
            return jnp.concatenate(
                [
                    _edge_residuals(qc, tc, corner_q, ec, loss),
                    _edge_residuals(qlc, tlc, cornl_q, ecl, loss),
                    _plane_residuals(qc, tc, surf_q, pc, loss),
                    _plane_residuals(qlc, tlc, surfl_q, pcl, loss),
                ]
            )

        def other_residuals(delta):
            qc, tc, qlc, tlc = unpack(delta)
            # non-lidar factors are replicated on every sp device: rep_scale
            # (rsqrt(n_sp)) makes the psum'd H/g count them exactly once
            return jnp.concatenate([
                fac.relative_r_residual(qlc, qc, delta_q_imu, imu_cov)
                * (w_imu * rep_scale),
                fac.pitchroll_residual(qc, imu_ypr[1], imu_ypr[2], 0.02)
                * (w_imu * rep_scale),
                fac.pitchroll_residual(
                    qlc, imu_ypr_last[1], imu_ypr_last[2], 0.02
                ) * (w_imu * rep_scale),
                fac.ground_goable_residual(
                    qc, tc, ql, tl,
                    ground_last, ground_cur, q_w_curr_f, 0.2,
                ) * (w_ground * rep_scale),
                fac.ground_goable_residual(
                    qlc, tlc, q_w_last2, t_w_last2,
                    ground_last2, ground_last, q_w_curr_f2, 0.2,
                ) * (w_ground * rep_scale),
            ])

        def residuals(delta):
            return jnp.concatenate(
                [lidar_residuals(delta), other_residuals(delta)]
            )

        def ceres_cost(delta):
            """TRUE robust cost 0.5·Σ rho(s) for the trust-region accept
            test: HuberLoss(0.1) on the lidar blocks' squared norms, identity
            on the NULL-loss factors (Ceres evaluates exactly this;
            Σ(√rho'·r)² would under-count outliers by up to 2x)."""
            qc, tc, qlc, tlc = unpack(delta)

            def edge_s(qq, tt, pts, corr):
                lp = m3.quat_rotate(qq[None, :], pts) + tt[None, :]
                nu = jnp.cross(lp - corr.pa, lp - corr.pb)
                de = jnp.linalg.norm(corr.pa - corr.pb, axis=-1, keepdims=True)
                r = nu / jnp.maximum(de, 1e-9) * corr.w[:, None]
                return jnp.sum(r * r, axis=-1)

            def plane_s(qq, tt, pts, corr):
                pw = m3.quat_rotate(qq[None, :], pts) + tt[None, :]
                r = (jnp.einsum("ni,ni->n", pw, corr.n) + corr.d) * corr.w
                return r * r

            s_lidar = jnp.concatenate([
                edge_s(qc, tc, corner_q, ec),
                edge_s(qlc, tlc, cornl_q, ecl),
                plane_s(qc, tc, surf_q, pc),
                plane_s(qlc, tlc, surfl_q, pcl),
            ])
            ro = other_residuals(delta)
            if cfg.mapping_loss == "l1":
                # the l1 weights only deviate from plain LS OUTSIDE the
                # |r|<=delta band (_huber_weight), so the objective the
                # weighted GN direction actually descends is piecewise
                # s / delta*sqrt(s) (continuous at s=delta^2) — the accept
                # test must measure THAT cost, not delta*sqrt(s) everywhere,
                # or inlier-dominated trust-region ratios compare an L1
                # true-decrease against a quadratic model prediction
                rho = jnp.where(
                    s_lidar <= 0.01,
                    s_lidar,
                    0.1 * jnp.sqrt(jnp.maximum(s_lidar, 1e-30)),
                )
            else:
                rho = fac.huber_rho(s_lidar)
            return 0.5 * (jnp.sum(rho) + jnp.sum(ro * ro))

        if cfg.degeneracy_thresh > 0:
            P, _ = fac.degeneracy_projection(
                lidar_residuals, 12, cfg.degeneracy_thresh, psum_axis=gn_axis
            )
        else:
            P = None
        delta = fac.ceres_lm(
            residuals, ceres_cost, 12, iterations=6, project=P,
            psum_axis=gn_axis,
        )
        q = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[0:3]), q))
        t = t + delta[3:6]
        ql = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[6:9]), ql))
        tl = tl + delta[9:12]
        n_edge = jnp.sum(ec.w > 0)
        n_plane = jnp.sum(pc.w > 0)
        if gn_axis is not None:
            n_edge = jax.lax.psum(n_edge, gn_axis)
            n_plane = jax.lax.psum(n_plane, gn_axis)
        ys = (n_edge, n_plane)
        if debug:
            ys = ys + (ec, ecl, pc, pcl, (q, t, ql, tl))
        return (q, t, ql, tl), ys

    (q_opt, t_opt, ql_opt, tl_opt), ys = jax.lax.scan(
        outer, (q0, t0, ql0, tl0), None, length=cfg.map_opt_iterations,
    )
    ne, np_ = ys[0], ys[1]
    dbg = ys[2:] if debug else None
    return (q_opt, t_opt, ql_opt, tl_opt), (ne, np_), dbg


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def mapping_step(
    state: MappingState,
    odo: OdometryOutput,
    corner_xyz: jax.Array,     # [C,3] current DS corner cloud (sensor frame)
    corner_conf: jax.Array,
    corner_mask: jax.Array,
    surf_xyz: jax.Array,       # [S,3]
    surf_conf: jax.Array,
    surf_mask: jax.Array,
    imu_ypr: jax.Array,        # [3] current IMU attitude (rad)
    stamp: jax.Array,
    cfg: SlamConfig,
):
    dtype = state.t_md.dtype
    ground_cur = odo.ground

    # ---- initial guess: odom pose lifted by map->odom ----
    q0 = m3.quat_normalize(m3.quat_mul(state.q_md, odo.q_w))
    t0 = state.t_md + m3.quat_rotate(state.q_md, odo.t_w)

    # ---- groundidentify (mapping-side machine) ----
    early = state.count <= 20
    push_early = early
    q_lc = m3.quat_mul(m3.quat_conj(state.q_w_last), q0)
    t_lc = m3.quat_rotate(m3.quat_conj(state.q_w_last), t0 - state.t_w_last)
    gnorm_c = m3.quat_rotate(q_lc, ground_cur.normal)
    gdist_c = ground_cur.distance + jnp.dot(gnorm_c, t_lc)
    gerr1 = jnp.linalg.norm(
        state.ground_last.distance * state.ground_last.normal - gdist_c * gnorm_c
    )
    gerr2 = jnp.abs(jnp.dot(state.ground_last.v1, gnorm_c))
    d_ypr_deg = m3.mat_to_ypr(m3.quat_to_mat(odo.delta_q_imu)) * RAD2DEG
    change = (~early) & (gerr1 >= 0.02) & (gerr2 >= 0.02) & (jnp.abs(d_ypr_deg[1]) > 0.5)
    gflag = jnp.where(change, 1, state.gflag)
    ccount = jnp.where(change, 0, state.change_count)
    ccount = jnp.where(gflag == 1, ccount + 1, ccount)
    resolve = (gflag == 1) & (ccount >= 25)
    now_ypr = m3.mat_to_ypr(m3.quat_to_mat(q0)) * RAD2DEG
    hist_ypr = m3.mat_to_ypr(m3.quat_to_mat(state.hist_q)) * RAD2DEG
    hvalid = jnp.arange(HIST_CAP) < state.hist_count
    pr = jnp.sqrt((hist_ypr[:, 1] - now_ypr[1]) ** 2 + (hist_ypr[:, 2] - now_ypr[2]) ** 2)
    pr = jnp.where(hvalid, pr, jnp.inf)
    bi = jnp.argmin(pr)
    found = pr[bi] < 6.0
    q_w_delta = jnp.where(resolve, jnp.where(found, state.hist_q[bi], q0), state.q_w_delta)
    push = push_early | (resolve & ~found)
    hist_q = jnp.where(
        push,
        state.hist_q.at[jnp.mod(state.hist_count, HIST_CAP)].set(
            jnp.where(early, state.q_w_last, q0)
        ),
        state.hist_q,
    )
    hist_count = jnp.where(push, state.hist_count + 1, state.hist_count)
    gflag = jnp.where(resolve, 0, gflag)
    q_w_curr_f = m3.quat_normalize(m3.quat_mul(m3.quat_conj(q_w_delta), state.q_w_last))
    q_w_curr_f2 = m3.quat_normalize(m3.quat_mul(m3.quat_conj(q_w_delta), state.q_w_last2))

    # ---- local map ----
    cm_pts, cm_mask, sm_pts, sm_mask = assemble_local_map(state, t0, cfg)

    n_corner = jnp.sum(corner_mask)
    n_surf = jnp.sum(surf_mask)
    n_cm = jnp.sum(cm_mask)
    n_sm = jnp.sum(sm_mask)
    do_opt = (
        (n_corner > 10) & (n_surf > 50) & (n_cm > 10) & (n_sm > 50)
    )

    # ---- IMU factor covariances (RGC_mapping.cpp:1285-1311); both factor
    # families are disabled in localization mode like the reference's
    # ``map_update != 0`` gates ----
    imu_cov = jnp.where(jnp.linalg.norm(d_ypr_deg) > 0.6, 0.004, 0.4)
    w_imu = jnp.asarray(1.0 if (cfg.use_imu and cfg.map_update) else 0.0, dtype)
    ground_on = (
        cfg.use_ground & cfg.map_update & (gflag == 0) & (state.count > 20)
        & ground_cur.valid & state.ground_last.valid
    )
    w_ground = jnp.where(ground_on, 1.0, 0.0).astype(dtype)

    # ---- sp point sharding (VERDICT r2 item 4): each device associates and
    # linearizes a BLOCK SLICE of the query points of all four clouds — the
    # kNN distance matrices and line/plane fits shrink by the shard count
    # (the reference's OpenMP point loops, RGC_mapping.cpp:1093-1283) — and
    # the 12-dim GN H/g partials are psum-reduced.  Factors replicated on
    # every device are pre-scaled by rsqrt(n_sp) so the psum counts them
    # once.  The keyframe store below keeps the FULL clouds, so state stays
    # replica-consistent.
    n_sp = cfg.sp_shards if cfg.psum_axis is not None else 1
    if n_sp > 1:
        def shard_slice(pts, conf, mask):
            per = pts.shape[0] // n_sp
            start = jax.lax.axis_index(cfg.psum_axis) * per
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, per)
            return sl(pts), sl(conf), sl(mask)

        corner_q, corner_q_conf, corner_q_mask = shard_slice(
            corner_xyz, corner_conf, corner_mask
        )
        cornl_q, cornl_q_conf, cornl_q_mask = shard_slice(
            state.last_corner, state.last_corner_conf, state.last_corner_mask
        )
        surf_q, surf_q_conf, surf_q_mask = shard_slice(surf_xyz, surf_conf, surf_mask)
        surfl_q, surfl_q_conf, surfl_q_mask = shard_slice(
            state.last_surf, state.last_surf_conf, state.last_surf_mask
        )
        rep_scale = jax.lax.rsqrt(jnp.asarray(float(n_sp), dtype))
    else:
        corner_q, corner_q_conf, corner_q_mask = corner_xyz, corner_conf, corner_mask
        cornl_q, cornl_q_conf, cornl_q_mask = (
            state.last_corner, state.last_corner_conf, state.last_corner_mask
        )
        surf_q, surf_q_conf, surf_q_mask = surf_xyz, surf_conf, surf_mask
        surfl_q, surfl_q_conf, surfl_q_mask = (
            state.last_surf, state.last_surf_conf, state.last_surf_mask
        )
        rep_scale = jnp.asarray(1.0, dtype)
    gn_axis = cfg.psum_axis if n_sp > 1 else None

    # ---- two outer iterations: freeze correspondences, 6 GN steps ----
    (q_opt, t_opt, _, _), (ne, np_), _ = scan_to_map_solve(
        q0, t0, state.q_w_last, state.t_w_last,
        corner_q, corner_q_conf, corner_q_mask,
        cornl_q, cornl_q_conf, cornl_q_mask,
        surf_q, surf_q_conf, surf_q_mask,
        surfl_q, surfl_q_conf, surfl_q_mask,
        cm_pts, cm_mask, sm_pts, sm_mask,
        odo.delta_q_imu, imu_cov, w_imu, imu_ypr, state.imu_ypr_last,
        state.ground_last, ground_cur,
        state.ground_last2, state.q_w_last2, state.t_w_last2,
        q_w_curr_f, q_w_curr_f2, w_ground,
        rep_scale, gn_axis, cfg,
    )
    q_w = jnp.where(do_opt, q_opt, q0)
    t_w = jnp.where(do_opt, t_opt, t0)

    # ---- transformUpdate (map -> odom) ----
    q_md = m3.quat_normalize(m3.quat_mul(q_w, m3.quat_conj(odo.q_w)))
    t_md = t_w - m3.quat_rotate(q_md, odo.t_w)

    # ---- keyframe gating (RGC_mapping.cpp:1843-1862) ----
    K = state.kf_q.shape[0]
    has_kf = state.kf_count > 0
    li = jnp.clip(state.kf_count - 1, 0, K - 1)
    d_pos = jnp.linalg.norm(t_w - state.kf_t[li])
    ypr_l = m3.mat_to_ypr(m3.quat_to_mat(state.kf_q[li]))
    ypr_c = m3.mat_to_ypr(m3.quat_to_mat(q_w))
    d_ang = jnp.max(jnp.abs(m3.wrap_angle(ypr_l - ypr_c)))
    add_kf = (~has_kf) | (d_pos > cfg.keyframe_dist) | (d_ang > cfg.keyframe_angle)
    add_kf = add_kf & jnp.asarray(cfg.map_update)

    if (not cfg.loop_closure_enable) and cfg.inline_compaction:
        # long-session eviction (no loop store to remap): thin the oldest
        # half when the store fills.  With loops enabled the compaction runs
        # in loop_closure_step instead, which also fixes loop indices.
        # NOTE: under vmap this cond's predicate is batched and XLA executes
        # BOTH branches every scan — fleets must set inline_compaction=False
        # and call parallel/fleet.compact_fleet on a host cadence instead.
        state = jax.lax.cond(
            add_kf & (state.kf_count >= K),
            lambda s: compact_keyframe_store(s)[0],
            lambda s: s,
            state,
        )
    # backstop: never write past capacity (reachable only if the host runs
    # loops/compaction rarer than COMPACT_MARGIN scans, or not at all)
    add_kf = add_kf & (state.kf_count < K)

    wi = jnp.clip(state.kf_count, 0, K - 1)
    C, S = cfg.max_kf_corner, cfg.max_kf_surf
    new_travel = state.travel_dist + jnp.where(has_kf, d_pos, 0.0)

    def set_kf(s: MappingState) -> MappingState:
        return s.replace(
            kf_q=s.kf_q.at[wi].set(q_w),
            kf_t=s.kf_t.at[wi].set(t_w),
            kf_stamp=s.kf_stamp.at[wi].set(stamp.astype(dtype)),
            kf_travel=s.kf_travel.at[wi].set(new_travel),
            kf_corner=s.kf_corner.at[wi].set(corner_xyz[:C]),
            kf_corner_conf=s.kf_corner_conf.at[wi].set(corner_conf[:C]),
            kf_corner_mask=s.kf_corner_mask.at[wi].set(corner_mask[:C]),
            kf_surf=s.kf_surf.at[wi].set(surf_xyz[:S]),
            kf_surf_conf=s.kf_surf_conf.at[wi].set(surf_conf[:S]),
            kf_surf_mask=s.kf_surf_mask.at[wi].set(surf_mask[:S]),
            kf_count=s.kf_count + 1,
        )

    state_kf = set_kf(state)
    state = jax.tree.map(lambda a, b: jnp.where(add_kf, b, a), state, state_kf)

    # ---- shift "last" frame state ----
    state = state.replace(
        q_md=q_md,
        t_md=t_md,
        q_w_last2=state.q_w_last,
        t_w_last2=state.t_w_last,
        q_w_last=q_w,
        t_w_last=t_w,
        last_corner=corner_xyz,
        last_corner_conf=corner_conf,
        last_corner_mask=corner_mask,
        last_surf=surf_xyz,
        last_surf_conf=surf_conf,
        last_surf_mask=surf_mask,
        ground_last2=state.ground_last,
        ground_last=ground_cur,
        gflag=jnp.asarray(gflag, jnp.int32),
        change_count=jnp.asarray(ccount, jnp.int32),
        q_w_delta=q_w_delta,
        hist_q=hist_q,
        hist_count=hist_count,
        imu_ypr_last=imu_ypr,
        count=state.count + 1,
        travel_dist=jnp.where(add_kf, new_travel, state.travel_dist),
    )

    out = MappingOutput(
        q_w=q_w,
        t_w=t_w,
        q_md=q_md,
        t_md=t_md,
        kf_added=add_kf,
        n_corner_factors=ne[-1],
        n_surf_factors=np_[-1],
    )
    return state, out
