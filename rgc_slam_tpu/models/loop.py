"""Loop closure + 4-DoF pose-graph optimization (SURVEY A14/A15, §3.4).

Reference mechanics rebuilt:
  * drift-adaptive candidate search — radius 15 + (travel-DistanceByLoop)*0.02,
    travel-distance separation gate, keyID>=10 (RGC_mapping.cpp:2141-2225)
  * current-keyframe vs ±N-keyframe-submap ICP, accept fitness < 0.1
    (RGC_mapping.cpp:2050-2081) — point-to-point ICP with batched 1-NN
    and closed-form Kabsch/Umeyama updates instead of pcl::ICP
  * low-drift state machine: >4 consecutive loops within 10 m -> rate-limit
    loops to every 5 m; reset when 20 m passes without one
    (RGC_mapping.cpp:2024-2036,2125-2138)
  * 4-DoF PGO: per-keyframe (yaw, t), sequential-odometry FourDOF chain + loop
    factors, oldest loop keyframe pinned, solved by matrix-free Gauss-Newton/CG
    (RGC_mapping.cpp:2302-2466); corrected poses + drift pushed back into the
    mapping state (correctKeyFramePoseGraph, RGC_mapping.cpp:1618-1686).

Everything is one jit-compiled function gated by traced booleans — the
reference's separate 1 Hz thread becomes a host-cadenced call (SlamSystem).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..utils import math3d as m3
from ..ops import factors as fac
from ..ops import knn as knn_ops
from ..ops import voxelhash as vh
from ..utils import pytree
from .mapping import MappingState
from .mapping import COMPACT_MARGIN as mapping_margin
from .mapping import compact_keyframe_store as mapping_compact
from .slam import SlamState

DRIFT_FACTOR = 0.02
MIN_LOOP_KEY = 10


@pytree.dataclass
class LoopState:
    loop_i: jax.Array         # [L] current-keyframe id (the "j" in FourDOF)
    loop_j: jax.Array         # [L] history/loop keyframe id (the "i")
    loop_t: jax.Array         # [L, 3] t of T_loop_correct (in loop kf frame)
    loop_yaw: jax.Array       # [L] relative yaw of T_loop_correct
    loop_pitch_j: jax.Array   # [L] loop keyframe pitch at detection
    loop_roll_j: jax.Array    # [L]
    loop_stamp: jax.Array     # [L] accept-order stamp (eviction age)
    loop_count: jax.Array     # []
    last_loop_travel: jax.Array   # [] lastLoopDistance
    distance_by_loop: jax.Array   # [] DistanceByLoop
    low_drift: jax.Array      # [] bool
    continue_count: jax.Array # [] int32
    last_kf_count: jax.Array  # [] int32 (bnewKeyFrame tracking)

    @classmethod
    def init(cls, cfg: SlamConfig, dtype=jnp.float32) -> "LoopState":
        L = cfg.max_loops
        return cls(
            loop_i=jnp.full((L,), -1, jnp.int32),
            loop_j=jnp.full((L,), -1, jnp.int32),
            loop_t=jnp.zeros((L, 3), dtype),
            loop_yaw=jnp.zeros((L,), dtype),
            loop_pitch_j=jnp.zeros((L,), dtype),
            loop_roll_j=jnp.zeros((L,), dtype),
            loop_stamp=jnp.zeros((L,), jnp.int32),
            loop_count=jnp.asarray(0, jnp.int32),
            last_loop_travel=jnp.asarray(-1000.0, dtype),
            distance_by_loop=jnp.asarray(0.0, dtype),
            low_drift=jnp.asarray(False),
            continue_count=jnp.asarray(0, jnp.int32),
            last_kf_count=jnp.asarray(0, jnp.int32),
        )


class LoopInfo(NamedTuple):
    attempted: jax.Array
    accepted: jax.Array
    candidate: jax.Array
    fitness: jax.Array
    pgo_ran: jax.Array


def choose_loop_slot(ls: LoopState) -> jax.Array:
    """Pick the loop-store slot the next accepted constraint is written to.

    The reference keeps every accepted loop forever (unbounded
    loopInfoContainer, RGC_mapping.cpp:2084-2138,2372-2400); a static-shape
    store must evict.  Policy (PARITY.md §loop-store): fill empty slots first
    (compaction frees slots by masking dead constraints to -1), then evict the
    OLDEST accepted loop by stamp — but never the slot holding the current PGO
    gauge anchor (the constraint with the smallest history keyframe,
    _pgo_solve's `pinned`), so the global frame's anchor can't silently jump
    to a newer keyframe once the store wraps."""
    L = ls.loop_i.shape[0]
    slot_idx = jnp.arange(L)
    slot_used = ls.loop_i >= 0
    big = jnp.asarray(2**30, jnp.int32)
    anchor_slot = jnp.argmin(jnp.where(slot_used, ls.loop_j, big))
    first_empty = jnp.argmin(jnp.where(~slot_used, slot_idx, L))
    evict = jnp.argmin(
        jnp.where((slot_idx != anchor_slot) | ~jnp.any(slot_used), ls.loop_stamp, big)
    )
    return jnp.where(jnp.any(~slot_used), first_empty, evict)


# ---------------------------------------------------------------------------
# point-to-point ICP (pcl::IterativeClosestPoint replacement)
# ---------------------------------------------------------------------------


def icp_point2point(
    src: jax.Array, src_mask: jax.Array,
    tgt: jax.Array, tgt_mask: jax.Array,
    max_corr: jax.Array, iterations: int,
):
    """Iterated 1-NN + weighted Kabsch — the pcl::IterativeClosestPoint
    pipeline the reference aligns loop submaps with (RGC_mapping.cpp:
    2050-2081: max-correspondence gate, TransformationEstimationSVD /
    Umeyama, RANSAC off).  Fixed iteration count replaces PCL's
    DefaultConvergenceCriteria early-exit: ICP is a fixed-point iteration,
    so extra iterations past convergence leave the pose at the fixed point
    (parity checked by the loop-ICP oracle, utils/parity.py).

    Returns (q, t, fitness, n_matched) with (q, t) mapping src into tgt's
    frame.  fitness follows pcl::Registration::getFitnessScore() exactly:
    the mean squared NN distance over ALL valid source points (max_range
    defaults to +inf there — unmatched points count too), which is what the
    reference compares against historyKeyframeFitnessScore."""
    dtype = src.dtype

    def body(_, carry):
        q, t = carry
        sp = m3.quat_rotate(q[None, :], src) + t[None, :]
        d2, idx = knn_ops.knn(sp, tgt, tgt_mask, 1)
        match = src_mask & (d2[:, 0] < max_corr * max_corr)
        w = match.astype(dtype)
        tp = tgt[idx[:, 0]]
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        cs = jnp.sum(sp * w[:, None], axis=0) / wsum
        ct = jnp.sum(tp * w[:, None], axis=0) / wsum
        H = jnp.einsum("n,ni,nj->ij", w, sp - cs, tp - ct)
        U, _, Vt = jnp.linalg.svd(H)
        det = jnp.linalg.det(Vt.T @ U.T)
        S = jnp.diag(jnp.array([1.0, 1.0, det], dtype))
        R = Vt.T @ S @ U.T
        dq = m3.mat_to_quat(R)
        dt = ct - R @ cs
        q_new = m3.quat_normalize(m3.quat_mul(dq, q))
        t_new = m3.quat_rotate(dq, t) + dt
        return (q_new, t_new)

    q, t = jax.lax.fori_loop(
        0, iterations, body, (m3.quat_identity(dtype), jnp.zeros(3, dtype))
    )
    sp = m3.quat_rotate(q[None, :], src) + t[None, :]
    d2, _ = knn_ops.knn(sp, tgt, tgt_mask, 1)
    match = src_mask & (d2[:, 0] < max_corr * max_corr)
    n = jnp.sum(match)
    n_valid = jnp.sum(src_mask)
    fitness = jnp.sum(jnp.where(src_mask, d2[:, 0], 0.0)) / jnp.maximum(n_valid, 1)
    return q, t, fitness, n


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _kf_cloud_world(ms: MappingState, k: jax.Array, cap_c: int, cap_s: int):
    """Keyframe k's corner+surf cloud in world frame."""
    q, t = ms.kf_q[k], ms.kf_t[k]
    c = m3.quat_rotate(q[None, :], ms.kf_corner[k]) + t[None, :]
    s = m3.quat_rotate(q[None, :], ms.kf_surf[k]) + t[None, :]
    pts = jnp.concatenate([c, s], axis=0)
    mask = jnp.concatenate([ms.kf_corner_mask[k], ms.kf_surf_mask[k]])
    return pts, mask


def _maybe_compact(state: SlamState, ls: LoopState, cfg: SlamConfig):
    """Run keyframe-store compaction when capacity headroom drops below
    COMPACT_MARGIN, remapping the loop store's keyframe indices.

    Loop-anchor keyframes are protected from eviction so stored constraints
    (relative pose in the anchor frame) stay exact; if protection ever leaves
    nothing evictable, compaction falls back to the unprotected rule and any
    loop whose endpoint died is dropped (masked to -1)."""
    ms = state.mapping
    K = ms.kf_q.shape[0]

    def do(args):
        ms, ls = args
        anchored = jnp.zeros(K, jnp.int32)
        li_ok = (ls.loop_i >= 0).astype(jnp.int32)
        lj_ok = (ls.loop_j >= 0).astype(jnp.int32)
        anchored = anchored.at[jnp.clip(ls.loop_i, 0, K - 1)].max(li_ok)
        anchored = anchored.at[jnp.clip(ls.loop_j, 0, K - 1)].max(lj_ok)
        ms2, keep, new_of_old = mapping_compact(ms, protect=anchored > 0)

        def remap(ix):
            safe = jnp.clip(ix, 0, K - 1)
            ok = (ix >= 0) & keep[safe]
            return jnp.where(ok, new_of_old[safe], -1)

        li = remap(ls.loop_i)
        lj = remap(ls.loop_j)
        both = (li >= 0) & (lj >= 0)
        # new_kf detection bookkeeping: count evictions below the watermark
        idx = jnp.arange(K)
        ev_below = jnp.sum((~keep) & (idx < ms.kf_count) & (idx < ls.last_kf_count))
        ls2 = ls.replace(
            loop_i=jnp.where(both, li, -1),
            loop_j=jnp.where(both, lj, -1),
            last_kf_count=jnp.maximum(ls.last_kf_count - ev_below, 0).astype(jnp.int32),
        )
        return ms2, ls2

    need = ms.kf_count >= K - mapping_margin
    ms2, ls2 = jax.lax.cond(need, do, lambda a: a, (ms, ls))
    return state.replace(mapping=ms2), ls2


def loop_closure_step(state: SlamState, loop_state: LoopState, cfg: SlamConfig):
    if cfg.loop_closure_enable and cfg.map_update:
        state, loop_state = _maybe_compact(state, loop_state, cfg)
    ms = state.mapping
    ls = loop_state
    dtype = ms.t_md.dtype
    K = ms.kf_q.shape[0]
    L = cfg.max_loops

    latest = jnp.clip(ms.kf_count - 1, 0, K - 1)
    travel_latest = ms.kf_travel[latest]

    new_kf = ms.kf_count > ls.last_kf_count
    rate_ok = jnp.where(
        ls.low_drift, jnp.abs(travel_latest - ls.last_loop_travel) >= 5.0, True
    )
    low_drift = jnp.where(
        jnp.abs(travel_latest - ls.last_loop_travel) > 20.0, False, ls.low_drift
    )
    # localization mode runs no loop detection (RGC_mapping.cpp:2014)
    attempt = (
        jnp.asarray(cfg.loop_closure_enable and cfg.map_update)
        & new_kf
        & rate_ok
        & (ms.kf_count > MIN_LOOP_KEY + 2)
    )

    # ---- candidate search (detectLoopClosure) ----
    radius = cfg.loop_search_radius + (travel_latest - ls.distance_by_loop) * DRIFT_FACTOR
    kf_idx = jnp.arange(K)
    valid = kf_idx < ms.kf_count
    d = jnp.linalg.norm(ms.kf_t - ms.kf_t[latest][None, :], axis=-1)
    # maturity gate: the reference skips the first MIN_LOOP_KEY keyframes
    # (index-based).  Expressed in travel so it stays correct after store
    # compaction relabels slots (pre-eviction the two are identical at the
    # keyframe distance gate: travel[i] ~= i * keyframe_dist).
    mature = ms.kf_travel >= MIN_LOOP_KEY * cfg.keyframe_dist
    eligible = (
        valid
        & mature
        & (kf_idx != latest)
        & (d < radius)
        & (jnp.abs(ms.kf_travel - travel_latest) > (cfg.loop_travel_gate + radius))
    )
    d_masked = jnp.where(eligible, d, jnp.inf)
    cand = jnp.argmin(d_masked)
    have_cand = jnp.isfinite(d_masked[cand]) & attempt

    # ---- submap assembly (±halfwidth keyframes around the candidate) ----
    W = cfg.loop_submap_halfwidth
    offs = jnp.arange(-W, W + 1)
    sub_ids = jnp.clip(cand + offs, 0, K - 1)
    sub_ok = ((cand + offs) >= 0) & ((cand + offs) < latest) & valid[sub_ids]

    def gather_world(k):
        return _kf_cloud_world(ms, k, cfg.max_kf_corner, cfg.max_kf_surf)

    sub_pts, sub_mask = jax.vmap(gather_world)(sub_ids)
    sub_mask = sub_mask & sub_ok[:, None]
    P = sub_pts.shape[1]
    sub_pts = sub_pts.reshape((2 * W + 1) * P, 3)
    sub_mask = sub_mask.reshape((2 * W + 1) * P)
    origin = ms.kf_t[cand]
    sub_voxel = cfg.loop_submap_voxel or cfg.map_surf_voxel
    tgt, tgt_mask, _ = vh.voxel_downsample(
        sub_pts - origin[None, :], sub_mask, sub_voxel,
        cfg.max_loop_submap_points, probes=cfg.hash_probes,
    )

    src, src_mask = _kf_cloud_world(ms, latest, cfg.max_kf_corner, cfg.max_kf_surf)
    src = src - origin[None, :]

    if cfg.loop_icp_method == "gicp":
        from ..ops.gicp import gicp_register
        from ..utils import math3d as _m3

        res = gicp_register(
            src, src_mask & have_cand, tgt, tgt_mask,
            _m3.quat_identity(dtype), jnp.zeros(3, dtype), cfg,
            max_iters=cfg.loop_icp_iterations,
        )
        q_icp, t_icp, fitness, n_icp = res.q, res.t, res.fitness, res.n_corr
    elif cfg.loop_icp_method == "plane":
        from ..ops.gicp import p2plane_register
        from ..utils import math3d as _m3

        res = p2plane_register(
            src, src_mask & have_cand, tgt, tgt_mask,
            _m3.quat_identity(dtype), jnp.zeros(3, dtype), cfg,
            max_iters=cfg.loop_icp_iterations,
        )
        q_icp, t_icp, fitness, n_icp = res.q, res.t, res.fitness, res.n_corr
    else:
        q_icp, t_icp, fitness, n_icp = icp_point2point(
            src, src_mask & have_cand, tgt, tgt_mask, 2.0 * radius,
            cfg.loop_icp_iterations,
        )
    accepted = have_cand & (fitness < cfg.loop_fitness_thresh) & (n_icp > 100)

    # ---- loop constraint from the ICP drift (T_loop_correct) ----
    # world-frame drift: X_world_corrected = q_icp (X_world - origin) + t_icp + origin
    t_drift = t_icp + origin - m3.quat_rotate(q_icp, origin)
    q_latest, t_latest = ms.kf_q[latest], ms.kf_t[latest]
    q_corr = m3.quat_normalize(m3.quat_mul(q_icp, q_latest))
    t_corr = m3.quat_rotate(q_icp, t_latest) + t_drift
    q_loop, t_loop = ms.kf_q[cand], ms.kf_t[cand]
    q_rel = m3.quat_mul(m3.quat_conj(q_loop), q_corr)
    t_rel = m3.quat_rotate(m3.quat_conj(q_loop), t_corr - t_loop)
    ypr_rel = m3.quat_to_ypr(q_rel)
    ypr_loop = m3.quat_to_ypr(q_loop)

    wi = choose_loop_slot(ls)
    ls = ls.replace(
        loop_i=jnp.where(accepted, ls.loop_i.at[wi].set(latest), ls.loop_i),
        loop_j=jnp.where(accepted, ls.loop_j.at[wi].set(cand), ls.loop_j),
        loop_t=jnp.where(accepted, ls.loop_t.at[wi].set(t_rel), ls.loop_t),
        loop_yaw=jnp.where(accepted, ls.loop_yaw.at[wi].set(ypr_rel[0]), ls.loop_yaw),
        loop_pitch_j=jnp.where(
            accepted, ls.loop_pitch_j.at[wi].set(ypr_loop[1]), ls.loop_pitch_j
        ),
        loop_roll_j=jnp.where(
            accepted, ls.loop_roll_j.at[wi].set(ypr_loop[2]), ls.loop_roll_j
        ),
        loop_stamp=jnp.where(
            accepted, ls.loop_stamp.at[wi].set(ls.loop_count + 1), ls.loop_stamp
        ),
        loop_count=jnp.where(accepted, ls.loop_count + 1, ls.loop_count),
    )

    # drift state machine (RGC_mapping.cpp:2125-2138)
    cont = jnp.where(
        accepted,
        jnp.where(
            jnp.abs(travel_latest - ls.last_loop_travel) < 10.0,
            ls.continue_count + 1,
            0,
        ),
        ls.continue_count,
    )
    low_drift = jnp.where(accepted & (cont > 4), True, low_drift)
    dbl = jnp.maximum(travel_latest - ms.kf_travel[cand], 0.0)
    ls = ls.replace(
        continue_count=jnp.asarray(cont, jnp.int32),
        low_drift=low_drift,
        distance_by_loop=jnp.where(accepted, dbl, ls.distance_by_loop),
        last_loop_travel=jnp.where(accepted, travel_latest, ls.last_loop_travel),
        last_kf_count=ms.kf_count,
    )

    # ---- 4-DoF PGO (runs when a loop was just added) ----
    state, pgo_ran = _pose_graph_optimize(state, ls, accepted, cfg)

    info = LoopInfo(
        attempted=attempt,
        accepted=accepted,
        candidate=cand,
        fitness=fitness,
        pgo_ran=pgo_ran,
    )
    return state, ls, info


def _pose_graph_optimize(state: SlamState, ls: LoopState, run: jax.Array, cfg: SlamConfig):
    """Dispatch the 4-DoF solve under lax.cond so the CG iterations only
    execute on the (rare) scans that actually added a loop."""
    ms_out = jax.lax.cond(
        run,
        lambda m: _pgo_solve(m, ls, cfg),
        lambda m: m,
        state.mapping,
    )
    return state.replace(mapping=ms_out), run


def _pgo_solve(ms: MappingState, ls: LoopState, cfg: SlamConfig) -> MappingState:
    """4-DoF pose-graph solve in PER-EDGE INCREMENT coordinates.

    The reference optimizes absolute (yaw, t) per keyframe with Ceres'
    SPARSE_NORMAL_CHOLESKY (RGC_mapping.cpp:2302-2466) — an exact sparse
    solve.  A matrix-free CG on the same absolute parametrization is a poor
    substitute: the odometry chain makes J^T J a 1-D graph Laplacian
    (condition ~K^2), and each CG iteration propagates a loop correction one
    keyframe hop, so at K >= 2048 the 128-iteration solve barely moves.

    Reparametrize by increments instead: variables are per-edge
    (dyaw_k, dt_k) with entry 0 holding the absolute base pose; absolute
    poses are reconstructed inside the residual via two cumsums
    (yaw = cumsum(dyaw); t = cumsum of yaw-rotated dt).  The cost function is
    IDENTICAL (chain residual r = [dt_k - t_meas, wrap(dyaw_k - yaw_meas)] is
    exactly fourdof_residual at the reconstructed poses), but now the chain
    block of J^T J is the identity and each loop factor contributes rank <= 4
    supported on a prefix interval — CG converges in ~4·n_loops iterations
    independent of K.  The gauge null space (base pose) is held at x0 by the
    damping; afterwards the solution is re-anchored so the oldest loop
    keyframe keeps its pose exactly (ref SetParameterBlockConstant,
    RGC_mapping.cpp:2404-2419).
    """
    dtype = ms.t_md.dtype
    K = ms.kf_q.shape[0]
    L = ls.loop_i.shape[0]
    kf_idx = jnp.arange(K)
    valid = kf_idx < ms.kf_count

    ypr0 = m3.quat_to_ypr(ms.kf_q)            # [K, 3]
    yaw0 = ypr0[:, 0]
    pitch0 = ypr0[:, 1]
    roll0 = ypr0[:, 2]
    t0 = ms.kf_t

    # odometry-chain measurements from current poses
    Ri0 = m3.ypr_to_mat(ypr0)                  # [K,3,3]
    t_ij_meas = jnp.einsum(
        "kji,kj->ki", Ri0[:-1], t0[1:] - t0[:-1]
    )                                          # in frame of kf i
    yaw_ij_meas = m3.wrap_angle(yaw0[1:] - yaw0[:-1])
    chain_w = (valid[1:] & valid[:-1]).astype(dtype)

    # the reference parametrizes yaw in DEGREES (euler_array carries degrees,
    # FourDOFError's angle residual is degree-wrapped while the translation
    # rows are meters, RGC_mapping.cpp:2352-2360).  Matching that unit mix
    # reproduces its implicit yaw-vs-translation weighting (yaw errors count
    # 180/pi times as much).  Scaling BOTH the variable and the residual keeps
    # the chain block of J^T J at identity, so CG conditioning is unchanged.
    RAD2DEG = jnp.asarray(57.29577951308232, dtype)
    yaw_scale = jnp.array([1.0, 1.0, 1.0, RAD2DEG], dtype)

    loops_ok = (ls.loop_i >= 0) & (ls.loop_i < ms.kf_count) & (ls.loop_j >= 0)
    loop_w = loops_ok.astype(dtype)
    li = jnp.clip(ls.loop_i, 0, K - 1)
    lj = jnp.clip(ls.loop_j, 0, K - 1)

    # pin the oldest loop keyframe (RGC_mapping.cpp:2404-2419)
    oldest = jnp.min(jnp.where(loops_ok, lj, K))
    pinned = jnp.clip(oldest, 0, K - 1)

    def unpack(x):
        dyaw = x[:K] / RAD2DEG     # stored in degrees; used in radians
        dt = x[K:].reshape(K, 3)
        return dyaw, dt

    def reconstruct(x):
        dyaw, dt = unpack(x)
        yaw = jnp.cumsum(dyaw)
        R = m3.ypr_to_mat(jnp.stack([yaw, pitch0, roll0], axis=-1))  # [K,3,3]
        steps = jnp.concatenate(
            [dt[:1], jnp.einsum("kij,kj->ki", R[:-1], dt[1:])], axis=0
        )
        t = jnp.cumsum(steps, axis=0)
        return yaw, t

    def residuals(x):
        dyaw, dt = unpack(x)
        # chain residuals are fourdof_residual at the reconstructed poses,
        # which collapses to this closed form in increment coordinates
        r_chain = jnp.concatenate(
            [
                (dt[1:] - t_ij_meas) * chain_w[:, None],
                (m3.wrap_angle(dyaw[1:] - yaw_ij_meas) * RAD2DEG * chain_w)[:, None],
            ],
            axis=1,
        )

        yaw, t = reconstruct(x)

        def loop_res(k):
            return fac.fourdof_residual(
                yaw[lj[k]], t[lj[k]], yaw[li[k]], t[li[k]],
                ls.loop_t[k], ls.loop_yaw[k], ls.loop_pitch_j[k], ls.loop_roll_j[k],
            ) * yaw_scale

        r_loop = jax.vmap(loop_res)(jnp.arange(L)) * loop_w[:, None]
        return jnp.concatenate([r_chain.reshape(-1), r_loop.reshape(-1)])

    x0 = jnp.concatenate(
        [
            jnp.concatenate([yaw0[:1], yaw_ij_meas]) * RAD2DEG,
            jnp.concatenate([t0[:1], t_ij_meas], axis=0).reshape(-1),
        ]
    )
    x_opt = fac.gauss_newton_cg(
        residuals, x0, gn_iters=cfg.pgo_iterations, cg_iters=cfg.pgo_cg_iters,
        damping=1e-6,
    )
    yaw_new, t_new = reconstruct(x_opt)

    # re-anchor: global 4-DoF transform so the pinned keyframe keeps its
    # initial pose exactly (gauge choice — leaves every residual unchanged)
    dgauge = m3.wrap_angle(yaw0[pinned] - yaw_new[pinned])
    Rg = m3.ypr_to_mat(jnp.stack([dgauge, jnp.zeros((), dtype), jnp.zeros((), dtype)]))
    yaw_new = yaw_new + dgauge
    t_new = jnp.einsum("ij,kj->ki", Rg, t_new - t_new[pinned][None, :]) + t0[pinned][None, :]

    yaw_new = jnp.where(valid, yaw_new, yaw0)
    t_new = jnp.where(valid[:, None], t_new, t0)

    q_new = m3.ypr_to_quat(jnp.stack([yaw_new, pitch0, roll0], axis=-1))

    # drift of the latest keyframe, applied to the mapping frame
    latest = jnp.clip(ms.kf_count - 1, 0, K - 1)
    q_dr = m3.quat_normalize(
        m3.quat_mul(q_new[latest], m3.quat_conj(ms.kf_q[latest]))
    )
    t_dr = t_new[latest] - m3.quat_rotate(q_dr, ms.kf_t[latest])

    def apply(q, t):
        return (
            m3.quat_normalize(m3.quat_mul(q_dr, q)),
            m3.quat_rotate(q_dr, t) + t_dr,
        )

    q_md2, t_md2 = apply(ms.q_md, ms.t_md)
    q_l2, t_l2 = apply(ms.q_w_last, ms.t_w_last)
    q_l22, t_l22 = apply(ms.q_w_last2, ms.t_w_last2)

    return ms.replace(
        kf_q=q_new, kf_t=t_new,
        q_md=q_md2, t_md=t_md2,
        q_w_last=q_l2, t_w_last=t_l2,
        q_w_last2=q_l22, t_w_last2=t_l22,
    )
