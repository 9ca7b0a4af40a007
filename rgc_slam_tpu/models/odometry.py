"""Odometry front-end: the JAX rebuild of the `RGC_odometer` node (vg_ICP).

One pure jit-compiled step (SURVEY §3.2): IMU filtering/preintegration →
constant-velocity deskew → VGICP against the sliding submap → factor-graph
fusion (VGICP rotation/translation + ground coplanarity + IMU rotation) →
ground-change state machine → pose composition with the reference's xy/z split
and 95/5 IMU pitch-roll pullback → keyframe-gated submap ring update.

Everything lives in an explicit ``OdometryState`` pytree; the ROS queues,
mutexes and polling thread of the reference collapse into function
composition.  Registration runs in the world frame against world-frame submap
clouds (vs. the reference's re-expression of the submap into the previous
sensor frame each step, RGC_odometer.cpp:1240-1256) — algebraically the same
problem with a different gauge, and it avoids re-transforming the target
clouds every scan.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..types import GroundPlane, ImuBatch, PointCloud
from ..utils import math3d as m3
from ..ops import factors as fac
from ..ops import imu as imu_ops
from ..ops import registration as reg
from ..ops import voxelhash as vh
from ..ops.features import FeatureExtraction
from ..utils import pytree

HIST_CAP = 64     # historical ground-plane anchor orientations
RAD2DEG = 57.29577951308232


@pytree.dataclass
class OdometryState:
    # pose
    q_w: jax.Array            # [4] world <- current sensor
    t_w: jax.Array            # [3]
    q_last: jax.Array         # [4] previous relative motion (const-velocity)
    t_last: jax.Array         # [3]
    frame: jax.Array          # [] int32
    prev_stamp: jax.Array     # []

    # sliding submap ring (world frame), S = cfg.submap_window
    sub_xyz: jax.Array        # [S, P, 3]
    sub_cov: jax.Array        # [S, P, 3, 3]
    sub_mask: jax.Array       # [S, P]
    sub_q: jax.Array          # [S, 4] pose at insertion
    sub_t: jax.Array          # [S, 3]
    sub_count: jax.Array      # [] int32 number of valid entries
    sub_next: jax.Array       # [] int32 ring write position

    # ground-change state machine (RGC_odometer.cpp:1034-1085)
    ground_last: GroundPlane
    gflag: jax.Array          # [] int32
    change_count: jax.Array   # [] int32
    q_w_delta: jax.Array      # [4] anchor orientation
    hist_q: jax.Array         # [HIST_CAP, 4]
    hist_count: jax.Array     # [] int32

    # IMU
    imu_filter: imu_ops.ImuFilterState

    # gravity init (A11)
    g_init: jax.Array         # [3]
    q_body2world: jax.Array   # [4]

    fitness: jax.Array        # [] last VGICP fitness (vgicp_source)

    @classmethod
    def init(cls, cfg: SlamConfig, dtype=jnp.float32) -> "OdometryState":
        S, P = cfg.submap_window, cfg.max_source_points
        return cls(
            q_w=m3.quat_identity(dtype),
            t_w=jnp.zeros(3, dtype),
            q_last=m3.quat_identity(dtype),
            t_last=jnp.zeros(3, dtype),
            frame=jnp.asarray(0, jnp.int32),
            prev_stamp=jnp.asarray(0.0, dtype),
            sub_xyz=jnp.zeros((S, P, 3), dtype),
            sub_cov=jnp.zeros((S, P, 3, 3), dtype),
            sub_mask=jnp.zeros((S, P), bool),
            sub_q=jnp.tile(m3.quat_identity(dtype), (S, 1)),
            sub_t=jnp.zeros((S, 3), dtype),
            sub_count=jnp.asarray(0, jnp.int32),
            sub_next=jnp.asarray(0, jnp.int32),
            ground_last=GroundPlane.default(cfg.lidar_height, dtype),
            gflag=jnp.asarray(0, jnp.int32),
            change_count=jnp.asarray(0, jnp.int32),
            q_w_delta=m3.quat_identity(dtype),
            hist_q=jnp.tile(m3.quat_identity(dtype), (HIST_CAP, 1)),
            hist_count=jnp.asarray(0, jnp.int32),
            imu_filter=imu_ops.ImuFilterState.init(dtype),
            g_init=jnp.array([0.0, 0.0, 9.81], dtype),
            q_body2world=m3.quat_identity(dtype),
            fitness=jnp.asarray(0.0, dtype),
        )


class OdometryOutput(NamedTuple):
    q_w: jax.Array
    t_w: jax.Array
    q_rel: jax.Array          # fused relative rotation last->curr
    t_rel: jax.Array
    delta_q_imu: jax.Array    # IMU preintegrated rotation (for mapping)
    fitness: jax.Array
    n_corr: jax.Array
    deskewed_full: PointCloud         # sensor frame, deskewed
    deskewed_sharp_xyz: jax.Array     # [Ns, 3]
    deskewed_flat_xyz: jax.Array      # [Nf, 3]
    ground: GroundPlane
    gflag: jax.Array


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def deskew_points(xyz, rel_time, q_rel, t_rel):
    """Constant-velocity deskew to the end-of-scan frame.

    Matches ``adjustDistortion`` (RGC_odometer.cpp:1441-1481):
    s = 1 - rel_time;  p' = slerp(I, q_rel^-1, s) (p - s t_rel).
    """
    s = 1.0 - rel_time
    q_inv = m3.quat_conj(q_rel)
    qs = m3.quat_slerp(
        jnp.broadcast_to(m3.quat_identity(xyz.dtype), (xyz.shape[0], 4)),
        jnp.broadcast_to(q_inv, (xyz.shape[0], 4)),
        s,
    )
    return m3.quat_rotate(qs, xyz - s[:, None] * t_rel[None, :])


def _submap_target(state: OdometryState, cfg: SlamConfig, origin: jax.Array):
    """Concat submap ring (world frame, origin-shifted), 0.3 m downsample,
    then build the 1.0 m Gaussian voxel map (ref RGC_odometer.cpp:984-1009)."""
    S, P = state.sub_xyz.shape[0], state.sub_xyz.shape[1]
    pts = (state.sub_xyz - origin[None, None, :]).reshape(S * P, 3)
    covs = state.sub_cov.reshape(S * P, 3, 3)
    mask = state.sub_mask.reshape(S * P)
    ds_pts, ds_mask, (ds_cov,) = vh.voxel_downsample(
        pts, mask, cfg.target_voxel_size, cfg.max_voxels, extras=(covs,),
        probes=cfg.hash_probes,
    )
    return vh.build_gaussian_voxelmap(
        ds_pts, ds_cov, ds_mask, cfg.vgicp_resolution, cfg.max_voxels,
        probes=cfg.hash_probes,
    )


def _insert_submap(state: OdometryState, xyz_w, cov_w, mask, q, t) -> OdometryState:
    i = state.sub_next
    return state.replace(
        sub_xyz=state.sub_xyz.at[i].set(xyz_w),
        sub_cov=state.sub_cov.at[i].set(cov_w),
        sub_mask=state.sub_mask.at[i].set(mask),
        sub_q=state.sub_q.at[i].set(q),
        sub_t=state.sub_t.at[i].set(t),
        sub_count=jnp.minimum(state.sub_count + 1, state.sub_xyz.shape[0]),
        sub_next=jnp.mod(state.sub_next + 1, state.sub_xyz.shape[0]),
    )


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def fusion_solve(
    q_l, t_l, fitness, g_last, ground_cur, q_w_curr_f,
    delta_q_imu, imu_cov, w_imu, w_ground,
):
    """The odometer's (q, t) factor-fusion solve (RGC_odometer.cpp:
    1024-1119 + ceres::Solve at 1188-1193): DeltaR(q_l, fitness) +
    [ground] DeltaP(t_l, fitness/10) + Ground_DeltaFactor(0.2) +
    [imu] DeltaR(delta_q_imu, imu_cov) — every block NULL loss (the
    HuberLoss object at cpp:1025 is created but never attached).

    Solved by ceres_lm with the identity cost (no robust losses, so the
    TRUE cost IS the residual square), matching Ceres's DENSE_QR
    max_num_iterations=6 trust-region semantics — parity enforced by the
    stage-7 oracle (utils/parity.reference_odometry_fusion).  Extracted
    from odometry_step so the oracle can drive it directly."""

    def residuals(delta):
        q = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[:3]), q_l))
        t = t_l + delta[3:]
        r_lidar_q = fac.delta_r_residual(q, q_l, fitness)
        r_lidar_p = fac.delta_p_residual(t, t_l, fitness / 10.0) * w_ground
        r_ground = (
            fac.ground_delta_residual(q, t, g_last, ground_cur, q_w_curr_f, 0.2)
            * w_ground
        )
        r_imu = fac.delta_r_residual(q, delta_q_imu, imu_cov) * w_imu
        return jnp.concatenate([r_lidar_q, r_lidar_p, r_ground, r_imu])

    def cost(delta):
        r = residuals(delta)
        return 0.5 * jnp.sum(r * r)

    delta = fac.ceres_lm(residuals, cost, 6, iterations=6)
    q_fused = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[:3]), q_l))
    t_fused = t_l + delta[3:]
    return q_fused, t_fused


def odometry_step(
    state: OdometryState,
    fx: FeatureExtraction,
    imu: ImuBatch,
    stamp: jax.Array,
    cfg: SlamConfig,
):
    """One scan through the odometry front-end.  Returns (state, output)."""
    dtype = state.t_w.dtype
    ground_cur = fx.ground

    # ---- IMU: attitude filter + preintegration over the interval ----
    imu_state = imu_ops.complementary_filter_scan(state.imu_filter, imu, cfg.gravity)
    if cfg.imu_cov_mode == "preint":
        # full 15-dim propagation: the θ-block variance becomes the DeltaR
        # factor weight below (principled replacement for the reference's two
        # hardcoded constants, utility.h:303-380)
        preint_full = imu_ops.preintegrate_full(
            imu, state.prev_stamp, stamp,
            state.imu_filter.ba, state.imu_filter.bg,
            acc_n=cfg.imu_acc_n, gyr_n=cfg.imu_gyr_n,
            acc_w=cfg.imu_acc_w, gyr_w=cfg.imu_gyr_w,
        )
        preint = imu_ops.Preintegration(
            delta_q=preint_full.delta_q, delta_p=preint_full.delta_p,
            delta_v=preint_full.delta_v, sum_dt=preint_full.sum_dt,
        )
        imu_rot_var = jnp.trace(preint_full.cov[3:6, 3:6]) / 3.0
    else:
        preint = imu_ops.preintegrate(
            imu, state.prev_stamp, stamp, state.imu_filter.ba, state.imu_filter.bg
        )
        imu_rot_var = None
    delta_q_imu = preint.delta_q if cfg.use_imu else m3.quat_identity(dtype)
    frame_dt = jnp.maximum(stamp - state.prev_stamp, 1e-3).astype(dtype)

    # constant-velocity prediction; rotation replaced by IMU Δq when available
    q_pred = delta_q_imu if cfg.use_imu else state.q_last
    t_pred = state.t_last

    # ---- deskew (full + features) with the predicted motion ----
    full_xyz = deskew_points(fx.full.xyz, fx.full.rel_time, q_pred, t_pred)
    sharp_xyz = deskew_points(fx.sharp.xyz, fx.sharp.rel_time, q_pred, t_pred)
    flat_xyz = deskew_points(fx.flat.xyz, fx.flat.rel_time, q_pred, t_pred)
    full = fx.full.replace(xyz=full_xyz)

    # ---- source downsample (0.2 m) with covariances ----
    src, src_mask, (src_cov,) = vh.voxel_downsample(
        full_xyz, full.mask, cfg.source_voxel_size, cfg.max_source_points,
        extras=(fx.normals_cov,), probes=cfg.hash_probes,
    )
    if cfg.psum_axis is not None and cfg.sp_shards > 1:
        # point-sharded registration, BLOCK SLICE (VERDICT r2 item 4): each
        # device looks up and linearizes a static n/sp_shards slice of the
        # source — a real per-device FLOP/memory reduction — and lm_register
        # psum-reduces the 6x6 H / b / cost partials.  (The submap insertion
        # below uses the full arrays so state stays replica-consistent.)
        per = src.shape[0] // cfg.sp_shards
        start = jax.lax.axis_index(cfg.psum_axis) * per
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, per)
        reg_src, reg_cov, reg_mask = sl(src), sl(src_cov), sl(src_mask)
    elif cfg.psum_axis is not None:
        # stride-masked fallback (sp_shards unset): correct H/b/cost psum but
        # every device still pays the full-N lookup
        shard = jax.lax.axis_index(cfg.psum_axis)
        n_shards = jax.lax.psum(1, cfg.psum_axis)
        reg_src, reg_cov = src, src_cov
        reg_mask = src_mask & (jnp.arange(src.shape[0]) % n_shards == shard)
    else:
        reg_src, reg_cov, reg_mask = src, src_cov, src_mask

    # ---- VGICP against the submap (world frame, origin-anchored) ----
    origin = jnp.floor(state.t_w)
    vm = _submap_target(state, cfg, origin)
    q_guess = m3.quat_normalize(m3.quat_mul(state.q_w, q_pred))
    t_guess = state.t_w + m3.quat_rotate(state.q_w, t_pred) - origin
    res = reg.lm_register(reg_src, reg_cov, reg_mask, vm, q_guess, t_guess, cfg)
    have_map = state.sub_count > 0
    q_new_w = jnp.where(have_map, res.q, q_guess)
    t_new_w = jnp.where(have_map, res.t, t_guess) + origin
    fitness = jnp.where(have_map, res.fitness, jnp.asarray(1.0, dtype))
    fitness = jnp.clip(fitness, 1e-4, 1.0)

    # relative motion from VGICP (lidar measurement)
    q_l = m3.quat_normalize(m3.quat_mul(m3.quat_conj(state.q_w), q_new_w))
    t_l = m3.quat_rotate(m3.quat_conj(state.q_w), t_new_w - state.t_w)

    # ---- ground-change detection (RGC_odometer.cpp:1034-1085) ----
    g_last = state.ground_last
    norm_cur_l = m3.quat_rotate(q_l, ground_cur.normal)
    dist_cur_l = ground_cur.distance + jnp.dot(norm_cur_l, t_l)
    gerr1 = jnp.linalg.norm(
        g_last.distance * g_last.normal - dist_cur_l * norm_cur_l
    )
    gerr2 = jnp.abs(jnp.dot(g_last.v1, norm_cur_l))
    d_ypr_deg = m3.mat_to_ypr(m3.quat_to_mat(delta_q_imu)) * RAD2DEG
    change_detected = (gerr1 >= 0.02) & (gerr2 >= 0.02) & (jnp.abs(d_ypr_deg[1]) > 0.5)

    gflag = jnp.where(change_detected, 1, state.gflag)
    change_count = jnp.where(change_detected, 0, state.change_count)
    counting = gflag == 1
    change_count = jnp.where(counting, change_count + 1, change_count)
    resolve = counting & (change_count >= 25)

    # historical plane re-anchor: best pitch/roll match over history (degrees)
    now_ypr = m3.mat_to_ypr(m3.quat_to_mat(state.q_w)) * RAD2DEG
    hist_ypr = m3.mat_to_ypr(m3.quat_to_mat(state.hist_q)) * RAD2DEG
    hist_valid = jnp.arange(HIST_CAP) < state.hist_count
    pr_err = jnp.sqrt(
        (hist_ypr[:, 1] - now_ypr[1]) ** 2 + (hist_ypr[:, 2] - now_ypr[2]) ** 2
    )
    pr_err = jnp.where(hist_valid, pr_err, jnp.inf)
    best = jnp.argmin(pr_err)
    found = pr_err[best] < 4.0
    q_w_delta = jnp.where(
        resolve,
        jnp.where(found, state.hist_q[best], state.q_w),
        state.q_w_delta,
    )
    push_hist = resolve & ~found
    hist_q = jnp.where(
        push_hist,
        state.hist_q.at[jnp.mod(state.hist_count, HIST_CAP)].set(state.q_w),
        state.hist_q,
    )
    hist_count = jnp.where(push_hist, state.hist_count + 1, state.hist_count)
    gflag = jnp.where(resolve, 0, gflag)

    q_w_curr_f = m3.quat_normalize(
        m3.quat_mul(m3.quat_conj(q_w_delta), state.q_w)
    )

    # ---- factor fusion over (q, t) (RGC_odometer.cpp:1024-1119) ----
    ground_active = cfg.use_ground & (gflag == 0) & ground_cur.valid & g_last.valid
    d_ypr_norm = jnp.linalg.norm(d_ypr_deg)
    if imu_rot_var is not None:
        imu_cov = jnp.clip(imu_rot_var, 1e-4, 1.0)
    else:
        imu_cov = jnp.where(d_ypr_norm > 0.6, cfg.imu_cov_fast, 1.0 - fitness)
        imu_cov = jnp.maximum(imu_cov, 1e-4)
    w_ground = jnp.where(ground_active, 1.0, 0.0).astype(dtype)
    w_imu = jnp.asarray(1.0 if cfg.use_imu else 0.0, dtype)
    q_fused, t_fused = fusion_solve(
        q_l, t_l, fitness, g_last, ground_cur, q_w_curr_f,
        delta_q_imu, imu_cov, w_imu, w_ground,
    )
    # without the ground factor the reference keeps the raw VGICP translation
    t_fused = jnp.where(ground_active, t_fused, t_l)

    # ---- pose composition: xy from VGICP, z from the fused solve
    # (RGC_odometer.cpp:1194-1205) ----
    t_tmp_f = m3.quat_rotate(state.q_w, t_fused)
    t_tmp_l = m3.quat_rotate(state.q_w, t_l)
    t_tmp = jnp.stack([t_tmp_l[0], t_tmp_l[1], t_tmp_f[2]])
    t_rel = m3.quat_rotate(m3.quat_conj(state.q_w), t_tmp)
    t_w = state.t_w + m3.quat_rotate(state.q_w, t_rel)
    q_w = m3.quat_normalize(m3.quat_mul(state.q_w, q_fused))

    # ---- 95/5 pitch-roll pullback to the IMU gravity direction
    # (RGC_odometer.cpp:1206-1214) ----
    if cfg.use_imu:
        ypr_w = m3.mat_to_ypr(m3.quat_to_mat(q_w))
        ypr_i = m3.mat_to_ypr(imu_state.rwi())
        ypr_mix = jnp.stack(
            [ypr_w[0], 0.95 * ypr_w[1] + 0.05 * ypr_i[1], 0.95 * ypr_w[2] + 0.05 * ypr_i[2]]
        )
        q_w = m3.ypr_to_quat(ypr_mix)

    # ---- gravity initialization on the first moving frame (A11) ----
    do_grav = cfg.use_imu & (state.frame == 1)
    v_ij = t_rel / frame_dt
    t_ij = jnp.where(jnp.linalg.norm(v_ij) < 0.1, jnp.zeros(3, dtype), t_rel)
    g_new, q_b2w = imu_ops.gravity_init(preint, state.q_w, t_ij, frame_dt, cfg.gravity)
    g_init = jnp.where(do_grav, g_new, state.g_init)
    q_body2world = jnp.where(do_grav, q_b2w, state.q_body2world)

    # ---- consume the init (VERDICT r2 item 3): re-align the odometry world
    # frame so +z opposes the solved gravity.  The reference computes exactly
    # this rotation (RGC_odometer.cpp:1163-1186) and feeds g_init to the
    # preintegration gravity (IMU_Integration->G, cpp:1187); the frame
    # rotation itself is left unapplied there (q_body2world has no reader).
    # Here it is applied once at the init frame — pose, submap store, and
    # g_init itself rotate together, so afterwards the factor library's
    # G = [0, 0, 9.81] IS the solved gravity expressed in the aligned frame.
    # (Steady-state the 95/5 IMU pullback above dominates the attitude, as it
    # does in the reference; the alignment removes any initial tilt the
    # filter warm-up has not yet corrected.)
    if cfg.use_imu:
        qg = jnp.where(do_grav, q_b2w, m3.quat_identity(dtype))
        Rg = m3.quat_to_mat(qg)
        q_w = m3.quat_normalize(m3.quat_mul(qg, q_w))
        t_w = m3.quat_rotate(qg, t_w)
        g_init = m3.quat_rotate(qg, g_init)
        # q_w_delta / hist_q are WORLD-ATTITUDE snapshots consumed by the
        # ground-change machine (q_w_curr_f = conj(q_w_delta) ∘ q_w above);
        # left-multiplying both by qg keeps that relative rotation invariant
        # while expressing the snapshots in the aligned frame, so a large
        # initial tilt does not leave stale pre-alignment attitudes in the
        # history for later re-anchoring.
        q_w_delta = m3.quat_normalize(m3.quat_mul(qg, q_w_delta))
        hist_q = jax.vmap(
            lambda q: m3.quat_normalize(m3.quat_mul(qg, q))
        )(hist_q)
        state = state.replace(
            sub_xyz=jnp.einsum("ij,snj->sni", Rg, state.sub_xyz),
            sub_cov=jnp.einsum("ij,snjk,lk->snil", Rg, state.sub_cov, Rg),
            sub_q=jax.vmap(
                lambda q: m3.quat_normalize(m3.quat_mul(qg, q))
            )(state.sub_q),
            sub_t=jnp.einsum("ij,sj->si", Rg, state.sub_t),
        )

    # ---- first-frame handling: attitude from the IMU filter + configured
    # initial pose (ref RGC_odometer.cpp:865-870: init_x/y/z and init_yaw
    # added to the IMU yaw) ----
    is_first = state.frame == 0
    if cfg.use_imu:
        ypr0 = m3.mat_to_ypr(imu_state.rwi().astype(dtype))
        q_first = m3.ypr_to_quat(
            jnp.stack([ypr0[0] + cfg.init_yaw, ypr0[1], ypr0[2]])
        )
    else:
        q_first = m3.ypr_to_quat(jnp.array([cfg.init_yaw, 0.0, 0.0], dtype))
    t_first = jnp.array([cfg.init_x, cfg.init_y, cfg.init_z], dtype)
    q_w = jnp.where(is_first, q_first, q_w)
    t_w = jnp.where(is_first, t_first, t_w)
    q_rel_out = jnp.where(is_first, m3.quat_identity(dtype), q_fused)
    t_rel_out = jnp.where(is_first, jnp.zeros(3, dtype), t_rel)

    # ---- submap insertion (keyframe-gated, RGC_odometer.cpp:1218-1256) ----
    last_i = jnp.mod(state.sub_next - 1, state.sub_xyz.shape[0])
    ypr_last = m3.mat_to_ypr(m3.quat_to_mat(state.sub_q[last_i]))
    ypr_cur = m3.mat_to_ypr(m3.quat_to_mat(q_w))
    d_ang = jnp.abs(m3.wrap_angle(ypr_last - ypr_cur))
    d_pos = jnp.linalg.norm(state.sub_t[last_i] - t_w)
    want_insert = (
        is_first
        | (state.sub_count < state.sub_xyz.shape[0])
        | (d_pos > cfg.keyframe_dist)
        | jnp.any(d_ang > cfg.keyframe_angle)
    )
    xyz_w = m3.quat_rotate(q_w[None, :], src) + t_w[None, :]
    R_w = m3.quat_to_mat(q_w)
    cov_w = jnp.einsum("ij,njk,lk->nil", R_w, src_cov, R_w)
    new_state_ins = _insert_submap(state, xyz_w, cov_w, src_mask, q_w, t_w)
    state = jax.tree.map(
        lambda a, b: jnp.where(want_insert, b, a), state, new_state_ins
    )

    state = state.replace(
        q_w=q_w,
        t_w=t_w,
        q_last=q_rel_out,
        t_last=t_rel_out,
        frame=state.frame + 1,
        prev_stamp=stamp.astype(dtype),
        ground_last=ground_cur,
        gflag=jnp.asarray(gflag, jnp.int32),
        change_count=jnp.asarray(change_count, jnp.int32),
        q_w_delta=q_w_delta,
        hist_q=hist_q,
        hist_count=hist_count,
        imu_filter=imu_state,
        g_init=g_init,
        q_body2world=q_body2world,
        fitness=fitness,
    )

    out = OdometryOutput(
        q_w=q_w,
        t_w=t_w,
        q_rel=q_rel_out,
        t_rel=t_rel_out,
        delta_q_imu=delta_q_imu,
        fitness=fitness,
        n_corr=res.n_corr,
        deskewed_full=full,
        deskewed_sharp_xyz=sharp_xyz,
        deskewed_flat_xyz=flat_xyz,
        ground=ground_cur,
        gflag=jnp.asarray(gflag, jnp.int32),
    )
    return state, out
