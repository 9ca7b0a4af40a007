"""IMU frontend: median filter, complementary filter, preintegration.

Rebuilds SURVEY §2.1 A5/A6:
  * running median filters on accelerometer channels (``Mid_Filter``,
    utility.h:206-243; windows 201/41/41 at RGC_odometer.cpp:39)
  * complementary attitude filter with adaptive gain and gyro-rate damping
    (``ComplementaryFilter``, RGC_odometer.cpp:545-716)
  * quaternion-only preintegration (``IMU_preintegration``,
    RGC_odometer.cpp:1418-1422) and VINS-style midpoint Δp/Δv/Δq
    (``IMU_preintegration2`` + ``IntegrationBase``, utility.h:303-380)

All sequential recurrences are ``lax.scan`` over the padded IMU window; the
filter state is an explicit pytree carried across scans.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..types import ImuBatch
from ..utils import math3d as m3
from ..utils import pytree

MED_WIN = 41          # median window for ay/az (ax uses MED_WIN_X)
MED_WIN_X = 201

# startup static-bias estimation window (ref get_init_imu_bias,
# RGC_odometer.cpp:444-486,628-697: drop the first 100 samples, then collect
# ~700 and trimmed-mean them; scaled to 256/32 here — ~1.3 s at 200 Hz)
WARM_DROP = 100
WARM_CAP = 256
WARM_TRIM = 32


@pytree.dataclass
class ImuFilterState:
    """Persistent complementary-filter + median-filter state."""

    roll: jax.Array           # [] rad
    pitch: jax.Array          # [] rad
    yaw: jax.Array            # [] rad
    count: jax.Array          # [] int32 samples processed
    last_t: jax.Array         # [] last sample time
    ba: jax.Array             # [3] accel bias (gravity-aligned init value)
    bg: jax.Array             # [3] gyro bias
    bufx: jax.Array           # [MED_WIN_X] ring buffer accx
    bufy: jax.Array           # [MED_WIN]
    bufz: jax.Array           # [MED_WIN]

    # startup bias-estimation window (see WARM_* above).  bias_ready flips
    # True once the estimate has been applied (or preset True to disable).
    warm_acc: jax.Array       # [WARM_CAP, 3] raw samples after WARM_DROP
    warm_gyr: jax.Array       # [WARM_CAP, 3]
    warm_n: jax.Array         # [] int32 collected count
    bias_ready: jax.Array     # [] bool

    @classmethod
    def init(cls, dtype=jnp.float32) -> "ImuFilterState":
        return cls(
            roll=jnp.asarray(0.0, dtype),
            pitch=jnp.asarray(0.0, dtype),
            yaw=jnp.asarray(0.0, dtype),
            count=jnp.asarray(0, jnp.int32),
            last_t=jnp.asarray(-1.0, dtype),
            ba=jnp.zeros(3, dtype),
            bg=jnp.zeros(3, dtype),
            bufx=jnp.zeros(MED_WIN_X, dtype),
            bufy=jnp.zeros(MED_WIN, dtype),
            bufz=jnp.zeros(MED_WIN, dtype),
            warm_acc=jnp.zeros((WARM_CAP, 3), dtype),
            warm_gyr=jnp.zeros((WARM_CAP, 3), dtype),
            warm_n=jnp.asarray(0, jnp.int32),
            bias_ready=jnp.asarray(False),
        )

    def rwi(self) -> jax.Array:
        """World-from-IMU rotation from the filter attitude."""
        return m3.ypr_to_mat(jnp.stack([self.yaw, self.pitch, self.roll]))


def _median_update(buf: jax.Array, count: jax.Array, x: jax.Array):
    """Push x into ring buffer, return (new_buf, median over filled part)."""
    w = buf.shape[0]
    pos = jnp.mod(count, w)
    buf = buf.at[pos].set(x)
    filled = jnp.minimum(count + 1, w)
    # median over the filled part: mask unfilled slots to +inf, sort, index
    # (ring overwrite order doesn't matter for a median)
    idx = jnp.arange(w)
    masked = jnp.where(idx < filled, buf, jnp.inf)
    srt = jnp.sort(masked)
    med = srt[(filled - 1) // 2]
    return buf, med


def _euler_rates_matrix(roll, pitch):
    """Body rates -> euler-angle rates (ref eulerRates2bodyRates inverse)."""
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    tp = sp / jnp.maximum(cp, 1e-6)
    return jnp.array(
        [
            [1.0, sr * tp, cr * tp],
            [0.0, cr, -sr],
            [0.0, sr / jnp.maximum(cp, 1e-6), cr / jnp.maximum(cp, 1e-6)],
        ]
    )


def complementary_filter_scan(state: ImuFilterState, imu: ImuBatch, gravity: float = 9.81):
    """Run the complementary filter over one padded IMU window."""
    rad2deg = 57.29577951308232

    def step(s: ImuFilterState, inp):
        t, acc, gyr, valid = inp
        dt = jnp.where(
            (s.last_t > 0) & (t > s.last_t), t - s.last_t, 0.005
        )
        # median filters on acc channels (RGC_odometer.cpp:561-563)
        bufx, ax = _median_update(s.bufx, s.count, acc[0])
        bufy, ay = _median_update(s.bufy, s.count, acc[1])
        bufz, az = _median_update(s.bufz, s.count, acc[2])

        # the handler increments count BEFORE the filter runs
        # (RGC_odometer.cpp:484-485), so sample m sees count == m+1
        cnt = s.count + 1
        k = jnp.where(cnt < 300, 0.9, 0.002)
        gx, gy, gz = gyr[0] - s.bg[0], gyr[1] - s.bg[1], gyr[2] - s.bg[2]
        gz = jnp.where(jnp.abs(gz * rad2deg) < 0.2, 0.0, gz)

        # acceleration gating toward expected gravity direction (cpp:578-596)
        Rimu = m3.ypr_to_mat(jnp.stack([jnp.zeros_like(s.pitch), s.pitch, s.roll]))
        acc_exp = Rimu @ jnp.array([0.0, 0.0, gravity])
        ratio_x = jnp.abs(acc_exp[0]) / jnp.maximum(jnp.abs(ax), 1e-6)
        ax = jnp.where(
            (cnt > 300) & (jnp.abs(ax) > 0.3) & (ratio_x < 0.8),
            ratio_x * ax + (1 - ratio_x) * acc_exp[0],
            ax,
        )
        ratio_y = jnp.abs(acc_exp[1]) / jnp.maximum(jnp.abs(ay), 1e-6)
        ay = jnp.where(
            (cnt > 300) & (jnp.abs(ay) > 0.3) & (ratio_y < 0.8),
            ratio_y * ay + (1 - ratio_y) * acc_exp[1],
            ay,
        )

        roll_acc = jnp.arctan2(ay, az)
        pitch_acc = -jnp.arctan2(ax, az)

        # body rates -> euler rates (cpp:600-605)
        E = _euler_rates_matrix(s.roll, s.pitch)
        er = E @ jnp.stack([gx, gy, gz])

        roll = k * roll_acc + (1.0 - k) * (s.roll + er[0] * dt)
        pitch = k * pitch_acc + (1.0 - k) * (s.pitch + er[1] * dt)
        yaw = s.yaw + er[2] / 0.9998 * dt

        # damp attitude updates during fast rotation (cpp:612-618) — the
        # reference converts gz to the euler yaw rate IN PLACE before this
        # test, so the threshold applies to er[2], not the body rate
        fast = jnp.abs(er[2] * rad2deg) > 5.0
        low = 0.005
        roll = jnp.where(fast, low * roll + (1 - low) * s.roll, roll)
        pitch = jnp.where(fast, low * pitch + (1 - low) * s.pitch, pitch)

        # startup bias window: collect raw samples after the WARM_DROP
        # discard (ref drops the first 100, RGC_odometer.cpp:452-457)
        collect = valid & (s.count >= WARM_DROP) & (s.warm_n < WARM_CAP) & ~s.bias_ready
        wpos = jnp.clip(s.warm_n, 0, WARM_CAP - 1)
        warm_acc = jnp.where(collect, s.warm_acc.at[wpos].set(acc), s.warm_acc)
        warm_gyr = jnp.where(collect, s.warm_gyr.at[wpos].set(gyr), s.warm_gyr)

        new = s.replace(
            # roll/pitch take the reference's HALF wrap (±pi past ±pi/2,
            # NormalizationRollPitchAngle), yaw the full wrap
            roll=jnp.where(valid, m3.wrap_rollpitch(roll), s.roll),
            pitch=jnp.where(valid, m3.wrap_rollpitch(pitch), s.pitch),
            yaw=jnp.where(valid, m3.wrap_angle(yaw), s.yaw),
            count=jnp.where(valid, s.count + 1, s.count),
            last_t=jnp.where(valid, t, s.last_t),
            bufx=jnp.where(valid, bufx, s.bufx),
            bufy=jnp.where(valid, bufy, s.bufy),
            bufz=jnp.where(valid, bufz, s.bufz),
            warm_acc=warm_acc,
            warm_gyr=warm_gyr,
            warm_n=jnp.where(collect, s.warm_n + 1, s.warm_n),
        )
        return new, None

    out, _ = jax.lax.scan(step, state, (imu.t, imu.acc, imu.gyr, imu.mask))

    # ---- startup bias/attitude initialization (ref get_init_imu_bias):
    # once the warm-up window fills, trimmed-mean the stationary samples.
    # Applied only if at least half the window tested static — a robot moving
    # from power-on keeps zero biases (round-1 behavior) rather than adopting
    # a motion-polluted estimate.
    ready_now = (~out.bias_ready) & (out.warm_n >= WARM_CAP)
    all_mask = jnp.ones(WARM_CAP, bool)
    ba_mean, bg_mean, roll_i, pitch_i = estimate_static_bias(
        out.warm_acc, out.warm_gyr, all_mask, trim=WARM_TRIM, gravity=gravity
    )
    n_static = jnp.sum(check_static(out.warm_acc, out.warm_gyr, gravity))
    apply = ready_now & (n_static >= WARM_CAP // 2)
    # true accel bias for preintegration = norm excess along the measured
    # gravity direction (the stationary mean IS gravity-in-body + bias);
    # convention-free, unlike reconstructing R(roll,pitch) here
    ba_norm = jnp.linalg.norm(ba_mean)
    ba_true = ba_mean * (1.0 - gravity / jnp.maximum(ba_norm, 1e-6))
    out = out.replace(
        ba=jnp.where(apply, ba_true, out.ba),
        bg=jnp.where(apply, bg_mean, out.bg),
        roll=jnp.where(apply, roll_i, out.roll),
        pitch=jnp.where(apply, pitch_i, out.pitch),
        bias_ready=out.bias_ready | ready_now,
    )
    return out


def check_static(acc: jax.Array, gyr: jax.Array, gravity: float = 9.81):
    """Per-sample stationarity test (ref ``checkImuState``,
    RGC_odometer.cpp:699-716): |acc|-g within 0.5 m/s^2 and every gyro axis
    below 0.05 rad/s."""
    acc_ok = jnp.abs(jnp.linalg.norm(acc, axis=-1) - gravity) <= 0.5
    gyr_ok = jnp.all(jnp.abs(gyr) <= 0.05, axis=-1)
    return acc_ok & gyr_ok


def estimate_static_bias(
    acc: jax.Array,           # [N, 3] samples collected while stationary
    gyr: jax.Array,           # [N, 3]
    mask: jax.Array,          # [N]
    trim: int = 50,
    gravity: float = 9.81,
):
    """Startup bias/attitude estimation (ref ``get_init_imu_bias``,
    RGC_odometer.cpp:628-697): keep stationary samples, trimmed-mean each
    channel (the reference sorts and drops 50 from each end of 700), derive
    the initial roll/pitch from the gravity direction.

    Returns (ba [3], bg [3], roll_init, pitch_init).  Like the reference, the
    "accel bias" is the full stationary specific-force mean — consumed only by
    the attitude init, not subtracted from measurements.
    """
    ok = mask & check_static(acc, gyr, gravity)

    def trimmed_mean(x):
        # sort with invalid samples pushed to +inf, then average the valid
        # middle section
        big = jnp.where(ok[:, None], x, jnp.inf)
        srt = jnp.sort(big, axis=0)
        n_ok = jnp.sum(ok)
        n_use = jnp.maximum(n_ok - 2 * trim, 1)
        lo = jnp.minimum(trim, jnp.maximum(n_ok - 1, 0))
        idx = jnp.arange(x.shape[0])[:, None]
        use = (idx >= lo) & (idx < lo + n_use)
        return jnp.sum(jnp.where(use & jnp.isfinite(srt), srt, 0.0), axis=0) / n_use

    ba = trimmed_mean(acc)
    bg = trimmed_mean(gyr)
    roll_init = jnp.arctan2(ba[1], ba[2])
    pitch_init = -jnp.arctan2(ba[0], jnp.sqrt(ba[1] ** 2 + ba[2] ** 2))
    return ba, bg, roll_init, pitch_init


class Preintegration(NamedTuple):
    """Δ quantities over one scan interval (body frame of the first sample)."""

    delta_q: jax.Array        # [4]
    delta_p: jax.Array        # [3]
    delta_v: jax.Array        # [3]
    sum_dt: jax.Array         # []


def preintegrate(
    imu: ImuBatch,
    t0: jax.Array,
    t1: jax.Array,
    ba: jax.Array,
    bg: jax.Array,
) -> Preintegration:
    """Quaternion + midpoint Δp/Δv preintegration over [t0, t1].

    Mirrors the per-sample dt bookkeeping of RGC_odometer.cpp:899-928 (first
    sample measured from t0) and the midpoint rule of ``IMU_preintegration2``.
    """
    m = imu.t.shape[0]

    # dt per sample: first = t - t0, else t_i - t_{i-1}
    prev_t = jnp.concatenate([jnp.array([-1.0], imu.t.dtype), imu.t[:-1]])
    prev_valid = jnp.concatenate([jnp.array([False]), imu.mask[:-1]])
    dt = jnp.where(prev_valid, imu.t - prev_t, imu.t - t0)
    dt = jnp.where(imu.mask, jnp.maximum(dt, 0.0), 0.0)

    prev_acc = jnp.concatenate([imu.acc[:1], imu.acc[:-1]], axis=0)
    prev_gyr = jnp.concatenate([imu.gyr[:1], imu.gyr[:-1]], axis=0)
    acc0 = jnp.where(prev_valid[:, None], prev_acc, imu.acc)
    gyr0 = jnp.where(prev_valid[:, None], prev_gyr, imu.gyr)

    def step(carry, inp):
        q, p, v, sdt = carry
        dt_i, a0, a1, g0, g1, valid = inp
        un_acc_0 = m3.quat_rotate(q, a0 - ba)
        un_gyr = 0.5 * (g0 + g1) - bg
        dq = m3.quat_normalize(
            jnp.concatenate([jnp.ones((1,), q.dtype), un_gyr * dt_i / 2.0])
        )
        q_new = m3.quat_normalize(m3.quat_mul(q, dq))
        un_acc_1 = m3.quat_rotate(q_new, a1 - ba)
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        p_new = p + v * dt_i + 0.5 * un_acc * dt_i * dt_i
        v_new = v + un_acc * dt_i
        q_out = jnp.where(valid, q_new, q)
        p_out = jnp.where(valid, p_new, p)
        v_out = jnp.where(valid, v_new, v)
        return (q_out, p_out, v_out, sdt + jnp.where(valid, dt_i, 0.0)), None

    init = (
        m3.quat_identity(imu.acc.dtype),
        jnp.zeros(3, imu.acc.dtype),
        jnp.zeros(3, imu.acc.dtype),
        jnp.asarray(0.0, imu.acc.dtype),
    )
    (q, p, v, sdt), _ = jax.lax.scan(
        step, init, (dt, acc0, imu.acc, gyr0, imu.gyr, imu.mask)
    )
    return Preintegration(delta_q=q, delta_p=p, delta_v=v, sum_dt=sdt)


class PreintegrationFull(NamedTuple):
    """Preintegration with 15-dim uncertainty (ref ``IntegrationBase``,
    utility.h:303-380).  Tangent-state order: [δp, δθ, δv, δba, δbg]."""

    delta_q: jax.Array        # [4]
    delta_p: jax.Array        # [3]
    delta_v: jax.Array        # [3]
    sum_dt: jax.Array         # []
    cov: jax.Array            # [15, 15] propagated noise covariance
    jac: jax.Array            # [15, 15] d(state)/d(state0); columns 9:15 are
    #                           the bias-correction Jacobians (∂Δ/∂ba, ∂Δ/∂bg)


def preintegrate_full(
    imu: ImuBatch,
    t0: jax.Array,
    t1: jax.Array,
    ba: jax.Array,
    bg: jax.Array,
    acc_n: float = 0.08,
    gyr_n: float = 0.004,
    acc_w: float = 4e-5,
    gyr_w: float = 2e-6,
) -> PreintegrationFull:
    """Midpoint preintegration with 15-dim covariance + bias Jacobians.

    The reference's ``IntegrationBase::midpointIntegration``
    (utility.h:303-380) hand-derives the 15x15 transition F and 15x18 noise
    matrix V per sample.  Here both are the exact linearization of the same
    midpoint step, obtained by forward-mode autodiff of a tangent-space
    wrapper — no hand-derived blocks to get wrong, and the 27 JVP columns
    batch as elementwise ops.  One fidelity upgrade over the reference: the
    midpoint rule reuses each sample's measurement noise in two consecutive
    steps (as the step-k ``a1`` and the step-k+1 ``a0``); VINS treats those
    as independent, underestimating σ by √2 (verified by Monte-Carlo).  We
    carry the previous sample's noise as 6 extra augmented-state dims so the
    correlation is exact.  Noise model: white measurement noise densities
    ``acc_n``/``gyr_n`` (discretized as σ²/dt) and bias random walks
    ``acc_w``/``gyr_w`` (σ²·dt).
    """
    dtype = imu.acc.dtype

    prev_t = jnp.concatenate([jnp.array([-1.0], imu.t.dtype), imu.t[:-1]])
    prev_valid = jnp.concatenate([jnp.array([False]), imu.mask[:-1]])
    dt = jnp.where(prev_valid, imu.t - prev_t, imu.t - t0)
    dt = jnp.where(imu.mask, jnp.maximum(dt, 0.0), 0.0)
    prev_acc = jnp.concatenate([imu.acc[:1], imu.acc[:-1]], axis=0)
    prev_gyr = jnp.concatenate([imu.gyr[:1], imu.gyr[:-1]], axis=0)
    acc0s = jnp.where(prev_valid[:, None], prev_acc, imu.acc)
    gyr0s = jnp.where(prev_valid[:, None], prev_gyr, imu.gyr)

    def midpoint(q, p, v, ba_, bg_, a0, a1, g0, g1, dt_i):
        un_gyr = 0.5 * (g0 + g1) - bg_
        dq = m3.quat_normalize(
            jnp.concatenate([jnp.ones((1,), dtype), un_gyr * dt_i / 2.0])
        )
        q_new = m3.quat_normalize(m3.quat_mul(q, dq))
        un_acc = 0.5 * (m3.quat_rotate(q, a0 - ba_) + m3.quat_rotate(q_new, a1 - ba_))
        p_new = p + v * dt_i + 0.5 * un_acc * dt_i * dt_i
        v_new = v + un_acc * dt_i
        return q_new, p_new, v_new

    # ---- phase 1: nominal trajectory per sample (cheap sequential scan) ----
    def mean_step(carry, inp):
        q, p, v, sdt = carry
        dt_i, a0, a1, g0, g1, valid = inp
        q_new, p_new, v_new = midpoint(q, p, v, ba, bg, a0, a1, g0, g1, dt_i)
        out = (
            jnp.where(valid, q_new, q),
            jnp.where(valid, p_new, p),
            jnp.where(valid, v_new, v),
            sdt + jnp.where(valid, dt_i, 0.0),
        )
        # carry-IN state is the linearization point of sample k
        return out, (q, p, v)

    init = (
        m3.quat_identity(dtype),
        jnp.zeros(3, dtype),
        jnp.zeros(3, dtype),
        jnp.asarray(0.0, dtype),
    )
    xs = (dt, acc0s, imu.acc, gyr0s, imu.gyr, imu.mask)
    (q, p, v, sdt), (qs, ps, vs) = jax.lax.scan(mean_step, init, xs)

    # ---- phase 2: per-sample F/V by vmapped forward-mode autodiff ----
    # (the 27 JVP columns AND the sample axis batch together —
    # the naive formulation ran jacfwd inside the scan, serializing the
    # samples and making cfg.imu_cov_mode="preint" ~3x the IMU-path cost)
    def linearize(q0_, p0_, v0_, dt_i, a0, a1, g0, g1):
        q_new, p_new, v_new = midpoint(q0_, p0_, v0_, ba, bg, a0, a1, g0, g1, dt_i)

        def perturbed(z):
            """z = [xi(15), n_prev(6): a0/g0 noise, n_new(6): a1/g1 noise]
            -> augmented output tangent [x'(15), n_new(6)]."""
            xi, np_, nn = z[:15], z[15:21], z[21:27]
            q_ = m3.quat_mul(q0_, m3.quat_exp(xi[3:6]))
            q2, p2, v2 = midpoint(
                q_, p0_ + xi[:3], v0_ + xi[6:9], ba + xi[9:12], bg + xi[12:15],
                a0 + np_[0:3], a1 + nn[0:3], g0 + np_[3:6], g1 + nn[3:6], dt_i,
            )
            th = m3.quat_log(m3.quat_mul(m3.quat_conj(q_new), q2))
            return jnp.concatenate(
                [p2 - p_new, th, v2 - v_new, xi[9:12], xi[12:15], nn]
            )

        return jax.jacfwd(perturbed)(jnp.zeros(27, dtype))   # [21, 27]

    FV = jax.vmap(linearize)(qs, ps, vs, dt, acc0s, imu.acc, gyr0s, imu.gyr)
    F_aug, V_aug = FV[:, :, :21], FV[:, :, 21:]              # [m,21,21],[m,21,6]
    dts = jnp.maximum(dt, 1e-4)
    qd = jnp.concatenate(
        [
            jnp.broadcast_to((acc_n**2 / dts)[:, None], (dt.shape[0], 3)),
            jnp.broadcast_to((gyr_n**2 / dts)[:, None], (dt.shape[0], 3)),
        ],
        axis=1,
    )
    walk_diag = jnp.concatenate(
        [
            jnp.zeros((dt.shape[0], 9), dtype),
            jnp.broadcast_to((acc_w**2 * dts)[:, None], (dt.shape[0], 3)),
            jnp.broadcast_to((gyr_w**2 * dts)[:, None], (dt.shape[0], 3)),
            jnp.zeros((dt.shape[0], 6), dtype),
        ],
        axis=1,
    )

    # ---- phase 3: the 21x21 covariance / 15x15 Jacobian recurrence ----
    def cov_step(carry, inp):
        cov, jac = carry
        Fk, Vk, qdk, wk, valid = inp
        cov_new = Fk @ cov @ Fk.T + (Vk * qdk[None, :]) @ Vk.T + jnp.diag(wk)
        jac_new = Fk[:15, :15] @ jac
        return (
            jnp.where(valid, cov_new, cov),
            jnp.where(valid, jac_new, jac),
        ), None

    (cov, jac), _ = jax.lax.scan(
        cov_step,
        (jnp.zeros((21, 21), dtype), jnp.eye(15, dtype=dtype)),
        (F_aug, V_aug, qd, walk_diag, imu.mask),
    )
    return PreintegrationFull(
        delta_q=q, delta_p=p, delta_v=v, sum_dt=sdt, cov=cov[:15, :15], jac=jac
    )


def bias_corrected_delta(pre: PreintegrationFull, dba: jax.Array, dbg: jax.Array):
    """First-order bias correction of the preintegrated deltas (the reference
    re-evaluates via ``IntegrationBase::evaluate``'s Jacobian blocks)."""
    dp = pre.delta_p + pre.jac[0:3, 9:12] @ dba + pre.jac[0:3, 12:15] @ dbg
    dv = pre.delta_v + pre.jac[6:9, 9:12] @ dba + pre.jac[6:9, 12:15] @ dbg
    dth = pre.jac[3:6, 12:15] @ dbg
    dq = m3.quat_normalize(m3.quat_mul(pre.delta_q, m3.quat_exp(dth)))
    return dq, dp, dv


def gravity_init(
    preint: Preintegration,
    q_w_curr: jax.Array,
    t_ij: jax.Array,
    dt: jax.Array,
    gravity: float = 9.81,
):
    """First-frame gravity-direction initialization (SURVEY A11).

    The reference solves two sequential Ceres problems
    (RGC_odometer.cpp:1121-1186) whose residuals are *linear* in (g, vi, vj):
        r_p = t_ij + q (0.5 g dt^2 - vi dt) - Δp
        r_v = q (vj - vi + g dt) - Δv
    We solve the same system directly by min-norm least squares around the
    prior g0 = (0,0,9.81) and renormalize to |g| = 9.81, then return the
    rotation aligning g to the world +z axis (q_body2world).
    """
    dtype = t_ij.dtype
    R = m3.quat_to_mat(q_w_curr)
    # unknown x = [g(3), vi(3), vj(3)] ; residuals r = A x - rhs
    A_p = jnp.concatenate([0.5 * dt * dt * R, -dt * R, jnp.zeros((3, 3), dtype)], axis=1)
    A_v = jnp.concatenate([dt * R, -R, R], axis=1)
    A = jnp.concatenate([A_p, A_v], axis=0)
    rhs = jnp.concatenate([preint.delta_p - t_ij, preint.delta_v])
    # min-norm solution around prior x0
    x0 = jnp.concatenate([jnp.array([0.0, 0.0, gravity], dtype), jnp.zeros(6, dtype)])
    r0 = rhs - A @ x0
    dx = A.T @ jnp.linalg.solve(A @ A.T + 1e-6 * jnp.eye(6, dtype=dtype), r0)
    x = x0 + dx
    g = x[:3]
    g = gravity * g / jnp.maximum(jnp.linalg.norm(g), 1e-6)
    # rotation taking g to +z*gravity (RGC_odometer.cpp:1163-1186)
    g_w = jnp.array([0.0, 0.0, gravity], dtype)
    axis = jnp.cross(g, g_w)
    axis_n = jnp.linalg.norm(axis)
    angle = jnp.arctan2(axis_n, jnp.dot(g, g_w))
    axis = jnp.where(axis_n < 1e-8, jnp.array([1.0, 0.0, 0.0], dtype), axis / jnp.maximum(axis_n, 1e-8))
    q_body2world = m3.quat_from_axis_angle(axis, angle)
    return g, m3.quat_normalize(q_body2world)
