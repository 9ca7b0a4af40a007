"""Per-stage parity oracles: numpy transliterations of the reference's
numerically subtle stages (VERDICT r2 item 1 — the instrument for the ≤5%
ATE-parity north star in an image with no real data and no buildable C++).

Each function replays the corresponding C++ loop verbatim (same iteration
order, same gates, same quirks) so tests can assert tight numeric agreement
with the JAX engine:

  * ``reference_ground_fit``            scanRegistration.cpp:307-431
  * ``reference_complementary_filter``  RGC_odometer.cpp:545-625 (+ Mid_Filter
                                        utility.h:206-243, eulerRates2bodyRates
                                        RGC_odometer.cpp:206-220)
  * ``reference_gaussian_voxelmap`` /
    ``reference_vgicp_linearize``       fast_vgicp_voxel.hpp:141-266,
                                        impl/fast_vgicp_impl.hpp:73-214
  * ``reference_lm_vgicp``              impl/lsq_registration_impl.hpp:125-172
  * ``reference_fourdof_residual`` /
    ``reference_pgo_solve``             lidarFactor.hpp:557-595,
                                        RGC_mapping.cpp:2302-2466
  * ``reference_mapping_solve``         RGC_mapping.cpp:1076-1354 (the
                                        two-pose scan-to-map Ceres solve) +
                                        the Ceres trust-region LM internals
                                        it runs on (trust_region_minimizer /
                                        levenberg_marquardt_strategy defaults)
  * ``reference_loop_icp``              pcl::IterativeClosestPoint as used at
                                        RGC_mapping.cpp:2050-2081
  * ``reference_odometry_fusion``       RGC_odometer.cpp:1024-1119 (the
                                        odometer's (q,t) fusion Ceres solve)

Host-side and intentionally slow; deliberately quirk-faithful (e.g. the
Mid_Filter's zero-initialized buffers, the duplicate pushes in the ground
accumulation, the degree-denominated FourDOF parametrization).  ``dtype``
parameters let tests mirror the engine's f32 accumulation where the compare
needs bit-level agreement on branchy schedules (the LM accept trace).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# (a) ground segmentation + weighted PCA plane (scanRegistration.cpp:307-431)
# ---------------------------------------------------------------------------


def reference_ground_fit(
    xyz: np.ndarray,            # [N, 3] flat ring-major organized cloud
    rng: np.ndarray,            # [N] per-point range
    ring_sizes: Sequence[int],  # per-ring point counts (rings contiguous)
    expected_ranges: Sequence[float],   # Ground_scan_range per ring
    ground_scan_rings: int = 7,         # groundScanInd
    range_gate: float = 0.8,
    lidar_height: float = 0.56,         # laderH
    ground_z_max: float = 0.3,
    dtype=np.float64,
) -> Dict[str, np.ndarray]:
    """Exact sequential ground marking + weighted PCA + robustified distance.

    Quirks kept: the neighbor flood window is n ∈ [-5, 5) around each seed
    with the *seed's* ring gate; each passing neighbor is PUSHED again for
    every seed that floods it (duplicates weight the moments and the distance
    pass); flood indices run over the flat array and can cross ring
    boundaries; the planarity check (λ1 > 6 λ0) only prints — it does not
    gate the published plane; and ``i / (groundScanInd-1)`` is C++ INTEGER
    division (both ints), so the ring gate and weight are step functions
    (0.8/1.5 for rings 0..gsi-2, 1.6/0.5 for ring gsi-1), not linear ramps.
    """
    xyz = np.asarray(xyz, dtype)
    rng = np.asarray(rng, dtype)
    n = len(xyz)
    gsi = ground_scan_rings
    marked = np.zeros(n, bool)
    pushes: List[Tuple[int, float]] = []   # (flat index, groundweight)

    start = 0
    for i, size in enumerate(ring_sizes):
        if i >= gsi:
            break
        th = range_gate * (1.0 + i // (gsi - 1))   # C++ int division
        gw = 1.5 - i // (gsi - 1)
        for col in range(5, int(size) - 5):
            ci = start + col
            if abs(rng[ci] - expected_ranges[i]) < th and xyz[ci, 2] < ground_z_max:
                marked[ci] = True
                for off in range(-5, 5):
                    j = ci + off
                    if 0 <= j < n and abs(rng[j] - rng[ci]) < th / 2:
                        marked[j] = True
                        pushes.append((j, gw))
        start += int(size)

    out: Dict[str, np.ndarray] = {
        "marked": marked,
        "groundsize": np.asarray(len(pushes)),
    }
    if not pushes:
        return out

    idx = np.array([p[0] for p in pushes])
    w = np.array([p[1] for p in pushes], dtype)
    pts = xyz[idx]
    wsum = w.sum()
    center = (pts * w[:, None]).sum(axis=0) / wsum
    d = pts - center
    cov = np.einsum("n,ni,nj->ij", w, d, d) / wsum
    evals, evecs = np.linalg.eigh(cov)          # ascending like SelfAdjoint
    normal = evecs[:, 0] / np.linalg.norm(evecs[:, 0])
    if center @ normal < 0:
        normal = -normal
    planarity_ok = evals[1] > 6.0 * evals[0]

    d_unit = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-300)
    dw = 1.0 - 100.0 * np.abs(d_unit @ normal)
    dw = np.where(dw < 0, 0.1, dw)
    gs1 = dw.sum()
    distance = (dw * (pts @ normal)).sum() / gs1
    gs1 = gs1 / len(pushes)
    if distance / lidar_height > 1.1 or distance / lidar_height < 0.9:
        distance = lidar_height
    if gs1 < 0.9:
        distance = 0.9 * lidar_height + 0.1 * distance

    out.update(
        center=center, normal=normal, v1=evecs[:, 1], v2=evecs[:, 2],
        distance=np.asarray(distance), source=np.asarray(1.0 - gs1),
        planarity_ok=np.asarray(planarity_ok), evals=evals,
        weight_of=_scatter_weights(n, idx, w),
    )
    return out


def _scatter_weights(n: int, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Total push weight per flat point index (engine-side comparison aid)."""
    out = np.zeros(n)
    np.add.at(out, idx, w)
    return out


# ---------------------------------------------------------------------------
# (b) complementary attitude filter (RGC_odometer.cpp:545-625)
# ---------------------------------------------------------------------------


class _MidFilter:
    """utility.h:206-243 — ring buffer, bubble sort, middle element.  The
    C++ object is a zero-initialized global, so the median includes the
    buffer's zeros until ``filter_size`` samples have been pushed."""

    def __init__(self, size: int):
        self.buf = np.zeros(size)
        self.size = size
        self.count = 0

    def __call__(self, x: float) -> float:
        self.buf[self.count] = x
        self.count += 1
        if self.count >= self.size:
            self.count = 0
        return float(np.sort(self.buf)[(self.size - 1) // 2])


def _euler_rates_to_body(roll: float, pitch: float) -> np.ndarray:
    """eulerRates2bodyRates (RGC_odometer.cpp:206-220)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    return np.array([[1, 0, -sp], [0, cr, sr * cp], [0, -sr, cr * cp]])


def _ypr2R_deg(ypr_deg: np.ndarray) -> np.ndarray:
    """Utility::ypr2R (utility.h:120-150): degrees in, R = Rz(y)Ry(p)Rx(r)."""
    y, p, r = np.asarray(ypr_deg, float) * np.pi / 180.0
    Rz = np.array([[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0], [0, 0, 1]])
    Ry = np.array([[np.cos(p), 0, np.sin(p)], [0, 1, 0], [-np.sin(p), 0, np.cos(p)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]])
    return Rz @ Ry @ Rx


def _norm_angle(a: float) -> float:
    if a > np.pi:
        a -= 2 * np.pi
    elif a < -np.pi:
        a += 2 * np.pi
    return a


def _norm_rollpitch(a: float) -> float:
    """NormalizationRollPitchAngle: HALF wrap — ±π when |angle| > π/2."""
    if a > np.pi / 2:
        a -= np.pi
    elif a < -np.pi / 2:
        a += np.pi
    return a


def reference_complementary_filter(
    t: np.ndarray,              # [M] sample times
    acc: np.ndarray,            # [M, 3] bias-subtracted (handler does acc - ba)
    gyr: np.ndarray,            # [M, 3] bias-subtracted
    gravity: float = 9.81,
) -> Dict[str, np.ndarray]:
    """Exact replay of ``ComplementaryFilter`` over a sample stream.

    The handler (RGC_odometer.cpp:449-486) subtracts the configured biases and
    increments ``count`` BEFORE each call, so sample m (0-based) runs with
    count == m+1.  Returns per-sample roll/pitch/yaw (radians, post-wrap).
    """
    rad2deg = 180.0 / np.pi
    mf_x, mf_y, mf_z = _MidFilter(201), _MidFilter(41), _MidFilter(41)
    roll = pitch = yaw = 0.0
    last_t = 0.0
    first = True
    m = len(t)
    out_r, out_p, out_y = np.zeros(m), np.zeros(m), np.zeros(m)
    out_ax, out_ay, out_az = np.zeros(m), np.zeros(m), np.zeros(m)

    for i in range(m):
        count = i + 1
        d_t = t[i] - last_t
        if first:
            d_t = 0.005
            first = False

        ax = mf_x(acc[i, 0])
        ay = mf_y(acc[i, 1])
        az = mf_z(acc[i, 2])
        k = 0.9 if count < 300 else 0.002

        gx, gy, gz = gyr[i]
        if abs(gz * rad2deg) < 0.2:
            gz = 0.0

        if count > 300:
            Rimu = _ypr2R_deg(np.array([0.0, pitch, roll]) * rad2deg)
            imu_acc = Rimu @ np.array([0.0, 0.0, gravity])
            if abs(ax) > 0.3:
                ratio_x = abs(imu_acc[0]) / abs(ax)
                if ratio_x < 0.8:
                    ax = ratio_x * ax + (1 - ratio_x) * imu_acc[0]
            if abs(ay) > 0.3:
                ratio_y = abs(imu_acc[1]) / abs(ay)
                if ratio_y < 0.8:
                    ay = ratio_y * ay + (1 - ratio_y) * imu_acc[1]

        roll_acc = np.arctan2(ay, az)
        pitch_acc = -np.arctan2(ax, az)

        R_eul2w = _euler_rates_to_body(roll, pitch)
        gx, gy, gz = np.linalg.inv(R_eul2w) @ np.array([gx, gy, gz])

        roll_new = k * roll_acc + (1.0 - k) * (roll + gx * d_t)
        pitch_new = k * pitch_acc + (1.0 - k) * (pitch + gy * d_t)
        yaw_new = yaw + gz / 0.9998 * d_t

        if abs(gz * rad2deg) > 5.0:
            low = 0.005
            roll_new = low * roll_new + (1 - low) * roll
            pitch_new = low * pitch_new + (1 - low) * pitch

        roll = _norm_rollpitch(roll_new)
        pitch = _norm_rollpitch(pitch_new)
        yaw = _norm_angle(yaw_new)
        last_t = t[i]
        out_r[i], out_p[i], out_y[i] = roll, pitch, yaw
        out_ax[i], out_ay[i], out_az[i] = ax, ay, az

    return {"roll": out_r, "pitch": out_p, "yaw": out_y,
            "ax": out_ax, "ay": out_ay, "az": out_az}


# ---------------------------------------------------------------------------
# (c) VGICP voxel map + linearize (fast_vgicp_voxel.hpp / fast_vgicp_impl.hpp)
# ---------------------------------------------------------------------------


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], v.dtype)


def reference_gaussian_voxelmap(
    pts: np.ndarray,            # [N, 3]
    covs: np.ndarray,           # [N, 3, 3]
    resolution: float,
    dtype=np.float64,
) -> Dict[Tuple[int, int, int], Tuple[int, np.ndarray, np.ndarray]]:
    """ADDITIVE GaussianVoxelMap: coord = floor(x/res - 0.5) (the half-voxel
    shift of ``GaussianVoxelMap::voxel_coord``), per-voxel mean of points and
    mean of member covariances.  Returns {coord: (n, mean[3], cov[3,3])}."""
    pts = np.asarray(pts, dtype)
    covs = np.asarray(covs, dtype)
    acc: Dict[Tuple[int, int, int], list] = {}
    for p, c in zip(pts, covs):
        coord = tuple(np.floor(p / resolution - 0.5).astype(int))
        ent = acc.setdefault(coord, [0, np.zeros(3, dtype), np.zeros((3, 3), dtype)])
        ent[0] += 1
        ent[1] = ent[1] + p
        ent[2] = ent[2] + c
    return {k: (n, m / n, c / n) for k, (n, m, c) in acc.items()}


def reference_vgicp_linearize(
    src: np.ndarray,            # [N, 3]
    src_covs: np.ndarray,       # [N, 3, 3]
    vmap: Dict[Tuple[int, int, int], Tuple[int, np.ndarray, np.ndarray]],
    T: np.ndarray,              # [4, 4] target_T_source
    resolution: float,
    with_Hb: bool = True,
    frozen: Optional[list] = None,
    dtype=np.float64,
):
    """``FastVGICP::update_correspondences`` + ``linearize`` (DIRECT1).

    Correspondence = source point's voxel at the transformed position (no
    distance gate in the reference).  Returns (H, b, cost, corr) where corr
    is the frozen correspondence list [(i, mean_B, mahalanobis, w)] reusable
    by ``reference_compute_error`` (the LM accept test re-evaluates cost with
    FROZEN correspondences — fast_gicp freezes them between linearize and
    compute_error).
    """
    T = np.asarray(T, dtype)
    R = T[:3, :3]
    corr = []
    if frozen is None:
        for i in range(len(src)):
            tp = R @ np.asarray(src[i], dtype) + T[:3, 3]
            coord = tuple(np.floor(tp / resolution - 0.5).astype(int))
            hit = vmap.get(coord)
            if hit is None:
                continue
            n_pts, mean_B, cov_B = hit
            RCR = cov_B + R @ np.asarray(src_covs[i], dtype) @ R.T
            mahal = np.linalg.inv(RCR)   # 4x4 form with (3,3)=1 == 3x3 inverse
            corr.append((i, mean_B, mahal, np.sqrt(n_pts)))
    else:
        corr = frozen

    H = np.zeros((6, 6), dtype)
    b = np.zeros(6, dtype)
    cost = dtype(0.0)
    for i, mean_B, mahal, w in corr:
        tp = R @ np.asarray(src[i], dtype) + T[:3, 3]
        err = mean_B - tp
        cost += w * err @ mahal @ err
        if with_Hb:
            J = np.concatenate([_skew(tp), -np.eye(3, dtype=dtype)], axis=1)  # 3x6
            H += w * J.T @ mahal @ J
            b += w * J.T @ mahal @ err
    return H, b, cost, corr


def reference_compute_error(src, corr, T, dtype=np.float64):
    """``FastVGICP::compute_error`` on a frozen correspondence set."""
    T = np.asarray(T, dtype)
    R = T[:3, :3]
    cost = dtype(0.0)
    for i, mean_B, mahal, w in corr:
        tp = R @ np.asarray(src[i], dtype) + T[:3, 3]
        err = mean_B - tp
        cost += w * err @ mahal @ err
    return cost


# ---------------------------------------------------------------------------
# (d) the LM λ-schedule (impl/lsq_registration_impl.hpp:53-172)
# ---------------------------------------------------------------------------


def _so3_exp(omega: np.ndarray) -> np.ndarray:
    """fast_gicp so3_exp (so3.hpp:58-77) -> 3x3 rotation."""
    theta_sq = float(omega @ omega)
    if theta_sq < 1e-10:
        theta_quad = theta_sq * theta_sq
        imag = 0.5 - theta_sq / 48.0 + theta_quad / 3840.0
        real = 1.0 - theta_sq / 8.0 + theta_quad / 384.0
    else:
        theta = np.sqrt(theta_sq)
        imag = np.sin(0.5 * theta) / theta
        real = np.cos(0.5 * theta)
    w, x, y, z = real, *(imag * omega)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def reference_lm_vgicp(
    src: np.ndarray,
    src_covs: np.ndarray,
    tgt: np.ndarray,
    tgt_covs: np.ndarray,
    resolution: float,
    T0: np.ndarray,
    max_iterations: int = 25,
    lm_max_iterations: int = 10,
    lm_init_lambda_factor: float = 1e-9,
    rotation_epsilon: float = 2e-3,
    transformation_epsilon: float = 5e-4,
    dtype=np.float64,
):
    """``LsqRegistration::computeTransformation`` with the LM path: the exact
    λ schedule (init λ = factor·max|diag H|; accept → λ·max(1/3, 1−(2ρ−1)³),
    ν=2; reject → λ·ν, ν·2), frozen-correspondence accept test, elementwise
    |R−I|/|t| convergence.  Returns (T_final, trace) where trace is one dict
    per outer iteration: {y0, n_rejects, accepted, lam_after, converged}.
    """
    vmap = reference_gaussian_voxelmap(tgt, tgt_covs, resolution, dtype)
    x0 = np.asarray(T0, dtype).copy()
    lm_lambda = -1.0
    trace = []
    converged = False

    def is_converged(delta):
        r = np.abs(delta[:3, :3] - np.eye(3)).max() / rotation_epsilon
        tt = np.abs(delta[:3, 3]).max() / transformation_epsilon
        return max(r, tt) < 1.0

    for _ in range(max_iterations):
        if converged:
            break
        H, bvec, y0, corr = reference_vgicp_linearize(
            src, src_covs, vmap, x0, resolution, dtype=dtype
        )
        # note the reference's b has the SAME sign as the engine's: bi = w
        # J^T M err, solved as d = solve(H + λI, -b)
        if lm_lambda < 0.0:
            lm_lambda = lm_init_lambda_factor * np.abs(np.diag(H)).max()

        nu = 2.0
        n_rejects = 0
        accepted = False
        success = False
        for _inner in range(lm_max_iterations):
            d = np.linalg.solve(
                H + lm_lambda * np.eye(6, dtype=dtype), -bvec
            )
            delta = np.eye(4, dtype=dtype)
            delta[:3, :3] = _so3_exp(d[:3])
            delta[:3, 3] = d[3:]
            xi = delta @ x0
            yi = reference_compute_error(src, corr, xi, dtype)
            rho = (y0 - yi) / (d @ (lm_lambda * d - bvec))
            if rho < 0:
                n_rejects += 1
                if is_converged(delta):
                    converged = True
                    success = True
                    break
                lm_lambda = nu * lm_lambda
                nu = 2 * nu
                continue
            x0 = xi
            lm_lambda = lm_lambda * max(1.0 / 3.0, 1 - (2 * rho - 1) ** 3)
            accepted = True
            success = True
            converged = converged or is_converged(delta)
            break
        trace.append(
            dict(y0=float(y0), n_rejects=n_rejects, accepted=accepted,
                 lam_after=float(lm_lambda), converged=bool(converged))
        )
        if not success:   # lm_max_iterations exhausted -> "lm not converged"
            break
    return x0, trace


# ---------------------------------------------------------------------------
# (e) FourDOF residual + dense PGO solve (lidarFactor.hpp:557-595,
#     RGC_mapping.cpp:2302-2466)
# ---------------------------------------------------------------------------


def _norm_deg(a):
    if a > 180.0:
        return a - 360.0
    if a < -180.0:
        return a + 360.0
    return a


def _ypr_deg_to_R(yaw_deg, pitch_deg, roll_deg):
    """YawPitchRollToRotationMatrix (lidarFactor.hpp:518-533)."""
    return _ypr2R_deg(np.array([yaw_deg, pitch_deg, roll_deg]))


def reference_fourdof_residual(
    yaw_i_deg, t_i, yaw_j_deg, t_j, t_meas, relative_yaw_deg, pitch_i_deg, roll_i_deg
) -> np.ndarray:
    """``FourDOFError::operator()`` — angles in DEGREES (the Ceres problem
    parametrizes yaw in degrees; residual[3] is a degree-wrapped angle while
    residuals[0:3] are meters — that unit mix is reference behavior)."""
    t_w_ij = np.asarray(t_j, float) - np.asarray(t_i, float)
    w_R_i = _ypr_deg_to_R(yaw_i_deg, pitch_i_deg, roll_i_deg)
    t_i_ij = w_R_i.T @ t_w_ij
    return np.array(
        [
            t_i_ij[0] - t_meas[0],
            t_i_ij[1] - t_meas[1],
            t_i_ij[2] - t_meas[2],
            _norm_deg(yaw_j_deg - yaw_i_deg - relative_yaw_deg),
        ]
    )


def reference_pgo_solve(
    ypr: np.ndarray,            # [K, 3] keyframe yaw/pitch/roll (radians)
    t: np.ndarray,              # [K, 3]
    loops: Sequence[Tuple[int, int, np.ndarray, float]],
    # each loop: (key_curr i.e. "j"/loop_i, key_loop i.e. "i"/loop_j,
    #             t_rel[3] in the loop keyframe's frame, relative_yaw (rad))
    max_gn_iters: int = 50,
) -> Dict[str, np.ndarray]:
    """``PoseGraphOptimize4DoF``: chain factors from consecutive poses, loop
    factors from the stored constraints, oldest loop keyframe pinned, solved
    densely (numpy lstsq Gauss-Newton stands in for Ceres
    SPARSE_NORMAL_CHOLESKY — same normal equations, exact solve).

    Variables per keyframe: yaw (degrees — the Ceres parametrization) and t.
    Pitch/roll are held at their odometry values inside the factors.
    Returns corrected {"yaw" (rad), "t"}.
    """
    rad2deg = 180.0 / np.pi
    K = len(ypr)
    yaw_deg = ypr[:, 0] * rad2deg
    pitch_deg = ypr[:, 1] * rad2deg
    roll_deg = ypr[:, 2] * rad2deg
    tt = np.asarray(t, float).copy()

    # chain measurements from the current (pre-optimization) poses
    chain = []
    for i in range(1, K):
        R_i = _ypr_deg_to_R(yaw_deg[i - 1], pitch_deg[i - 1], roll_deg[i - 1])
        t_ij = R_i.T @ (tt[i] - tt[i - 1])
        rel_yaw = yaw_deg[i] - yaw_deg[i - 1]   # unwrapped, like the C++
        chain.append((i - 1, i, t_ij, rel_yaw, pitch_deg[i - 1], roll_deg[i - 1]))

    loop_factors = []
    for (ki, kj, t_rel, rel_yaw) in loops:
        loop_factors.append(
            (kj, ki, np.asarray(t_rel, float), rel_yaw * rad2deg,
             pitch_deg[kj], roll_deg[kj])
        )
    if not loop_factors:
        return {"yaw": ypr[:, 0].copy(), "t": tt}
    pinned = min(f[0] for f in loop_factors)

    yawv = yaw_deg.copy()
    tv = tt.copy()

    def residuals_and_jac(yawv, tv):
        rows = []
        J = []
        n_var = 4 * K
        for (a, b, t_meas, rel_yaw, p_a, r_a) in chain + loop_factors:
            r0 = reference_fourdof_residual(
                yawv[a], tv[a], yawv[b], tv[b], t_meas, rel_yaw, p_a, r_a
            )
            rows.append(r0)
            Jrow = np.zeros((4, n_var))
            eps = 1e-6
            for (k, comp) in [(a, "yaw"), (a, "t"), (b, "yaw"), (b, "t")]:
                if comp == "yaw":
                    r1 = reference_fourdof_residual(
                        yawv[a] + (eps if k == a else 0.0), tv[a],
                        yawv[b] + (eps if k == b else 0.0), tv[b],
                        t_meas, rel_yaw, p_a, r_a,
                    )
                    Jrow[:, 4 * k] += (r1 - r0) / eps
                else:
                    for c in range(3):
                        dt = np.zeros(3)
                        dt[c] = eps
                        r1 = reference_fourdof_residual(
                            yawv[a], tv[a] + (dt if k == a else 0.0),
                            yawv[b], tv[b] + (dt if k == b else 0.0),
                            t_meas, rel_yaw, p_a, r_a,
                        )
                        Jrow[:, 4 * k + 1 + c] = (r1 - r0) / eps
            J.append(Jrow)
        return np.concatenate(rows), np.concatenate(J, axis=0)

    free = np.ones(4 * K, bool)
    free[4 * pinned: 4 * pinned + 4] = False
    for it in range(max_gn_iters):
        r, J = residuals_and_jac(yawv, tv)
        Jf = J[:, free]
        dx, *_ = np.linalg.lstsq(Jf, -r, rcond=None)
        full = np.zeros(4 * K)
        full[free] = dx
        yawv = yawv + full[0::4]
        for c in range(3):
            tv[:, c] = tv[:, c] + full[1 + c::4]
        if np.abs(dx).max() < 1e-10:
            break

    return {"yaw": np.array([_norm_angle(y / rad2deg) for y in yawv]), "t": tv}


# ---------------------------------------------------------------------------
# (g) two-pose scan-to-map solve (RGC_mapping.cpp:1076-1354)
# ---------------------------------------------------------------------------
#
# The sixth oracle stage (VERDICT r3 item 2): the *other* Ceres solve.  Per
# outer iteration (iterCount < 2) the four clouds associate against the local
# map (5-NN PCA line fit with the λ2>3λ1 gate for corners; QR plane fit with
# the 0.2 residual gate for surfs), then a fresh Ceres problem over
# (para_q, para_t, para_q_last, para_t_last) solves with HuberLoss(0.1) on
# the lidar factors, NULL loss on RelativeR / PitchRoll /
# Ground_DeltaFactor_goable, DENSE_QR, max_num_iterations = 6.
#
# The solver replayed here is Ceres's default trust-region Levenberg-
# Marquardt (trust_region_minimizer.cc + levenberg_marquardt_strategy.cc):
# radius 1e4, diagonal-scaled augmentation clamped to [1e-6, 1e32],
# min_relative_decrease 1e-3, accept -> radius /= max(1/3, 1-(2ρ-1)³) and
# decrease_factor reset to 2, reject -> radius /= decrease_factor,
# decrease_factor *= 2; function_tolerance 1e-6, parameter_tolerance 1e-8,
# gradient_tolerance 1e-10.  HuberLoss has rho'' <= 0 everywhere, so Ceres's
# corrector is exactly sqrt(rho') scaling of residual AND jacobian (the
# alpha = 0 branch of corrector.cc) — no curvature correction term.
#
# Quaternions use ceres::EigenQuaternionParameterization: x_plus =
# quat(HALF-angle delta) ⊗ x, i.e. q_delta = [cos|d|, sin|d|/|d| · d].


def _quat_rotate_xyzw(q, v):
    """Eigen quaternion rotation, q stored (x, y, z, w)."""
    x, y, z, w = q
    uv = 2.0 * np.cross(q[:3], v)
    return v + w * uv + np.cross(q[:3], uv)


def _quat_mul_xyzw(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _quat_conj_xyzw(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _eigen_quat_plus(q, delta):
    """ceres::EigenQuaternionParameterization::Plus — half-angle delta."""
    nd = np.linalg.norm(delta)
    if nd > 0.0:
        sin_by = np.sin(nd) / nd
        dq = np.array([sin_by * delta[0], sin_by * delta[1],
                       sin_by * delta[2], np.cos(nd)])
        out = _quat_mul_xyzw(dq, q)
    else:
        out = q.copy()
    return out


def _quat2euler_lidarfactor(q_xyzw):
    """Quaternion2EulerAngle (lidarFactor.hpp:405-432) -> [yaw, pitch, roll]."""
    x, y, z, w = q_xyzw
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = np.arctan2(sinr_cosp, cosr_cosp)
    sinp = 2.0 * (w * y - x * z)
    pitch = np.pi / 2 if sinp >= 1 else (-np.pi / 2 if sinp <= -1 else np.arcsin(sinp))
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = np.arctan2(siny_cosp, cosy_cosp)
    return np.array([yaw, pitch, roll])


def reference_mapping_associate(
    pts_sensor: np.ndarray,     # [N, 3] downsampled feature cloud
    conf: np.ndarray,           # [N] normal_x confidence
    q: np.ndarray, t: np.ndarray,   # pose used by pointAssociateToMap
    map_pts: np.ndarray,        # [M, 3] world-frame DS map
    kind: str,                  # "corner" | "surf"
) -> List[dict]:
    """One association pass: exact 5-NN + line/plane fit + gates.

    Corner (RGC_mapping.cpp:1093-1141): 5-NN, sqDis[4] < 1.0, raw-sum
    covariance of the 5 neighbors, accept if λ2 > 3 λ1, line endpoints
    center ± 0.1 · dominant eigenvector.
    Surf (RGC_mapping.cpp:1191-1238): 5-NN, sqDis[4] < 2.0, QR solve of
    A n = -1, d = 1/|n|, accept if all five |n·p + d| <= 0.2.
    Returns one dict per point: {accept, and the factor params if accepted}.
    """
    out = []
    for i in range(len(pts_sensor)):
        p_sel = _quat_rotate_xyzw(q, pts_sensor[i]) + t
        d2 = np.sum((map_pts - p_sel) ** 2, axis=1)
        nn = np.argsort(d2, kind="stable")[:5]
        rec = {"accept": False}
        if kind == "corner":
            if d2[nn[4]] < 1.0:
                near = map_pts[nn]
                center = near.mean(axis=0)
                dd = near - center
                cov = dd.T @ dd
                evals, evecs = np.linalg.eigh(cov)
                if evals[2] > 3.0 * evals[1]:
                    unit = evecs[:, 2]
                    rec = {
                        "accept": True,
                        "pa": center + 0.1 * unit,
                        "pb": center - 0.1 * unit,
                        "var": float(conf[i]),
                        "point": pts_sensor[i],
                    }
        else:
            if d2[nn[4]] < 2.0:
                A = map_pts[nn]
                norm, *_ = np.linalg.lstsq(A, -np.ones(5), rcond=None)
                neg_oa = 1.0 / np.linalg.norm(norm)
                norm = norm / np.linalg.norm(norm)
                if np.all(np.abs(A @ norm + neg_oa) <= 0.2):
                    rec = {
                        "accept": True,
                        "n": norm,
                        "neg_oa": float(neg_oa),
                        "var": float(conf[i]),
                        "point": pts_sensor[i],
                    }
        out.append(rec)
    return out


def _mapping_factor_blocks(
    assoc_c, assoc_cl, assoc_s, assoc_sl,
    delta_q_imu, imu_cov, imu_pr, imu_pr_last,
    grounds,
):
    """Residual blocks as (fn(x) -> r, loss) with x = (q, t, ql, tl).

    Block order mirrors the reference's AddResidualBlock order; order does
    not affect the normal equations, only the bookkeeping."""
    blocks = []

    def edge_block(rec, which):
        def fn(x):
            qq, tt = (x[0], x[1]) if which == "cur" else (x[2], x[3])
            lp = _quat_rotate_xyzw(qq, rec["point"]) + tt
            nu = np.cross(lp - rec["pa"], lp - rec["pb"])
            de = np.linalg.norm(rec["pa"] - rec["pb"])
            return nu / de * rec["var"]
        return fn

    def plane_block(rec, which):
        def fn(x):
            qq, tt = (x[0], x[1]) if which == "cur" else (x[2], x[3])
            pw = _quat_rotate_xyzw(qq, rec["point"]) + tt
            return np.array([(rec["n"] @ pw + rec["neg_oa"]) * rec["var"]])
        return fn

    for rec in assoc_c:
        if rec["accept"]:
            blocks.append((edge_block(rec, "cur"), "huber"))
    for rec in assoc_cl:
        if rec["accept"]:
            blocks.append((edge_block(rec, "last"), "huber"))
    for rec in assoc_s:
        if rec["accept"]:
            blocks.append((plane_block(rec, "cur"), "huber"))
    for rec in assoc_sl:
        if rec["accept"]:
            blocks.append((plane_block(rec, "last"), "huber"))

    if delta_q_imu is not None:
        dq = np.asarray(delta_q_imu, float)    # xyzw

        def rel_r(x):
            qij = _quat_mul_xyzw(_quat_conj_xyzw(x[2]), x[0])
            err = _quat_mul_xyzw(_quat_conj_xyzw(dq), qij)
            return 2.0 * err[:3] / imu_cov
        blocks.append((rel_r, None))

        p_m, r_m = imu_pr

        def pr_cur(x):
            ypr = _quat2euler_lidarfactor(x[0])
            return 2.0 * np.array([ypr[1] - p_m, ypr[2] - r_m]) / 0.02
        blocks.append((pr_cur, None))

        p_l, r_l = imu_pr_last

        def pr_last(x):
            ypr = _quat2euler_lidarfactor(x[2])
            return 2.0 * np.array([ypr[1] - p_l, ypr[2] - r_l]) / 0.02
        blocks.append((pr_last, None))

    if grounds is not None:
        (g_last, g_cur, q_hist, g_last2, q_hist2, q_w_last2, t_w_last2) = grounds

        def ground_fn(g_l, g_c, q_h, get_cur, get_last, var=0.2):
            # Ground_DeltaFactor_goable (lidarFactor.hpp:352-403): last pose
            # is a constant SNAPSHOT (last_q_q/last_t_t); for the current-
            # pose factor that snapshot is the (aliased) para_q_last value at
            # problem creation, handled by the caller passing a closure.
            def fn(x):
                qq, tt = get_cur(x)
                q_l, t_l = get_last(x)
                q_lc = _quat_mul_xyzw(_quat_conj_xyzw(q_l), qq)
                t_lc = _quat_rotate_xyzw(_quat_conj_xyzw(q_l), tt - t_l)
                norm_cur = _quat_rotate_xyzw(q_lc, g_c["normal"])
                delta_t = _quat_rotate_xyzw(q_h, t_lc)
                dist_cur = g_c["distance"] + delta_t[2]
                return np.array([
                    (g_l["distance"] - dist_cur) / (var / 1000.0),
                    abs(g_l["v1"] @ norm_cur) / (var * 10.0),
                    abs(g_l["v2"] @ norm_cur) / (var * 10.0),
                ])
            return fn
        return blocks, ground_fn, (g_last, g_cur, q_hist, g_last2, q_hist2,
                                   q_w_last2, t_w_last2)
    return blocks, None, None


def _ceres_lm_solve(blocks, x0, max_iterations=6, huber_delta=0.1,
                    kinds=("quat", "vec3", "quat", "vec3")):
    """ceres::Solve with TrustRegionMinimizer + LM strategy defaults.

    ``kinds`` names each parameter block of x ("quat" = Eigen quaternion
    parameterization, xyzw storage, 3-dim local tangent; "vec3" = plain);
    local dim = 3·len(kinds).  Jacobians by central finite differences in
    the local parametrization (stands in for autodiff; ~1e-10 accurate).
    """
    radius = 1e4
    decrease_factor = 2.0
    x = [np.asarray(v, float).copy() for v in x0]
    dim = 3 * len(kinds)

    def plus(x, step):
        out = []
        for i, kind in enumerate(kinds):
            d = step[3 * i: 3 * i + 3]
            out.append(_eigen_quat_plus(x[i], d) if kind == "quat"
                       else x[i] + d)
        return out

    def corrected(x):
        """Residual vector + jacobian with the Huber corrector applied."""
        rows, jrows = [], []
        eps = 1e-7
        for fn, loss in blocks:
            r = np.atleast_1d(fn(x))
            J = np.zeros((len(r), dim))
            for c in range(dim):
                dp = np.zeros(dim)
                dp[c] = eps
                rp = np.atleast_1d(fn(plus(x, dp)))
                rm = np.atleast_1d(fn(plus(x, -dp)))
                J[:, c] = (rp - rm) / (2 * eps)
            if loss == "huber":
                s = float(r @ r)
                if s > huber_delta ** 2:
                    w = np.sqrt(huber_delta / np.sqrt(s))
                    r = r * w
                    J = J * w
            rows.append(r)
            jrows.append(J)
        return np.concatenate(rows), np.concatenate(jrows, axis=0)

    def total_cost(x):
        c = 0.0
        for fn, loss in blocks:
            r = np.atleast_1d(fn(x))
            s = float(r @ r)
            if loss == "huber" and s > huber_delta ** 2:
                c += 2 * huber_delta * np.sqrt(s) - huber_delta ** 2
            else:
                c += s
        return 0.5 * c

    cost = total_cost(x)
    for _ in range(max_iterations):
        r, J = corrected(x)
        g = J.T @ r
        if np.abs(g).max() <= 1e-10:
            break
        JtJ_diag = np.sum(J * J, axis=0)
        D = np.sqrt(np.clip(JtJ_diag, 1e-6, 1e32) / radius)
        # DENSE_QR on the augmented system [J; diag(D)] step = [-r; 0]
        A = np.concatenate([J, np.diag(D)], axis=0)
        rhs = np.concatenate([-r, np.zeros(dim)])
        step, *_ = np.linalg.lstsq(A, rhs, rcond=None)
        model_res = J @ step
        model_cost_change = -model_res @ (r + model_res / 2.0)
        accepted = False
        if model_cost_change > 0:
            x_new = plus(x, step)
            new_cost = total_cost(x_new)
            relative_decrease = (cost - new_cost) / model_cost_change
            if relative_decrease > 1e-3:
                accepted = True
                radius = radius / max(1.0 / 3.0,
                                      1.0 - (2.0 * relative_decrease - 1.0) ** 3)
                radius = min(radius, 1e16)
                decrease_factor = 2.0
                cost_change = cost - new_cost
                x = x_new
                for i, kind in enumerate(kinds):
                    if kind == "quat":
                        x[i] = x[i] / np.linalg.norm(x[i])
                converged = (
                    abs(cost_change) <= 1e-6 * cost
                    or np.linalg.norm(step)
                    <= 1e-8 * (np.linalg.norm(np.concatenate(x)) + 1e-8)
                )
                cost = new_cost
                if converged:
                    break
        if not accepted:
            radius = radius / decrease_factor
            decrease_factor *= 2.0
            if radius < 1e-32:
                break
    return x


def reference_mapping_solve(
    corner_cur, corner_cur_conf,
    surf_cur, surf_cur_conf,
    corner_last, corner_last_conf,
    surf_last, surf_last_conf,
    corner_map, surf_map,
    q0, t0, ql0, tl0,           # xyzw quats + translations
    delta_q_imu=None, imu_cov=None, imu_pr=None, imu_pr_last=None,
    grounds=None,               # (g_last, g_cur, q_hist, g_last2, q_hist2,
                                #  q_w_last2, t_w_last2); g_* are dicts with
                                #  normal/v1/v2/distance
    outer_iters=2,
    max_inner_iters=6,
):
    """Full two-pose scan-to-map replay (RGC_mapping.cpp:1076-1354).

    Returns {"q", "t", "ql", "tl", "assoc": per-outer dict of accept masks
    and factor params, "r0": residual blocks at each outer's start}."""
    x = [np.asarray(q0, float).copy(), np.asarray(t0, float).copy(),
         np.asarray(ql0, float).copy(), np.asarray(tl0, float).copy()]
    assoc_log = []
    for _outer in range(outer_iters):
        assoc_c = reference_mapping_associate(
            corner_cur, corner_cur_conf, x[0], x[1], corner_map, "corner")
        assoc_cl = reference_mapping_associate(
            corner_last, corner_last_conf, x[2], x[3], corner_map, "corner")
        assoc_s = reference_mapping_associate(
            surf_cur, surf_cur_conf, x[0], x[1], surf_map, "surf")
        assoc_sl = reference_mapping_associate(
            surf_last, surf_last_conf, x[2], x[3], surf_map, "surf")
        blocks, ground_fn, gparams = _mapping_factor_blocks(
            assoc_c, assoc_cl, assoc_s, assoc_sl,
            delta_q_imu, imu_cov, imu_pr, imu_pr_last, grounds,
        )
        if ground_fn is not None:
            (g_last, g_cur, q_hist, g_last2, q_hist2,
             q_w_last2, t_w_last2) = gparams
            # current-pose ground factor: last pose is snapshotted at problem
            # creation from the ALIASED para_q_last (RGC_mapping.cpp:1322-26)
            ql_snap, tl_snap = x[2].copy(), x[3].copy()
            blocks.append((ground_fn(
                g_last, g_cur, q_hist,
                get_cur=lambda x: (x[0], x[1]),
                get_last=lambda x, q=ql_snap, t=tl_snap: (q, t),
            ), None))
            blocks.append((ground_fn(
                g_last2, g_last, q_hist2,
                get_cur=lambda x: (x[2], x[3]),
                get_last=lambda x: (np.asarray(q_w_last2, float),
                                    np.asarray(t_w_last2, float)),
            ), None))
        assoc_log.append({
            "corner_mask": np.array([a["accept"] for a in assoc_c]),
            "corner_last_mask": np.array([a["accept"] for a in assoc_cl]),
            "surf_mask": np.array([a["accept"] for a in assoc_s]),
            "surf_last_mask": np.array([a["accept"] for a in assoc_sl]),
            "assoc": (assoc_c, assoc_cl, assoc_s, assoc_sl),
            "r0": [np.atleast_1d(fn(x)) for fn, _ in blocks],
            "x0": [v.copy() for v in x],
        })
        x = _ceres_lm_solve(blocks, x, max_iterations=max_inner_iters)
    return {"q": x[0], "t": x[1], "ql": x[2], "tl": x[3], "outer": assoc_log}


# ---------------------------------------------------------------------------
# (i) odometry factor fusion (RGC_odometer.cpp:1024-1213)
# ---------------------------------------------------------------------------


def reference_odometry_fusion(
    q_l, t_l,                  # xyzw VGICP relative pose — init AND measurement
    fitness,                   # vgicp_source
    ground=None,               # (g_last dict, g_cur dict, q_w_curr_f xyzw)
    delta_q_imu=None, imu_cov=None,
    max_iterations=6,
):
    """The odometer's (q, t) fusion Ceres problem (RGC_odometer.cpp:
    1024-1119 + solve at 1188-1193): DeltaRFactor(q_l, vgicp_source) on q;
    when ground is active, DeltaPFactor(t_l, vgicp_source/10) on t and
    Ground_DeltaFactor(g_last, g_cur, q_w_curr_f, 0.2) on (q, t); when IMU
    is active, DeltaRFactor(delta_q_imu, imu_cov) on q.  EVERY block has
    NULL loss — the HuberLoss object at cpp:1025 is created but never
    passed to AddResidualBlock.  DENSE_QR, max_num_iterations = 6.
    Returns {"q", "t"} (xyzw)."""
    blocks = []

    def dr(meas, var):
        m = np.asarray(meas, float)

        def fn(x):
            err = _quat_mul_xyzw(_quat_conj_xyzw(m), x[0])
            return 2.0 * err[:3] / var
        return fn

    blocks.append((dr(q_l, fitness), None))
    if ground is not None:
        g_last, g_cur, q_hist = ground
        tl = np.asarray(t_l, float)
        qh = np.asarray(q_hist, float)

        def dp(x):
            return (x[1] - tl) / (fitness / 10.0)
        blocks.append((dp, None))

        def gd(x):
            norm_cur = _quat_rotate_xyzw(x[0], g_cur["normal"])
            delta_t = _quat_rotate_xyzw(qh, x[1])
            dist_cur = g_cur["distance"] + delta_t[2]
            return np.array([
                (g_last["distance"] - dist_cur) / (0.2 / 1000.0),
                abs(g_last["v1"] @ norm_cur) / (0.2 * 10.0),
                abs(g_last["v2"] @ norm_cur) / (0.2 * 10.0),
            ])
        blocks.append((gd, None))
    if delta_q_imu is not None:
        blocks.append((dr(delta_q_imu, imu_cov), None))

    x = _ceres_lm_solve(
        blocks, [np.asarray(q_l, float), np.asarray(t_l, float)],
        max_iterations=max_iterations, kinds=("quat", "vec3"),
    )
    return {"q": x[0], "t": x[1]}


# ---------------------------------------------------------------------------
# (h) loop-closure ICP (pcl::IterativeClosestPoint as configured at
#     RGC_mapping.cpp:2050-2081)
# ---------------------------------------------------------------------------


def _umeyama_rigid(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Eigen::umeyama(with_scaling=false) as used by PCL's
    TransformationEstimationSVD: R from the SVD of the cross-covariance with
    the det sign fix, t = mu_tgt - R mu_src.  Returns a 4x4."""
    mu_s = src.mean(axis=0)
    mu_t = tgt.mean(axis=0)
    sigma = (tgt - mu_t).T @ (src - mu_s) / len(src)
    U, D, Vt = np.linalg.svd(sigma)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_t - R @ mu_s
    return T


def reference_loop_icp(
    src: np.ndarray,            # [N, 3] latest keyframe cloud
    tgt: np.ndarray,            # [M, 3] history submap cloud
    max_corr: float,            # poseGraphSearchRadius * 2
    max_iterations: int = 100,
    transformation_epsilon: float = 1e-6,
    euclidean_fitness_epsilon: float = 1e-6,
) -> Dict[str, np.ndarray]:
    """pcl::IterativeClosestPoint::align with the reference's settings
    (RGC_mapping.cpp:2051-2056) — RANSAC off, default correspondence
    estimation (1-NN, rejected beyond max_corr), TransformationEstimationSVD,
    DefaultConvergenceCriteria:
      * iterations >= max  -> converged (failure_after_max_iter_ = false)
      * incremental transform: cos_angle >= 1 - eps AND |t|^2 <= eps
      * |mse - mse_prev| < 1e-12 absolute, or / mse_prev < fitness_eps
    Fitness follows getFitnessScore(max_range=+inf): mean squared NN
    distance over ALL source points under the final transform.
    Returns {"T", "fitness", "n_iterations", "converged", "state"}.
    """
    T_final = np.eye(4)
    src_cur = np.asarray(src, float).copy()
    tgt = np.asarray(tgt, float)
    max_d2 = float(max_corr) ** 2
    prev_mse = np.inf
    state = "not_converged"
    nr_iterations = 0

    def nn(pts):
        d2 = ((pts[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
        j = d2.argmin(axis=1)
        return d2[np.arange(len(pts)), j], j

    while True:
        d2, j = nn(src_cur)
        keep = d2 < max_d2
        if keep.sum() < 3:
            state = "failure_no_correspondences"
            break
        T = _umeyama_rigid(src_cur[keep], tgt[j[keep]])
        src_cur = src_cur @ T[:3, :3].T + T[:3, 3]
        T_final = T @ T_final
        nr_iterations += 1
        # DefaultConvergenceCriteria::hasConverged(), in its check order
        if nr_iterations >= max_iterations:
            state = "iterations"
            break
        cos_angle = 0.5 * (T[0, 0] + T[1, 1] + T[2, 2] - 1.0)
        translation_sqr = float(T[:3, 3] @ T[:3, 3])
        if (cos_angle >= 1.0 - transformation_epsilon
                and translation_sqr <= transformation_epsilon):
            state = "transform"
            break
        mse = float(d2[keep].mean())
        if abs(mse - prev_mse) < 1e-12:
            state = "abs_mse"
            break
        if prev_mse != np.inf and abs(mse - prev_mse) / prev_mse < euclidean_fitness_epsilon:
            state = "rel_mse"
            break
        prev_mse = mse

    d2, _ = nn(src_cur)
    return {
        "T": T_final,
        "fitness": float(d2.mean()),       # getFitnessScore, max_range=inf
        "n_iterations": nr_iterations,
        "converged": state != "failure_no_correspondences",
        "state": state,
    }


# ---------------------------------------------------------------------------
# (f) azimuth -> relative sweep time (scanRegistration.cpp:115-207)
# ---------------------------------------------------------------------------


def reference_rel_time(xyz: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Exact sequential transliteration of the projection loop's relTime:
    startOri/endOri with the (pi, 3pi] clamp (cpp:117-127) and the
    halfPassed two-branch angle unwrapping (cpp:186-207).  Quirks kept: the
    trigger point itself keeps its branch-1 angle (the flag is set AFTER
    the current ori is final), and relTime may leave [0, 1]
    (cpp:206 comment: -0.5 < relTime < 1.5)."""
    n = xyz.shape[0]
    start_ori = dtype(-np.arctan2(xyz[0, 1], xyz[0, 0]))
    end_ori = dtype(-np.arctan2(xyz[n - 1, 1], xyz[n - 1, 0])) + 2 * np.pi
    if end_ori - start_ori > 3 * np.pi:
        end_ori -= 2 * np.pi
    elif end_ori - start_ori < np.pi:
        end_ori += 2 * np.pi

    half_passed = False
    rel = np.empty(n, dtype)
    for i in range(n):
        ori = dtype(-np.arctan2(xyz[i, 1], xyz[i, 0]))
        if not half_passed:
            if ori < start_ori - np.pi / 2:
                ori += 2 * np.pi
            elif ori > start_ori + np.pi * 3 / 2:
                ori -= 2 * np.pi
            if ori - start_ori > np.pi:
                half_passed = True
        else:
            ori += 2 * np.pi
            if ori < end_ori - np.pi * 3 / 2:
                ori += 2 * np.pi
            elif ori > end_ori + np.pi / 2:
                ori -= 2 * np.pi
        rel[i] = (ori - start_ori) / (end_ori - start_ori)
    return rel


def _eigen_slerp_wxyz(qa: np.ndarray, qb: np.ndarray, t: float) -> np.ndarray:
    """Eigen Quaternion::slerp, exactly (Quaternion.h): |dot|>=1-eps linear
    branch, acos/sin weights otherwise, shortest-path sign on scale1, NO
    final normalize (unit inputs stay unit to rounding)."""
    d = float(np.dot(qa, qb))
    abs_d = abs(d)
    one = 1.0 - np.finfo(np.float64).eps
    if abs_d >= one:
        scale0, scale1 = 1.0 - t, t
    else:
        theta = np.arccos(abs_d)
        sin_theta = np.sin(theta)
        scale0 = np.sin((1.0 - t) * theta) / sin_theta
        scale1 = np.sin(t * theta) / sin_theta
    if d < 0:
        scale1 = -scale1
    return scale0 * qa + scale1 * qb


def reference_deskew(
    xyz: np.ndarray,
    intensity: np.ndarray,
    q_last_curr_wxyz: np.ndarray,
    t_last_curr: np.ndarray,
    scan_period: float = 0.1,
) -> np.ndarray:
    """Sequential transliteration of ``vg_ICP::adjustDistortion``
    (RGC_odometer.cpp:1441-1481): per point,
    s = 1 - frac(intensity)/SCAN_PERIOD (cpp:1448, SCAN_PERIOD=0.1
    cpp:323), q_p = Identity.slerp(s, q_last_curr^-1) with Eigen's exact
    slerp branches, p' = q_p * (p - s * t_last_curr).  Constant-velocity
    deskew to the end-of-scan frame."""
    q_inv = q_last_curr_wxyz * np.array([1.0, -1.0, -1.0, -1.0])
    ident = np.array([1.0, 0.0, 0.0, 0.0])
    out = np.empty_like(xyz, dtype=np.float64)
    for i in range(xyz.shape[0]):
        s = 1.0 - (intensity[i] - int(intensity[i])) / scan_period
        q_p = _eigen_slerp_wxyz(ident, q_inv, float(s))
        w, qv = q_p[0], q_p[1:]
        v = xyz[i].astype(np.float64) - s * t_last_curr
        # Eigen QuaternionBase::_transformVector: v + 2w(qv x v) + 2 qv x (qv x v)
        uv = 2.0 * np.cross(qv, v)
        out[i] = v + w * uv + np.cross(qv, uv)
    return out
