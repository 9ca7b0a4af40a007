"""Factor library + small Gauss-Newton solver.

JAX rebuild of ``src/lidarFactor.hpp`` (SURVEY §2.2).  Each factor is a pure
residual function; Jacobians come from ``jax.jacfwd`` over a 6-dim (or 12-dim)
tangent parameterization — the JAX-native replacement for Ceres autodiff.
Residual weighting conventions follow the reference exactly (divide by `var`,
the asymmetric ground weights var/1000 and var*10, the 2*vec(q_err) rotation
residuals).

Factors implemented (reference locations):
  * delta_r_residual        — ``DeltaRFactor``       lidarFactor.hpp:132-172
  * relative_r_residual     — ``RelativeRFactor``    lidarFactor.hpp:174-226
  * delta_p_residual        — ``DeltaPFactor``       lidarFactor.hpp:228-265
  * ground_delta_residual   — ``Ground_DeltaFactor`` lidarFactor.hpp:311-350
  * ground_goable_residual  — ``Ground_DeltaFactor_goable``        :352-403
  * pitchroll_residual      — ``PitchRollFactor``    lidarFactor.hpp:434-468
  * edge_residual           — ``LidarEdgeFactor``    lidarFactor.hpp:9-51
  * plane_norm_residual     — ``LidarPlaneNormFactor``             :91-121
  * fourdof_residual        — ``FourDOFError``       lidarFactor.hpp:557-595
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..types import GroundPlane
from ..utils import math3d as m3


# ---------------------------------------------------------------------------
# residuals (all take explicit parameters; quaternions [w,x,y,z])
# ---------------------------------------------------------------------------


def delta_r_residual(q: jax.Array, q_meas: jax.Array, var) -> jax.Array:
    """2 * vec(q_meas^-1 ⊗ q) / var — absolute rotation prior."""
    err = m3.quat_mul(m3.quat_conj(q_meas), q)
    return 2.0 * err[1:4] / var


def relative_r_residual(q_i, q_j, q_meas, var) -> jax.Array:
    """2 * vec(q_meas^-1 ⊗ (q_i^-1 q_j)) / var."""
    qij = m3.quat_mul(m3.quat_conj(q_i), q_j)
    err = m3.quat_mul(m3.quat_conj(q_meas), qij)
    return 2.0 * err[1:4] / var


def delta_p_residual(t: jax.Array, t_meas: jax.Array, var) -> jax.Array:
    return (t - t_meas) / var


def ground_delta_residual(
    q: jax.Array,
    t: jax.Array,
    g_last: GroundPlane,
    g_cur: GroundPlane,
    q_w_curr_f: jax.Array,
    var,
) -> jax.Array:
    """Plane-coplanarity between consecutive scans (3-dim, asymmetric weights).

    residual[0]: Δ plane distance where the translation's contribution is
    taken as the world-z component of q_w_curr_f * t (the reference's
    `delta_t(2,0)` form, lidarFactor.hpp:329-338);
    residual[1:3]: rotated current normal must stay orthogonal to the last
    plane's in-plane eigenvectors.
    """
    norm_cur = m3.quat_rotate(q, g_cur.normal)
    delta_t = m3.quat_rotate(q_w_curr_f, t)
    dist_cur = g_cur.distance + delta_t[2]
    r0 = (g_last.distance - dist_cur) / (var / 1000.0)
    r1 = jnp.abs(jnp.dot(g_last.v1, norm_cur)) / (var * 10.0)
    r2 = jnp.abs(jnp.dot(g_last.v2, norm_cur)) / (var * 10.0)
    return jnp.stack([r0, r1, r2])


def ground_goable_residual(
    q: jax.Array,
    t: jax.Array,
    q_last: jax.Array,
    t_last: jax.Array,
    g_last: GroundPlane,
    g_cur: GroundPlane,
    q_history: jax.Array,
    var,
) -> jax.Array:
    """Ground_DeltaFactor_goable: same as above but the relative pose comes
    from two absolute poses (one held fixed) and a historical anchor
    orientation (lidarFactor.hpp:352-403)."""
    q_lc = m3.quat_mul(m3.quat_conj(q_last), q)
    t_lc = m3.quat_rotate(m3.quat_conj(q_last), t - t_last)
    norm_cur = m3.quat_rotate(q_lc, g_cur.normal)
    delta_t = m3.quat_rotate(q_history, t_lc)
    dist_cur = g_cur.distance + delta_t[2]
    r0 = (g_last.distance - dist_cur) / (var / 1000.0)
    r1 = jnp.abs(jnp.dot(g_last.v1, norm_cur)) / (var * 10.0)
    r2 = jnp.abs(jnp.dot(g_last.v2, norm_cur)) / (var * 10.0)
    return jnp.stack([r0, r1, r2])


def pitchroll_residual(q: jax.Array, pitch_meas, roll_meas, var) -> jax.Array:
    ypr = m3.quat_to_ypr(q)
    return 2.0 * jnp.stack([ypr[1] - pitch_meas, ypr[2] - roll_meas]) / var


def edge_residual(q, t, p, pa, pb, var) -> jax.Array:
    """Point-to-line: |(Tp-a)×(Tp-b)| / |a-b| per-axis, scaled by confidence."""
    lp = m3.quat_rotate(q, p) + t
    nu = jnp.cross(lp - pa, lp - pb)
    de = jnp.linalg.norm(pa - pb)
    return nu / jnp.maximum(de, 1e-9) * var


def plane_norm_residual(q, t, p, unit_norm, neg_oa_dot_norm, var) -> jax.Array:
    pw = m3.quat_rotate(q, p) + t
    return (jnp.dot(unit_norm, pw) + neg_oa_dot_norm) * var


def plane_3pt_residual(q, t, p, pj, pl, pm) -> jax.Array:
    """Point-to-plane with the plane from 3 points (``LidarPlaneFactor``,
    lidarFactor.hpp:53-89 — A-LOAM leftover, unused in the reference graphs
    but part of the factor library surface)."""
    n = jnp.cross(pj - pl, pj - pm)
    n = n / jnp.maximum(jnp.linalg.norm(n), 1e-12)
    lp = m3.quat_rotate(q, p) + t
    return jnp.dot(lp - pj, n)


def imu_delta_p_residual(t, p_meas, p_rel, var) -> jax.Array:
    """2-dim xy translation prior (``IMU_DeltaPFactor``, lidarFactor.hpp:267-309,
    unused in the reference graphs)."""
    e = t + p_rel - p_meas
    return e[:2] / var


def ground_z_residual(t_i, t_j, var) -> jax.Array:
    """z_i - z_j (``GroundFactor``, lidarFactor.hpp:470-488, unused)."""
    return (t_i[2] - t_j[2]) / var


def imu_preint_residual(
    p_i, q_i, v_i, ba_i, bg_i,
    p_j, q_j, v_j, ba_j, bg_j,
    delta_p, delta_q, delta_v, sum_dt,
    gravity: float = 9.81,
) -> jax.Array:
    """Full 15-dim IMU preintegration residual (``IntegrationBase::evaluate``,
    utility.h:349-379 / ``IMUFactor``, lidarFactor.hpp:598-815).

    [r_p(3), r_q(3), r_v(3), r_ba(3), r_bg(3)] with the standard VINS form.
    Bias-correction Jacobians are handled by re-preintegrating in JAX (autodiff
    differentiates through the preintegration scan), so the first-order
    bias-correction terms of the reference are not needed here.
    """
    G = jnp.array([0.0, 0.0, gravity], p_i.dtype)
    qi_inv = m3.quat_conj(q_i)
    r_p = (
        m3.quat_rotate(qi_inv, 0.5 * G * sum_dt * sum_dt + p_j - p_i - v_i * sum_dt)
        - delta_p
    )
    r_q = 2.0 * m3.quat_mul(
        m3.quat_conj(delta_q), m3.quat_mul(qi_inv, q_j)
    )[1:4]
    r_v = m3.quat_rotate(qi_inv, G * sum_dt + v_j - v_i) - delta_v
    return jnp.concatenate([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i])


def fourdof_residual(yaw_i, t_i, yaw_j, t_j, t_ij_meas, yaw_ij_meas, pitch_i, roll_i):
    """4-DoF relative pose residual (radians internally; reference works in
    degrees — conversion handled by the PGO layer)."""
    R_i = m3.ypr_to_mat(jnp.stack([yaw_i, pitch_i, roll_i]))
    t_w_ij = t_j - t_i
    t_i_ij = R_i.T @ t_w_ij
    r_t = t_i_ij - t_ij_meas
    r_yaw = m3.wrap_angle(yaw_j - yaw_i - yaw_ij_meas)
    return jnp.concatenate([r_t, jnp.stack([r_yaw])])


# ---------------------------------------------------------------------------
# Gauss-Newton driver over a tangent-parameterized residual stack
# ---------------------------------------------------------------------------


def gauss_newton(
    residual_fn: Callable[[jax.Array], jax.Array],
    dim: int,
    iterations: int,
    damping: float = 1e-6,
    step_clip: float = 1.0,
    project=None,
    psum_axis=None,
):
    """Iterate x <- x + solve(J^T J, -J^T r) from x=0 via jacfwd.

    ``residual_fn`` must be re-centered by the caller between calls if the
    linearization point moves; here we solve the full nonlinear problem in the
    tangent coordinates of the initial point (adequate for the small-angle
    per-scan problems it serves — mirrors Ceres' 6-iteration DENSE_QR usage,
    RGC_odometer.cpp:1188-1193).
    Returns the final tangent step x*.

    With ``psum_axis`` the residual rows live point-sharded across the named
    mesh axis: each device linearizes its slice, and the dim×dim H / g
    partials are all-reduced before the solve (the device analog of the OpenMP
    reductions in RGC_mapping.cpp:1093-1283).  Residual rows replicated on
    every device must be pre-scaled by rsqrt(axis size) so the psum counts
    them once.
    """
    def body(_, x):
        r = residual_fn(x)
        J = jax.jacfwd(residual_fn)(x)
        H = J.T @ J
        g = J.T @ r
        if psum_axis is not None:
            # reduce BEFORE damping so the ridge is sp-size-invariant
            H = jax.lax.psum(H, psum_axis)
            g = jax.lax.psum(g, psum_axis)
        H = H + damping * jnp.eye(dim, dtype=r.dtype)
        # diagonal equilibration: residual weights span ~1e3 (ground factors
        # at var/1000), so H spans ~1e7 — an unscaled f32 solve destroys the
        # weakly-constrained directions (Ceres survives this in f64)
        s = jax.lax.rsqrt(jnp.maximum(jnp.diag(H), 1e-12))
        Hs = H * s[:, None] * s[None, :] + damping * jnp.eye(dim, dtype=r.dtype)
        dx = s * jnp.linalg.solve(Hs, -(s * g))
        if project is not None:
            # degeneracy-aware solution remapping: zero the update along
            # ill-constrained eigen-directions (Zhang & Kaehler style)
            dx = project @ dx
        dx = jnp.clip(dx, -step_clip, step_clip)
        ok = jnp.all(jnp.isfinite(dx))
        return x + jnp.where(ok, dx, 0.0)

    return jax.lax.fori_loop(0, iterations, body, jnp.zeros(dim))


def huber_rho(s: jax.Array, delta: float = 0.1) -> jax.Array:
    """Ceres HuberLoss rho(s) on squared block norms s: s inside, 2δ√s − δ²
    outside.  Used by the trust-region accept test, which compares TRUE
    robust costs (0.5 Σ rho(s)) — not the IRLS-weighted residual squares
    (Σ rho'(s)·s), which differ for outliers."""
    d2 = delta * delta
    return jnp.where(s <= d2, s, 2.0 * delta * jnp.sqrt(jnp.maximum(s, 1e-30)) - d2)


def ceres_lm(
    residual_fn: Callable[[jax.Array], jax.Array],
    cost_fn: Callable[[jax.Array], jax.Array],
    dim: int,
    iterations: int,
    project=None,
    psum_axis=None,
    radius0: float = 1e4,
    min_relative_decrease: float = 1e-3,
):
    """Ceres trust-region LM over a tangent-parameterized residual stack —
    the solver the reference's mapping problem actually runs
    (RGC_mapping.cpp:1340-1347: DENSE_QR, max_num_iterations=6, otherwise
    Solver::Options defaults; trust_region_minimizer.cc +
    levenberg_marquardt_strategy.cc semantics):

      * augmentation D = clamp(diag(JᵀJ), 1e-6, 1e32) / radius, radius₀=1e4
      * accept iff model_cost_change > 0 AND
        (cost − new_cost)/model_cost_change > 1e-3
      * accept: radius /= max(1/3, 1−(2ρ−1)³), decrease factor resets to 2
      * reject: radius /= decrease_factor, decrease_factor *= 2 — the pose
        does NOT move (this is what plain GN lacks: on outlier-bent steps GN
        walks the pose away while Ceres stands still and re-damps)

    ``residual_fn`` returns the CORRECTED (loss-weighted) residuals used for
    H/g; ``cost_fn`` returns the TRUE robust cost 0.5·Σ rho(s) used by the
    accept test (they differ for Huber outliers).  Both see sharded rows
    under ``psum_axis``; H/g/cost/model-change partials are all-reduced.
    Runs a FIXED ``iterations`` count (rejected steps consume an iteration,
    as in Ceres).  Returns the final tangent step x*.
    """
    def total_cost(x):
        c = cost_fn(x)
        if psum_axis is not None:
            c = jax.lax.psum(c, psum_axis)
        return c

    def body(_, carry):
        x, radius, dec = carry
        r = residual_fn(x)
        J = jax.jacfwd(residual_fn)(x)
        H = J.T @ J
        g = J.T @ r
        if psum_axis is not None:
            H = jax.lax.psum(H, psum_axis)
            g = jax.lax.psum(g, psum_axis)
        cost = total_cost(x)
        D = jnp.clip(jnp.diag(H), 1e-6, 1e32) / radius
        Hd = H + jnp.diag(D)
        # diagonal equilibration before the f32 solve (see gauss_newton)
        s = jax.lax.rsqrt(jnp.maximum(jnp.diag(Hd), 1e-12))
        Hs = Hd * s[:, None] * s[None, :] + 1e-6 * jnp.eye(dim, dtype=r.dtype)
        step = s * jnp.linalg.solve(Hs, -(s * g))
        if project is not None:
            step = project @ step
        model_res = J @ step
        mcc = -jnp.dot(model_res, r + model_res / 2.0)
        if psum_axis is not None:
            mcc = jax.lax.psum(mcc, psum_axis)
        new_cost = total_cost(x + step)
        rel_decrease = (cost - new_cost) / jnp.where(mcc == 0, 1e-30, mcc)
        accept = (
            (mcc > 0)
            & (rel_decrease > min_relative_decrease)
            & jnp.all(jnp.isfinite(step))
        )
        x = jnp.where(accept, x + step, x)
        grow = jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rel_decrease - 1.0) ** 3
        )
        radius = jnp.where(accept, radius / grow, radius / dec)
        radius = jnp.clip(radius, 1e-32, 1e16)
        dec = jnp.where(accept, 2.0, dec * 2.0)
        return x, radius, dec

    x, _, _ = jax.lax.fori_loop(
        0, iterations, body,
        (jnp.zeros(dim), jnp.asarray(radius0), jnp.asarray(2.0)),
    )
    return x


def degeneracy_projection(
    residual_fn: Callable[[jax.Array], jax.Array],
    dim: int,
    eig_thresh: float,
    psum_axis=None,
):
    """Projection matrix keeping only well-constrained directions of J^T J.

    Eigen-directions of the (lidar-factor) normal matrix with eigenvalue below
    ``eig_thresh`` are degenerate — the environment does not observe them
    (e.g. the along-axis direction of a featureless corridor) — and the solver
    must not move along them.  The reference has no such guard (its mapping
    solve wanders in degenerate scenes); this is the standard LOAM-lineage
    solution-remapping fix expressed as a fixed projection per linearization.
    """
    J = jax.jacfwd(residual_fn)(jnp.zeros(dim))
    H = J.T @ J
    if psum_axis is not None:
        # point-sharded residuals: the projection must come from the GLOBAL
        # normal matrix or replicas would project along different eigenbases
        # and their states would diverge
        H = jax.lax.psum(H, psum_axis)
    w, V = jnp.linalg.eigh(H)
    keep = (w > eig_thresh).astype(H.dtype)
    P = (V * keep[None, :]) @ V.T
    n_degenerate = dim - jnp.sum(keep)
    return P, n_degenerate


def gauss_newton_cg(
    residual_fn: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    gn_iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
):
    """Matrix-free Gauss-Newton: each step solves (J^T J + λI) dx = -J^T r by
    conjugate gradients using jvp/vjp products — the XLA-native stand-in for
    Ceres' SPARSE_NORMAL_CHOLESKY on the pose graph (RGC_mapping.cpp:2421-2428).
    Scales to thousands of variables without materializing J.
    """

    def gn_step(_, x):
        r, vjp_fn = jax.vjp(residual_fn, x)
        g = vjp_fn(r)[0]

        def JTJ(p):
            _, Jp = jax.jvp(residual_fn, (x,), (p,))
            return vjp_fn(Jp)[0] + damping * p

        dx, _ = jax.scipy.sparse.linalg.cg(JTJ, -g, maxiter=cg_iters)
        ok = jnp.all(jnp.isfinite(dx))
        return x + jnp.where(ok, dx, 0.0)

    return jax.lax.fori_loop(0, gn_iters, gn_step, x0)
