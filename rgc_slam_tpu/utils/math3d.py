"""SO(3)/SE(3) math utilities (JAX).

Quaternions are stored as arrays ``[w, x, y, z]`` (Hamilton convention).
Euler angles are always yaw-pitch-roll (ZYX intrinsic) in **radians**.

Functionality parity with the reference's math layer:
  - ``rgc_slam/include/rgc_slam/utility.h:102-204`` (R2ypr / ypr2R / deltaQ /
    skewSymmetric) and ``include/fast_gicp/so3/so3.hpp:8-76`` (skew, so3_exp).
All functions are pure, jit-safe, and batch along leading axes via vmap.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# basic helpers
# ---------------------------------------------------------------------------


def skew(v: jax.Array) -> jax.Array:
    """3-vector -> 3x3 skew-symmetric matrix (ref: so3.hpp:8-30)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


# ---------------------------------------------------------------------------
# quaternions  [w, x, y, z]
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_conj(q: jax.Array) -> jax.Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) v by quaternion q.  Supports broadcasting."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_mat(q: jax.Array) -> jax.Array:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def mat_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> quaternion [w,x,y,z], branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate constructions; pick the numerically best via where
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-12)) / 2.0
    q0 = jnp.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        axis=-1,
    )
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) / 2.0
    q1 = jnp.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        axis=-1,
    )
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-12)) / 2.0
    q2 = jnp.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        axis=-1,
    )
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-12)) / 2.0
    q3 = jnp.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        axis=-1,
    )

    cond0 = tr > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = jnp.where(
        cond0[..., None],
        q0,
        jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3)),
    )
    return quat_normalize(q)


def quat_from_axis_angle(axis: jax.Array, angle: jax.Array) -> jax.Array:
    half = angle / 2.0
    return jnp.concatenate(
        [jnp.cos(half)[..., None], axis * jnp.sin(half)[..., None]], axis=-1
    )


def quat_slerp(q0: jax.Array, q1: jax.Array, t: jax.Array) -> jax.Array:
    """Spherical interpolation, stable for nearly-identical quats."""
    dot = jnp.sum(q0 * q1, axis=-1)
    q1 = jnp.where(dot[..., None] < 0, -q1, q1)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_theta = jnp.sin(theta)
    # fall back to lerp when angle is tiny
    use_lerp = sin_theta < 1e-5
    w0 = jnp.where(use_lerp, 1.0 - t, jnp.sin((1.0 - t) * theta) / jnp.where(use_lerp, 1.0, sin_theta))
    w1 = jnp.where(use_lerp, t, jnp.sin(t * theta) / jnp.where(use_lerp, 1.0, sin_theta))
    return quat_normalize(w0[..., None] * q0 + w1[..., None] * q1)


def quat_exp(w: jax.Array) -> jax.Array:
    """so(3) vector -> quaternion, exact with small-angle Taylor fallback.

    Ref: ``so3_exp`` at include/fast_gicp/so3/so3.hpp:33-56.
    """
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, 1e-24))
    small = theta_sq < 1e-10
    # sin(t/2)/t
    k_small = 0.5 - theta_sq / 48.0
    k_big = jnp.sin(theta / 2.0) / theta
    k = jnp.where(small, k_small, k_big)
    cw = jnp.where(small, 1.0 - theta_sq / 8.0, jnp.cos(theta / 2.0))
    return quat_normalize(
        jnp.concatenate([cw[..., None], k[..., None] * w], axis=-1)
    )


def quat_log(q: jax.Array) -> jax.Array:
    """quaternion -> so(3) vector (inverse of quat_exp)."""
    q = jnp.where(q[..., 0:1] < 0, -q, q)
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    vnorm = jnp.linalg.norm(q[..., 1:4], axis=-1)
    angle = 2.0 * jnp.arctan2(vnorm, w)
    scale = jnp.where(vnorm < 1e-8, 2.0, angle / jnp.maximum(vnorm, 1e-12))
    return scale[..., None] * q[..., 1:4]


def so3_exp(w: jax.Array) -> jax.Array:
    """so(3) vector -> rotation matrix."""
    return quat_to_mat(quat_exp(w))


def so3_log(R: jax.Array) -> jax.Array:
    return quat_log(mat_to_quat(R))


# ---------------------------------------------------------------------------
# Euler (yaw-pitch-roll, ZYX, radians)
# ---------------------------------------------------------------------------


def ypr_to_mat(ypr: jax.Array) -> jax.Array:
    """[yaw, pitch, roll] (rad) -> R = Rz(y) Ry(p) Rx(r).

    Ref: ``Utility::ypr2R`` utility.h:121-147 (which takes degrees).
    """
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def mat_to_ypr(R: jax.Array) -> jax.Array:
    """R -> [yaw, pitch, roll] (rad).  Ref: ``Utility::R2ypr`` utility.h:105-119."""
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = jnp.arctan2(
        -R[..., 2, 0], jnp.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2)
    )
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    return jnp.stack([yaw, pitch, roll], axis=-1)


def quat_to_ypr(q: jax.Array) -> jax.Array:
    """Quaternion -> [yaw, pitch, roll] (rad).

    Matches ``Quaternion2EulerAngle`` (lidarFactor.hpp:405-432) which returns
    roll/pitch from the standard aerospace formulas.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = jnp.arctan2(sinr_cosp, cosr_cosp)
    sinp = jnp.clip(2.0 * (w * y - x * z), -1.0, 1.0)
    pitch = jnp.arcsin(sinp)
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = jnp.arctan2(siny_cosp, cosy_cosp)
    return jnp.stack([yaw, pitch, roll], axis=-1)


def ypr_to_quat(ypr: jax.Array) -> jax.Array:
    return mat_to_quat(ypr_to_mat(ypr))


def wrap_angle(a: jax.Array) -> jax.Array:
    """Wrap angle(s) to (-pi, pi]."""
    return a - 2.0 * jnp.pi * jnp.floor((a + jnp.pi) / (2.0 * jnp.pi))


def wrap_rollpitch(a: jax.Array) -> jax.Array:
    """Half-wrap to [-pi/2, pi/2] by a single ±pi shift — the reference's
    ``NormalizationRollPitchAngle`` (utility.h:92-99), which keeps the
    complementary filter's roll/pitch on the accelerometer's principal
    branch."""
    return jnp.where(
        a > jnp.pi / 2, a - jnp.pi, jnp.where(a < -jnp.pi / 2, a + jnp.pi, a)
    )


# ---------------------------------------------------------------------------
# SE(3) as (q, t) pairs
# ---------------------------------------------------------------------------


def se3_apply(q: jax.Array, t: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply pose (q, t) to points [..., 3]."""
    return quat_rotate(q, pts) + t


def se3_inverse(q: jax.Array, t: jax.Array):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_compose(qa, ta, qb, tb):
    """(qa,ta) ∘ (qb,tb): apply b first, then a."""
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def se3_mat(q: jax.Array, t: jax.Array) -> jax.Array:
    """(q,t) -> homogeneous 4x4."""
    R = quat_to_mat(q)
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=q.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)
