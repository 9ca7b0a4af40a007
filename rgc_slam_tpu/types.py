"""Core pytree containers for the SLAM engine.

These replace the reference's PCL point clouds + ROS messages (SURVEY §1, L1:
``utility.h:76-79,245-301``, ``ground_msg/msg/groundparam.msg``) with
fixed-shape, mask-padded JAX arrays.  Every container is a pytree dataclass
(utils/pytree.py) so it flows through jit / vmap / scan and serializes for
checkpointing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .utils import pytree


@pytree.dataclass
class PointCloud:
    """Padded point cloud: xyz positions + per-point attributes + valid mask.

    `rel_time` packs the reference's ring-relative timestamp (the decimal part
    of the `intensity = ringID + 0.1*relTime` encoding, scanRegistration.cpp:210)
    as its own channel — no bit packing needed.
    """

    xyz: jax.Array            # [N, 3] float32
    intensity: jax.Array      # [N] float32 (raw reflectivity)
    rel_time: jax.Array       # [N] float32, fraction of sweep in [0, 1)
    ring: jax.Array           # [N] int32
    mask: jax.Array           # [N] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    @classmethod
    def zeros(cls, n: int, dtype=jnp.float32) -> "PointCloud":
        return cls(
            xyz=jnp.zeros((n, 3), dtype),
            intensity=jnp.zeros((n,), dtype),
            rel_time=jnp.zeros((n,), dtype),
            ring=jnp.zeros((n,), jnp.int32),
            mask=jnp.zeros((n,), bool),
        )


@pytree.dataclass
class FeatureCloud:
    """Feature points with per-point confidence (`normal_x` in the reference,
    scanRegistration.cpp:501,554,609)."""

    xyz: jax.Array            # [N, 3]
    rel_time: jax.Array       # [N]
    confidence: jax.Array     # [N]
    mask: jax.Array           # [N] bool

    @classmethod
    def zeros(cls, n: int, dtype=jnp.float32) -> "FeatureCloud":
        return cls(
            xyz=jnp.zeros((n, 3), dtype),
            rel_time=jnp.zeros((n,), dtype),
            confidence=jnp.zeros((n,), dtype),
            mask=jnp.zeros((n,), bool),
        )


@pytree.dataclass
class GroundPlane:
    """Per-scan ground-plane estimate (ref ground_msg/msg/groundparam.msg:1-12).

    normal / v1 / v2 are the weighted-PCA eigenvectors (ascending eigenvalue),
    distance the robustified plane offset, source = 1 - confidence.
    """

    normal: jax.Array         # [3]
    v1: jax.Array             # [3] in-plane eigvec
    v2: jax.Array             # [3] in-plane eigvec
    distance: jax.Array       # [] scalar
    source: jax.Array         # [] scalar, 1-confidence
    valid: jax.Array          # [] bool

    @classmethod
    def default(cls, lidar_height: float = 0.56, dtype=jnp.float32) -> "GroundPlane":
        return cls(
            normal=jnp.array([0.0, 0.0, 1.0], dtype),
            v1=jnp.array([1.0, 0.0, 0.0], dtype),
            v2=jnp.array([0.0, 1.0, 0.0], dtype),
            distance=jnp.asarray(lidar_height, dtype),
            source=jnp.asarray(0.0, dtype),
            valid=jnp.asarray(False),
        )


@pytree.dataclass
class ImuBatch:
    """Padded IMU sample window between two scans (ref utility.h:245-269)."""

    t: jax.Array              # [M] timestamps (s)
    acc: jax.Array            # [M, 3]
    gyr: jax.Array            # [M, 3]
    mask: jax.Array           # [M] bool

    @classmethod
    def zeros(cls, m: int, dtype=jnp.float32) -> "ImuBatch":
        return cls(
            t=jnp.zeros((m,), dtype),
            acc=jnp.zeros((m, 3), dtype),
            gyr=jnp.zeros((m, 3), dtype),
            mask=jnp.zeros((m,), bool),
        )


@pytree.dataclass
class Pose:
    """SE(3) pose as quaternion [w,x,y,z] + translation."""

    q: jax.Array              # [4]
    t: jax.Array              # [3]

    @classmethod
    def identity(cls, dtype=jnp.float32) -> "Pose":
        return cls(q=jnp.array([1.0, 0, 0, 0], dtype), t=jnp.zeros((3,), dtype))


@pytree.dataclass
class VoxelMap:
    """Gaussian voxel map: open-addressing hash of per-voxel moments.

    Static-shape re-expression of the reference's GPU voxel map design
    (``cuda/gaussian_voxelmap.cu:21-57`` — atomicCAS bucket claiming becomes
    round-based scatter-min claiming; see ops/voxelmap.py).
    """

    keys: jax.Array           # [CAP] int32 packed voxel coords (-1 = empty)
    mean: jax.Array           # [CAP, 3]
    cov: jax.Array            # [CAP, 3, 3]
    num_points: jax.Array     # [CAP] float32
    resolution: jax.Array     # [] float32


@pytree.dataclass
class Scan:
    """One raw sweep, fixed shape — input to the whole pipeline."""

    cloud: PointCloud
    imu: ImuBatch
    stamp: jax.Array          # [] float64/float32 scan end time
