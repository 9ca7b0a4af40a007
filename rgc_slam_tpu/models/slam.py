"""The full SLAM engine: one pure scan->pose step function + host driver.

This is BASELINE.json's north star: the reference's three ROS processes
(scanRegistration → RGC_odometer → RGC_mapping, SURVEY §1) collapse into a
single jit-compiled ``slam_step(state, scan) -> (state, outputs)`` over an
explicit state pytree.  Loop closure + 4-DoF PGO run as a separately jitted
function at its own cadence (models/loop.py), mirroring the reference's 1 Hz
pose-graph thread.

``SlamSystem`` is the host-side driver: it owns the device state, feeds scans,
triggers the loop-closure cadence, and dumps TUM trajectories — the same role
as roslaunch + bag replay + the trajectory writers (SURVEY §4).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..types import ImuBatch, PointCloud
from ..ops import features as F
from ..ops import voxelhash as vh
from . import mapping as mapping_mod
from . import odometry as odometry_mod
from ..utils import pytree


@pytree.dataclass
class SlamState:
    odo: odometry_mod.OdometryState
    mapping: mapping_mod.MappingState

    @classmethod
    def init(cls, cfg: SlamConfig, dtype=jnp.float32) -> "SlamState":
        return cls(
            odo=odometry_mod.OdometryState.init(cfg, dtype),
            mapping=mapping_mod.MappingState.init(cfg, dtype),
        )


class SlamOutput(NamedTuple):
    q_odom: jax.Array
    t_odom: jax.Array
    q_map: jax.Array
    t_map: jax.Array
    fitness: jax.Array
    n_corr: jax.Array
    kf_added: jax.Array
    # deskewed full cloud (sensor frame) — stays on device unless fetched;
    # feeds the per-frame dump surface (ref RGC_odometer.cpp:1353-1354)
    full_xyz: jax.Array
    full_mask: jax.Array


def slam_step(
    state: SlamState,
    cloud: PointCloud,
    imu: ImuBatch,
    stamp: jax.Array,
    cfg: SlamConfig,
):
    """features -> odometry -> mapping, one scan."""
    if cfg.sp_features and cfg.psum_axis is not None and cfg.sp_shards > 1:
        # block-sharded feature front-end for sp meshes (PARITY §sp round-5
        # probe — dense single-stream deployments); static gate, so the
        # default fleet path compiles exactly as before
        fx = F.extract_features_sp(cloud, cfg)
    else:
        fx = F.extract_features(cloud, cfg)
    odo_state, odo_out = odometry_mod.odometry_step(state.odo, fx, imu, stamp, cfg)

    # current-frame feature clouds for mapping (downsampleCurrentLaserCloud,
    # RGC_mapping.cpp:1688-1714): corner at lineResolution, surf at
    # planeResolution, confidences carried through the voxel average
    c_xyz, c_mask, (c_conf,) = vh.voxel_downsample(
        odo_out.deskewed_sharp_xyz, fx.sharp.mask, cfg.map_corner_voxel,
        cfg.max_kf_corner, extras=(fx.sharp.confidence,), probes=cfg.hash_probes,
    )
    s_xyz, s_mask, (s_conf,) = vh.voxel_downsample(
        odo_out.deskewed_flat_xyz, fx.flat.mask, cfg.map_surf_voxel,
        cfg.max_kf_surf, extras=(fx.flat.confidence,), probes=cfg.hash_probes,
    )

    imu_ypr = jnp.stack(
        [odo_state.imu_filter.yaw, odo_state.imu_filter.pitch, odo_state.imu_filter.roll]
    )
    if cfg.mapping_skip_frame > 1:
        # rate decoupling (ref run.launch:8-9): mapping runs every Nth scan;
        # skipped scans reuse the map->odom correction for the output pose
        def run_map(ms):
            return mapping_mod.mapping_step(
                ms, odo_out, c_xyz, c_conf, c_mask, s_xyz, s_conf, s_mask,
                imu_ypr, stamp, cfg,
            )

        def skip_map(ms):
            q_w = mapping_mod.m3.quat_normalize(
                mapping_mod.m3.quat_mul(ms.q_md, odo_out.q_w)
            )
            t_w = ms.t_md + mapping_mod.m3.quat_rotate(ms.q_md, odo_out.t_w)
            out = mapping_mod.MappingOutput(
                q_w=q_w, t_w=t_w, q_md=ms.q_md, t_md=ms.t_md,
                kf_added=jnp.asarray(False),
                n_corner_factors=jnp.asarray(0, jnp.int32),
                n_surf_factors=jnp.asarray(0, jnp.int32),
            )
            return ms, out

        do_map = jnp.mod(state.odo.frame, cfg.mapping_skip_frame) == 0
        map_state, map_out = jax.lax.cond(do_map, run_map, skip_map, state.mapping)
    else:
        map_state, map_out = mapping_mod.mapping_step(
            state.mapping, odo_out, c_xyz, c_conf, c_mask, s_xyz, s_conf, s_mask,
            imu_ypr, stamp, cfg,
        )

    out = SlamOutput(
        q_odom=odo_out.q_w,
        t_odom=odo_out.t_w,
        q_map=map_out.q_w,
        t_map=map_out.t_w,
        fitness=odo_out.fitness,
        n_corr=odo_out.n_corr,
        kf_added=map_out.kf_added,
        full_xyz=odo_out.deskewed_full.xyz,
        full_mask=odo_out.deskewed_full.mask,
    )
    return SlamState(odo=odo_state, mapping=map_state), out


def make_chunk_step(step_fn, chunk: int):
    """Compile a program advancing ``chunk`` scans per dispatch.

    ``step_fn(state, cloud, imu, stamp) -> (state, out)``; the returned
    callable takes ``(state, *flat)`` where flat interleaves chunk
    (cloud, imu, stamp) triples and returns ``(state, [out] * chunk)``.
    Shared by SlamSystem.process_chunk, the fleet CLI, and bench.py — the
    dispatch-amortization lever in one place (its gain on the H100 is not
    measured yet)."""

    def chunk_step(state, *flat):
        outs = []
        for i in range(chunk):
            state, out = step_fn(state, *flat[3 * i:3 * i + 3])
            outs.append(out)
        return state, outs

    return jax.jit(chunk_step)


class SlamSystem:
    """Host driver around the jitted step (and loop closure, once enabled).

    ``chunk`` > 1 compiles a program that advances ``chunk`` scans per
    dispatch (python-unrolled): per-call overhead is paid once per chunk
    instead of per scan (see bench.py RGC_BENCH_CHUNK; the gain on the H100
    is not measured yet).  Use for buffered/offline replay — a
    hard-real-time loop wants chunk=1 so every scan's pose is available
    immediately.
    """

    def __init__(self, cfg: SlamConfig, enable_loop: Optional[bool] = None,
                 chunk: int = 1):
        self.cfg = cfg
        self.state = SlamState.init(cfg)
        # no donate_argnums on the state: whether donation pays on the GPU
        # is not measured yet
        self._step = jax.jit(functools.partial(slam_step, cfg=cfg))
        self.chunk = chunk
        self._chunk_step = None
        self.enable_loop = cfg.loop_closure_enable if enable_loop is None else enable_loop
        if chunk > 1:
            from . import mapping as _mapping

            if chunk > _mapping.COMPACT_MARGIN:
                # eviction runs between dispatches (loop_closure_step /
                # inline); a chunk longer than the capacity headroom could
                # silently drop keyframes mid-dispatch via the backstop
                raise ValueError(
                    f"chunk={chunk} exceeds the keyframe-eviction headroom "
                    f"(COMPACT_MARGIN={_mapping.COMPACT_MARGIN}); keyframes "
                    f"added past capacity inside one dispatch would be "
                    f"silently dropped"
                )
            gap = _mapping.worst_cadence_gap(cfg.loop_cadence, chunk)
            if self.enable_loop and gap > _mapping.COMPACT_MARGIN:
                # loop closure (and with it the loop-aware compaction) is
                # host-called only at chunk boundaries; a non-divisor chunk
                # fires a cadence boundary up to chunk-1 scans late, and
                # past the headroom that risks the same silent drop
                raise ValueError(
                    f"chunk={chunk} with loop_cadence={cfg.loop_cadence}: "
                    f"loop/compaction opportunities come only at chunk "
                    f"boundaries — worst-case gap {gap} scans exceeds the "
                    f"keyframe-eviction headroom "
                    f"(COMPACT_MARGIN={_mapping.COMPACT_MARGIN}); pick a "
                    f"chunk dividing loop_cadence or a smaller chunk"
                )
            self._chunk_step = make_chunk_step(
                functools.partial(slam_step, cfg=cfg), chunk
            )
        self._loop_fn = None
        if self.enable_loop:
            from . import loop as loop_mod

            self.loop_state = loop_mod.LoopState.init(cfg)
            self._loop_fn = jax.jit(functools.partial(loop_mod.loop_closure_step, cfg=cfg))
        self.trajectory = []      # (stamp, q_map, t_map)
        self.odom_trajectory = []
        self._frame = 0

    def process(self, cloud: PointCloud, imu: ImuBatch, stamp: float):
        self.state, out = self._step(
            self.state, cloud, imu, jnp.asarray(stamp, jnp.float32)
        )
        self._frame += 1
        self.trajectory.append((stamp, np.asarray(out.q_map), np.asarray(out.t_map)))
        self.odom_trajectory.append((stamp, np.asarray(out.q_odom), np.asarray(out.t_odom)))
        # reference runs PGO at 1 Hz (RGC_mapping.cpp:1964) — every
        # cfg.loop_cadence scans
        if self._loop_fn is not None and self._frame % self.cfg.loop_cadence == 0:
            self.state, self.loop_state, _ = self._loop_fn(
                self.state, self.loop_state
            )
        return out

    def process_chunk(self, items):
        """Advance ``len(items)`` scans in one dispatch (requires chunk > 1
        at construction and len(items) == chunk; feed a final partial chunk
        through ``process``).  items: [(cloud, imu, stamp), ...].  Loop
        closure keeps its every-loop_cadence-scans cadence, evaluated once
        per chunk boundary crossed."""
        assert self._chunk_step is not None and len(items) == self.chunk
        flat = [
            x
            for (cloud, imu, stamp) in items
            for x in (cloud, imu, jnp.asarray(stamp, jnp.float32))
        ]
        self.state, outs = self._chunk_step(self.state, *flat)
        lc = self.cfg.loop_cadence
        loops_due = (self._frame + self.chunk) // lc - self._frame // lc
        self._frame += self.chunk
        for (cloud, imu, stamp), out in zip(items, outs):
            self.trajectory.append(
                (stamp, np.asarray(out.q_map), np.asarray(out.t_map))
            )
            self.odom_trajectory.append(
                (stamp, np.asarray(out.q_odom), np.asarray(out.t_odom))
            )
        if self._loop_fn is not None:
            for _ in range(loops_due):
                self.state, self.loop_state, _ = self._loop_fn(
                    self.state, self.loop_state
                )
        return outs

    def save(self, path: str):
        """Checkpoint the full session (SLAM + loop state) with orbax."""
        from ..utils.checkpoint import save as _save

        payload = (self.state, self.loop_state) if self._loop_fn else (self.state,)
        _save(path, payload, step=self._frame)

    def load(self, path: str):
        from ..utils.checkpoint import restore as _restore

        like = (self.state, self.loop_state) if self._loop_fn else (self.state,)
        restored, step = _restore(path, like)
        if self._loop_fn:
            self.state, self.loop_state = restored
        else:
            (self.state,) = restored
        self._frame = step

    def dump_tum(self, path: str, which: str = "map"):
        from ..utils.evaluation import dump_tum

        traj = self.trajectory if which == "map" else self.odom_trajectory
        dump_tum(
            path,
            [s for s, _, _ in traj],
            [t for _, _, t in traj],
            [q for _, q, _ in traj],
        )
