"""Fleet long-session soak (VERDICT r3 item 8): the deployment mode is the
vmapped fleet, so the B=1 longrun's guarantees must hold at fleet scale —
B>=32 robots, 2,000+ scans each, loop closure + PGO at the product cadence,
LOOP-AWARE keyframe compaction (fleet.fleet_loop_step), asserting:

  * no capacity freeze: every robot keeps adding keyframes after its store
    first saturates (compaction count > 0 per robot),
  * no NaN anywhere in the trajectory,
  * bounded error: per-quarter keyframe ATE stays flat across robots (late
    quarters don't blow up), and loops are still accepted after saturation.

Inputs follow bench.py's honest-fleet rules: N_SEEDS distinct synthetic
worlds tiled over B robots plus independent per-robot per-scan point noise
injected on device, so batched while_loops can't converge in lockstep.

Run: `JAX_PLATFORMS=cpu python eval_longrun_fleet.py` (CPU: hours at B=32;
env RGC_FLEET_B / RGC_FLEET_SCANS / RGC_FLEET_SEEDS shrink it) or on the
GPU.  Prints one JSON result line; EVAL.md quotes it.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from rgc_slam_tpu.config import TEST_CONFIG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu.parallel import fleet
from rgc_slam_tpu.utils.evaluation import ate_rmse

B = int(os.environ.get("RGC_FLEET_B", 32))
N_SCANS = int(os.environ.get("RGC_FLEET_SCANS", 2000))
N_SEEDS = int(os.environ.get("RGC_FLEET_SEEDS", 4))
# Keyframe capacity: saturation (and thus compaction + post-saturation loop
# accepts) must actually occur inside the run.  Travel is ~0.2 m/scan, the
# keyframe gate 0.5 m, so saturation lands near scan KF*2.5 — a shrunk CPU
# run (RGC_FLEET_SCANS) must shrink RGC_FLEET_KF with it.
KF_CAP = int(os.environ.get("RGC_FLEET_KF", 256))
LOOP_EVERY = 5

CFG = dataclasses.replace(
    TEST_CONFIG,
    max_keyframes=KF_CAP,       # 0.5 m gate -> KF_CAP/2 m travel capacity
    max_loops=32,
    loop_submap_halfwidth=25,
    max_loop_submap_points=8192,
    loop_icp_iterations=60,
    max_kf_corner=256, max_kf_surf=1024,
    max_sharp_total=1024, max_flat_total=2048,
    loop_fitness_thresh=0.25,   # test-density clouds; see PARITY.md
    inline_compaction=False,    # batched lax.cond would run both branches
)


def main():
    cfg = CFG
    n_seeds = min(N_SEEDS, B)
    reps = -(-B // n_seeds)
    print(f"generating {n_seeds} x {N_SCANS}-scan worlds "
          f"(B={B}, tile x{reps})", flush=True)
    seqs = [
        synthetic.generate_sequence(
            n_scans=N_SCANS, n_azimuth=360, seed=31 + s, extent=26.0,
            radius=12.0, noise=0.004, motion_distortion=True,
            closes_loop=True, laps=N_SCANS * 0.2 / (2 * np.pi * 12.0),
            speed=2.0,
        )
        for s in range(n_seeds)
    ]
    n = min(len(s["scans"]) for s in seqs)

    @jax.jit
    def perturb(cloud, key):
        noise = 0.005 * jax.random.normal(key, cloud.xyz.shape, cloud.xyz.dtype)
        return cloud.replace(xyz=cloud.xyz + noise * cloud.mask[..., None])

    fstep = jax.jit(functools.partial(fleet.fleet_step, cfg=cfg))
    floop = jax.jit(functools.partial(fleet.fleet_loop_step, cfg=cfg))

    # Host fetches go through a dedicated tiny-output jit program, so a
    # fetch copies only the few small buffers it needs: the +0 forces fresh
    # small output buffers.
    @jax.jit
    def _fetch(*xs):
        # `x + 0` would silently promote bool leaves to int32 (advisor r4);
        # cast back so callers get the dtype they stored.
        return tuple((x + 0).astype(x.dtype) for x in xs)
    states = fleet.fleet_init(cfg, B)
    lstates = fleet.fleet_loop_init(cfg, B)

    est = np.zeros((n, B, 3), np.float32)
    compactions = np.zeros(B, np.int64)
    saturated_at = np.full(B, -1, np.int64)
    last_accept = np.full(B, -1, np.int64)
    loops_total = 0
    t0 = time.perf_counter()
    for k in range(n):
        clouds, imus, stamps = [], [], []
        for s in range(n_seeds):
            clouds.append(cloud_from_scan_dict(seqs[s]["scans"][k], cfg))
            t_imu, acc, gyr = seqs[s]["imu"][k]
            imus.append(imu_from_interval(t_imu, acc, gyr, cfg.max_imu))
            stamps.append(seqs[s]["stamps"][k])
        tile = lambda a: jnp.tile(a, (reps,) + (1,) * (a.ndim - 1))[:B]
        cb = jax.tree.map(tile, jax.tree.map(lambda *a: jnp.stack(a), *clouds))
        ib = jax.tree.map(tile, jax.tree.map(lambda *a: jnp.stack(a), *imus))
        cb = perturb(cb, jax.random.fold_in(jax.random.PRNGKey(7), k))
        sb = jnp.tile(jnp.asarray(stamps, jnp.float32), reps)[:B]

        states, outs = fstep(states, cb, ib, sb)
        t_h, kf_now = (np.asarray(x) for x in
                       _fetch(outs.t_map, states.mapping.kf_count))
        est[k] = t_h
        if (k + 1) % LOOP_EVERY == 0:
            kf_before = kf_now
            states, lstates, info = floop(states, lstates)
            kf_now, acc_mask, loops_dev = (np.asarray(x) for x in _fetch(
                states.mapping.kf_count, info.accepted, lstates.loop_count))
            compactions += kf_now < kf_before
            last_accept = np.where(acc_mask, k, last_accept)
            loops_total = int(loops_dev.sum())
        newly_sat = (saturated_at < 0) & (kf_now >= cfg.max_keyframes - 20)
        saturated_at = np.where(newly_sat, k, saturated_at)
        if (k + 1) % 250 == 0:
            print(f"  scan {k+1}/{n}: kf[min..max]={kf_now.min()}..{kf_now.max()} "
                  f"loops_total={loops_total} "
                  f"compactions[min..max]={compactions.min()}..{compactions.max()} "
                  f"({time.perf_counter()-t0:.0f}s)", flush=True)
    wall = time.perf_counter() - t0

    # per-robot, per-quarter keyframe ATE vs its world's ground truth
    quarters = np.zeros((B, 4))
    full_ate = np.zeros(B)
    for b in range(B):
        gt = np.stack([t for (_, t) in seqs[b % n_seeds]["poses"]])[:n]
        for i in range(4):
            sl = slice(i * n // 4, (i + 1) * n // 4)
            quarters[b, i] = ate_rmse(est[sl, b], gt[sl])
        full_ate[b] = ate_rmse(est[:, b], gt)

    loops_per_robot = np.asarray(_fetch(lstates.loop_count)[0])
    result = {
        "robots": B,
        "n_scans": n,
        "distinct_worlds": n_seeds,
        "capacity_travel_m": cfg.max_keyframes * cfg.keyframe_dist,
        "ate_full_m_minmax": [round(float(full_ate.min()), 3),
                              round(float(full_ate.max()), 3)],
        "ate_per_quarter_m_worstrobot": [
            round(float(quarters[:, i].max()), 3) for i in range(4)
        ],
        "loops_per_robot_minmax": [int(loops_per_robot.min()),
                                   int(loops_per_robot.max())],
        "compactions_per_robot_minmax": [int(compactions.min()),
                                         int(compactions.max())],
        "first_saturation_scan": int(saturated_at.min()),
        "last_accept_scan_minmax": [int(last_accept.min()),
                                    int(last_accept.max())],
        "nan_found": bool(~np.isfinite(est).all()),
        "wall_s": round(wall, 1),
    }
    print(json.dumps(result))
    assert np.isfinite(est).all(), "NaN in fleet trajectory"
    assert compactions.min() > 0, "some robot never compacted (freeze risk)"
    assert loops_per_robot.min() > 0, "some robot closed no loops"
    sat = int(saturated_at.max())
    assert last_accept.min() > sat, "no loop accepted after saturation"
    # boundedness: the worst late quarter stays within 4x the best quarter
    q = quarters.max(axis=0)
    assert q.max() < 4 * (q.min() + 0.05), f"fleet ATE not bounded: {q}"
    print("FLEET LONGRUN OK")


if __name__ == "__main__":
    main()
