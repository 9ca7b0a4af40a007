"""Long-session evidence run (VERDICT r1 item 2 'done' criterion).

2,000+ scans on a closed course whose travel exceeds the keyframe-store
capacity by >2x: the store must compact (not freeze), loops must still be
detected and accepted after saturation, and the keyframe-trajectory ATE must
stay bounded lap after lap.  Reference behavior: unbounded std::map store
(RGC_mapping.cpp:1839-1943) — parity here is graceful degradation instead of
a silent freeze.

Run: `JAX_PLATFORMS=cpu python eval_longrun.py` (CPU, ~20 min) or on the GPU.
Appends a JSON line to eval_results.json-style output on stdout.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from rgc_slam_tpu.config import TEST_CONFIG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu.models import loop as loop_mod
from rgc_slam_tpu.models.slam import SlamState, slam_step
from rgc_slam_tpu.utils.evaluation import ate_rmse

N_SCANS = 2000

CFG = dataclasses.replace(
    TEST_CONFIG,
    max_keyframes=256,          # 0.5 m gate -> ~128 m of travel capacity
    max_loops=32,
    loop_submap_halfwidth=25,
    max_loop_submap_points=8192,
    loop_icp_iterations=60,
    max_kf_corner=256, max_kf_surf=1024,
    max_sharp_total=1024, max_flat_total=2048,
    loop_fitness_thresh=0.25,   # test-density clouds; see PARITY.md
)


def main():
    # ~5.3 laps of a 12 m-radius circle: 400 m travel ~= 3x store capacity
    seq = synthetic.generate_sequence(
        n_scans=N_SCANS, n_azimuth=360, seed=31, extent=26.0, radius=12.0,
        noise=0.004, motion_distortion=True, closes_loop=True,
        laps=N_SCANS * 0.2 / (2 * np.pi * 12.0), speed=2.0,
    )
    cfg = CFG
    state = SlamState.init(cfg)
    lstate = loop_mod.LoopState.init(cfg)
    step = jax.jit(functools.partial(slam_step, cfg=cfg))
    loop_step = jax.jit(functools.partial(loop_mod.loop_closure_step, cfg=cfg))

    est, accepts, compactions = [], [], 0
    t0 = time.perf_counter()
    for k in range(len(seq["scans"])):
        cloud = cloud_from_scan_dict(seq["scans"][k], cfg)
        t_imu, acc, gyr = seq["imu"][k]
        imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu)
        state, out = step(state, cloud, imu,
                          jnp.asarray(seq["stamps"][k], jnp.float32))
        est.append(np.asarray(out.t_map))
        if (k + 1) % 5 == 0:
            before = int(state.mapping.kf_count)
            state, lstate, info = loop_step(state, lstate)
            if int(state.mapping.kf_count) < before:
                compactions += 1
            if bool(info.accepted):
                accepts.append(k)
        if (k + 1) % 500 == 0:
            print(f"  scan {k+1}: kf={int(state.mapping.kf_count)} "
                  f"loops={int(lstate.loop_count)} "
                  f"compactions={compactions}", flush=True)
    wall = time.perf_counter() - t0

    gt = np.stack([t for (_, t) in seq["poses"]])[: len(est)]
    est = np.stack(est)
    n = len(est)
    # per-quarter ATE: boundedness means the late quarters don't blow up
    quarters = [
        round(ate_rmse(est[i * n // 4:(i + 1) * n // 4],
                       gt[i * n // 4:(i + 1) * n // 4]), 3)
        for i in range(4)
    ]
    travel = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    result = {
        "n_scans": n,
        "travel_m": round(travel, 1),
        "capacity_travel_m": cfg.max_keyframes * cfg.keyframe_dist,
        "ate_per_quarter_m": quarters,
        "ate_full_m": round(ate_rmse(est, gt), 3),
        "n_loops": int(lstate.loop_count),
        "n_accepts": len(accepts),
        "last_accept_scan": accepts[-1] if accepts else None,
        "compactions": compactions,
        "kf_count_final": int(state.mapping.kf_count),
        "wall_s": round(wall, 1),
    }
    print(json.dumps(result))
    sat_scan = int(cfg.max_keyframes * cfg.keyframe_dist / 0.2)  # ~scan 640
    assert compactions > 0, "store never compacted"
    assert accepts and accepts[-1] > sat_scan, "no loop accepted after saturation"
    assert max(quarters) < 4 * (min(quarters) + 0.05), "ATE not bounded"
    print("LONGRUN OK")


if __name__ == "__main__":
    main()
