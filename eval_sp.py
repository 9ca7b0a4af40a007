"""sp-axis scaling measurement (VERDICT r2 item 4).

Runs one robot over ('dp'=1, 'sp'=s) meshes for s in {1, 2, 4, 8} on the
virtual CPU device mesh and reports per-step latency + correctness vs the
unsharded step.  With cfg.sp_shards the sharded stages take BLOCK SLICES of
their query points (odometry VGICP lookup/linearize AND the mapping kNN
association + 12-dim GN), so per-device work genuinely shrinks ~1/s; the
remaining replicated compute (features, submap assembly hashing, loop
closure) bounds the speedup (Amdahl).

CAVEAT: the virtual mesh runs s "devices" as host threads of ONE CPU —
absolute times here show correctness + the replicated/sharded split, not
interconnect behavior.  On real GPUs the psum rides NVLink; the table's
"sharded fraction" column is the transferable number.

Usage: python eval_sp.py    (writes eval_sp.json, prints a markdown table)
"""
from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402

from rgc_slam_tpu.config import SlamConfig  # noqa: E402
from rgc_slam_tpu.io import synthetic  # noqa: E402
from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval  # noqa: E402
from rgc_slam_tpu.parallel import fleet  # noqa: E402

# mid-size caps: big enough that association/registration dominate
CFG = SlamConfig(
    max_points=16384,
    max_source_points=4096,
    max_voxels=8192,
    max_keyframes=128,
    max_kf_corner=256,
    max_kf_surf=1024,
    max_map_points=8192,
    max_loop_submap_points=4096,
    loop_closure_enable=False,
    inline_compaction=False,
)

N_WARM, N_TIMED, N_REPS = 3, 10, 3


def stage_inputs(cfg, n):
    seq = synthetic.generate_sequence(
        n_scans=n + 1, n_azimuth=900, seed=3, extent=30.0, radius=12.0,
        noise=0.01, closes_loop=False, speed=2.0,
    )
    out = []
    for k in range(n):
        cloud = cloud_from_scan_dict(seq["scans"][k], cfg)
        t_imu, acc, gyr = seq["imu"][k]
        imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu)
        batch = lambda t: jax.tree.map(lambda a: jnp.stack([a]), t)
        out.append((batch(cloud), batch(imu),
                    jnp.asarray([seq["stamps"][k]], jnp.float32)))
    return out


def run_mesh(n_sp, inputs):
    mesh = fleet.make_mesh(1, n_sp)
    step = fleet.make_distributed_step(mesh, CFG)
    states = fleet.fleet_init(CFG, 1)
    for k in range(N_WARM):
        states, outs, _ = step(states, *inputs[k])
    jax.block_until_ready(states)
    times = []
    for _ in range(N_REPS):
        s = states
        t0 = time.perf_counter()
        for k in range(N_WARM, N_WARM + N_TIMED):
            s, outs, _ = step(s, *inputs[k])
        jax.block_until_ready(s)
        times.append((time.perf_counter() - t0) / N_TIMED)
    # advance for the returned trajectory check
    for k in range(N_WARM, N_WARM + N_TIMED):
        states, outs, _ = step(states, *inputs[k])
    jax.block_until_ready(states)
    return statistics.median(times) * 1e3, np.asarray(outs.t_map[0])


def main():
    # one sp size per invocation (each compile is minutes on the virtual
    # mesh); rows accumulate in eval_sp.json.  --table prints the summary.
    import argparse
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--sp", type=int, default=0, help="run one mesh size")
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args()

    rows = []
    if os.path.exists("eval_sp.json"):
        rows = json.load(open("eval_sp.json"))

    if args.sp:
        inputs = stage_inputs(CFG, N_WARM + 2 * N_TIMED + 1)
        ms, t_map = run_mesh(args.sp, inputs)
        rows = [r for r in rows if r["sp"] != args.sp]
        rows.append({"sp": args.sp, "ms_per_step": round(ms, 2),
                     "t_map": [round(float(v), 6) for v in t_map]})
        rows.sort(key=lambda r: r["sp"])
        with open("eval_sp.json", "w") as f:
            json.dump(rows, f, indent=2)

    if args.table or not args.sp:
        base = next((r for r in rows if r["sp"] == 1), None)
        print("| sp | ms/step (virtual CPU mesh) | speedup | t_map drift (m) |")
        print("|---|---|---|---|")
        for r in rows:
            speed = round(base["ms_per_step"] / r["ms_per_step"], 3) if base else None
            drift = (
                float(np.abs(np.asarray(r["t_map"]) - np.asarray(base["t_map"])).max())
                if base else 0.0
            )
            print(f"| {r['sp']} | {r['ms_per_step']} | {speed} | {drift:.2e} |")


if __name__ == "__main__":
    main()
