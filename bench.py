"""Benchmark: registered scans/sec per GPU on 16-channel data.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...extras}.

Baseline: the C++ reference is a real-time 10 scans/sec CPU system (it warns
when a scan exceeds 100 ms, RGC_odometer.cpp:1360-1361 — see BASELINE.md);
vs_baseline is the speedup over that 10 Hz bar.  The measured step is the
full scan->pose pipeline (feature extraction -> odometry VGICP + fusion ->
scan-to-map optimization) on full-size 16-ch sweeps, aggregated over a
128-robot vmapped fleet per GPU (BASELINE config 5) — the throughput
deployment mode.  Every result names the device it ran on; finding no GPU
is an error line, not a CPU run.

Methodology (honest-fleet rules):
  * every robot gets a DISTINCT input stream — 8 synthetic worlds with
    different seeds tiled across the fleet, plus independent per-robot
    per-scan point noise injected on device.  Identical inputs would let the
    batched while_loops converge in lockstep (and any value-level caching
    flatter the number); distinct inputs measure the real fleet workload.
  * timing is the MEDIAN of 5 windows of 40 steps (not best-of).
  * single-stream latency (B=1, full-size caps) is reported alongside.
  * run on a QUIET host: concurrent CPU jobs contend with the dispatch
    path.
"""
from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import time


def _note(msg: str) -> None:
    """Progress marker on stderr (stdout stays the single JSON line)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _emit_error(kind: str, detail: str, **extra) -> None:
    """Terminal failure -> ONE parseable JSON line on stdout, rc=0:
    whatever happens, stdout carries exactly one JSON line."""
    print(json.dumps({
        "metric": "registered scans/sec/GPU",
        "value": None,
        "unit": "scans/sec",
        "vs_baseline": None,
        "error": kind,
        "detail": detail[-600:],
        **extra,
    }))
    sys.exit(0)


import jax
import jax.numpy as jnp

from rgc_slam_tpu.config import SlamConfig
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval

BENCH_CONFIG = SlamConfig(
    max_points=16384,          # 16 rings x 900 azimuth, masked
    max_source_points=8192,
    max_voxels=16384,
    max_keyframes=256,
    max_kf_corner=512,
    max_kf_surf=2048,
    max_map_points=16384,
    max_loop_submap_points=8192,
)

# per-robot capacities for the vmapped fleet (bounded by device memory).
# inline_compaction off: a batched lax.cond executes BOTH branches under
# vmap, so per-scan inline eviction would pay the store-permutation gathers
# every scan for every robot — the fleet CLI and this bench instead compact
# on a host cadence (included in the timed window, like run.py --fleet)
FLEET_CONFIG = SlamConfig(
    max_points=16384,
    max_source_points=4096,
    max_voxels=8192,
    max_keyframes=128,
    max_kf_corner=256,
    max_kf_surf=1024,
    max_map_points=8192,
    max_loop_submap_points=4096,
    inline_compaction=False,
)

FLEET_B = int(os.environ.get("RGC_BENCH_B", 128))
N_SEEDS = int(os.environ.get("RGC_BENCH_SEEDS", 8))
N_WARMUP = 5
N_TIMED = int(os.environ.get("RGC_BENCH_TIMED", 40))
N_REPS = int(os.environ.get("RGC_BENCH_REPS", 5))
SKIP_SINGLE = os.environ.get("RGC_BENCH_SKIP_SINGLE", "") == "1"
SKIP_LOOPS = os.environ.get("RGC_BENCH_SKIP_LOOPS", "") == "1"
# dispatch chunking: run C consecutive scans inside one jit call (unrolled),
# so C dispatches become 1.  A deployment lever when scans are buffered (not
# strictly real-time); the per-dispatch number is reported alongside as the
# real-time-loop rate.  Must stay <= cfg.loop_cadence (10) so the fused
# with-loops chunk keeps ONE lax.cond per chunk; compile cost grows with the
# unroll.
CHUNK = int(os.environ.get("RGC_BENCH_CHUNK", 8))


def _stage_inputs(cfg: SlamConfig, B: int, n_scans: int):
    """Per-robot distinct inputs: N_SEEDS worlds tiled over B robots, plus
    independent on-device point noise per (robot, scan)."""
    n_seeds = min(N_SEEDS, B)
    reps = -(-B // n_seeds)  # ceil
    seqs = [
        synthetic.generate_sequence(
            n_scans=n_scans, n_azimuth=900, seed=1 + s,
            extent=30.0, radius=12.0, noise=0.01, closes_loop=False, speed=2.0,
        )
        for s in range(n_seeds)
    ]

    @functools.partial(jax.jit, static_argnums=())
    def perturb(cloud, key):
        noise = 0.005 * jax.random.normal(key, cloud.xyz.shape, cloud.xyz.dtype)
        return cloud.replace(xyz=cloud.xyz + noise * cloud.mask[..., None])

    n_scans = min(len(s["scans"]) for s in seqs)
    inputs = []
    for k in range(n_scans):
        clouds, imus, stamps = [], [], []
        for s in range(n_seeds):
            clouds.append(cloud_from_scan_dict(seqs[s]["scans"][k], cfg))
            t_imu, acc, gyr = seqs[s]["imu"][k]
            imus.append(imu_from_interval(t_imu, acc, gyr, cfg.max_imu))
            stamps.append(seqs[s]["stamps"][k])
        cloud8 = jax.tree.map(lambda *a: jnp.stack(a), *clouds)
        imu8 = jax.tree.map(lambda *a: jnp.stack(a), *imus)
        tile = lambda a: jnp.tile(a, (reps,) + (1,) * (a.ndim - 1))[:B]
        cloudB = jax.tree.map(tile, cloud8)
        imuB = jax.tree.map(tile, imu8)
        cloudB = perturb(cloudB, jax.random.fold_in(jax.random.PRNGKey(0), k))
        stampB = jnp.tile(jnp.asarray(stamps, jnp.float32), reps)[:B]
        inputs.append(jax.device_put((cloudB, imuB, stampB)))
    jax.block_until_ready(inputs[-1])
    return inputs, seqs[0]


def _single_stream(seq, n_scans: int):
    """B=1 latency on the full-size config (ms/scan)."""
    from rgc_slam_tpu.models.slam import SlamState, slam_step

    cfg = BENCH_CONFIG
    state = SlamState.init(cfg)
    step = jax.jit(functools.partial(slam_step, cfg=cfg))
    ins = []
    for k in range(n_scans):
        cloud = cloud_from_scan_dict(seq["scans"][k], cfg)
        t_imu, acc, gyr = seq["imu"][k]
        imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu)
        ins.append(jax.device_put((cloud, imu, jnp.asarray(seq["stamps"][k], jnp.float32))))
    for k in range(N_WARMUP):
        state, _ = step(state, *ins[k])
    jax.block_until_ready(state)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for k in range(N_WARMUP, n_scans):
            state, _ = step(state, *ins[k])
        jax.block_until_ready(state)
        times.append((time.perf_counter() - t0) / (n_scans - N_WARMUP))
    return statistics.median(times) * 1e3


def _card() -> str:
    """``name, power.limit`` of the cards, read by nvidia-smi (not JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(line.strip() for line in r.stdout.strip().splitlines())


def main():
    from rgc_slam_tpu.parallel import fleet

    devices = jax.devices()
    if devices[0].platform != "gpu":
        _emit_error("no_gpu", f"JAX's first device is {devices[0].platform!r}")
    B, n_reps, chunk = FLEET_B, N_REPS, CHUNK
    cfg = FLEET_CONFIG
    _note(f"staging inputs (B={B})")
    inputs, seq0 = _stage_inputs(cfg, B, N_WARMUP + N_TIMED + 2)
    n_scans = len(inputs)
    n_timed = min(N_TIMED, n_scans - N_WARMUP)

    _note("inputs staged; compiling fleet step")
    states = fleet.fleet_init(cfg, B)
    # keyframe eviction is folded into the step program as a device-resident
    # top-level lax.cond (fleet.fleet_step_compacting) — matching run.py
    # --fleet: zero host round-trips, compaction the scan a robot needs it
    fstep = jax.jit(functools.partial(fleet.fleet_step_compacting, cfg=cfg))
    _note("warmup")
    for k in range(N_WARMUP):
        states, outs = fstep(states, *inputs[k])
        jax.block_until_ready(states)
    loadavg = os.getloadavg()

    # per-dispatch (real-time loop) rate; eviction is inside the step
    rates = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        for k in range(N_WARMUP, N_WARMUP + n_timed):
            states, outs = fstep(states, *inputs[k])
        jax.block_until_ready(states)
        rates.append(n_timed * B / (time.perf_counter() - t0))
    per_dispatch = statistics.median(rates)
    _note(f"per-dispatch done: {per_dispatch:.0f} scans/sec")

    scans_per_sec = per_dispatch
    if chunk > 1:
        from rgc_slam_tpu.models.slam import make_chunk_step

        cstep = make_chunk_step(
            functools.partial(fleet.fleet_step_compacting, cfg=cfg), chunk
        )
        n_timed_c = (n_timed // chunk) * chunk

        def run_window(states):
            for k in range(N_WARMUP, N_WARMUP + n_timed_c, chunk):
                flat = [x for j in range(chunk) for x in inputs[k + j]]
                states, outs = cstep(states, *flat)
            return states

        _note("chunk compile")
        states = run_window(states)          # compile outside the timed reps
        jax.block_until_ready(states)
        rates = []
        for _ in range(n_reps):
            t0 = time.perf_counter()
            states = run_window(states)
            jax.block_until_ready(states)
            rates.append(n_timed_c * B / (time.perf_counter() - t0))
        scans_per_sec = statistics.median(rates)
        _note(f"chunked done: {scans_per_sec:.0f} scans/sec")

    # ---- full SLAM including the pose-graph thread: vmapped loop closure +
    # PGO + loop-aware compaction, cadence-gated INSIDE the chunked step
    # program (fleet.make_fleet_chunk_step: top-level lax.cond, counter on
    # device) ----
    with_loops = None
    if not SKIP_LOOPS:
        _note("compiling fused loop step")
        states_l = fleet.fleet_init(cfg, B)
        loop_states = fleet.fleet_loop_init(cfg, B)
        counter = jnp.asarray(0, jnp.int32)
        lchunk = max(chunk, 1)
        cstep_l = fleet.make_fleet_chunk_step(cfg, lchunk)
        n_timed_l = (n_timed // lchunk) * lchunk

        def run_loop_window(states_l, loop_states, counter):
            for k in range(N_WARMUP, N_WARMUP + n_timed_l, lchunk):
                flat = [x for j in range(lchunk) for x in inputs[k + j]]
                states_l, loop_states, counter, _ = cstep_l(
                    states_l, loop_states, counter, *flat
                )
            return states_l, loop_states, counter

        # compile + warm up outside the timed reps (one full window, like the
        # chunked headline — repeating a single scan inside a chunk would
        # feed zero inter-scan dt into the step)
        states_l, loop_states, counter = run_loop_window(
            states_l, loop_states, counter
        )
        jax.block_until_ready((states_l, loop_states))
        rates = []
        for _ in range(n_reps):
            t0 = time.perf_counter()
            states_l, loop_states, counter = run_loop_window(
                states_l, loop_states, counter
            )
            jax.block_until_ready(states_l)
            rates.append(n_timed_l * B / (time.perf_counter() - t0))
        with_loops = statistics.median(rates)
        _note(f"with-loops (fused, {lchunk}-scan chunks) done: "
              f"{with_loops:.0f} scans/sec")

    # re-sample AFTER the timed windows: load starting mid-run must show up
    # in the artifact
    loadavg_end = os.getloadavg()

    _note("single-stream")
    single_ms = None if SKIP_SINGLE else _single_stream(seq0, n_scans)

    print(
        json.dumps(
            {
                "metric": (
                    f"registered scans/sec/GPU (16-ch full SLAM steps, "
                    f"{B}-robot vmap fleet, distinct per-robot inputs, "
                    f"median of {n_reps}, {chunk}-scan dispatch chunks)"
                ),
                "value": scans_per_sec,
                "unit": "scans/sec",
                "vs_baseline": scans_per_sec / 10.0,
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                "device_count": len(devices),
                "card": _card(),
                "xla_flags": os.environ.get("XLA_FLAGS", ""),
                "per_dispatch_scans_per_sec": per_dispatch,
                "with_loops_scans_per_sec": with_loops,
                "single_stream_ms_per_scan": single_ms,
                "host_loadavg_1_5_15": list(loadavg),
                "host_loadavg_end_1_5_15": list(loadavg_end),
            }
        )
    )


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        raise
    except Exception as e:  # noqa: BLE001 — stdout must stay one JSON line
        import traceback

        traceback.print_exc(file=sys.stderr)
        _emit_error("bench_failed", f"{type(e).__name__}: {e}")
