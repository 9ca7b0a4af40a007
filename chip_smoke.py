#!/usr/bin/env python3
"""Smoke run of the SLAM main path on a GPU, at the widths users run.

    python chip_smoke.py                 # phases 0-3 on one card
    python chip_smoke.py --devices 4     # only the sharded fleet step, 4 cards

Phases (one card):
  0. device: the card, JAX's settings, and a float32 kNN check;
  1. the Pallas Triton kNN kernel at the pipeline's widths vs ops/knn's XLA
     formulation (both timed);
  2. single stream: ``rgc_slam_tpu.run.main`` on a sweep-log of a closed
     synthetic course at the SlamConfig() defaults, loop closure on;
  3. fleet: ``fleet.make_fleet_chunk_step`` at bench.FLEET_CONFIG, B=128
     distinct robots, against one robot run alone.

Exits non-zero on any failure and when JAX finds no GPU.  The last stdout
line is one JSON object: {"ok": true, "device": {platform, kind, count}}.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name() -> str:
    """``name, power.limit`` of each card, read by nvidia-smi (not JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(line.strip() for line in r.stdout.strip().splitlines())


def _timed(fn, *args, reps: int = 20) -> float:
    """Median ms of ``fn(*args)`` over ``reps`` synced calls (after warmup)."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------- phase 0
def float32_check(n_q: int = 2048, n_p: int = 32768, seed: int = 0) -> dict:
    """ops/knn's XLA formulation on the default device vs a float64 numpy
    brute force, on map-scale coordinates (uniform in ±40 m).

    Bound: 8 unit roundoffs of float32 (2^-24) times the largest
    |q|^2 + |p|^2 after centring, ~4.6e-3 m^2 at ±40 m; float32 on the CPU
    reaches ~1.1e-3 here.  A product run in TF32 (10 mantissa bits) misses
    it by about three orders of magnitude (~10 m^2)."""
    import jax.numpy as jnp

    from rgc_slam_tpu.ops import knn as knn_ops

    rng = np.random.default_rng(seed)
    q = rng.uniform(-40, 40, (n_q, 3)).astype(np.float32)
    p = rng.uniform(-40, 40, (n_p, 3)).astype(np.float32)
    d, i = knn_ops.knn_xla(jnp.asarray(q), jnp.asarray(p),
                           jnp.ones(n_p, bool), 5)
    d, i = np.asarray(d, np.float64), np.asarray(i)
    q64, p64 = q.astype(np.float64), p.astype(np.float64)
    exact = ((q64[:, None, :] - p64[i]) ** 2).sum(-1)
    c = q64.mean(0)
    scale = ((q64 - c) ** 2).sum(1).max() + ((p64 - c) ** 2).sum(1).max()
    bound = 8 * 2.0 ** -24 * scale
    err = float(np.abs(d - exact).max())
    return {"max_err_m2": err, "bound_m2": float(bound)}


def phase_device() -> dict:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r}")
    import rgc_slam_tpu

    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    log(f"card: {card_name()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"jax_default_matmul_precision={jax.config.jax_default_matmul_precision}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir} "
        f"(package default {rgc_slam_tpu.CACHE_DIR})")
    r = float32_check()
    log(f"float32 check: max |d - d_f64| = {r['max_err_m2']:.3e} m^2 "
        f"(bound {r['bound_m2']:.3e} m^2)")
    if not r["max_err_m2"] < r["bound_m2"]:
        raise AssertionError(f"float32 check failed: {r}")
    return info


# ---------------------------------------------------------------- phase 1
# (queries, points, k, fleet batch): mapping association single stream and
# fleet, loop ICP (max_kf_corner + max_kf_surf sources vs the submap cap)
KNN_SHAPES = {
    "mapping": (2048, 32768, 5, 0),
    "fleet_mapping": (1024, 8192, 5, 128),
    "loop_icp": (2560, 16384, 1, 0),
}


def check_knn_kernel(qn: int, n: int, k: int, batch: int = 0, seed: int = 0,
                     interpret: bool = False, time_it: bool = False) -> dict:
    """Kernel vs ops/knn.knn_xla on the same inputs (uniform in ±10 m, 10 %
    of points masked).  Distances agree within the float32 rounding bound of
    float32_check, 8·2^-24·(|q|^2 + |p|^2) (~2.9e-4 m^2 here): the two
    compute the same centred expression, but the kernel's fused
    multiply-adds round differently from XLA's product (the interpret-mode
    tests, where both round alike, hold 1e-4).  Indices are equal, ties to
    the lower index; a differing index is accepted only as a float32
    near-tie, both chosen points' exact float64 distances within the bound.
    """
    import jax
    import jax.numpy as jnp

    from rgc_slam_tpu.ops import knn as knn_ops
    from rgc_slam_tpu.ops.pallas.knn_kernel import knn_triton

    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    q = rng.uniform(-10, 10, lead + (qn, 3)).astype(np.float32)
    p = rng.uniform(-10, 10, lead + (n, 3)).astype(np.float32)
    m = rng.random(lead + (n,)) > 0.1
    kern = functools.partial(knn_triton, k=k, interpret=interpret)
    ref = functools.partial(knn_ops.knn_xla, k=k)
    if batch:
        kern, ref = jax.vmap(kern), jax.vmap(ref)
    kern, ref = jax.jit(kern), jax.jit(ref)
    args = (jnp.asarray(q), jnp.asarray(p), jnp.asarray(m))
    t0 = time.perf_counter()
    kern.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    d_k, i_k = (np.asarray(a) for a in kern(*args))
    d_r, i_r = (np.asarray(a) for a in ref(*args))
    c = q.reshape(-1, qn, 3).mean(1)[:, None, :]
    scale = (((q.reshape(-1, qn, 3) - c) ** 2).sum(-1).max()
             + ((p.reshape(-1, n, 3) - c) ** 2).sum(-1).max())
    bound = 8 * 2.0 ** -24 * float(scale)
    d_err = float(np.abs(d_k - d_r).max())
    assert d_err <= bound, f"distance error {d_err} > {bound}"
    diff = i_k != i_r
    if diff.any():
        qq = q.reshape(-1, qn, 1, 3).astype(np.float64)
        pp = p.reshape(-1, n, 3).astype(np.float64)
        rows = np.arange(pp.shape[0])[:, None, None]
        exact = lambda idx: ((pp[rows, idx.reshape(-1, qn, k)] - qq) ** 2).sum(-1)
        gap = float(np.abs(exact(i_k) - exact(i_r)).max())
        assert gap <= bound, f"{int(diff.sum())} indices differ, not near-ties ({gap})"
    out = {"compile_s": compile_s, "max_dist_err": d_err, "bound": bound,
           "near_tie_swaps": int(diff.sum())}
    if time_it:
        out["kernel_ms"] = _timed(kern, *args)
        out["xla_ms"] = _timed(ref, *args)
    return out


def phase_knn(card: str) -> None:
    from rgc_slam_tpu.ops import knn as knn_ops

    for name, (qn, n, k, b) in KNN_SHAPES.items():
        r = check_knn_kernel(qn, n, k, b, time_it=True)
        log(f"knn {name} Q={qn} N={n} k={k} B={b or 1}: compile "
            f"{r['compile_s']:.1f} s, max |dd| {r['max_dist_err']:.2e} "
            f"(bound {r['bound']:.2e}), "
            f"near-tie swaps {r['near_tie_swaps']}; kernel "
            f"{r['kernel_ms']:.3f} ms vs XLA {r['xla_ms']:.3f} ms "
            f"[{card}]; knn() takes "
            f"{'kernel' if knn_ops.use_kernel(qn, n, k) else 'XLA'}")


# ---------------------------------------------------------------- phase 2
# the closed course of tests/test_loop.py (seed-11 circle, 1.25 laps) at the
# 16-beam sensor's full 900-azimuth width; that test holds the post-PGO
# keyframe trajectory of this course to 1.5 m ATE
LOOP_COURSE = dict(n_scans=210, n_azimuth=900, seed=11, extent=22.0,
                   radius=9.0, noise=0.004, motion_distortion=True,
                   closes_loop=True, laps=1.25)
KF_ATE_BOUND_M = 1.5


def _load_tum(path: str) -> np.ndarray:
    return np.loadtxt(path)[:, 1:4]


def phase_single(card: str, workdir: str, course: dict = LOOP_COURSE) -> None:
    import jax
    import jax.numpy as jnp

    from rgc_slam_tpu import run
    from rgc_slam_tpu.config import SlamConfig
    from rgc_slam_tpu.io import synthetic
    from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu.models import loop as loop_mod
    from rgc_slam_tpu.models.slam import SlamState, slam_step
    from rgc_slam_tpu.runtime.loader import write_sequence
    from rgc_slam_tpu.utils.evaluation import ate_rmse

    seq = synthetic.generate_sequence(**course)
    slog = os.path.join(workdir, "course.slog")
    write_sequence(slog, seq)
    cfg = SlamConfig()
    assert cfg.loop_closure_enable

    # compile the two programs run.main jits, once, to time them; run.main
    # then loads them from the persistent compile cache
    t_imu, acc, gyr = seq["imu"][0]
    ex = (SlamState.init(cfg), cloud_from_scan_dict(seq["scans"][0], cfg),
          imu_from_interval(t_imu, acc, gyr, cfg.max_imu),
          jnp.asarray(seq["stamps"][0], jnp.float32))
    t0 = time.perf_counter()
    step_c = jax.jit(functools.partial(slam_step, cfg=cfg)).lower(*ex).compile()
    log(f"single: slam_step compile {time.perf_counter() - t0:.1f} s [{card}]")
    log(f"single: slam_step memory_analysis {step_c.memory_analysis()}")
    t0 = time.perf_counter()
    jax.jit(functools.partial(loop_mod.loop_closure_step, cfg=cfg)).lower(
        ex[0], loop_mod.LoopState.init(cfg)).compile()
    log(f"single: loop_closure_step compile {time.perf_counter() - t0:.1f} s "
        f"[{card}]")

    out_dir = os.path.join(workdir, "single_out")
    t0 = time.perf_counter()
    system = run.main(["--log", slog, "--out-dir", out_dir])
    wall = time.perf_counter() - t0
    est = _load_tum(os.path.join(out_dir, "pose_evo.txt"))
    gt = np.stack([t for (_, t) in seq["poses"]])
    assert est.shape == gt.shape and np.isfinite(est).all(), "non-finite poses"
    n_loops = int(system.loop_state.loop_count)
    ms = system.state.mapping
    n_kf = int(ms.kf_count)
    kf_t = np.asarray(ms.kf_t[:n_kf])
    stamps = np.asarray(seq["stamps"], np.float32)
    kf_gt = np.stack([gt[int(np.argmin(np.abs(stamps - s)))]
                      for s in np.asarray(ms.kf_stamp[:n_kf])])
    kf_ate = ate_rmse(kf_t, kf_gt)
    timing = json.load(open(os.path.join(out_dir, "timing.json")))["scan"]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"single: {len(est)} scans in {wall:.1f} s via run.main; steady "
        f"{timing['p50_ms']:.2f} ms/scan p50, {timing['p95_ms']:.2f} p95, "
        f"{timing['max_ms']:.1f} max (per scan incl. host sync) [{card}]")
    log(f"single: loops {n_loops}, ATE {ate_rmse(est, gt):.4f} m, post-PGO "
        f"keyframe ATE {kf_ate:.4f} m over {n_kf} keyframes "
        f"(bound {KF_ATE_BOUND_M} m); peak_bytes_in_use {peak}")
    assert n_loops >= 1, "no loop accepted on the closed course"
    assert kf_ate < KF_ATE_BOUND_M, f"keyframe ATE {kf_ate} m"


# ---------------------------------------------------------------- phase 3
# Scans per chunk program.  bench.CHUNK (8) compiles for many minutes on the
# card (a 2-scan chunk took 133-198 s on an H100, PERF.md), too long for a
# smoke run; 2 divides loop_cadence, so the loop cond fires every 10 scans.
FLEET_CHUNK = 2


def phase_fleet(card: str, B: int = 128, chunk: int = FLEET_CHUNK,
                n_chunks: int = 8, cfg=None) -> None:
    """Chunked fleet program with loop closure folded in; robot 0 against
    its own stream through unbatched slam_step + loop_closure_step.

    Tolerance, as tests/test_fleet.py holds the vmapped fleet to a single
    robot: the first 3 poses agree to 1e-4 m (batched and unbatched
    programs reduce in different orders, and the gated nonlinear solve
    amplifies that later), and over the whole window the two ATEs agree
    within 0.25 * max + 0.02 m."""
    import jax
    import jax.numpy as jnp

    import bench
    from rgc_slam_tpu.models import loop as loop_mod
    from rgc_slam_tpu.models.slam import SlamState, slam_step
    from rgc_slam_tpu.parallel import fleet
    from rgc_slam_tpu.utils.evaluation import ate_rmse

    cfg = cfg or bench.FLEET_CONFIG
    n_scans = chunk * n_chunks
    t0 = time.perf_counter()
    inputs, seq0 = bench._stage_inputs(cfg, B, n_scans + 1)
    inputs = inputs[:n_scans]
    log(f"fleet: staged {n_scans} scans x {B} robots in "
        f"{time.perf_counter() - t0:.1f} s")

    cstep = fleet.make_fleet_chunk_step(cfg, chunk)
    states = fleet.fleet_init(cfg, B)
    loop_states = fleet.fleet_loop_init(cfg, B)
    counter = jnp.asarray(0, jnp.int32)
    flat = lambda c: [x for j in range(chunk) for x in inputs[c * chunk + j]]
    t0 = time.perf_counter()
    compiled = cstep.lower(states, loop_states, counter, *flat(0)).compile()
    log(f"fleet: {chunk}-scan chunk program compile "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    log(f"fleet: memory_analysis {compiled.memory_analysis()}")

    traj, times = [], []
    for c in range(n_chunks):
        t0 = time.perf_counter()
        states, loop_states, counter, outs = compiled(
            states, loop_states, counter, *flat(c))
        jax.block_until_ready(states)
        times.append(time.perf_counter() - t0)
        traj.extend(np.asarray(o.t_map) for o in outs)
    traj = np.stack(traj)                                   # [T, B, 3]
    assert np.isfinite(traj).all(), "non-finite fleet poses"
    fired = int(counter) // cfg.loop_cadence
    assert fired >= 1, "the loop/PGO/compaction cond never fired"
    steady = statistics.median(times[1:])
    log(f"fleet: {B} robots, {n_scans} scans, loop cond fired {fired}x; "
        f"steady {chunk * B / steady:.0f} scans/s ({steady * 1e3:.1f} ms "
        f"per {chunk}-scan chunk) [{card}]")

    # robot 0 alone, loop closure after each chunk that crossed a cadence
    # boundary (where the chunk program's cond fired)
    one = lambda tree: jax.tree.map(lambda a: a[0], tree)
    sstep = jax.jit(functools.partial(slam_step, cfg=cfg))
    sloop = jax.jit(functools.partial(loop_mod.loop_closure_step, cfg=cfg))
    s, ls = SlamState.init(cfg), loop_mod.LoopState.init(cfg)
    single = []
    for k in range(n_scans):
        s, out = sstep(s, *one(inputs[k]))
        single.append(np.asarray(out.t_map))
        if (k + 1) % chunk == 0 and \
                (k + 1) // cfg.loop_cadence > (k + 1 - chunk) // cfg.loop_cadence:
            s, ls, _ = sloop(s, ls)
    single = np.stack(single)
    gt = np.stack([t for (_, t) in seq0["poses"]])[:n_scans]
    a_f, a_s = ate_rmse(traj[:, 0], gt), ate_rmse(single, gt)
    head = float(np.abs(traj[:3, 0] - single[:3]).max())
    log(f"fleet: robot 0 vs alone: first-3 gap {head:.2e} m, ATE fleet "
        f"{a_f:.4f} m vs alone {a_s:.4f} m")
    assert head <= 1e-4, f"robot 0 first poses differ by {head} m"
    assert abs(a_f - a_s) < 0.25 * max(a_f, a_s) + 0.02, (a_f, a_s)


# ---------------------------------------------------------------- phase 4
def phase_mesh(card: str, n_devices: int = 4, n_robots: int = 8,
               n_steps: int = 8, cfg=None, n_azimuth: int = 900) -> None:
    """fleet.make_distributed_step on an n-card ('dp', 'sp') mesh against
    the same fleet vmapped on one card, under dryrun_multichip's 5e-3 m
    gate; then checks that the sharded state spans every card."""
    import jax

    import bench
    from __graft_entry__ import dryrun_multichip

    cfg = cfg or bench.FLEET_CONFIG
    t0 = time.perf_counter()
    r = dryrun_multichip(n_devices, n_steps=n_steps, cfg=cfg,
                         n_robots=n_robots, n_azimuth=n_azimuth)
    log(f"mesh: {n_robots} robots x {n_steps} steps on {n_devices} devices, "
        f"max shard-vs-vmap gap {r['max_gap_m']:.2e} m (gate 5e-3), "
        f"{time.perf_counter() - t0:.1f} s incl. compile [{card}]")
    leaf = r["states"].mapping.kf_t
    used = {sh.device for sh in leaf.addressable_shards}
    devs = jax.devices()[:n_devices]
    # the CPU backend keeps no memory stats (None)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    log(f"mesh: state shards on {sorted(d.id for d in used)}; "
        f"peak_bytes_in_use per device {peaks}")
    assert used == set(devs), f"state lives on {used}, not on all {devs}"
    assert all(p is None or p > 0 for p in peaks), "a device did no work"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded fleet step on four cards")
    args = ap.parse_args(argv)

    t_all = time.perf_counter()
    info = phase_device()
    card = card_name()
    if args.devices > 1:
        if info["count"] < args.devices:
            raise SystemExit(f"need {args.devices} GPUs, JAX sees {info['count']}")
        phases = {"mesh": lambda _: phase_mesh(card, args.devices)}
    else:
        phases = {
            "knn": lambda _: phase_knn(card),
            "single": lambda workdir: phase_single(card, workdir),
            "fleet": lambda _: phase_fleet(card),
        }
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        for name, fn in phases.items():
            t0 = time.perf_counter()
            fn(workdir)
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    log(f"all phases: {time.perf_counter() - t_all:.1f} s; card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
