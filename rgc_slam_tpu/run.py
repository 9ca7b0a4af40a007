"""CLI runner: the `roslaunch rgc_slam run.launch` equivalent.

    python -m rgc_slam_tpu.run --log seq.slog --out-dir results/
    python -m rgc_slam_tpu.run --kitti path/to/sequences/00/velodyne --no-imu
    python -m rgc_slam_tpu.run --synthetic 100 --out-dir results/

Processes a sweep source through the full SLAM engine, dumps TUM trajectories
(odometry + mapped), the global map PCD, and a metrics JSONL — the file
surface the reference produces via its trajectory writers and PCD dumps.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    """Run the CLI; returns the SlamSystem (None in fleet mode)."""
    ap = argparse.ArgumentParser(description="rgc-slam-tpu runner")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--log", help="sweep-log file (runtime/sweeplog format)")
    src.add_argument("--bag", help="rosbag v2.0 file (PointCloud2 + Imu)")
    src.add_argument("--kitti", help="KITTI velodyne directory")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="run N synthetic scans")
    ap.add_argument("--cloud-topic", default="/velodyne_points")
    ap.add_argument("--imu-topic", default="/mynteye/imu/data_raw")
    ap.add_argument("--out-dir", default="slam_out")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--n-scans-sensor", type=int, metavar="N", default=0,
                    help="sensor beam count (16/32/64); sets the ring "
                         "bookkeeping and ground tables (default 16)")
    ap.add_argument("--imu-cov-mode", choices=["reference", "preint"],
                    default=None,
                    help="DeltaR factor weight source: the reference's "
                         "hardcoded constants, or the propagated 15-dim "
                         "preintegration covariance (ops/imu)")
    ap.add_argument("--no-ground", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--localize", metavar="CKPT",
                    help="localization mode: restore a prior-map checkpoint")
    ap.add_argument("--save-ckpt", metavar="DIR", help="save final state")
    ap.add_argument("--dump-frames", action="store_true",
                    help="write each deskewed scan as a world-frame PCD "
                         "(ref per-frame dumps, RGC_odometer.cpp:1353-1354)")
    ap.add_argument("--viz", action="store_true",
                    help="write viewer.html (map + trajectory + loop edges)")
    ap.add_argument("--viz-every", type=int, metavar="N", default=0,
                    help="rewrite viewer.html every N scans with "
                         "auto-refresh (live rviz stand-in)")
    ap.add_argument("--fleet", type=int, metavar="B", default=0,
                    help="run B SLAM instances per device (vmap fleet, "
                         "BASELINE config 5); the source stream is "
                         "replicated to every robot")
    ap.add_argument("--chunk", type=int, metavar="C", default=1,
                    help="advance C scans per device dispatch (buffered "
                         "replay throughput lever; per-scan budget timing "
                         "is then per-chunk)")
    args = ap.parse_args(argv)

    import jax

    from .config import SlamConfig
    from .io.convert import cloud_from_arrays, imu_from_interval
    from .models.slam import SlamSystem, SlamState
    from .utils.profiling import Metrics, StageTimer

    overrides = {}
    if args.no_imu:
        overrides["use_imu"] = False
    if args.imu_cov_mode:
        overrides["imu_cov_mode"] = args.imu_cov_mode
    if args.n_scans_sensor:
        overrides["n_scans"] = args.n_scans_sensor
        if args.n_scans_sensor > 32:
            # no low-ring ground-elevation table for 64-beam sensors (ring 0
            # is the highest beam) — config would raise (see
            # SlamConfig.expected_ground_ranges); the KITTI preset does this
            overrides["use_ground"] = False
    if args.no_ground:
        overrides["use_ground"] = False
    if args.no_loop:
        overrides["loop_closure_enable"] = False
    if args.localize:
        overrides["map_update"] = False

    os.makedirs(args.out_dir, exist_ok=True)

    # ---- source ----
    if args.kitti:
        from .io.kitti import KittiSequence, kitti_config

        cfg = kitti_config(**overrides)
        source = KittiSequence(args.kitti, cfg)
        feed = iter(source)
    elif args.bag:
        # the reference's front door: bag replay (README.md:40-52).  Parsed
        # pure-Python (io/rosbag.py) — no ROS installation required.
        from .io.rosbag import scan_stream

        cfg = SlamConfig(**overrides)

        def gen():
            for s in scan_stream(args.bag, args.cloud_topic, args.imu_topic,
                                 cfg.n_scans, cfg.scan_period):
                mask = np.ones(len(s["xyz"]), bool)
                yield {
                    "cloud": cloud_from_arrays(
                        s["xyz"], s["intensity"], s["ring"], s["rel_time"],
                        mask, cfg.max_points,
                    ),
                    "imu": imu_from_interval(
                        s["imu_t"], s["imu_acc"], s["imu_gyr"], cfg.max_imu,
                    ),
                    "stamp": s["stamp"],
                }

        feed = gen()
    elif args.log:
        from .runtime.loader import SweepLogReader

        cfg = SlamConfig(**overrides)
        reader = SweepLogReader(args.log, cfg.max_points, cfg.max_imu)

        def gen():
            for s in reader:
                yield {
                    "cloud": cloud_from_arrays(
                        s["xyz"], s["intensity"], s["ring"], s["rel_time"],
                        s["mask"], cfg.max_points,
                    ),
                    "imu": imu_from_interval(
                        s["imu_t"][s["imu_mask"]], s["imu_acc"][s["imu_mask"]],
                        s["imu_gyr"][s["imu_mask"]], cfg.max_imu,
                    ),
                    "stamp": s["stamp"],
                }

        feed = gen()
    else:
        from .io import synthetic
        from .io.convert import cloud_from_scan_dict

        cfg = SlamConfig(**overrides)
        seq = synthetic.generate_sequence(
            n_scans=args.synthetic + 1, n_azimuth=900, seed=0,
            extent=30.0, radius=12.0, closes_loop=False, speed=2.0,
        )

        def gen():
            for k in range(len(seq["scans"])):
                t_imu, acc, gyr = seq["imu"][k]
                yield {
                    "cloud": cloud_from_scan_dict(seq["scans"][k], cfg),
                    "imu": imu_from_interval(t_imu, acc, gyr, cfg.max_imu),
                    "stamp": seq["stamps"][k],
                }

        feed = gen()

    # ---- fleet mode: B vmapped instances, one device (BASELINE config 5) ----
    if args.fleet:
        import dataclasses
        import functools
        import time as _time

        import jax.numpy as jnp

        from .models.mapping import COMPACT_MARGIN
        from .parallel import fleet

        # surface unsupported flag combinations instead of silently ignoring
        # them (ADVICE r2): fleet mode has no per-frame dump / viz / ckpt
        for flag, name in [
            (args.dump_frames, "--dump-frames"), (args.viz, "--viz"),
            (args.viz_every, "--viz-every"), (args.save_ckpt, "--save-ckpt"),
            (args.localize, "--localize"),
        ]:
            if flag:
                raise SystemExit(f"{name} is not supported with --fleet")

        # the per-scan inline-compaction cond would execute both branches
        # under vmap (see fleet.compact_fleet) — eviction runs host-cadenced
        cfg = dataclasses.replace(cfg, inline_compaction=False)
        B = args.fleet
        C = max(args.chunk, 1)
        # loop closure + PGO run vmapped on the SlamSystem cadence (the
        # reference's pose-graph thread always runs when enabled,
        # RGC_mapping.cpp:303-304,1962); its compaction is loop-aware, so
        # the loop path must NOT also run fleet.compact_fleet
        run_loops = cfg.loop_closure_enable and cfg.map_update
        states = fleet.fleet_init(cfg, B)
        if run_loops:
            # loop closure + PGO + loop-aware compaction are cadence-gated
            # INSIDE the step program (fleet.fleet_loop_fused_step: top-level
            # lax.cond, counter on device) and chunked with it — one program,
            # full dispatch amortization, no host-gated eviction backstop.
            # A non-divisor chunk can delay a firing by up to chunk-1 scans;
            # make_fleet_chunk_step falls back to its cond-per-scan program
            # (exact cadence) whenever that would exceed the eviction
            # headroom, so the only hard bound here is on the cadence itself.
            if cfg.loop_cadence > COMPACT_MARGIN:
                raise SystemExit(
                    f"loop_cadence {cfg.loop_cadence} exceeds the "
                    f"keyframe-eviction headroom "
                    f"(COMPACT_MARGIN={COMPACT_MARGIN})"
                )
            loop_states = fleet.fleet_loop_init(cfg, B)
            counter = jnp.asarray(0, jnp.int32)
            fchunk_l = fleet.make_fleet_chunk_step(cfg, C)
            # trailing-partial-chunk program (compiled lazily on first use)
            fstep1_l = fchunk_l if C == 1 else None
        else:
            # loop-less fleets compact ON DEVICE inside the step (top-level
            # lax.cond — no host round-trips, no staleness; see
            # fleet.fleet_step_compacting)
            fstep = jax.jit(
                functools.partial(fleet.fleet_step_compacting, cfg=cfg)
            )
            if C > 1:
                # chunked dispatch (bench.py's lever) for the fleet too
                from .models.slam import make_chunk_step

                fchunk = make_chunk_step(
                    functools.partial(fleet.fleet_step_compacting, cfg=cfg), C
                )
        metrics = Metrics()
        # summarize fitness into two dedicated scalars: np.asarray on a leaf
        # of the big step output would drag the whole tuple device->host
        _fit_summary = jax.jit(lambda f: (jnp.median(f), jnp.max(f)))
        n = 0
        outs = None
        buf = []
        t0 = _time.perf_counter()

        def batch(item):
            b = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                (item["cloud"], item["imu"]),
            )
            stamps = jnp.broadcast_to(
                jnp.asarray(item["stamp"], jnp.float32), (B,)
            )
            return (b[0], b[1], stamps)

        for item in feed:
            buf.append(batch(item))
            if len(buf) < C:
                continue
            if run_loops:
                flat = [x for triple in buf for x in triple]
                states, loop_states, counter, chunk_outs = fchunk_l(
                    states, loop_states, counter, *flat
                )
                outs = chunk_outs[-1]
            elif C > 1:
                flat = [x for triple in buf for x in triple]
                states, chunk_outs = fchunk(states, *flat)
                outs = chunk_outs[-1]
            else:
                states, outs = fstep(states, *buf[0])
            n += len(buf)
            buf = []
            if n % 50 < C:
                med, mx = _fit_summary(outs.fitness)
                print(f"  scan {n}: fleet fitness med={float(med):.4f} "
                      f"max={float(mx):.4f}")
        for triple in buf:                       # trailing partial chunk
            if run_loops:
                if fstep1_l is None:
                    fstep1_l = fleet.make_fleet_chunk_step(cfg, 1)
                states, loop_states, counter, outs1 = fstep1_l(
                    states, loop_states, counter, *triple
                )
                outs = outs1[-1]
            else:
                states, outs = fstep(states, *triple)
            n += 1
        if outs is None:
            print("fleet: no scans in the source (check topic names / file)")
            return
        jax.block_until_ready(states)
        wall = _time.perf_counter() - t0
        tm = np.asarray(outs.t_map)
        metrics.log(n, robots=B, scans_per_sec=round(n * B / wall, 1),
                    cross_robot_spread_m=float(np.abs(tm - tm[:1]).max()))
        metrics.dump(os.path.join(args.out_dir, "fleet_metrics.jsonl"))
        np.savetxt(os.path.join(args.out_dir, "fleet_final_poses.txt"), tm)
        print(f"fleet {B}x{n} scans in {wall:.1f}s "
              f"({n * B / wall:.0f} scans/sec) -> {args.out_dir}")
        return

    # ---- engine ----
    system = SlamSystem(cfg, chunk=args.chunk)
    if args.localize:
        from .utils.checkpoint import restore

        # checkpoints are SlamSystem.save tuples: (state,) or (state, loop)
        from .models.loop import LoopState

        try:
            (restored, _loop), _ = restore(
                args.localize, (SlamState.init(cfg), LoopState.init(cfg))
            )
        except Exception as with_loop_err:
            # the checkpoint may predate loop state (no-loop session); if
            # that layout fails too, surface BOTH causes instead of masking
            # the real restore error behind the fallback's mismatch message
            try:
                (restored,), _ = restore(args.localize, (SlamState.init(cfg),))
            except Exception as no_loop_err:
                raise RuntimeError(
                    f"--localize failed for both checkpoint layouts: "
                    f"with-loop: {with_loop_err}; without-loop: {no_loop_err}"
                ) from with_loop_err
        system.state = system.state.replace(mapping=restored.mapping)

    timer = StageTimer(budget_ms=100.0 * args.chunk)
    metrics = Metrics()
    n = 0
    frame_sink = None
    if args.dump_frames:
        # async native PCD writer: frames queue into a bounded ring drained
        # by a C++ thread, so disk writes never stall the replay loop
        try:
            from .runtime.loader import PcdSink

            frame_sink = PcdSink(os.path.join(args.out_dir, "frames"))
        except Exception as e:
            print(f"[rgc-slam-tpu] native PCD sink unavailable ({e}); "
                  "falling back to synchronous writes")

    def chunked(feed, size):
        """Group the stream into size-C lists; the final partial group is
        emitted as singletons (process path)."""
        buf = []
        for item in feed:
            buf.append(item)
            if len(buf) == size:
                yield buf
                buf = []
        for item in buf:
            yield [item]

    try:
      for items in chunked(feed, max(args.chunk, 1)):
        # sync on the step outputs so timing.json measures compute, not
        # dispatch — otherwise the reference's >100 ms budget warning
        # (RGC_odometer.cpp:1360-1361) can never fire.  bench.py, which
        # never syncs per step, owns the throughput story.
        with timer.stage("scan"):
            if len(items) == system.chunk and system.chunk > 1:
                outs = system.process_chunk(
                    [(i["cloud"], i["imu"], i["stamp"]) for i in items]
                )
            else:
                outs = [
                    system.process(i["cloud"], i["imu"], i["stamp"])
                    for i in items
                ]
            jax.block_until_ready(outs)
        out = outs[-1]
        for kk, o in enumerate(outs):
            metrics.log(n + kk, fitness=float(o.fitness),
                        n_corr=int(o.n_corr), kf_added=bool(o.kf_added))
        if args.dump_frames:
            from .utils.math3d import quat_rotate

            frames_dir = os.path.join(args.out_dir, "frames")
            os.makedirs(frames_dir, exist_ok=True)
            for kk, o in enumerate(outs):
                mask = np.asarray(o.full_mask)
                world = np.asarray(
                    quat_rotate(o.q_map[None, :], o.full_xyz) + o.t_map[None, :]
                )[mask]
                if frame_sink is not None:
                    frame_sink.push(n + kk, world)
                else:
                    from .io.export import write_pcd

                    write_pcd(
                        os.path.join(frames_dir, f"frame_{n + kk:06d}.pcd"),
                        world,
                    )
        n_prev = n
        n += len(outs)
        # boundary-crossing test so --chunk C not dividing --viz-every still
        # refreshes at the requested rate
        if args.viz_every and n // args.viz_every > n_prev // args.viz_every:
            from .io.viz import write_viewer

            write_viewer(os.path.join(args.out_dir, "viewer.html"), system, cfg,
                         refresh_s=2.0)
        if n % 50 == 0:
            print(f"  scan {n}: t={np.asarray(out.t_map).round(2)}")
    finally:
        # always drain/join the native writer thread — an exception mid-loop
        # must not leak it or silently drop queued frames
        if frame_sink is not None:
            errs = frame_sink.close()
            if errs:
                print(f"[rgc-slam-tpu] PCD sink: {errs} write errors")

    # ---- outputs (the reference's pose_evo.txt / PCD surface) ----
    system.dump_tum(os.path.join(args.out_dir, "pose_evo.txt"), "map")
    system.dump_tum(os.path.join(args.out_dir, "odometry_pose_evo.txt"), "odom")
    from .io.export import global_map, write_pcd

    pts, conf = global_map(system.state.mapping, cfg)
    if len(pts):
        write_pcd(os.path.join(args.out_dir, "global_map.pcd"), pts, conf)
    if args.viz or args.viz_every:
        from .io.viz import write_viewer

        write_viewer(os.path.join(args.out_dir, "viewer.html"), system, cfg)
    metrics.dump(os.path.join(args.out_dir, "metrics.jsonl"))
    with open(os.path.join(args.out_dir, "timing.json"), "w") as f:
        json.dump(timer.summary(), f, indent=2)
    if args.save_ckpt:
        system.save(args.save_ckpt)
    print(f"processed {n} scans -> {args.out_dir}")
    return system


if __name__ == "__main__":
    main()
