"""Per-stage timing + FLOPs breakdown of one SLAM step on the bench config.

Times each pipeline stage (features / odometry / mapping / full step) as a
separately jitted function on real hardware and reports XLA cost-analysis
FLOPs + bytes, to aim kernel work at the true hot spot (VERDICT r1 item 4).

Run: `python eval_stages.py` (GPU) or `JAX_PLATFORMS=cpu ...` (debug).
"""
from __future__ import annotations

import functools
import statistics
import time

import jax
import jax.numpy as jnp

from bench import BENCH_CONFIG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu.models import odometry as odo_mod
from rgc_slam_tpu.models.slam import SlamState, slam_step
from rgc_slam_tpu.ops import features as F


def _time(fn, args, n=30):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _cost(fn, args):
    try:
        ca = jax.jit(fn).lower(*args).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return ca.get("flops", 0.0), ca.get("bytes accessed", 0.0)
    except Exception:
        return None, None


def fleet_differential(B: int = 128, n_timed: int = 40):
    """Stage shares by config differencing at fleet batch:

      full               — the bench fleet step
      mapping skipped    — mapping_skip_frame huge (lax.cond skip branch)
      + LM capped at 1   — vgicp_max_iterations=1 (registration share)
      features only      — vmapped extract_features on the same inputs

    Differences between medians estimate per-stage device time; every
    variant pays the same dispatch cost, which cancels.
    """
    import dataclasses
    import jax.numpy as jnp
    from bench import FLEET_CONFIG, _stage_inputs
    from rgc_slam_tpu.parallel import fleet

    cfg = FLEET_CONFIG
    inputs, _ = _stage_inputs(cfg, B, n_timed + 6)

    def run_variant(name, vcfg, only_features=False):
        states = fleet.fleet_init(vcfg, B)
        if only_features:
            f = jax.jit(jax.vmap(functools.partial(F.extract_features, cfg=vcfg)))
            step = lambda st, cl, im, sp: (st, f(cl))
            lowered = jax.jit(
                lambda st, cl, im, sp: (st, f(cl))
            ).lower(states, *inputs[0])
        else:
            step = jax.jit(functools.partial(fleet.fleet_step, cfg=vcfg))
            lowered = step.lower(states, *inputs[0])
        # deterministic work columns beside the wall times: XLA cost
        # analysis (flops/bytes) per variant
        try:
            ca = lowered.compile().cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            gf = ca.get("flops", 0.0) / 1e9
            gb = ca.get("bytes accessed", 0.0) / 1e9
        except Exception:
            gf = gb = float("nan")
        for k in range(4):
            states, out = step(states, *inputs[k])
        jax.block_until_ready(out)
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            for k in range(4, 4 + n_timed):
                states, out = step(states, *inputs[k])
            jax.block_until_ready(out)
            reps.append((time.perf_counter() - t0) / n_timed * 1e3)
        ms = statistics.median(reps)
        print(f"{name:22s} {ms:8.3f} ms/fleet-step (B={B})  "
              f"flops={gf:8.2f} G  bytes={gb:8.2f} GB", flush=True)
        return ms, gf, gb

    full = run_variant("full", cfg)
    nomap = run_variant("mapping skipped", dataclasses.replace(
        cfg, mapping_skip_frame=1_000_000_000))
    lm1 = run_variant("nomap + LM capped 1", dataclasses.replace(
        cfg, mapping_skip_frame=1_000_000_000, vgicp_max_iterations=1))
    feat = run_variant("features only", cfg, only_features=True)
    print(f"{'mapping share≈':22s} {full[0] - nomap[0]:8.3f} ms  "
          f"{full[1] - nomap[1]:8.2f} Gflop  {full[2] - nomap[2]:8.2f} GB")
    print(f"{'vgicp LM share≈':22s} {nomap[0] - lm1[0]:8.3f} ms  "
          f"{nomap[1] - lm1[1]:8.2f} Gflop  {nomap[2] - lm1[2]:8.2f} GB")
    print(f"{'features(+floor)≈':22s} {feat[0]:8.3f} ms  {feat[1]:8.2f} Gflop  "
          f"{feat[2]:8.2f} GB")
    return dict(full=full, nomap=nomap, lm1=lm1, feat=feat)


def fleet_breakdown(B: int = 128, iters: int = 20):
    """Per-stage times of scan-wrapped stage programs at fleet batch."""
    import jax.numpy as jnp
    from bench import FLEET_CONFIG, _stage_inputs
    from rgc_slam_tpu.parallel import fleet

    cfg = FLEET_CONFIG
    inputs, _ = _stage_inputs(cfg, B, 6)
    states = fleet.fleet_init(cfg, B)
    fstep = jax.jit(functools.partial(fleet.fleet_step, cfg=cfg))
    for k in range(4):
        states, _ = fstep(states, *inputs[k])
    jax.block_until_ready(states)
    cloud, imu, stamps = inputs[4]

    def scanned(body, init_carry):
        def outer(cloud, imu, stamps, st):
            def it(c, _):
                return body(c, cloud, imu, stamps, st), None
            c, _ = jax.lax.scan(it, init_carry, None, length=iters)
            return c
        return jax.jit(outer)

    def feat_body(c, cloud, imu, stamps, st):
        cl = cloud.replace(xyz=cloud.xyz + c * 1e-7)
        fx = jax.vmap(functools.partial(F.extract_features, cfg=cfg))(cl)
        return jnp.sum(fx.sharp.confidence) * 0.0 + c * 0.5

    def full_body(c, cloud, imu, stamps, st):
        cl = cloud.replace(xyz=cloud.xyz + c * 1e-7)
        _, out = fleet.fleet_step(st, cl, imu, stamps, cfg)
        return jnp.sum(out.fitness) * 0.0 + c * 0.5

    def odo_body(c, cloud, imu, stamps, st):
        cl = cloud.replace(xyz=cloud.xyz + c * 1e-7)
        fx = jax.vmap(functools.partial(F.extract_features, cfg=cfg))(cl)
        ost, oout = jax.vmap(functools.partial(odo_mod.odometry_step, cfg=cfg))(
            st.odo, fx, imu, stamps
        )
        return jnp.sum(oout.fitness) * 0.0 + c * 0.5

    rows = {}
    base = jnp.asarray(1.0, jnp.float32)
    for name, body in (("features", feat_body), ("feat+odo", odo_body),
                       ("full", full_body)):
        fn = scanned(body, base)
        ms = _time(lambda *a: fn(*a), (cloud, imu, stamps, states), n=8)
        rows[name] = ms / iters
        print(f"{name:10s} {ms / iters:8.3f} ms/step (B={B}, x{iters} scanned)",
              flush=True)
    print(f"{'odometry≈':10s} {rows['feat+odo'] - rows['features']:8.3f} ms/step")
    print(f"{'mapping≈':10s} {rows['full'] - rows['feat+odo']:8.3f} ms/step")
    return rows


def main():
    cfg = BENCH_CONFIG
    seq = synthetic.generate_sequence(
        n_scans=8, n_azimuth=900, seed=1, extent=30.0, radius=12.0,
        noise=0.01, closes_loop=False, speed=2.0,
    )
    cloud = cloud_from_scan_dict(seq["scans"][3], cfg)
    t_imu, acc, gyr = seq["imu"][3]
    imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu)
    stamp = jnp.asarray(seq["stamps"][3], jnp.float32)

    # warm a state by running a few real steps
    state = SlamState.init(cfg)
    step = jax.jit(functools.partial(slam_step, cfg=cfg))
    for k in range(3):
        c = cloud_from_scan_dict(seq["scans"][k], cfg)
        ti, a, g = seq["imu"][k]
        state, _ = step(state, c, imu_from_interval(ti, a, g, cfg.max_imu),
                        jnp.asarray(seq["stamps"][k], jnp.float32))
    jax.block_until_ready(state)

    feats = jax.jit(functools.partial(F.extract_features, cfg=cfg))
    fx = feats(cloud)

    odostep = jax.jit(functools.partial(odo_mod.odometry_step, cfg=cfg))

    rows = []
    for name, fn, args in (
        ("features", feats, (cloud,)),
        ("odometry", odostep, (state.odo, fx, imu, stamp)),
        ("full_step", step, (state, cloud, imu, stamp)),
    ):
        ms = _time(fn, args)
        flops, byt = _cost(lambda *a: fn(*a), args)
        rows.append((name, ms, flops, byt))
        fl = f"{flops / 1e9:.3f} G" if flops else "n/a"
        by = f"{byt / 1e6:.1f} MB" if byt else "n/a"
        print(f"{name:10s} {ms:8.3f} ms   flops={fl}  bytes={by}", flush=True)
    mapping_ms = rows[2][1] - rows[1][1] - rows[0][1]
    print(f"{'mapping≈':10s} {mapping_ms:8.3f} ms (full - odo - features)")


if __name__ == "__main__":
    import sys

    if "--fleet" in sys.argv:
        i = sys.argv.index("--fleet")
        b = int(sys.argv[i + 1]) if len(sys.argv) > i + 1 else 128
        fleet_differential(b)
    else:
        main()
