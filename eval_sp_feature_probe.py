"""sp revisit probe (VERDICT r4 item 9 / PARITY §sp FINAL's one reserved
revisit condition): does the FEATURE stage leave the dispatch floor on a
single-robot, compute-heavy deployment?

PARITY's sp-FINAL decision keeps the feature front-end unsharded because at
product caps the whole fleet step sat on the dispatch floor.
The reserved revisit case is a single-stream 128-beam-class sensor at 10x
the point cap (max_points=131072, 64 rings x 2048 azimuth — the densest
spec this synthetic generator can cast).  This probe times exactly that:

  * jitted ``ops.features.extract_features`` single-stream at 131072-point
    caps (10x sharp/flat/intensity budgets so the picker scales too),
  * a trivial jitted program on the same input, which IS the dispatch floor
    for this device,
  * the same feature program at the product 16-ch cap for reference.

Decision rule printed with the numbers: if feature time stays within ~2x
the dispatch floor, the ±5-point halo-exchange sp design for the feature
stage stays closed (sharding it would only shave compute the dispatch floor
hides); if it clears the floor by >>2x, the halo design has its first real
justification.  Reference analog: the OpenMP point loops that parallelize
this same stage on CPU (scanRegistration.cpp:233-306).

Run on the GPU: `python eval_sp_feature_probe.py` (one JSON line).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from rgc_slam_tpu.config import SlamConfig
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict
from rgc_slam_tpu.ops import features as F


def _note(msg):
    print(f"[probe {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _median_ms(fn, args, n=30):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _flops(fn, args):
    try:
        ca = jax.jit(fn).lower(*args).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        f = ca.get("flops", 0.0)
        return float(f) if f else None
    except Exception:
        return None


def probe_config(n_rings: int, n_azimuth: int, cap_scale: int) -> SlamConfig:
    return SlamConfig(
        n_scans=n_rings,
        use_ground=False,                     # no ground table at 64 beams
        use_imu=False,
        max_points=n_rings * n_azimuth,
        max_points_per_ring=n_azimuth,
        max_sharp_total=2048 * cap_scale,
        max_flat_total=4096 * cap_scale,
        max_inten_total=2048 * cap_scale,
    )


def time_features(cfg: SlamConfig, n_rings: int, n_azimuth: int, seed: int):
    world = synthetic.default_world(seed=seed, extent=40.0)
    rng = np.random.default_rng(seed)
    scan = synthetic.cast_scan(
        world, np.eye(3), np.array([0.0, 0.0, 0.56]), n_rings=n_rings,
        n_azimuth=n_azimuth, rng=rng, noise=0.01,
    )
    cloud = jax.device_put(cloud_from_scan_dict(scan, cfg))
    feat = jax.jit(functools.partial(F.extract_features, cfg=cfg))
    ms = _median_ms(feat, (cloud,))
    gf = _flops(functools.partial(F.extract_features, cfg=cfg), (cloud,))
    # dispatch floor: a trivial program on the same device
    floor_fn = jax.jit(lambda c: c.xyz[0] + 1.0)
    floor_ms = _median_ms(floor_fn, (cloud,))
    return ms, floor_ms, (gf / 1e9 if gf else None), int(np.sum(
        np.asarray(cloud.mask)))


def main():
    dev = jax.devices()[0].device_kind

    _note("dense probe: 64 rings x 2048 az = 131072-point caps, 10x budgets")
    dense_ms, dense_floor, dense_gflops, dense_n = time_features(
        probe_config(64, 2048, 10), 64, 2048, seed=5
    )
    _note(f"dense features {dense_ms:.2f} ms (floor {dense_floor:.2f} ms)")

    _note("product probe: 16 rings x 900 az = 16384-point caps")
    prod_cfg = dataclasses.replace(
        probe_config(16, 1024, 1), max_points=16384, use_ground=True
    )
    prod_ms, prod_floor, prod_gflops, prod_n = time_features(
        prod_cfg, 16, 900, seed=5
    )
    _note(f"product features {prod_ms:.2f} ms (floor {prod_floor:.2f} ms)")

    floor = min(dense_floor, prod_floor)
    ratio = dense_ms / floor if floor > 0 else None
    verdict = (
        "sp-halo stays closed: the dense feature stage is within ~2x of the "
        "dispatch floor — sharding it would shave compute the floor hides"
        if ratio is not None and ratio < 2.0 else
        "sp-halo revisit justified: the dense feature stage clears the "
        "dispatch floor — a ±5-point halo exchange over sp would now buy "
        "real single-stream latency"
    )
    print(json.dumps({
        "probe": "sp feature-stage revisit (PARITY §sp, VERDICT r4 item 9)",
        "device": dev,
        "dense_caps": {"rings": 64, "azimuth": 2048, "max_points": 131072,
                       "valid_points": dense_n},
        "dense_feature_ms": round(dense_ms, 3),
        "dense_dispatch_floor_ms": round(dense_floor, 3),
        "dense_feature_gflops": (round(dense_gflops, 3)
                                 if dense_gflops else None),
        "product_feature_ms": round(prod_ms, 3),
        "product_valid_points": prod_n,
        "dense_over_floor_x": round(ratio, 2) if ratio else None,
        "verdict": verdict,
    }))


if __name__ == "__main__":
    main()
