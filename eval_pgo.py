"""PGO scalability benchmark (VERDICT r1 item 7).

Measures `_pgo_solve` latency and solution quality at growing keyframe
capacities on a synthetic drifted loop: K ground-truth poses on a circle,
the estimate accumulates smooth yaw/translation drift, and one loop closure
ties the last keyframe back to the first.  The exact solver (reference:
Ceres SPARSE_NORMAL_CHOLESKY, RGC_mapping.cpp:2421-2428) would spread the
correction smoothly around the ring; we report wall latency, post-PGO ATE
vs ground truth, and cost reduction for the matrix-free GN-CG solve.

Run: `python eval_pgo.py` (GPU) or `JAX_PLATFORMS=cpu python eval_pgo.py`.
Prints a markdown table (pasted into EVAL.md).
"""
from __future__ import annotations

import functools
import statistics
import time

import numpy as np
import jax
import jax.numpy as jnp

from rgc_slam_tpu.config import SlamConfig
from rgc_slam_tpu.models.mapping import MappingState
from rgc_slam_tpu.models.loop import LoopState, _pgo_solve
from rgc_slam_tpu.utils import math3d as m3


def make_graph(cfg: SlamConfig, K: int, drift_yaw: float = 2e-4,
               drift_t: float = 2e-3, seed: int = 0):
    """Drifted circle with n loops closing the ring (GT pitch/roll = 0)."""
    rng = np.random.default_rng(seed)
    R = K * 0.5 / (2 * np.pi)          # 0.5 m keyframe spacing
    th = np.linspace(0, 2 * np.pi, K, endpoint=False)
    gt_t = np.stack([R * np.cos(th), R * np.sin(th), np.zeros(K)], axis=-1)
    gt_yaw = th + np.pi / 2.0

    # integrate drifted odometry: per-step yaw bias + translation noise
    est_yaw = np.zeros(K)
    est_t = np.zeros((K, 3))
    est_yaw[0], est_t[0] = gt_yaw[0], gt_t[0]
    for i in range(K - 1):
        dyaw = gt_yaw[i + 1] - gt_yaw[i] + drift_yaw
        Rw = np.array([
            [np.cos(est_yaw[i] - gt_yaw[i]), -np.sin(est_yaw[i] - gt_yaw[i]), 0],
            [np.sin(est_yaw[i] - gt_yaw[i]), np.cos(est_yaw[i] - gt_yaw[i]), 0],
            [0, 0, 1],
        ])
        step = Rw @ (gt_t[i + 1] - gt_t[i]) + drift_t * rng.standard_normal(3)
        est_yaw[i + 1] = est_yaw[i] + dyaw
        est_t[i + 1] = est_t[i] + step

    ms = MappingState.init(cfg)
    Kc = cfg.max_keyframes
    ypr = np.zeros((K, 3), np.float32)
    ypr[:, 0] = est_yaw
    kf_q = np.zeros((Kc, 4), np.float32)
    kf_q[:, 0] = 1.0
    kf_q[:K] = np.asarray(jax.vmap(m3.ypr_to_quat)(jnp.asarray(ypr)))
    kf_t = np.zeros((Kc, 3), np.float32)
    kf_t[:K] = est_t
    travel = np.zeros(Kc, np.float32)
    travel[:K] = 0.5 * np.arange(K)
    ms = ms.replace(
        kf_q=jnp.asarray(kf_q), kf_t=jnp.asarray(kf_t),
        kf_travel=jnp.asarray(travel),
        kf_count=jnp.asarray(K, jnp.int32),
    )

    # one loop: latest (K-1) back to keyframe 0, measured from GT
    ls = LoopState.init(cfg)
    q0 = m3.ypr_to_quat(jnp.array([gt_yaw[0], 0.0, 0.0], jnp.float32))
    qn = m3.ypr_to_quat(jnp.array([gt_yaw[-1], 0.0, 0.0], jnp.float32))
    q_rel = m3.quat_mul(m3.quat_conj(q0), qn)
    t_rel = m3.quat_rotate(m3.quat_conj(q0), jnp.asarray(gt_t[-1] - gt_t[0], jnp.float32))
    ls = ls.replace(
        loop_i=ls.loop_i.at[0].set(K - 1),
        loop_j=ls.loop_j.at[0].set(0),
        loop_t=ls.loop_t.at[0].set(t_rel),
        loop_yaw=ls.loop_yaw.at[0].set(m3.quat_to_ypr(q_rel)[0]),
        loop_count=jnp.asarray(1, jnp.int32),
    )
    return ms, ls, gt_t


def ate(kf_t, gt_t, K):
    e = np.asarray(kf_t)[:K] - gt_t
    return float(np.sqrt(np.mean(np.sum(e * e, axis=-1))))


def run_case(K: int, cg_iters: int, reps: int = 3):
    cfg = SlamConfig(max_keyframes=K, max_kf_corner=8, max_kf_surf=8,
                     max_loops=8, pgo_cg_iters=cg_iters)
    ms, ls, gt_t = make_graph(cfg, K)
    solve = jax.jit(functools.partial(_pgo_solve, cfg=cfg))
    out = solve(ms, ls)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = solve(ms, ls)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return {
        "K": K,
        "cg_iters": cg_iters,
        "latency_ms": round(statistics.median(times) * 1e3, 1),
        "ate_before_m": round(ate(ms.kf_t, gt_t, K), 3),
        "ate_after_m": round(ate(out.kf_t, gt_t, K), 3),
    }


def main():
    rows = []
    for K in (512, 2048, 4096):
        for cg in (128,):
            rows.append(run_case(K, cg))
            print(rows[-1], flush=True)
    print()
    print("| K | cg_iters | latency (ms) | ATE before (m) | ATE after (m) |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['K']} | {r['cg_iters']} | {r['latency_ms']} | "
              f"{r['ate_before_m']} | {r['ate_after_m']} |")


if __name__ == "__main__":
    main()
