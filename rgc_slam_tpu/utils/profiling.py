"""Tracing / metrics — the structured upgrade of the reference's TicToc.

The reference scatters ad-hoc wall-clock prints (``tic_toc.h:7-29``, used at
scanRegistration.cpp:104,729, RGC_odometer.cpp:849,1358-1361,
RGC_mapping.cpp:971,1444-1445).  Here:
  * ``TicToc``        — drop-in stopwatch (host wall clock, device-synced)
  * ``StageTimer``    — named-stage accumulator with p50/p95/max summaries and
    the reference's over-budget warning (>100 ms per scan)
  * ``Metrics``       — step-indexed scalar registry (fitness, factor counts,
    loop events …) dumpable to JSON lines
  * ``trace``         — context manager bridging to jax.profiler traces for
    XLA-level profiling on the device
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, List

import jax
import numpy as np


class TicToc:
    """Wall-clock stopwatch (ref include/rgc_slam/tic_toc.h)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        """Elapsed milliseconds."""
        return (time.perf_counter() - self._t0) * 1000.0


class StageTimer:
    def __init__(self, budget_ms: float = 100.0, sync: bool = True):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.budget_ms = budget_ms
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, *sync_args):
        t0 = time.perf_counter()
        yield
        if self.sync and sync_args:
            jax.block_until_ready(sync_args)
        ms = (time.perf_counter() - t0) * 1000.0
        self.samples[name].append(ms)
        if ms > self.budget_ms:
            # the reference warns when odometry exceeds its 100 ms real-time
            # budget (RGC_odometer.cpp:1360-1361)
            print(f"[rgc-slam-tpu] stage '{name}' over budget: {ms:.1f} ms")

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "max_ms": float(a.max()),
            }
        return out


class Metrics:
    """Step-indexed scalar registry with JSONL dump."""

    def __init__(self):
        self.records: List[dict] = []

    def log(self, step: int, **scalars):
        rec = {"step": step}
        for k, v in scalars.items():
            rec[k] = float(v) if np.isscalar(v) or hasattr(v, "item") else v
        self.records.append(rec)

    def dump(self, path: str):
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def series(self, key: str) -> np.ndarray:
        return np.asarray([r[key] for r in self.records if key in r])


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace for XLA/device-level inspection (xprof/tensorboard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
