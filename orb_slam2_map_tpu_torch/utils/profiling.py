"""Per-stage timing — a first-class subsystem.

The reference's only instrumentation is wall-clock timing in the example
mains (reference: Examples/RGB-D/rgbd_tum.cc:91-133: per-frame
steady_clock around TrackRGBD, sorted median/mean at exit) and vocabulary
load timing (src/System.cc:75,95). Here every pipeline stage reports into
a process-wide registry. Device-side traces come from torch.profiler.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np


class StageStats:
    __slots__ = ("count", "total", "times")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.times: List[float] = []

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        t = np.asarray(self.times) if self.times else np.zeros(1)
        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "mean_ms": round(float(t.mean()) * 1e3, 3),
            "median_ms": round(float(np.median(t)) * 1e3, 3),
            "p95_ms": round(float(np.percentile(t, 95)) * 1e3, 3),
            "max_ms": round(float(t.max()) * 1e3, 3),
        }


class Profiler:
    """Thread-safe named-stage timer registry."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._stages: Dict[str, StageStats] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._stages.setdefault(name, StageStats()).add(dt)

    def add_sample(self, name: str, dt: float):
        with self._lock:
            self._stages.setdefault(name, StageStats()).add(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: v.summary() for k, v in sorted(self._stages.items())}

    def report(self) -> str:
        rows = [f"{'stage':<28}{'count':>7}{'mean ms':>10}"
                f"{'median ms':>11}{'p95 ms':>9}"]
        for name, s in self.summary().items():
            rows.append(f"{name:<28}{s['count']:>7}{s['mean_ms']:>10.2f}"
                        f"{s['median_ms']:>11.2f}{s['p95_ms']:>9.2f}")
        return "\n".join(rows)

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

    def reset(self):
        with self._lock:
            self._stages.clear()


# process-wide default, used by the pipeline stages
PROFILER = Profiler()


def stage(name: str):
    return PROFILER.stage(name)

