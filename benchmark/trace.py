"""The device trace of a traced slice: `torch.profiler` over CPU and CUDA,
exported as a Chrome trace into a directory under TMPDIR, read back and
deleted.

From it: the device's busy seconds (the union of kernel, copy and set
intervals), the device time of each kernel name, the idle gaps between
device operations, each named by the benchmark's own host range
(`record_function("bench.<what>")`) that was open at the gap's middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """busy_s, window_s, kernel seconds by name, idle gaps."""

    def __init__(self, events: List[Dict], window_s: float):
        dev = sorted(((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e)
                      for e in events if e.get("cat") in DEVICE_CATS
                      and e.get("ph") == "X"), key=lambda x: x[0])
        self.window_s = window_s
        self.kernel_s: Dict[str, float] = {}
        for a, b, e in dev:
            if e["cat"] == "kernel":
                self.kernel_s[e["name"]] = self.kernel_s.get(e["name"], 0.0) \
                    + (b - a)
        merged: List[List[float]] = []
        for a, b, _ in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged)
        self._ranges = [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                         e["name"]) for e in events
                        if e.get("cat") == "user_annotation"
                        and e.get("name", "").startswith("bench.")]
        # (length, middle) of every idle gap between device operations
        self.gaps = [(b - a, 0.5 * (a + b))
                     for (_, a), (b, _) in zip(merged[:-1], merged[1:])]

    def _host_range(self, t: float) -> str:
        """The innermost benchmark range open on the host at time t."""
        inner = [r for r in self._ranges if r[0] <= t <= r[1]]
        return min(inner, key=lambda r: r[1] - r[0])[2] if inner \
            else "no bench range"

    def kernel_time(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(s for n, s in self.kernel_s.items()
                   if any(p in n for p in patterns))

    def breakdown(self) -> Dict:
        ops = sorted(self.kernel_s.items(), key=lambda x: -x[1])[:10]
        gaps = sorted(self.gaps, reverse=True)[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[self._host_range(t), s] for s, t in gaps]}


@contextlib.contextmanager
def traced(result: Dict):
    """Profile the block; on exit `result["trace"]` holds its `Trace`, the
    window being the block's wall time after a synchronise."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    out_dir = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with torch.profiler.profile(activities=act) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        result["trace"] = Trace(events, window)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
