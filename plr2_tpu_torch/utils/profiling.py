"""Profiling and timing, the port of plr2_tpu/utils/profiling.py:

  * `trace(logdir)`: `torch.profiler` around a block (the CPU, and the
    card where there is one), written as a Chrome trace
    (`<logdir>/trace.json`, for Perfetto or chrome://tracing); the block
    gets the profiler, whose `key_averages()` sum time by op and kernel
  * `time_fn`: first-call and steady-state timing; CUDA work is
    synchronised before each clock read, and the first call (lazy
    initialisation, kernel builds, CUDA graph capture) is kept apart as
    `compile_s`
  * `Timer`: the reference's wall-clock section logger.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity, profile


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: `with trace('dir') as prof: run_step()`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kwargs) -> Dict[str, float]:
    """First call + steady-state timing. Returns ms stats and items/s if the
    first argument has a leading batch dimension."""
    _sync()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    compile_s = time.perf_counter() - t0

    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()

    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    dt = time.perf_counter() - t0

    res = {"compile_s": compile_s, "mean_ms": dt / iters * 1e3,
           "iters": float(iters)}
    if args and hasattr(args[0], "shape") and len(args[0].shape) > 0:
        res["items_per_s"] = args[0].shape[0] * iters / dt
    return res


class Timer:
    """Accumulating section timer for host-side loops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {total / n * 1e3:.2f} "
                         f"ms/call ({n} calls)")
        return "\n".join(lines)
