"""Profiling and tracing, the port of plr2_tpu/utils/profiling.py:

  * `trace(logdir)`: `torch.profiler` around a block (the CPU, and the
    card where there is one), written as a Chrome trace
    (`<logdir>/trace.json`, for Perfetto or chrome://tracing); the block
    gets the profiler, whose `key_averages()` sum time by op and kernel
  * `span(name)`: a named range of the program's own host work (the
    serving and training entry points open them: `plr2.serve.*`,
    `plr2.train.*`). A span is recorded only while a `torch.profiler`
    session records (`trace`, or any other profiler); otherwise it costs
    one check of the profiler's flag. A recorded span is a
    `record_function` range of the device trace, on that trace's clock,
    and a record in memory (`spans()`)
  * `idle_by_span(path)`: the device's idle time in a Chrome trace,
    split by the innermost `plr2.*` range open on the host.

A span's record: `name`; `start_ns` and `end_ns` from `time.time_ns()`,
the clock the Chrome trace's `ts` counts from (`ts` is microseconds
after the trace's `baseTimeNanoseconds`); `parent`, the index in
`spans()` of the span it opened in (None for a root), and `call`, the
sequence number of its root span, shared by every span of one call or
step.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# device operations in a Chrome trace of the card (kernels, copies, sets)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside the program"

_records: List[Dict] = []
_lock = threading.Lock()
_local = threading.local()  # .stack: the records of the open spans
_roots = itertools.count()
_OFF = contextlib.nullcontext()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: `with trace('dir') as prof: run_step()`. The
    closed spans recorded so far are dropped on entry, so `spans()`
    afterwards holds the block's (and those of a span open around it)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class _Span:
    """A recorded span: its record opens before its range and closes
    after it, so a child's record lies inside its parent's. A record
    holds its parent's record (`up`), so `clear_spans` cannot leave a
    child pointing at another span."""

    __slots__ = ("name", "record", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.record = dict(name=self.name, start_ns=time.time_ns(),
                           end_ns=None, up=up,
                           call=next(_roots) if up is None else up["call"])
        stack.append(self.record)
        with _lock:
            _records.append(self.record)
        self.range = record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.record["end_ns"] = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str):
    """`with span("plr2.<layer>.<what>"):` a recorded span while a
    profiler records, else nothing (module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spans() -> List[Dict]:
    """A copy of the recorded spans, in the order they opened."""
    with _lock:
        at = {id(r): i for i, r in enumerate(_records)}
        return [dict(name=r["name"], start_ns=r["start_ns"],
                     end_ns=r["end_ns"],
                     parent=None if r["up"] is None else at[id(r["up"])],
                     call=r["call"]) for r in _records]


def clear_spans() -> None:
    """Drop the closed spans. A span still open stays, with its open
    ancestors, so the spans that open inside it keep their parent."""
    with _lock:
        _records[:] = [r for r in _records if r["end_ns"] is None]


def idle_by_span(path: str) -> Dict[str, float]:
    """Idle seconds of the device in the Chrome trace at `path` (as
    `trace` writes it): every gap between device operations, keyed by the
    innermost `plr2.*` range open on the host at the gap's middle, or by
    "outside the program" where none is. Innermost is the shortest range
    that holds the middle: the rule by which `benchmark/trace.py` names a
    gap by its `bench.*` ranges, and the two must agree."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS and e.get("ph") == "X")
    merged: List[List[float]] = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                    for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("ph") == "X"
                    and e.get("name", "").startswith("plr2."))
    out: Dict[str, float] = {}
    active: List = []
    i = 0
    for (_, a), (b, _) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (a + b)  # the gaps' middles rise, so a sweep does
        while i < len(ranges) and ranges[i][0] <= mid:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= mid]
        name = min(active, key=lambda r: r[1] - r[0])[2] if active \
            else OUTSIDE
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out
