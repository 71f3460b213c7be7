"""What the readers of the program's own spans share (`metrics/host_ms.py`,
`inputs_ms.py`, `adam_ms.py`): the spans that `plr2_tpu_torch.utils.
profiling` recorded in this process. The program records a span only while
a profiler records, and in a benchmark run only the traced slice runs the
program under one, so these are the traced slice's. A program that records
no spans (one older than them) gives none, and its readers None.

The readers take self time: a span's duration less that of the spans
inside it where the host waits for or drives the device (`WAITS`). A
replay's host time under the profiler is mostly the profiler's tracing of
the graph, and a copy from pageable memory waits for the work queued
before it, so neither is the host's own work."""

from __future__ import annotations

from typing import Dict, List, Optional

# the root span of each call or step
ROOTS = ("plr2.serve.call", "plr2.train.step")
# spans of the device's work, or of a wait for it, not of the host's
WAITS = ("plr2.serve.capture", "plr2.serve.replay", "plr2.serve.eager",
         "plr2.train.capture", "plr2.train.replay", "plr2.train.eager",
         "plr2.train.copy")


def program_spans() -> List[Dict]:
    from plr2_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return [] if spans is None else spans()


def _ms(s: Dict) -> float:
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def self_ms_per_root(o, names: tuple = ROOTS) -> Optional[float]:
    """The summed self time (duration less the `WAITS` spans inside) of the
    outermost spans named `names` (the root spans where not given), over
    the number of root spans that started inside the trace's window, in
    ms; None without a trace or a closed root span."""
    if o.trace is None:
        return None
    spans = program_spans()
    roots = [s for s in spans if s["parent"] is None
             and s["name"] in ROOTS and s["end_ns"] is not None]
    if not roots:
        return None
    # the traced slice's roots: those that started inside its window,
    # which ends at or after the last root's end (a span of an earlier
    # profiler session started before the window)
    start = max(s["end_ns"] for s in roots) - o.trace.window_s * 1e9
    roots = [s for s in roots if s["start_ns"] >= start]
    calls = {s["call"] for s in roots}

    def owner(s: Dict) -> Optional[Dict]:
        """The nearest enclosing span named in `names` or `WAITS`."""
        up = s["parent"]
        while up is not None and spans[up]["name"] not in names + WAITS:
            up = spans[up]["parent"]
        return None if up is None else spans[up]

    total = 0.0
    for s in spans:
        if s["call"] not in calls or s["end_ns"] is None:
            continue
        up = owner(s)
        if s["name"] in names and up is None:
            total += _ms(s)
        elif s["name"] in WAITS and up is not None and up["name"] in names:
            total -= _ms(s)
    return total / len(roots)
