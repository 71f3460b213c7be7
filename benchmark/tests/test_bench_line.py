"""The result line's form, untraced and traced, and what the per-layer
readers make of a device trace."""

import json

import pytest

from benchmark import run as R
from benchmark.tests import tiny
from benchmark.trace import Trace


def _events():
    """Two kernels and a copy on the device, 0.6 ms busy in a 1 ms window,
    with a 0.3 ms gap while the host was in bench.call."""
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name,
                               "ts": ts, "dur": dur}
    return [k("upconv_sgemm_kernel<8>", 0.0, 200.0),
            k("head_sgemm_kernel<64>", 100.0, 200.0),
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
             "ts": 600.0, "dur": 300.0},
            {"ph": "X", "cat": "user_annotation", "name": "bench.call",
             "ts": 250.0, "dur": 700.0}]


def test_untraced_line():
    line, _ = tiny.run(tiny.spec(tiny.CELLS[0]))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["platform"] == "cpu"  # never a device metric
    spec = R.load_cell(tiny.CELLS[0])
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line))


def test_trace_reading():
    t = Trace(_events(), window_s=1e-3)
    assert t.busy_s == pytest.approx(6e-4)
    assert t.kernel_time(("upconv_sgemm_kernel",)) == pytest.approx(2e-4)
    b = t.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(2e-4)
    assert b["idle_gaps"] == [["bench.call", pytest.approx(3e-4)]]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_traced_line_has_the_cells_per_layer_metrics(cell):
    spec = tiny.spec(cell)
    _, outcome = tiny.run(spec)
    outcome.trace = Trace(_events(), window_s=1e-3)
    outcome.counts["window_s"] = 1e-3
    device = {"platform": "gpu", "kind": "x", "count": 1,
              "memory_peak_bytes": 1, "busy_s": 6e-4, "window_s": 1e-3}
    line = R.result_line(spec, outcome, device, trace=True)
    assert set(line["metrics"]) == {m["name"] for m in spec["per_layer"]}
    idle = [v["value"] for k, v in line["metrics"].items()
            if k.endswith("device_idle")]
    assert idle == [pytest.approx(40.0)]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"


def test_readers_find_nothing_without_a_trace():
    spec = tiny.spec(tiny.CELLS[0])
    _, outcome = tiny.run(spec)
    line = R.result_line(spec, outcome, {}, trace=True)
    assert line["metrics"] == {} and "breakdown" not in line
