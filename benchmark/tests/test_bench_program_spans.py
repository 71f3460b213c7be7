"""The readers of the program's own spans (`metrics/host_ms.py`,
`inputs_ms.py`, `adam_ms.py`) on hand-built span lists, the names that
send a metric to them, and a traced tiny run of each cell on the CPU
whose line carries the cell's span metrics."""

import types

import pytest

from benchmark import run as R
from benchmark.tests import tiny

SPAN_METRICS = {"serve.host_ms": "host_ms.py", "train.host_ms": "host_ms.py",
                "window.host_ms": "host_ms.py",
                "serve.inputs_ms": "inputs_ms.py",
                "train.inputs_ms": "inputs_ms.py",
                "window.inputs_ms": "inputs_ms.py",
                "train.adam_ms": "adam_ms.py", "window.adam_ms": "adam_ms.py"}


def _span(name, start_ms, end_ms, parent, call):
    return dict(name=name, start_ns=int(start_ms * 1e6),
                end_ns=int(end_ms * 1e6), parent=parent, call=call)


def _steps():
    """Two training steps of 10 and 6 ms. The first: inputs 1 ms holding a
    0.5 ms copy, inputs 0.5 ms (a window's two samples), a 3 ms replay,
    Adam 3 ms; the second: inputs 2 ms, Adam 1 ms. A stray inputs span
    outside any step, and a root left open, count for nothing. Self time:
    host 10 - 0.5 - 3 and 6, inputs 0.5 + 0.5 and 2."""
    return [_span("plr2.train.step", 0, 10, None, 0),
            _span("plr2.train.inputs", 0, 1, 0, 0),
            _span("plr2.train.copy", 0.2, 0.7, 1, 0),
            _span("plr2.train.inputs", 2, 2.5, 0, 0),
            _span("plr2.train.replay", 3, 6, 0, 0),
            _span("plr2.train.adam", 6, 9, 0, 0),
            _span("plr2.train.step", 20, 26, None, 1),
            _span("plr2.train.inputs", 20, 22, 6, 1),
            _span("plr2.train.adam", 24, 25, 6, 1),
            _span("plr2.train.inputs", 30, 39, None, 2),
            dict(name="plr2.train.step", start_ns=40, end_ns=None,
                 parent=None, call=3)]


def _calls():
    """Three serve calls of 4, 5 and 6 ms, inputs 1, 2 and 0 ms. The first
    replays for 2 ms; the second captures for 1 ms, with an eager span
    inside the capture (subtracted once). Host self time 2, 4 and 6 ms."""
    return [_span("plr2.serve.call", 0, 4, None, 0),
            _span("plr2.serve.inputs", 0, 1, 0, 0),
            _span("plr2.serve.replay", 1, 3, 0, 0),
            _span("plr2.serve.call", 10, 15, None, 1),
            _span("plr2.serve.inputs", 10, 12, 3, 1),
            _span("plr2.serve.capture", 12, 13, 3, 1),
            _span("plr2.serve.eager", 12.2, 12.8, 5, 1),
            _span("plr2.serve.outputs", 13, 14, 3, 1),
            _span("plr2.serve.call", 20, 26, None, 2)]


# the trace of a 1 s traced slice (the readers read its window alone)
TRACE = types.SimpleNamespace(window_s=1.0)


def _read(metric, spans, monkeypatch, trace=TRACE):
    from plr2_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in spans])
    reader = R.load_module(R.reader_path(metric), "t_" + metric)
    return reader.read(types.SimpleNamespace(trace=trace))


@pytest.mark.parametrize("metric,reader", sorted(SPAN_METRICS.items()))
def test_reader_found_by_metric_name(metric, reader):
    import os

    assert os.path.basename(R.reader_path(metric)) == reader


@pytest.mark.parametrize("metric,want", [
    ("train.host_ms", 6.25), ("train.inputs_ms", 1.5),
    ("train.adam_ms", 2.0)])
def test_train_readers_mean_over_steps(metric, want, monkeypatch):
    assert _read(metric, _steps(), monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [
    ("serve.host_ms", 4.0), ("serve.inputs_ms", 1.0),
    ("window.adam_ms", 0.0)])  # no Adam span in a serve call
def test_serve_readers_mean_over_calls(metric, want, monkeypatch):
    assert _read(metric, _calls(), monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [
    ("serve.host_ms", 4.0), ("serve.inputs_ms", 1.0)])
def test_readers_drop_spans_older_than_the_window(metric, want, monkeypatch):
    """A call of an earlier profiler session, 5 s before the traced slice
    (its spans still in the list), counts for nothing."""
    old = [_span("plr2.serve.call", -5000, -4990, None, 9),
           _span("plr2.serve.inputs", -5000, -4991, 0, 9)]
    calls = [dict(s, parent=None if s["parent"] is None else s["parent"] + 2)
             for s in _calls()]
    assert _read(metric, old + calls, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_readers_give_none_without_a_root_or_a_trace(metric, monkeypatch):
    stray = [_span("plr2.train.inputs", 0, 1, None, 0)]
    assert _read(metric, stray, monkeypatch) is None
    assert _read(metric, [], monkeypatch) is None
    assert _read(metric, _calls(), monkeypatch, trace=None) is None


def test_readers_give_none_for_a_program_without_spans(monkeypatch):
    """A program older than the spans (no `profiling.spans`): None, no
    error."""
    from plr2_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    for metric in SPAN_METRICS:
        reader = R.load_module(R.reader_path(metric), "t_old_" + metric)
        assert reader.read(types.SimpleNamespace(trace=TRACE)) is None


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_traced_tiny_run_carries_the_cells_span_metrics(cell, monkeypatch):
    """A `--trace 1` run of the tiny cell on the CPU (the profiler's CPU
    activity alone; no device synchronise): the line holds every span
    metric of the cell, positive, and the program's spans are the traced
    slice's alone."""
    import torch
    from plr2_tpu_torch.utils import profiling

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: real(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    profiling.clear_spans()
    spec = tiny.spec(cell)
    line, _ = R.execute(spec, tiny.args(seconds=0.5, trace=1),
                        device=torch.device("cpu"), check_card=False)
    want = {m["name"] for m in spec["per_layer"]} & set(SPAN_METRICS)
    assert len(want) == (2 if "serve" in cell else 3)
    for name in want:
        assert line["metrics"][name]["value"] > 0
        assert line["metrics"][name]["unit"] == "ms"
    roots = [s for s in profiling.spans() if s["parent"] is None]
    assert len(roots) == line["attempted"] > 0
    profiling.clear_spans()
