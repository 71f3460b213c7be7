"""The port's spans and counters (`utils/profiling.py`, `serving.py`,
`train/`), on the CPU and small:

- with no profiler recording, `span` records nothing and never enters a
  `record_function` range;
- under `torch.profiler.profile`, `FrameEstimator.run` / `run_frames` and
  the training steps (the eager `BatchTrainer._step`, the fused window's
  step, and both through an eager stand-in for the CUDA graph capture)
  give their `plr2.*` span trees: one `call` id a call, parents that hold
  their children's intervals;
- each `plr2.*` range of the exported Chrome trace starts within 1 ms of
  its record, on the shared clock (`ts` + `baseTimeNanoseconds` / 1000);
- each training step's input moves sit in `plr2.train.copy` spans
  inside its `plr2.train.inputs`, and the per-sample trainer's optimizer step
  (`TrainStep.apply`) is a `plr2.train.adam`;
- `idle_by_span` on a hand-written trace; `clear_spans` keeps an open
  span and its children's parent;
- on the card (marked `chip`, skipped here): after warm-up `captures`
  stands still and `replays` counts calls, in `FrameEstimator` and
  `GradientGraphs`. On the card: `python3 -m pytest --noconftest
  tests/test_torch_port_tracing.py -q` (the tests' conftest imports JAX,
  which the card's machine lacks).

This file imports no JAX. 80 x 80 canvases on 120 x 160 frames, 32 points,
windows and batches of 2.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch import config as t_config
from plr2_tpu_torch import serving
from plr2_tpu_torch.serving import FrameEstimator
from plr2_tpu_torch.train import BatchTrainer, graphs, make_fused_accum_step
from plr2_tpu_torch.train.graphs import GradientGraphs
from plr2_tpu_torch.utils import profiling
from plr2_tpu_torch.utils.cuda_graphs import Graph, clone

torch.set_num_threads(2)

H, W, CANVAS, N, NUM_OBJ, M, B = 120, 160, 80, 32, 3, 16, 2
SYM = (2,)
ROOTS = ("plr2.serve.call", "plr2.train.step")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured and "
                    "replayed only there")
    return torch.device("cuda")


def _pipe(device="cpu"):
    return DenseFusionPipeline(N, NUM_OBJ, device=device, seed=3)


def _frame(seed=0):
    """One frame with object 1 in view (object 2 absent): color, depth,
    label, obj_ids, model_points, intr."""
    rng = np.random.default_rng(seed)
    color = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    depth = rng.uniform(500, 900, (H, W)).astype(np.float32)
    label = np.zeros((H, W), np.int32)
    label[40:80, 50:100] = 1
    obj_ids = np.array([1, 2])
    models = (rng.normal(size=(2, M, 3)) * 0.05).astype(np.float32)
    intr = np.array([W / 2, H / 2, 572.0, 572.0, 1000.0], np.float32)
    return color, depth, label, obj_ids, models, intr


def _frames(f=2):
    parts = [_frame(s) for s in range(f)]
    return [np.stack(x) for x in zip(*parts)]


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    mp = rng.normal(size=(n, M, 3)) * 0.05
    idx = np.arange(n) % NUM_OBJ
    b = dict(img=rng.normal(size=(n, CANVAS, CANVAS, 3)),
             points=rng.normal(size=(n, N, 3)) * 0.1,
             choose=rng.integers(0, CANVAS * CANVAS // 8, size=(n, N)),
             target=mp + rng.normal(size=(n, 1, 3)) * 0.05,
             model_points=mp, idx=idx)
    out = {k: torch.from_numpy(v.astype(np.int64 if v.dtype.kind == "i"
                                        else np.float32))
           for k, v in b.items()}
    out["obj"] = tuple(int(i) for i in idx)  # host ids, as idx
    return out


def _cfg():
    return t_config.PipelineConfig(
        dataset=t_config.DatasetConfig(num_points=N, num_objects=NUM_OBJ,
                                       num_mesh_points=M, sym_list=SYM,
                                       add_noise=False, crop_size=CANVAS),
        model=t_config.ModelConfig(num_points=N, num_objects=NUM_OBJ),
        train=t_config.TrainConfig(batch_size=B, lr=1e-4, w=0.015))


def _recorded(fn, calls):
    """`fn` called `calls` times under a CPU profiler: (the spans, the
    Chrome trace's events and its baseTimeNanoseconds)."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(calls):
            fn(i)
    got = profiling.spans()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return got, trace["traceEvents"], trace["baseTimeNanoseconds"]


@pytest.fixture(autouse=True)
def _no_spans_left():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _tree(got):
    """The spans by call: {call id: [names in opening order]}, after
    checking each child against its parent: the same call, its interval
    inside the parent's, and every root one of `ROOTS`."""
    calls = {}
    for s in got:
        assert s["name"].startswith("plr2.") and s["end_ns"] is not None
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is None:
            assert s["name"] in ROOTS and s["call"] not in calls
        else:
            p = got[s["parent"]]
            assert p["call"] == s["call"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
        calls.setdefault(s["call"], []).append(s["name"])
    return calls


def _children(got, call):
    """The names of the direct children of `call`'s root."""
    root = next(i for i, s in enumerate(got)
                if s["parent"] is None and s["call"] == call)
    return [s["name"] for s in got if s["parent"] == root]


def _copies_inside_inputs(got):
    """Every `plr2.train.copy` opens inside a `plr2.train.inputs`, and
    every inputs span holds two: the batch's move and the masks'."""
    copies = [s for s in got if s["name"] == "plr2.train.copy"]
    inputs = [i for i, s in enumerate(got) if s["name"] == "plr2.train.inputs"]
    assert copies and all(got[s["parent"]]["name"] == "plr2.train.inputs"
                          for s in copies)
    assert sorted(s["parent"] for s in copies) == sorted(inputs * 2)


# ---------------- off: nothing recorded, no range entered ----------------


def test_span_records_nothing_without_a_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: entered.append(name))
    with profiling.span("plr2.test.off"):
        pass
    est = FrameEstimator(_pipe(), canvas=CANVAS, img_h=H, img_w=W,
                         refine_iterations=1)
    est.run(*_frame())
    est.run_frames(*_frames(), np.array([0, 1]))
    tr = BatchTrainer(_cfg(), pipe=_pipe(), device="cpu", graphs=False)
    tr._step(tr.stage_step(tr.init_state()), _batch(),
             torch.Generator().manual_seed(0))
    assert profiling.spans() == [] and entered == []
    assert est.captures == 0 and est.replays == 0  # a CPU pipeline: eager


# ---------------- serving ----------------


def test_serve_spans_tree_and_the_trace_clock():
    est = FrameEstimator(_pipe(), canvas=CANVAS, img_h=H, img_w=W,
                         refine_iterations=1)
    frame, frames = _frame(), _frames()

    def call(i):
        if i < 2:
            est.run(*frame, i)
        else:
            est.run_frames(*frames, np.array([0, 1]))

    got, events, base = _recorded(call, 3)
    calls = _tree(got)
    assert len(calls) == 3
    for c, names in calls.items():
        assert names == ["plr2.serve.call", "plr2.serve.inputs",
                         "plr2.serve.eager"]
    # the shared clock: each range of the trace starts within 1 ms of its
    # record (ranges and records matched by name, in order)
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e["name"].startswith("plr2.")),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == [s["name"] for s in got]
    for e, s in zip(ranges, got):
        assert abs(e["ts"] + base / 1e3 - s["start_ns"] / 1e3) < 1e3


def _serve_capture(fn, args):
    """A stand-in for `serving._capture` on the CPU: the "graph" reruns the
    program on the static inputs, writing the static outputs in place."""
    static = clone(tuple(args))
    out = fn(*static)

    class Replay:
        @staticmethod
        def replay():
            for o, n in zip(out, fn(*static)):
                o.copy_(n)
    return Graph(Replay, static, out)


def test_serve_graph_spans_and_counters_with_a_stand_in(monkeypatch):
    monkeypatch.setattr(serving, "_capture", _serve_capture)
    est = FrameEstimator(_pipe(), canvas=CANVAS, img_h=H, img_w=W,
                         refine_iterations=1)
    est.graphs = True  # the CUDA path, with the stand-in capture
    frame = _frame()
    got, _, _ = _recorded(lambda i: est.run(*frame, i), 3)
    calls = _tree(got)
    first, *rest = sorted(calls)
    assert _children(got, first) == ["plr2.serve.inputs", "plr2.serve.capture",
                                     "plr2.serve.replay", "plr2.serve.outputs"]
    for c in rest:
        assert _children(got, c) == ["plr2.serve.inputs", "plr2.serve.replay",
                                     "plr2.serve.outputs"]
    assert est.captures == 1 and est.replays == 3


# ---------------- training ----------------


def test_eager_batch_step_spans():
    tr = BatchTrainer(_cfg(), pipe=_pipe(), device="cpu", graphs=False)
    step = tr.stage_step(tr.init_state())
    gen = torch.Generator().manual_seed(0)
    got, _, _ = _recorded(lambda i: tr._step(step, _batch(i), gen), 2)
    calls = _tree(got)
    assert len(calls) == 2
    for c in calls:
        assert _children(got, c) == ["plr2.train.adam", "plr2.train.inputs",
                                     "plr2.train.eager", "plr2.train.adam"]
    _copies_inside_inputs(got)
    # the per-sample trainer's optimizer step, outside any step span
    step.accumulate(_batch(), gen)
    got, _, _ = _recorded(lambda i: step.apply(), 1)
    assert [(s["name"], s["parent"]) for s in got] == [("plr2.train.adam",
                                                         None)]


def test_fused_window_step_spans():
    step = make_fused_accum_step(_pipe(), SYM, 0.015, lr=1e-4)
    gen = torch.Generator().manual_seed(0)
    got, _, _ = _recorded(lambda i: step(_batch(i), gen), 2)
    calls = _tree(got)
    assert len(calls) == 2
    for c in calls:  # the per-sample loop: B samples, then Adam
        assert _children(got, c) == ["plr2.train.inputs",
                                     "plr2.train.eager"] * B \
            + ["plr2.train.adam"]
    _copies_inside_inputs(got)


def _train_capture(fn, args, after_warmup=None, pool=None):
    """A stand-in for `utils.cuda_graphs.capture` on the CPU: the warm-up
    runs and is undone, a replay reruns the program on the static
    inputs."""
    static = clone(tuple(args))
    out = clone(fn(*static))
    if after_warmup is not None:
        after_warmup()

    class Replay:
        @staticmethod
        def replay():
            for o, n in zip(out, fn(*static)):
                o.copy_(n)

        @staticmethod
        def pool():
            return "pool"
    return Graph(Replay, static, out)


@pytest.mark.parametrize("kind", ["batch", "window"])
def test_graphed_train_step_spans_and_counters_with_a_stand_in(kind,
                                                               monkeypatch):
    monkeypatch.setattr(graphs, "capture", _train_capture)
    gg = GradientGraphs()
    gen = torch.Generator().manual_seed(0)
    if kind == "batch":
        tr = BatchTrainer(_cfg(), pipe=_pipe(), device="cpu", graphs=False)
        tr.graphs = gg  # the card's path, on the CPU
        step = tr.stage_step(tr.init_state())
        fn = lambda i: tr._step(step, _batch(i), gen)  # noqa: E731
    else:
        fused = make_fused_accum_step(_pipe(), SYM, 0.015, lr=1e-4, graphs=gg)
        fn = lambda i: fused(_batch(i), gen)  # noqa: E731
    got, _, _ = _recorded(fn, 3)
    calls = _tree(got)
    first, *rest = sorted(calls)
    assert _children(got, first) == ["plr2.train.inputs", "plr2.train.capture",
                                     "plr2.train.replay", "plr2.train.outputs",
                                     "plr2.train.adam"]
    for c in rest:
        assert _children(got, c) == ["plr2.train.inputs", "plr2.train.replay",
                                     "plr2.train.outputs", "plr2.train.adam"]
    assert gg.captures == 1 and gg.replays == 3
    _copies_inside_inputs(got)


# ---------------- the operator's idle split ----------------


def test_idle_by_span_on_a_hand_written_trace(tmp_path):
    """Device busy 0-100, 150-200, 300-310 and 400-420 us. The gap
    100-150 (middle 125) lies in plr2.serve.inputs inside plr2.serve.call,
    200-300 (250) in the call alone, 310-400 (355) outside every plr2
    range (a bench.* range does not count)."""
    k = lambda ts, dur, cat="kernel": {"ph": "X", "cat": cat,  # noqa: E731
                                       "name": "k", "ts": ts, "dur": dur}
    r = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation",  # noqa
                               "name": name, "ts": ts, "dur": dur}
    events = [k(0, 100), k(150, 50, "gpu_memcpy"), k(300, 10),
              k(400, 20, "gpu_memset"),
              r("plr2.serve.call", 90, 230), r("plr2.serve.inputs", 110, 30),
              r("bench.call", 80, 400),
              {"ph": "X", "cat": "gpu_user_annotation",
               "name": "plr2.serve.call", "ts": 0, "dur": 500}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.idle_by_span(str(path))
    assert got == {"plr2.serve.inputs": pytest.approx(50e-6),
                   "plr2.serve.call": pytest.approx(100e-6),
                   profiling.OUTSIDE: pytest.approx(90e-6)}


def test_trace_clears_the_spans_on_entry(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("plr2.test.before"):
            pass
    assert len(profiling.spans()) == 1
    with profiling.trace(str(tmp_path)):
        with profiling.span("plr2.test.inside"):
            pass
    assert [s["name"] for s in profiling.spans()] == ["plr2.test.inside"]
    assert (tmp_path / "trace.json").exists()


def test_clear_spans_inside_an_open_span_keeps_its_parent():
    """`clear_spans` drops the closed spans; the open one stays, so a span
    opened inside it after the clear still names it as parent."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("plr2.test.outer"):
            with profiling.span("plr2.test.done"):
                pass
            profiling.clear_spans()
            with profiling.span("plr2.test.inner"):
                pass
    got = profiling.spans()
    assert [(s["name"], s["parent"]) for s in got] == [
        ("plr2.test.outer", None), ("plr2.test.inner", 0)]
    assert got[0]["call"] == got[1]["call"]


# ---------------- on the card ----------------


@pytest.mark.chip
def test_captures_stand_still_and_replays_count_on_the_card(card):
    est = FrameEstimator(_pipe(card), canvas=CANVAS, img_h=H, img_w=W,
                         refine_iterations=1)
    frame = _frame()
    est.run(*frame, 0)  # warm-up: the one capture
    assert est.captures == 1 and est.replays == 1
    for i in range(3):
        est.run(*frame, i + 1)
    assert est.captures == 1 and est.replays == 4
    gg = GradientGraphs()
    step = make_fused_accum_step(_pipe(card), SYM, 0.015, lr=1e-4, graphs=gg)
    gen = torch.Generator().manual_seed(0)
    window = {k: v.to(card) if isinstance(v, torch.Tensor) else v
              for k, v in _batch().items()}
    step(window, gen)
    assert gg.captures == 1 and gg.replays == 1
    for _ in range(3):
        step(window, gen)
    assert gg.captures == 1 and gg.replays == 4
    torch.cuda.synchronize()
    # the graphed call's span tree on the card
    got, _, _ = _recorded(lambda i: est.run(*frame, i), 2)
    for c in _tree(got):
        assert _children(got, c) == ["plr2.serve.inputs", "plr2.serve.replay",
                                     "plr2.serve.outputs"]
    assert est.captures == 1
