"""The harness finds every piece by name, keeps to the contract's shapes,
refuses a run without a card, and checks the loaded modules by whole
top-level names."""

import json
import os
import re

import pytest

from benchmark import run as R

BENCH = json.load(open(os.path.join(R.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    spec = R.load_cell(cell)
    assert spec["cell"]["name"] == cell
    driver = spec["traffic"]["driver"]
    assert os.path.exists(os.path.join(R.HERE, "traffic", driver + ".py"))
    assert spec["workload"]["dtype"] in ("float32", "bfloat16")
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        mod = R.load_module(R.reader_path(m["name"]),
                            "t_" + m["name"].replace(".", "_"))
        assert callable(mod.read)
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


@pytest.mark.parametrize("metric,reader", [
    ("serve.mfu", "mfu.py"), ("window.device_idle", "device_idle.py"),
    ("mlp_head_roofline.train", "mlp_head_roofline.py"),
    ("upconv3x3_prelu_roofline", "upconv3x3_prelu_roofline.py")])
def test_reader_found_by_metric_name(metric, reader):
    assert os.path.basename(R.reader_path(metric)) == reader
    with pytest.raises(R.Refused):
        R.reader_path("serve.no_such_metric")


def test_benchmark_json_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert json.load(open(os.path.join(R.ROOT, c["file"])))["name"] \
            == c["name"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(CELLS)
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        layers.add(m["layer"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(R.HERE, "workloads",
                                           w["name"] + ".json"))
        assert os.path.exists(os.path.join(R.HERE, "traffic",
                                           w["traffic"] + ".json"))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_cell_refused():
    with pytest.raises(R.Refused):
        R.load_cell("no.such.cell")


def test_forbidden_modules_by_whole_top_level_name():
    assert R.forbidden_modules(["plr2_tpu_torch", "plr2_tpu_torch.ops",
                                "numpy", "jaxtyping"]) == []
    assert R.forbidden_modules(["plr2_tpu.ops.knn", "plr2_tpu_torch"]) \
        == ["plr2_tpu"]
    assert R.forbidden_modules(["jax", "jaxlib.xla", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", CELLS[0], "--seed", "5", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_harness_imports_no_jax_package():
    import subprocess
    import sys

    code = ("import sys, benchmark.run, benchmark.counts, benchmark.trace, "
            "benchmark.trainloop, benchmark.reference.frame, "
            "benchmark.reference.train, benchmark.gen.frames;"
            "import benchmark.run as R; print(R.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
