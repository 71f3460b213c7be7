"""The port's eval CLIs on the CPU, as subprocesses at a tiny size: the
train -> eval -> report chain (`tools.train`, `tools.eval_linemod
--save_distances --plot`, `tools.plot_accuracy --distances --json`),
`tools.infer --synthetic`, and `tools.eval_precision_modes` on a port
checkpoint that this test writes from the bridged
`trained_models/synthetic_e2e/best.msgpack`; then the refusals of the
flags that are not ported."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from flax.serialization import msgpack_restore

from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch.eval.report import accuracy_table, load_distance_report
from plr2_tpu_torch.tools import eval_linemod, infer, plot_accuracy
from plr2_tpu_torch.train import CheckpointManager

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZE = ["--num_points", "64", "--mesh_points", "96"]
# two threads, as every test process here
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}


def _run(module, *args):
    res = subprocess.run([sys.executable, "-m", f"plr2_tpu_torch.tools.{module}",
                          *args], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout + res.stderr


def test_train_eval_report_chain(tmp_path):
    _run("train", "--synthetic", "--cpu", "--nepoch", "1", *SIZE,
         "--outf", str(tmp_path), "--log_dir", str(tmp_path))
    dist, plot, table = (tmp_path / n for n in ("d.json", "c.png", "t.json"))
    out = _run("eval_linemod", "--synthetic", "--cpu", "--model",
               str(tmp_path / "linemod"), "--refine_iterations", "4", *SIZE,
               "--save_distances", str(dist), "--plot", str(plot))
    assert "loaded checkpoint (epoch 1)" in out
    assert "mean success rate:" in out and "4 samples" in out
    assert plot.read_bytes()[:4] == b"\x89PNG"
    per_obj, meta = load_distance_report(str(dist))
    assert sum(map(len, per_obj.values())) == 4
    assert meta["refine_iterations"] == 4 and len(meta["diameters"]) == 2
    out = _run("plot_accuracy", "--distances", str(dist), "--json", str(table))
    rows = json.loads(table.read_text())
    diameters = {int(k): v for k, v in meta["diameters"].items()}
    assert rows == accuracy_table(per_obj, diameters=diameters)
    assert rows[-1]["object"] == "all" and rows[-1]["count"] == 4
    assert "AUC" in out and "<0.1d" in out


def test_infer_synthetic():
    out = _run("infer", "--synthetic", "--cpu", "--num_points", "64")
    assert "pose quaternion (wxyz)" in out and "ADD error vs ground truth" in out


def test_eval_precision_modes_on_a_bridged_checkpoint(tmp_path):
    variables = msgpack_restore(
        (ROOT / "trained_models/synthetic_e2e/best.msgpack").read_bytes())
    pipe = DenseFusionPipeline(64, 4, device="cpu", seed=None)
    pipe.load_jax_variables(variables["variables"])
    state = SimpleNamespace(pipe=pipe, lr=1e-4, w=0.015, decay_started=True,
                            refine_started=True, best_test=0.01, epoch=3)
    CheckpointManager(str(tmp_path)).save(state, 0.01)
    out = _run("eval_precision_modes", "--ckpt", str(tmp_path), "--cpu",
               "--test_frames", "2", "--batch_size", "4", "--bootstrap", "20",
               "--num_points", "64", "--mesh_points", "96")
    lines = out.splitlines()
    assert any(line.startswith("f32") and "ADD-S AUC=" in line for line in lines)
    assert any(line.startswith("bf16") and "ADD-S AUC=" in line for line in lines)
    assert "AUC delta bf16 vs f32:" in out and "4 held-out samples/mode" in out


def test_eval_precision_modes_without_checkpoint(tmp_path, capsys):
    from plr2_tpu_torch.tools import eval_precision_modes
    assert eval_precision_modes.main(["--ckpt", str(tmp_path), "--cpu"]) == 1
    assert "no checkpoint" in capsys.readouterr().out


@pytest.mark.parametrize("call,exc,match", [
    (lambda: eval_linemod.main(["--cpu"]), SystemExit, "--dataset_root DIR"),
    (lambda: eval_linemod.main(["--synthetic", "--dataset_root", "/d", "--cpu"]),
     SystemExit, "pick one"),
    (lambda: eval_linemod.main(["--synthetic", "--segnet_results", "/s", "--cpu"]),
     SystemExit, "not of --synthetic"),
    (lambda: infer.main(["--color", "c.png", "--cpu"]), SystemExit, "--depth"),
    (lambda: plot_accuracy.main(["--mat_dir", "/m", "--dataset_root", "/d",
                                 "--synthetic"]), SystemExit, "pick one"),
], ids=["eval_real", "eval_dataset_root", "eval_segnet", "infer_real",
        "plot_ycb"])
def test_cli_refuses_unported_flags(call, exc, match):
    """What still waits for another item raises NotImplementedError naming
    it; a real-data run without its data (or with --synthetic beside it)
    exits with what to give."""
    with pytest.raises(exc, match=match):
        call()


def test_eval_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_linemod.main(["--synthetic", *SIZE])
