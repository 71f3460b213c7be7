"""The port's CLIs on the miniature LineMOD and YCB-Video layouts of
tests/test_real_loaders.py, on the CPU (the counterpart of
tests/test_cli_real_layout.py): `tools.train --dataset linemod
--dataset_root ... --workers 2 --cache_mb 16` then `tools.eval_linemod
--dataset_root --model --save_distances` as processes, `--segnet_results`
with predicted and empty masks, YCB training then `tools.serve
--dataset_root`, `tools.infer` on one fixture frame, `--noise_trans`, and
a native library that does not build."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from plr2_tpu_torch import native
from plr2_tpu_torch.tools import eval_linemod, infer, serve
from plr2_tpu_torch.tools import train as train_cli
from test_real_loaders import linemod_root, ycb_root  # noqa: F401  (fixtures)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZE = ["--num_points", "96", "--mesh_points", "128"]
# two threads, as every test process here
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}


def _run(module, *args):
    res = subprocess.run([sys.executable, "-m", f"plr2_tpu_torch.tools.{module}",
                          *args], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout + res.stderr


@pytest.fixture(scope="module")
def linemod_model(linemod_root, tmp_path_factory):
    """One epoch of `tools.train` on the LineMOD layout, as a process, fed by
    two worker threads of the native data plane and a frame cache."""
    out = tmp_path_factory.mktemp("linemod_model")
    log = _run("train", "--dataset", "linemod", "--dataset_root", linemod_root,
               "--nepoch", "1", "--cpu", *SIZE, "--batch_size", "2",
               "--workers", "2", "--cache_mb", "16", "--outf", str(out),
               "--log_dir", str(out))
    return out / "linemod", log


def test_train_cli_on_the_linemod_layout(linemod_model, linemod_root):
    ckpt, log = linemod_model
    assert sorted(os.listdir(ckpt)) == ["best.pt", "last.pt"]
    assert "epoch 1:" in log and f"{linemod_root}, 2 workers): 1 train / 1 test" in log
    line = next(x for x in log.splitlines() if "epoch 1:" in x)
    assert np.isfinite(float(line.split("loss=")[1].split()[0]))


def test_eval_cli_on_the_linemod_layout(linemod_model, linemod_root, tmp_path):
    report = tmp_path / "d.json"
    out = _run("eval_linemod", "--dataset_root", linemod_root, "--model",
               str(linemod_model[0]), "--cpu", *SIZE, "--refine_iterations", "2",
               "--save_distances", str(report))
    assert "loaded checkpoint (epoch 1)" in out and "mean success rate:" in out
    rep = json.loads(report.read_text())
    # object 01 is the layout's only object: objlist index 0
    assert list(rep["distances"]) == ["0"] and len(rep["distances"]["0"]) == 1
    assert all(np.isfinite(rep["distances"]["0"]))
    assert rep["meta"]["dataset"] == "linemod" and list(rep["meta"]["diameters"]) == ["0"]


def test_eval_cli_with_segnet_results(linemod_model, linemod_root, tmp_path):
    gt = np.asarray(Image.open(os.path.join(linemod_root, "data/01/mask/0001.png"))) > 128
    pred = gt.copy()
    pred[:, 1::3] = False
    (tmp_path / "01_label").mkdir()
    Image.fromarray(pred.astype(np.uint8) * 255).save(tmp_path / "01_label/0001_label.png")
    argv = ["--dataset_root", linemod_root, "--model", str(linemod_model[0]),
            "--cpu", *SIZE, "--refine_iterations", "1", "--segnet_results",
            str(tmp_path)]
    res, diameters = eval_linemod.run(eval_linemod.parse_args(argv))
    assert (res.num_samples, res.lost_detections) == (1, 0)
    assert np.isfinite(res.mean_distance) and list(diameters) == [0]
    # an empty predicted mask: a lost detection, skipped
    Image.fromarray(np.zeros_like(pred, np.uint8)).save(tmp_path / "01_label/0001_label.png")
    res, _ = eval_linemod.run(eval_linemod.parse_args(argv))
    assert (res.num_samples, res.lost_detections) == (0, 1)


def test_train_then_serve_on_the_ycb_layout(ycb_root, tmp_path, capsys):
    state = train_cli.main(["--dataset", "ycb", "--dataset_root", ycb_root,
                            "--nepoch", "1", "--cpu", *SIZE, "--batch_size", "2",
                            "--workers", "2", "--outf", str(tmp_path),
                            "--log_dir", str(tmp_path)])
    assert state.epoch == 1 and np.isfinite(state.best_test)
    assert sorted(os.listdir(tmp_path / "ycb")) == ["best.pt", "last.pt"]
    capsys.readouterr()
    served, totals = serve.main(["--dataset_root", ycb_root, "--cpu",
                                 "--model", str(tmp_path / "ycb"), "--num_frames",
                                 "3", "--num_points", "96", "--iters", "1",
                                 "--max_objects", "3", "--eager"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    # the test split holds one frame with the layout's two objects (label
    # ids 1 and 2), the third slot inactive
    assert served == 1 and len(lines) == 1
    objs = lines[0]["objects"]
    assert [o["obj"] for o in objs] == [1, 2, 0]
    assert [o["valid"] for o in objs] == [True, True, False]
    for o in objs[:2]:
        assert np.isfinite(o["quat"]).all() and np.isfinite(o["trans"]).all()
        assert abs(np.linalg.norm(o["quat"]) - 1) < 1e-3


def test_infer_cli_on_a_fixture_frame(ycb_root, capsys):
    base = os.path.join(ycb_root, "data/0001/000001")
    argv = ["--color", base + "-color.png", "--depth", base + "-depth.png",
            "--label", base + "-label.png", "--obj", "2", "--points",
            os.path.join(ycb_root, "models/003_cracker_box/points.xyz"),
            "--cam", "312.9869,241.3109,1066.778,1067.487,10000",
            "--cpu", "--num_points", "96", "--refine_iterations", "1"]
    est, err = infer.main(argv)
    out = capsys.readouterr().out
    assert err is None and "pose quaternion (wxyz)" in out and "ADD error" not in out
    q = est.quat[0].numpy()
    assert np.isfinite(q).all() and abs(np.linalg.norm(q) - 1) < 1e-5
    assert np.isfinite(est.trans[0].numpy()).all()
    est2, _ = infer.main(argv)  # the same frame, the same pose
    assert torch.equal(est2.quat, est.quat) and torch.equal(est2.trans, est.trans)


def test_train_cli_noise_trans_sets_the_datasets_and_the_config(linemod_root):
    """--noise_trans goes into DatasetConfig.noise_trans, which both of the
    trainer's sample iterators draw at (tests/test_torch_port_real_data.py
    holds the draws), and onto the datasets, as in JAX."""
    for argv, want in (([], 0.03), (["--noise_trans", "0.05"], 0.05),
                       (["--noise_trans", "0"], 0.0)):
        args = train_cli.parse_args(["--dataset_root", linemod_root, *SIZE, *argv])
        cfg = train_cli.build_config(args)
        assert cfg.dataset.noise_trans == want and cfg.dataset.root == linemod_root
        train_ds, test_ds = train_cli.build_datasets(args, cfg)
        assert train_ds.noise_trans == want and train_ds.add_noise
        assert not test_ds.add_noise


def test_workers_stop_with_the_native_build_error(linemod_root, tmp_path, monkeypatch):
    """No quiet fallback: a native library that does not build stops the
    run with the compiler's output."""
    bad = tmp_path / "dataplane.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build(.|\n)*error"):
        train_cli.main(["--dataset_root", linemod_root, "--nepoch", "1", "--cpu",
                        *SIZE, "--workers", "2", "--outf", str(tmp_path / "o"),
                        "--log_dir", str(tmp_path / "o")])
    assert not list((tmp_path / "o").rglob("*.pt"))  # no checkpoint written
