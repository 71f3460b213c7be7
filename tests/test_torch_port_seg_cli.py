"""The segmentation and full-pipeline CLIs of the port on the CPU at a tiny
size (the counterparts of tools/train_segmentation.py,
tools/segment_linemod.py, tools/eval_ycb.py, tools/serve.py --seg_arch and
tools/journey_config5.py): `tools.train_segmentation --synthetic` as a
process (best / last checkpoints, a stop at a batch boundary), then
`tools.segment_linemod` on the LineMOD layout of tests/test_real_loaders.py
and `tools.eval_linemod --segnet_results` on its masks; `tools.eval_ycb`
per sample and with --full_pipeline / --save_mat / --device_pipeline /
--posecnn_results, its `.mat` dump read back by `tools.plot_accuracy
--mat_dir --synthetic` (the same table as in the process) and, on the YCB
layout, `--mat_dir --dataset_root`; `tools.serve --seg_arch` with both
segmenters, a trained one and seg_scale 2; and the config-5 journey at the
shrunk scale of tests/test_journey_config5.py."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio
import torch
from PIL import Image

from plr2_tpu_torch.eval.report import accuracy_table, distances_from_mat_dir
from plr2_tpu_torch.tools import (eval_ycb, journey_config5, plot_accuracy,
                                  serve, train_segmentation)
from test_real_loaders import linemod_root, ycb_root  # noqa: F401  (fixtures)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZE = ["--num_points", "64", "--mesh_points", "96"]
# two threads, as every test process here
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}


def _run(module, *args):
    res = subprocess.run([sys.executable, "-m", f"plr2_tpu_torch.tools.{module}",
                          *args], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout + res.stderr


@pytest.fixture(scope="module")
def seg_models(tmp_path_factory):
    """One epoch of `tools.train_segmentation --synthetic` as a process for
    each segmenter: a 14-class SegNet (LineMOD's classes) and a 22-class
    PSPNet segmenter (YCB's), at 64 px crops."""
    out = tmp_path_factory.mktemp("seg")
    logs = {}
    for arch, classes in (("segnet", 14), ("pspnet", 22)):
        logs[arch] = _run(
            "train_segmentation", "--synthetic", "--nepoch", "1", "--cpu",
            "--arch", arch, "--num_classes", str(classes), "--crop", "64",
            "--save_path", str(out / arch), "--logs_path", str(out / arch))
    return out, logs


def test_train_segmentation_writes_best_and_last(seg_models):
    out, logs = seg_models
    for arch in ("segnet", "pspnet"):
        assert sorted(os.listdir(out / arch)) == ["best.pt", "last.pt", "train.log"]
        line = next(x for x in logs[arch].splitlines() if "epoch 1:" in x)
        assert np.isfinite(float(line.split("loss=")[1].split()[0]))
        state = torch.load(out / arch / "best.pt", weights_only=True)
        assert all(v.device.type == "cpu" for v in state.values())
    assert "classifier.weight" in torch.load(out / "segnet" / "best.pt",
                                             weights_only=True)


def test_train_segmentation_stops_at_a_batch_boundary(tmp_path, monkeypatch):
    """A stop request inside the first epoch: 'last' saved, no 'best'."""
    from plr2_tpu_torch.utils import interrupt

    class Requested(interrupt.GracefulInterrupt):
        def __call__(self):
            return True
    monkeypatch.setattr(interrupt, "GracefulInterrupt", Requested)
    state = train_segmentation.main([
        "--synthetic", "--nepoch", "3", "--cpu", "--crop", "32",
        "--num_classes", "4", "--save_path", str(tmp_path),
        "--logs_path", str(tmp_path)])
    assert state["interrupted"]
    assert sorted(os.listdir(tmp_path)) == ["last.pt", "train.log"]
    assert "at a batch boundary ('last' saved)" in (tmp_path / "train.log").read_text()


def test_segment_linemod_then_eval_with_its_masks(seg_models, linemod_root,
                                                  tmp_path):
    out, _ = seg_models
    masks = tmp_path / "segnet_results"
    log = _run("segment_linemod", "--dataset_root", linemod_root, "--model",
               str(out / "segnet" / "best.pt"), "--out", str(masks), "--cpu")
    assert f"wrote 1 predicted masks under {masks}" in log
    png = np.asarray(Image.open(masks / "01_label" / "0001_label.png"))
    assert png.shape == (480, 640) and set(np.unique(png)) <= {0, 255}
    log = _run("eval_linemod", "--dataset_root", linemod_root,
               "--segnet_results", str(masks), "--cpu", *SIZE,
               "--refine_iterations", "1")
    assert "mean success rate:" in log


def test_eval_ycb_full_pipeline_and_mat_dump(tmp_path, capsys):
    """--save_mat implies --full_pipeline; the dump re-read by
    plot_accuracy gives the table of the in-process distances."""
    mats = tmp_path / "mat"
    res = eval_ycb.main(["--synthetic", "--cpu", *SIZE, "--save_mat", str(mats),
                         "--save_distances", str(tmp_path / "d.json")])
    out = capsys.readouterr().out
    assert "ADD-S AUC (<0.1 m):" in out and "(6 objects / 2 frames)" in out
    assert sorted(os.listdir(mats)) == ["000000.mat", "000001.mat"]
    poses = sio.loadmat(mats / "000000.mat")["poses"]
    assert poses.shape == (3, 7)
    rows = plot_accuracy.main(["--mat_dir", str(mats), "--synthetic",
                               "--json", str(tmp_path / "t.json")])
    want = accuracy_table(res.per_object_distances)
    assert [r["object"] for r in rows] == [r["object"] for r in want]
    for r, w in zip(rows, want):
        for k in ("count", "auc", "under_2cm"):
            assert abs(r[k] - w[k]) <= 1e-6, (k, r, w)
    assert json.loads((tmp_path / "t.json").read_text()) == rows
    dev = eval_ycb.main(["--synthetic", "--cpu", *SIZE, "--device_pipeline"])
    assert dev.num_objects == res.num_objects and dev.num_frames == 2
    for o, d in res.per_object_distances.items():
        np.testing.assert_allclose(dev.per_object_distances[o], d, atol=1e-5)


def test_eval_ycb_per_sample_and_posecnn(tmp_path, capsys):
    res = eval_ycb.main(["--synthetic", "--cpu", *SIZE, "--batch_size", "3"])
    assert res.num_samples == 6 and "object  0: AUC" in capsys.readouterr().out
    from plr2_tpu_torch.data import SyntheticPoseDataset
    ds = SyntheticPoseDataset(num_frames=2, num_objects=3, model_points=96,
                              num_points=64, seed=7)
    d = tmp_path / "posecnn"
    d.mkdir()
    for fi, fr in enumerate(ds.frames):
        rois = []
        for o in sorted(fr.poses)[1:]:  # the first object is never detected
            ys, xs = np.nonzero(fr.label == o)
            rois.append([0, o, xs.min() - 1, ys.min() - 1, xs.max() + 2,
                         ys.max() + 2])
        sio.savemat(d / f"{fi:06d}.mat", {"labels": fr.label.astype(np.int32),
                                          "rois": np.asarray(rois, np.float32)})
    res = eval_ycb.main(["--synthetic", "--cpu", *SIZE, "--posecnn_results",
                         str(d)])
    assert res.lost_detections == 2 and res.num_objects == 6
    assert "lost detections (scored as failures): 2" in capsys.readouterr().out


def test_plot_accuracy_on_the_ycb_layout(ycb_root, tmp_path, capsys):
    mats = tmp_path / "mat"
    res = eval_ycb.main(["--dataset_root", ycb_root, "--cpu", *SIZE,
                         "--save_mat", str(mats)])
    assert res.num_frames > 0
    rows = plot_accuracy.main(["--mat_dir", str(mats), "--dataset_root", ycb_root])
    from plr2_tpu_torch.config import get_preset
    from plr2_tpu_torch.data import YCBDataset
    from plr2_tpu_torch.eval.full_pipeline import ycb_frames_and_models
    cfg = get_preset("ycb_refine")
    frames, models = ycb_frames_and_models(YCBDataset(
        ycb_root, "test", cfg.model.num_points, cfg.dataset.num_mesh_points,
        add_noise=False))
    want = accuracy_table(distances_from_mat_dir(str(mats), frames, models,
                                                 cfg.dataset.sym_list))
    assert rows == want and rows[-1]["count"] == res.num_objects


@pytest.mark.parametrize("arch,extra", [
    ("pspnet", ["--seg_scale", "2"]), ("segnet", []), ("pspnet", "trained")],
    ids=["pspnet_s2", "segnet", "pspnet_trained"])
def test_serve_with_a_segmenter(arch, extra, seg_models, capsys):
    if extra == "trained":
        extra = ["--seg_model", str(seg_models[0] / "pspnet" / "best.pt")]
    served, totals = serve.main(["--synthetic", "--cpu", "--num_frames", "2",
                                 "--num_points", "64", "--iters", "1",
                                 "--max_objects", "2", "--canvas", "120",
                                 "--seg_arch", arch, *extra])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert served == 2 and [x["frame"] for x in lines] == [0, 1]
    assert all(len(x["objects"]) == 2 for x in lines)


def test_serve_refuses_a_model_without_arch():
    with pytest.raises(SystemExit, match="--seg_arch"):
        serve.main(["--synthetic", "--cpu", "--seg_model", "seg.pt"])


def test_cli_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: eval_ycb.main(["--synthetic", *SIZE]),
                 lambda: train_segmentation.main([
                     "--synthetic", "--nepoch", "1", "--logs_path", str(tmp_path),
                     "--save_path", str(tmp_path)]),
                 lambda: serve.main(["--synthetic", "--seg_arch", "segnet"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(SystemExit, match="pick one"):
        eval_ycb.main(["--cpu"])


def test_journey_config5_shrunk_scale(tmp_path, capsys):
    """The config-5 chain at the shrunk scale: both curriculum switches,
    SegNet, the predicted-mask full pipeline with refinement, the .mat
    export and the offline report. It pins the chain, not the accuracy
    (4 Adam steps of a seeded SegNet)."""
    outf = tmp_path / "journey"
    summary = journey_config5.main([
        "--objects", "3", "--sym", "2", "--train_frames", "6",
        "--test_frames", "2", "--per_frame", "2", "--num_points", "96",
        "--model_points", "128", "--batch", "4", "--epochs", "2",
        "--seg_epochs", "2", "--refine_iterations", "2",
        "--force_switches", "--cpu", "--outf", str(outf)])
    out = capsys.readouterr().out
    assert summary["decay_started"] and summary["refine_started"]
    assert summary["epochs"] == 2
    assert summary["num_objects_scored"] == 2 * 2
    assert 0.0 <= summary["auc"] <= 100.0
    assert 0.0 <= summary["segnet_pixel_acc"] <= 1.0
    assert {"best.pt", "last.pt", "segnet.pt"} <= set(os.listdir(outf))
    assert sorted(os.listdir(outf / "mat")) == ["000000.mat", "000001.mat"]
    report = json.loads((outf / "distance_report.json").read_text())
    assert report["meta"]["lost_detections"] == summary["lost_detections"]
    assert (outf / "journey_summary.json").exists()
    assert "AUC" in out and "JOURNEY " in out
