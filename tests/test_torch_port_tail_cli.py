"""The tail's entry points on the CPU at tiny sizes: `tools.train --config
--pretrained_trunk`, `tools.export_torch`, `tools.overfit_synthetic`,
`tools.train_synthetic_e2e` and `tools.soak_run` (one kill / resume
cycle, and the two faults of the JAX script that the port does not
copy); each CLI's flags against its JAX twin under `tools/`.
"""

import ast
import dataclasses
import os
import re
import sys
import time
from pathlib import Path

import pytest
import torch

from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch.config import get_preset
from plr2_tpu_torch.config_io import load_config, save_config
from plr2_tpu_torch.models.torch_import import load_reference_checkpoint
from plr2_tpu_torch.tools import (export_torch, overfit_synthetic, soak_run,
                                  train as train_cli, train_synthetic_e2e)
from plr2_tpu_torch.train import CheckpointManager, Trainer
from test_torch_port_tail import TRUNK_COUNTS, fake_torchvision_resnet18_sd

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N = 32  # sampled points and mesh points of every run here


def flags(path):
    """The option strings of every add_argument call in `path`."""
    out = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value)
    return out


@pytest.mark.parametrize("name", ["train", "export_torch", "overfit_synthetic",
                                  "train_synthetic_e2e", "soak_run"])
def test_cli_flags_equal_the_jax_twins(name):
    """Every flag of tools/<name>.py, and only those; the soak twin adds
    --resume (the override of its stale-state check)."""
    extra = {"--resume"} if name == "soak_run" else set()
    assert flags(ROOT / "plr2_tpu_torch" / "tools" / f"{name}.py") == (
        flags(ROOT / "tools" / f"{name}.py") | extra)


# ---------------- train --config --pretrained_trunk, then export ----------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of `tools.train --config <yml> --synthetic
    --pretrained_trunk <pth>`: (tmp dir, YAML's config, source state dict,
    what the trainer held when fit started, the returned state)."""
    tmp = tmp_path_factory.mktemp("tail_cli")
    cfg = get_preset("linemod_train")
    cfg = dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset, root="datasets/none"),
        train=dataclasses.replace(cfg.train, nepoch=1, batch_size=2, lr=3e-4))
    save_config(cfg, str(tmp / "run.yml"))
    sd = fake_torchvision_resnet18_sd(seed=4)
    torch.save(sd, tmp / "resnet18.pth")
    seen = {}
    fit = Trainer.fit

    def recording_fit(self, state, *a, **k):
        feats = self.pipe.posenet.cnn.model.feats
        seen.update(cfg=self.cfg, layer2=feats.layer2[0].conv1.weight.clone(),
                    bn=feats.layer4[1].bn2.running_var.clone(),
                    stem=feats.conv1.weight.clone())
        return fit(self, state, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "fit", recording_fit)
        state = train_cli.main([
            "--config", str(tmp / "run.yml"), "--synthetic",
            "--pretrained_trunk", str(tmp / "resnet18.pth"),
            "--synthetic_frames", "2", "--num_points", str(N),
            "--mesh_points", str(N), "--nepoch", "9", "--lr", "1.0",
            "--cpu", "--outf", str(tmp / "out"), "--log_dir", str(tmp / "logs")])
    return tmp, cfg, sd, seen, state


def test_train_config_is_authoritative_and_loads_the_trunk_first(trained):
    tmp, cfg, sd, seen, state = trained
    # the YAML's train section (nepoch 1, lr 3e-4) over the flags; the
    # size flags still override; --synthetic over the YAML's root
    assert load_config(str(tmp / "run.yml")) == cfg
    assert seen["cfg"].train == cfg.train and state.epoch == 1
    assert seen["cfg"].model.num_points == N and seen["cfg"].dataset.num_mesh_points == N
    assert sorted(os.listdir(tmp / "out" / "linemod")) == ["best.pt", "last.pt"]
    # the trunk held the source's tensors when training began; the stem its init
    assert torch.equal(seen["layer2"], sd["layer2.0.conv1.weight"])
    assert torch.equal(seen["bn"], sd["layer4.1.bn2.running_var"])
    init = DenseFusionPipeline(N, cfg.model.num_objects, device="cpu", seed=0)
    assert torch.equal(seen["stem"], init.posenet.cnn.model.feats.conv1.weight)
    log = (tmp / "logs" / "train_linemod.log").read_text()
    assert (f"{TRUNK_COUNTS[0]} tensors imported, {TRUNK_COUNTS[1]} without a "
            "deep-stem counterpart kept at init") in log


def test_export_then_reference_load_gives_a_bit_equal_estimate(trained, capsys):
    tmp, cfg, _, _, state = trained
    paths = export_torch.main(["--checkpoint", str(tmp / "out" / "linemod"),
                               "--out_dir", str(tmp / "exported"),
                               "--reference_names"])
    meta = CheckpointManager(str(tmp / "out" / "linemod")).restore("best")["meta"]
    stem = f"_{meta['epoch']}_{meta['best_test']:.6f}.pth"
    assert [Path(p).name for p in paths] == ["pose_model" + stem, "pose_refine_model" + stem]
    assert "wrote" in capsys.readouterr().out
    # a saved tag's path works as --checkpoint too
    again = export_torch.main(["--checkpoint", str(tmp / "out" / "linemod" / "best.pt"),
                               "--out_dir", str(tmp / "again"), "--no_refiner"])
    assert [Path(p).name for p in again] == ["pose_model.pth"]

    num_obj = cfg.model.num_objects
    ref = DenseFusionPipeline(N, num_obj, device="cpu", seed=1)
    payload = CheckpointManager(str(tmp / "out" / "linemod")).restore("best")
    ref.posenet.load_state_dict(payload["posenet"])
    ref.refiner.load_state_dict(payload["refiner"])
    pipe = load_reference_checkpoint(paths[0], DenseFusionPipeline(
        N, num_obj, device="cpu", seed=2), paths[1])
    g = torch.Generator().manual_seed(0)
    inputs = (torch.randn((2, 48, 48, 3), generator=g),
              torch.randn((2, N, 3), generator=g) * 0.1,
              torch.randint(0, 48 * 48, (2, N), generator=g), torch.tensor([0, 5]))
    want, got = ref.estimate(*inputs), pipe.estimate(*inputs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_refuses_a_missing_trunk_file_before_writing(tmp_path):
    with pytest.raises(FileNotFoundError, match="--pretrained_trunk"):
        train_cli.main(["--synthetic", "--cpu", "--pretrained_trunk",
                        str(tmp_path / "none.pth"), "--outf", str(tmp_path / "out"),
                        "--log_dir", str(tmp_path / "logs")])
    assert not os.listdir(tmp_path)


# ---------------- overfit and end-to-end tools ----------------


def test_overfit_synthetic_tiny(capsys):
    out = overfit_synthetic.main(["--steps", "2", "--batch", "2", "--num_points",
                                  str(N), "--cpu"])
    steps = [s for s, _, _ in out["history"]]
    assert steps == [0, 1]
    assert all(torch.isfinite(torch.tensor([l, d])).all() for _, l, d in out["history"])
    assert out["history"][-1][2] < out["history"][0][2]
    assert re.search(r"2 steps in [0-9.]+s \([0-9.]+ samples/s\)", capsys.readouterr().out)


def test_train_synthetic_e2e_tiny_through_a_curriculum_switch(tmp_path, capsys):
    """Margins that fire both switches at the first evaluation: the second
    step runs the rebuilt refine-stage step; `best` saved; FINAL line."""
    res = train_synthetic_e2e.main([
        "--steps", "2", "--batch", "2", "--num_points", str(N), "--train_frames",
        "2", "--test_frames", "1", "--eval_every", "1", "--decay_margin", "10",
        "--refine_margin", "10", "--cpu", "--outf", str(tmp_path)])
    text = capsys.readouterr().out
    assert "2 batches of 2" in text
    assert "curriculum switch: lr=3e-05 w=0.0045 refine=True" in text
    assert re.search(r"FINAL: ADD-S AUC=[0-9.]+  <2cm=[0-9.]+%", text)
    assert res.num_samples == 2 and 0.0 <= res.auc <= 100.0
    assert CheckpointManager(str(tmp_path)).restore("best")["meta"]["refine_started"]


# ---------------- the soak orchestrator ----------------


def test_soak_kill_resume_horizon(tmp_path, monkeypatch):
    """tests/test_soak_run.py's contract on the port's trainer, one cycle
    at 2 frames and a 2-epoch horizon: a graceful stop on SIGTERM after
    epoch 1, an unattended auto-resume, the horizon reached."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    outf, logd = tmp_path / "soak", tmp_path / "logs"
    summary = soak_run.main([
        "--synthetic_frames", "2", "--nepoch", "2", "--kill_epochs", "1",
        "--num_points", str(N), "--mesh_points", str(N), "--mode", "persample",
        "--poll_s", "0.2", "--cpu", "--outf", str(outf), "--log_dir", str(logd),
        "--extra", "--batch_size", "2"])
    assert [leg["kill_epoch"] for leg in summary["legs"]] == [1, None]
    leg0, leg1 = summary["legs"]
    assert leg0["graceful_stop"] and leg0["epochs_logged"][1] >= 1
    assert leg1["resumed_from"] is not None and leg1["resumed_from"] >= 1
    assert leg1["epochs_logged"][1] >= 2
    assert leg1["epochs_logged"][0] <= leg0["epochs_logged"][1] + 1
    assert "plr2_tpu_torch.tools.train" in summary["recipe"]
    assert (outf / "soak_summary.json").is_file()
    assert (logd / "soak_leg0.log").is_file() and (logd / "soak_leg1.log").is_file()


def test_soak_refuses_a_stale_last_checkpoint(tmp_path):
    """A `last` left by an earlier run would make leg 0 resume past its
    kill epoch: the run stops before launching anything, unless --resume."""
    (tmp_path / "soak" / "linemod").mkdir(parents=True)
    (tmp_path / "soak" / "linemod" / "last.pt").write_bytes(b"")
    with pytest.raises(SystemExit, match="last.pt exists.*--resume"):
        soak_run.main(["--cpu", "--outf", str(tmp_path / "soak"),
                       "--log_dir", str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()


@pytest.mark.parametrize("logged,match", [
    (2, "logged epoch 2 but exited before the SIGTERM reached it"),
    (1, "finished before epoch 2 was ever logged")],
    ids=["logged_then_exited", "never_logged"])
def test_soak_leg_tells_a_fast_exit_from_a_missing_epoch(logged, match, tmp_path):
    """A trainer that logs the kill epoch and exits within one poll is not
    reported as "never logged" (the capture is read again after the exit)."""
    cmd = [sys.executable, "-c", f"print('epoch {logged}: loss=0')"]
    with pytest.raises(SystemExit, match=match) as err:
        soak_run.run_leg(cmd, str(tmp_path / "leg.log"), 2, 60, 0.5)
    if logged == 2:
        assert "never logged" not in str(err.value)


def test_soak_leg_past_its_timeout_is_killed_and_reaped(tmp_path):
    cmd = [sys.executable, "-c", "import time; time.sleep(60)"]
    t0 = time.time()
    with pytest.raises(SystemExit, match="timed out after 1s"):
        soak_run.run_leg(cmd, str(tmp_path / "leg.log"), None, 1, 0.1)
    assert time.time() - t0 < 30
