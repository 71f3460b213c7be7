"""The port's checkpoints, graceful interrupt and training CLI (the
counterparts of tests/test_interrupt.py and tests/test_cli_smoke.py's
train run): `CheckpointManager` save -> restore_into is exact, tags are
independent, a stop mid-window rolls the BatchNorm statistics back and
saves `last`, BatchTrainer stops at a batch boundary, and
`python -m plr2_tpu_torch.tools.train --synthetic --cpu` writes `best` and
`last`, resumes from `last` and refuses flags that do not hold together
or name no file (the real-data flags run in
tests/test_torch_port_real_cli.py, --config and --pretrained_trunk in
tests/test_torch_port_tail_cli.py).
"""

import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from plr2_tpu_torch import DenseFusionPipeline
from plr2_tpu_torch.config import (DatasetConfig, ModelConfig, PipelineConfig,
                                   TrainConfig)
from plr2_tpu_torch.data import SyntheticPoseDataset, iterate_samples
from plr2_tpu_torch.tools import train as cli
from plr2_tpu_torch.train import BatchTrainer, CheckpointManager, Trainer
from plr2_tpu_torch.utils import GracefulInterrupt

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N, NUM_OBJ, MESH = 32, 4, 64


def tiny_config(**train):
    return PipelineConfig(
        dataset=DatasetConfig(name="synthetic", num_points=N,
                              num_objects=NUM_OBJ, num_mesh_points=MESH,
                              sym_list=(1,), add_noise=True, crop_size=120),
        model=ModelConfig(num_points=N, num_objects=NUM_OBJ),
        train=TrainConfig(**{"batch_size": 2, "refine_iterations": 2, **train}))


@pytest.fixture(scope="module")
def tiny():
    """Four samples of two frames (every crop 120 px), made once."""
    ds = SyntheticPoseDataset(num_frames=2, num_objects=2, model_points=MESH,
                              num_points=N, seed=0)
    return ds, list(iterate_samples(ds, torch.Generator().manual_seed(0), N,
                                    add_noise=True))


def trainer(kind=Trainer, samples=None, **train):
    tr = kind(tiny_config(**train), device="cpu")
    if samples is not None:
        tr._sample_iter = lambda *a, **k: iter(samples)
    return tr


# ---------------- checkpoints ----------------


def test_checkpoint_round_trip_is_exact(tmp_path):
    tr = trainer()
    state = tr.init_state()
    with torch.no_grad():
        for p in tr.pipe.posenet.parameters():
            p.add_(0.01)
        tr.pipe.posenet.cnn.model.feats.bn1.running_mean.add_(0.5)
    state.lr, state.w, state.epoch, state.best_test = 3e-5, 4.5e-3, 7, 0.0123
    state.decay_started = state.refine_started = True
    ckpt = CheckpointManager(str(tmp_path))
    path = ckpt.save(state, test_dis=0.02)
    assert path == str(tmp_path / "best.pt") and os.path.isfile(path)

    other = trainer(seed=5)
    fresh = other.init_state()
    restored = ckpt.restore_into(fresh, "best")
    for a, b in ((tr.pipe.posenet, other.pipe.posenet),
                 (tr.pipe.refiner, other.pipe.refiner)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert (restored.lr, restored.w, restored.epoch, restored.best_test,
            restored.decay_started, restored.refine_started) == (
        3e-5, 4.5e-3, 7, 0.0123, True, True)
    # Adam rebuilt, empty, for the refiner (refine_started) at the saved lr
    opt = restored.optimizer
    assert {id(p) for g in opt.param_groups for p in g["params"]} == {
        id(p) for p in other.pipe.refiner.parameters()}
    assert opt.param_groups[0]["lr"] == 3e-5 and not opt.state
    payload = ckpt.restore("best")
    assert set(payload) == {"posenet", "refiner", "meta"}
    assert set(payload["meta"]) == {"lr", "w", "decay_started",
                                    "refine_started", "best_test", "epoch"}


def test_checkpoint_tags_are_independent(tmp_path):
    tr = trainer()
    state = tr.init_state()
    ckpt = CheckpointManager(str(tmp_path))
    state.epoch = 1
    ckpt.save(state, 0.5, tag="best")
    w0 = tr.pipe.posenet.conv1_r.weight.detach().clone()
    with torch.no_grad():
        tr.pipe.posenet.conv1_r.weight.add_(1.0)
    state.epoch = 2
    ckpt.save(state, 0.7, tag="last")
    best, last = ckpt.restore("best"), ckpt.restore("last")
    assert best["meta"]["epoch"] == 1 and last["meta"]["epoch"] == 2
    assert best["meta"]["best_test"] == 0.5
    assert torch.equal(best["posenet"]["conv1_r.weight"], w0)
    assert torch.equal(last["posenet"]["conv1_r.weight"], w0 + 1.0)
    assert ckpt.restore("missing") is None
    assert ckpt.restore_into(state, "missing") is state and state.epoch == 2
    # a checkpoint file's path works as a tag (the reference's --resume_*)
    assert ckpt.restore(str(tmp_path / "best.pt"))["meta"]["epoch"] == 1
    assert sorted(os.listdir(tmp_path)) == ["best.pt", "last.pt"]


# ---------------- graceful interrupt ----------------


def test_graceful_interrupt_latches_first_signal_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulInterrupt() as stop:
        assert not stop and not stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop and stop() and stop.requested
        # a second signal aborts
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) is before


def test_graceful_interrupt_sigint_and_programmatic_request():
    with GracefulInterrupt(signals=(signal.SIGINT,)) as stop:
        os.kill(os.getpid(), signal.SIGINT)
        assert stop()
    with GracefulInterrupt() as stop:
        stop.request()
        assert stop()


def _bn(tr):
    return {k: v.clone() for k, v in tr.pipe.posenet.state_dict().items()
            if "running" in k or "num_batches" in k}


def test_stop_mid_window_rolls_back_bn_saves_last_and_restores_epoch(tiny, tmp_path):
    """Stop before the fourth sample (window 2): the first window stepped,
    the third sample's BN update is rolled back to the window's start,
    `last` is saved at epoch 0 and the epoch counter is restored."""
    _, samples = tiny
    ref = trainer(samples=samples[:2])
    ref_state = ref.init_state()
    ref.train_epoch(ref_state, None, torch.Generator().manual_seed(0))
    want_bn = _bn(ref)

    tr = trainer(samples=samples)
    state = tr.init_state()
    calls = {"n": 0}

    def stop_before_fourth():
        calls["n"] += 1
        return calls["n"] > 3

    ckpt = CheckpointManager(str(tmp_path))
    logs = []
    state = tr.fit(state, None, None, torch.Generator().manual_seed(0),
                   epochs=3, log_fn=logs.append,
                   save_last_fn=lambda s: ckpt.save(s, s.best_test, tag="last"),
                   stop_fn=stop_before_fourth)
    assert state.epoch == 0 and any("interrupt" in m for m in logs)
    got_bn = _bn(tr)
    for k, v in want_bn.items():
        assert torch.equal(got_bn[k], v), k
    opt = state.optimizer.state
    assert {int(opt[p]["step"]) for p in tr.pipe.posenet.parameters()} == {1}
    assert all(p.grad is None for p in tr.pipe.posenet.parameters())
    last = ckpt.restore("last")
    assert last["meta"]["epoch"] == 0 and ckpt.restore("best") is None
    for k, v in want_bn.items():
        assert torch.equal(last["posenet"][k], v), k


def test_fit_with_a_real_signal_stops_before_any_work(tiny):
    _, samples = tiny
    tr = trainer(samples=samples)
    state = tr.init_state()
    before = {k: v.clone() for k, v in tr.pipe.posenet.state_dict().items()}
    logs = []
    with GracefulInterrupt() as stop:
        os.kill(os.getpid(), signal.SIGTERM)
        state = tr.fit(state, None, None, epochs=5, log_fn=logs.append,
                       stop_fn=stop)
    assert state.epoch == 0 and any("interrupt" in m for m in logs)
    for k, v in tr.pipe.posenet.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_batch_trainer_stops_at_a_batch_boundary(tiny):
    """One batch of 2 runs (its step whole), then the stop: epoch 0 and
    `last` saved once."""
    _, samples = tiny
    tr = trainer(BatchTrainer, samples=samples, nepoch=3)
    state = tr.init_state()
    calls = {"n": 0}

    def stop_after_one_batch():
        calls["n"] += 1
        return calls["n"] > 1

    saved, logs = [], []
    state = tr.fit(state, None, None, epochs=3, log_fn=logs.append,
                   save_last_fn=lambda s: saved.append(s.epoch),
                   stop_fn=stop_after_one_batch)
    assert state.epoch == 0 and saved == [0]
    assert any("interrupt" in m for m in logs)
    opt = state.optimizer.state
    assert {int(opt[p]["step"]) for p in tr.pipe.posenet.parameters()} == {1}
    tracked = {int(v) for k, v in tr.pipe.posenet.state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert tracked == {1}  # one batch-2 BN update


def test_batch_trainer_pads_the_tail_batch_by_cycling(tiny):
    _, samples = tiny
    tr = trainer(BatchTrainer, samples=samples[:3], batch_size=2)
    batches = list(tr._batches(None, torch.Generator(), seed=0))
    assert len(batches) == 2
    assert torch.equal(batches[1]["img"][0], batches[1]["img"][1])
    assert torch.equal(batches[1]["points"][1], samples[2].points)


def test_trainers_refuse_what_the_port_does_not_run():
    # the mesh runs in BatchTrainer (tests/test_torch_port_parallel*.py);
    # the per-sample trainers run on one device
    for cfg in (dataclasses.replace(tiny_config(), data_parallel=2),
                dataclasses.replace(tiny_config(), model_parallel=2)):
        with pytest.raises(ValueError, match="run in BatchTrainer"):
            Trainer(cfg, device="cpu")
    # sym_slots and workers (the native data plane) are accepted
    Trainer(tiny_config(sym_slots=4), pipe=DenseFusionPipeline(8, 2, device="cpu"))
    Trainer(tiny_config(workers=2), pipe=DenseFusionPipeline(8, 2, device="cpu"))


def test_trainer_defaults_to_cuda_and_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_config())


# ---------------- the CLI ----------------

CLI = ["--synthetic", "--cpu", "--num_points", "96", "--mesh_points", "128"]


def test_cli_writes_best_and_last_then_resumes_from_last(tmp_path):
    outf, logs = tmp_path / "out", tmp_path / "logs"
    args = CLI + ["--outf", str(outf), "--log_dir", str(logs)]
    # two threads, as every test process here: the CLI process would
    # otherwise start one per core beside the other test workers
    env = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-m", "plr2_tpu_torch.tools.train",
                          "--nepoch", "2", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "epoch 2:" in res.stderr + res.stdout
    ckpt = CheckpointManager(str(outf / "linemod"))
    assert sorted(os.listdir(outf / "linemod")) == ["best.pt", "last.pt"]
    assert ckpt.restore("last")["meta"]["epoch"] == 2
    assert (logs / "train_linemod.log").is_file()
    # a second run resumes from `last` and goes on counting
    state = cli.main(["--nepoch", "1", *args])
    assert state.epoch == 3 and ckpt.restore("last")["meta"]["epoch"] == 3
    assert "auto-resumed from last checkpoint (epoch 2)" in (
        logs / "train_linemod.log").read_text()


@pytest.mark.parametrize("flags", [
    ["--config", "configs/x.yml"], ["--dataset_root", "/data"], [],
    ["--data_parallel", "2"], ["--model_parallel", "2"],
    ["--pretrained_trunk", "r18.pth"]],
    ids=["config", "dataset_root", "no_synthetic", "data_parallel",
         "model_parallel", "pretrained_trunk"])
def test_cli_refuses_unsupported_flags(flags, tmp_path):
    """--synthetic beside --dataset_root, or neither, exits (pick one); a
    mesh of 2 ranks outside torchrun exits naming it; a --config or a
    --pretrained_trunk file that is not there raises FileNotFoundError
    (their runs: tests/test_torch_port_tail_cli.py)."""
    base = [] if flags == [] else ["--synthetic"]
    if flags == [] or flags[0] == "--dataset_root":
        exc, match = SystemExit, "--dataset_root DIR .* or --synthetic: pick one"
    elif flags[0] in ("--data_parallel", "--model_parallel"):
        exc, match = SystemExit, "world size is 1: run under torchrun"
    else:
        exc, match = FileNotFoundError, "x.yml|r18.pth"
    with pytest.raises(exc, match=match):
        cli.main(base + ["--cpu", "--outf", str(tmp_path), *flags])
    assert not os.listdir(tmp_path)


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--synthetic", "--nepoch", "1", "--outf", str(tmp_path),
                  "--log_dir", str(tmp_path)])


@pytest.mark.parametrize("flags,kind", [
    ([], "Trainer"), (["--fused"], "FusedTrainer"),
    (["--batched"], "BatchTrainer"), (["--data_parallel", "1"], "BatchTrainer")],
    ids=["default", "fused", "batched", "data_parallel_1"])
def test_cli_picks_the_trainer_as_jax_does(flags, kind, tmp_path, monkeypatch):
    """tools/train.py:188-193: --data_parallel (1 included) runs the batched
    mean-gradient trainer, as --batched does."""
    from plr2_tpu_torch.train import FusedTrainer
    ran = []
    for cls in (Trainer, FusedTrainer, BatchTrainer):
        monkeypatch.setattr(cls, "fit", lambda self, state, *a, **k:
                            ran.append(type(self).__name__) or state)
    cli.main([*CLI, "--nepoch", "1", "--outf", str(tmp_path), "--log_dir",
              str(tmp_path), *flags])
    assert ran == [kind]


def test_cli_refuses_data_parallel_with_fused(tmp_path):
    with pytest.raises(SystemExit, match="pick one"):
        cli.main([*CLI, "--outf", str(tmp_path), "--data_parallel", "1",
                  "--fused"])
