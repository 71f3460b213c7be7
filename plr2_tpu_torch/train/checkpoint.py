"""Checkpoints with the reference's best-metric gating, the port of
plr2_tpu/train/checkpoint.py.

One `torch.save` file per tag, `<directory>/<tag>.pt`, holding:
  * "posenet", "refiner": the upstream-named state dicts of both networks
    (the port's native format, `models/weights.py`), on the CPU;
  * "meta": lr, w, decay_started, refine_started, best_test, epoch.
Adam's moments are not saved: `restore_into` builds a fresh Adam for the
restored stage's network, as the JAX package does and as the reference
builds a new optimizer at every stage switch and resume. A save writes a
temporary file and renames it over the tag, so an interrupted save leaves
the previous checkpoint whole.

The two packages' checkpoints are not interchangeable: the JAX package
writes Orbax directories and flax-serialised files of flax variable trees,
which this package never reads. `models/weights.py` is the bridge: it
turns flax variables (nested dicts of numpy arrays) into these state
dicts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from plr2_tpu_torch.parallel.data_parallel import adam

META_KEYS = ("lr", "w", "decay_started", "refine_started", "best_test", "epoch")


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


class CheckpointManager:
    """Saves both networks + the curriculum scalars of a `TrainState`
    under a tag ("best" on a better test distance, "last" every epoch)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, tag: str) -> str:
        """`tag` may also be a checkpoint file's path (the reference's
        --resume_posenet takes a path)."""
        if os.path.isfile(tag):
            return tag
        return os.path.join(self.directory, f"{tag}.pt")

    def save(self, state, test_dis: float, tag: str = "best") -> str:
        payload = {
            "posenet": _cpu_state(state.pipe.posenet),
            "refiner": _cpu_state(state.pipe.refiner),
            "meta": {"lr": float(state.lr), "w": float(state.w),
                     "decay_started": bool(state.decay_started),
                     "refine_started": bool(state.refine_started),
                     "best_test": float(min(state.best_test, test_dis)),
                     "epoch": int(state.epoch)},
        }
        path = self.path(tag)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, tag: str = "best") -> Optional[Dict[str, Any]]:
        path = self.path(tag)
        if not os.path.isfile(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore_into(self, state, tag: str = "best"):
        """Resume: load both networks and the curriculum scalars into
        `state` and rebuild Adam for the restored stage's network. Returns
        `state` unchanged when the tag has no checkpoint."""
        payload = self.restore(tag)
        if payload is None:
            return state
        state.pipe.posenet.load_state_dict(payload["posenet"], strict=True)
        state.pipe.refiner.load_state_dict(payload["refiner"], strict=True)
        meta = payload["meta"]
        state.lr, state.w = float(meta["lr"]), float(meta["w"])
        state.decay_started = bool(meta["decay_started"])
        state.refine_started = bool(meta["refine_started"])
        state.best_test = float(meta["best_test"])
        state.epoch = int(meta["epoch"])
        net = state.pipe.refiner if state.refine_started else state.pipe.posenet
        state.optimizer = adam(net, state.lr)
        return state
