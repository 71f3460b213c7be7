"""Port weights as reference (PyTorch DenseFusion) checkpoints, the port of
plr2_tpu/models/torch_export.py `save_reference_checkpoint`: the inverse
of `torch_import.load_reference_checkpoint`.

The port's state dicts already are the upstream modules' (lib/network.py
names and layouts, `num_batches_tracked` included), so an export writes
them as they are: `pose_model.pth` loads into upstream's PoseNet, and
`pose_refine_model.pth` into its PoseRefineNet, with
`load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Mapping

import torch


def save_reference_checkpoint(nets: Mapping, posenet_path: str,
                              refinenet_path: str = "") -> None:
    """Write `nets["posenet"]` (and, given `refinenet_path`,
    `nets["refiner"]`) as .pth files: state dicts, as a `CheckpointManager`
    payload holds them, copied to the CPU."""
    def save(sd, path):
        torch.save({k: v.detach().to("cpu", copy=True) for k, v in sd.items()},
                   path)

    save(nets["posenet"], posenet_path)
    if refinenet_path:
        save(nets["refiner"], refinenet_path)
