"""Reference (PyTorch DenseFusion) weights into the port: the port of
plr2_tpu/models/torch_import.py.

The port's networks already carry the upstream module tree's names and
layouts (lib/network.py: `cnn.model.feats...`, `feat.conv1...`,
`conv1_r...`; `models/weights.py`), so nothing here transforms a layout:

- `load_reference_checkpoint` reads upstream `pose_model*.pth` /
  `pose_refine_model*.pth` state dicts into a `DenseFusionPipeline`. Keys
  lose their `module.` path segments (upstream wraps modules in
  DataParallel); BatchNorm's `num_batches_tracked` may be present or
  absent (the JAX package's export writes none); every other tensor must
  match by name and shape, and then loads with `load_state_dict(strict=
  True)`. A source key the network does not hold, or a network tensor the
  source lacks, raises ValueError naming the first 10.
- `import_torchvision_resnet18` / `load_pretrained_trunk` copy a
  torchvision `resnet18` state dict into PoseNet's deep-stem dilated
  ResNet-18 trunk (`pipe.posenet.cnn.model.feats`), a partial load by
  design with the JAX package's rules (its docstring there): the stem and
  layer1 block 0's first conv, whose shapes differ, keep their
  initialisation; `fc.*` and `num_batches_tracked` are skipped; a
  BatchNorm (parameters and running statistics) imports only where the
  conv it normalises imported. The imported and skipped source keys come
  back in the JAX package's order: convs (and the keys no layer takes) as
  they come, then the BatchNorms.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _strip_module(key: str) -> str:
    return ".".join(p for p in key.split(".") if p != "module")


def _load_reference(net: nn.Module, state_dict: Mapping[str, torch.Tensor],
                    what: str) -> None:
    own = net.state_dict()
    src = {_strip_module(k): v for k, v in state_dict.items()}
    unmatched = [k for k in src if k not in own]
    if unmatched:
        raise ValueError(f"unmatched {what} keys: {unmatched[:10]}"
                         f"{'...' if len(unmatched) > 10 else ''}")
    missing = [k for k in own if k not in src
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"{what} keys missing from the checkpoint: "
                         f"{missing[:10]}{'...' if len(missing) > 10 else ''}")
    for k, v in src.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(own[k].shape)} "
                             f"vs {tuple(v.shape)}")
    # a counter the checkpoint lacks keeps the network's value
    net.load_state_dict({**{k: v for k, v in own.items()
                            if k.endswith("num_batches_tracked")}, **src},
                        strict=True)


def load_reference_checkpoint(posenet_path: str, pipe,
                              refinenet_path: str = ""):
    """Load upstream .pth file(s) into `pipe` (a `DenseFusionPipeline`);
    returns `pipe`."""
    _load_reference(pipe.posenet, torch.load(posenet_path, map_location="cpu",
                                             weights_only=True), "PoseNet")
    if refinenet_path:
        _load_reference(pipe.refiner,
                        torch.load(refinenet_path, map_location="cpu",
                                   weights_only=True), "RefineNet")
    return pipe


def _kind(parts: List[str]) -> Optional[str]:
    """"conv", "bn" or None for a torchvision ResNet key (the JAX
    package's `_map_resnet_key` classification)."""
    head = parts[0]
    if head in ("conv1", "conv2", "conv3"):
        return "conv"
    if head in ("bn1", "bn2", "bn3"):
        return "bn"
    if head.startswith("layer") and len(parts) > 3:
        sub = parts[2]
        if sub == "downsample" and len(parts) > 4:
            return "conv" if parts[3] == "0" else "bn"
        if sub in ("conv1", "conv2"):
            return "conv"
        if sub in ("bn1", "bn2"):
            return "bn"
    return None


def _bn_partner(prefix: str) -> str:
    """The conv a BatchNorm normalises: bnX -> convX, downsample.1 ->
    downsample.0 (same prefix)."""
    *head, last = prefix.split(".")
    return ".".join(head + ["0" if last == "1" else "conv" + last[2:]])


@torch.no_grad()
def import_torchvision_resnet18(state_dict: Mapping[str, torch.Tensor],
                                trunk: nn.Module) -> Tuple[List[str], List[str]]:
    """Partial load of a torchvision `resnet18` state dict into `trunk` (a
    `models.resnet.DilatedResNet18`), in place (module docstring). Returns
    (imported source keys, skipped source keys)."""
    own = trunk.state_dict()
    imported: List[str] = []
    skipped: List[str] = []
    conv_ok = set()
    bn_items = []
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked") or key.startswith("fc."):
            skipped.append(key)
            continue
        kind = _kind(key.split("."))
        if kind == "bn":
            bn_items.append((key, val))
            continue
        ok = (kind == "conv" and key in own
              and tuple(own[key].shape) == tuple(val.shape))
        if ok:
            own[key].copy_(val)
            conv_ok.add(key.rsplit(".", 1)[0])
        (imported if ok else skipped).append(key)
    for key, val in bn_items:
        prefix, leaf = key.rsplit(".", 1)
        ok = (_bn_partner(prefix) in conv_ok and leaf in _BN_LEAVES
              and key in own and tuple(own[key].shape) == tuple(val.shape))
        if ok:
            own[key].copy_(val)
        (imported if ok else skipped).append(key)
    return imported, skipped


def load_pretrained_trunk(path: str, pipe) -> Tuple[List[str], List[str]]:
    """Load a torchvision resnet18 .pth (a bare state dict, or a saved
    module, as the JAX package accepts: the file is unpickled, so it must
    be one the user trusts) into `pipe`'s PoseNet trunk (tools/train.py
    --pretrained_trunk). Returns (imported, skipped) source keys."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return import_torchvision_resnet18(sd, pipe.posenet.cnn.model.feats)
