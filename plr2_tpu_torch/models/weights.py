"""Weights for the port's modules: conversion from the JAX package's
variables, and seeded random initialisation.

`posenet_state_dict` / `refinenet_state_dict` are this package's own copy
of the conversion in plr2_tpu/models/torch_export.py: they take the flax
variables as nested dicts of numpy arrays ({"params": ..., "batch_stats":
...}) and return upstream-named state dicts (`cnn.model.feats...`,
`feat.conv1...`, `conv1_r...`) that load into PoseNet / PoseRefineNet with
`load_state_dict(strict=True)`. `segmenter_state_dict` does the same for
the two segmenters of `models/segnet.py`: SegNet (`enc{b}_{c}` /
`dec{b}_{c}` blocks of a conv and a BatchNorm, `classifier`) and the
PSPNet segmenter (the colour encoder's names without the `cnn.model.`
prefix). Layouts: HWIO -> OIHW (Conv2d), Dense (in, out) -> Conv1d (out,
in, 1) / Linear (out, in).

`init_random_` fills every parameter and buffer of a module from an
explicit `torch.Generator` (LeCun-normal weights, small random biases,
random BatchNorm statistics), generated on the CPU and copied, so a CPU
run and a CUDA run with one seed hold the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _conv2d(k) -> torch.Tensor:  # HWIO -> OIHW
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _conv1d(k) -> torch.Tensor:  # Dense (in, out) -> (out, in, 1)
    return _t(np.asarray(k).T[..., None])


def _linear(k) -> torch.Tensor:  # Dense (in, out) -> (out, in)
    return _t(np.asarray(k).T)


def _bn(prefix: str, params: Mapping, stats: Mapping, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _feats(fe: Mapping, se: Mapping, out: StateDict, pre: str) -> None:
    for i in (1, 2, 3):
        out[f"{pre}.conv{i}.weight"] = _conv2d(fe[f"conv{i}"]["kernel"])
        _bn(f"{pre}.bn{i}", fe[f"bn{i}"], se[f"bn{i}"], out)
    for li in range(1, 5):
        for bi in range(2):
            fb, sb = fe[f"layer{li}_block{bi}"], se[f"layer{li}_block{bi}"]
            base = f"{pre}.layer{li}.{bi}"
            out[f"{base}.conv1.weight"] = _conv2d(fb["conv1"]["kernel"])
            out[f"{base}.conv2.weight"] = _conv2d(fb["conv2"]["kernel"])
            _bn(f"{base}.bn1", fb["bn1"], sb["bn1"], out)
            _bn(f"{base}.bn2", fb["bn2"], sb["bn2"], out)
            if "downsample_conv" in fb:
                out[f"{base}.downsample.0.weight"] = _conv2d(
                    fb["downsample_conv"]["kernel"])
                _bn(f"{base}.downsample.1", fb["downsample_bn"],
                    sb["downsample_bn"], out)


def _trunk(feat: Mapping, out: StateDict) -> None:
    for name in ("conv1", "e_conv1", "conv2", "e_conv2", "conv5", "conv6"):
        out[f"feat.{name}.weight"] = _conv1d(feat[name]["kernel"])
        out[f"feat.{name}.bias"] = _t(feat[name]["bias"])


def _pspnet(params: Mapping, stats: Mapping, out: StateDict,
            pre: str) -> None:
    """The colour encoder's variables under the module prefix `pre`."""
    _feats(params["feats"], stats["feats"], out, f"{pre}feats")
    psp = params["psp"]
    for i in range(4):
        out[f"{pre}psp.stages.{i}.1.weight"] = _conv2d(
            psp[f"stage{i}_conv"]["kernel"])
    out[f"{pre}psp.bottleneck.weight"] = _conv2d(psp["bottleneck"]["kernel"])
    out[f"{pre}psp.bottleneck.bias"] = _t(psp["bottleneck"]["bias"])
    for name in ("up_1", "up_2", "up_3"):
        up = params[name]
        out[f"{pre}{name}.conv.1.weight"] = _conv2d(up["conv"]["kernel"])
        out[f"{pre}{name}.conv.1.bias"] = _t(up["conv"]["bias"])
        out[f"{pre}{name}.conv.2.weight"] = _t(up["prelu_alpha"]).reshape(1)
    out[f"{pre}final.0.weight"] = _conv2d(params["final"]["kernel"])
    out[f"{pre}final.0.bias"] = _t(params["final"]["bias"])


def posenet_state_dict(variables: Mapping) -> StateDict:
    """JAX PoseNet variables ({params, batch_stats}) -> PoseNet state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: StateDict = {}
    _pspnet(params["cnn"], stats["cnn"], out, "cnn.model.")
    _trunk(params["feat"], out)
    for tag in ("r", "t", "c"):
        for i in range(1, 5):
            lp = params[f"conv{i}_{tag}"]
            out[f"conv{i}_{tag}.weight"] = _conv1d(lp["kernel"])
            out[f"conv{i}_{tag}.bias"] = _t(lp["bias"])
    return out


def refinenet_state_dict(variables: Mapping) -> StateDict:
    """JAX PoseRefineNet variables ({params}) -> PoseRefineNet state dict."""
    params = variables["params"]
    out: StateDict = {}
    _trunk(params["feat"], out)
    for tag in ("r", "t"):
        for i in range(1, 4):
            lp = params[f"conv{i}_{tag}"]
            out[f"conv{i}_{tag}.weight"] = _linear(lp["kernel"])
            out[f"conv{i}_{tag}.bias"] = _t(lp["bias"])
    return out


def segmenter_state_dict(arch: str, variables: Mapping) -> StateDict:
    """JAX segmenter variables ({params, batch_stats}) of
    `build_segmenter(arch, ...)` -> the port segmenter's state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: StateDict = {}
    if arch == "pspnet":
        _pspnet(params, stats, out, "")
        return out
    if arch != "segnet":
        raise ValueError(f"unknown segmenter arch {arch!r}")
    for name, block in params.items():
        if name == "classifier":
            out["classifier.weight"] = _conv2d(block["kernel"])
            out["classifier.bias"] = _t(block["bias"])
            continue
        out[f"{name}.conv.weight"] = _conv2d(block["Conv_0"]["kernel"])
        out[f"{name}.conv.bias"] = _t(block["Conv_0"]["bias"])
        _bn(f"{name}.bn", block["BatchNorm_0"], stats[name]["BatchNorm_0"], out)
    return out


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill `module` from `generator`, in the order of `named_modules`."""
    def randn(shape) -> torch.Tensor:
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.copy_(randn(m.running_mean.shape) * 0.3)
            m.running_var.copy_(randn(m.running_var.shape).abs() * 0.5 + 0.3)
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(randn(m.weight.shape) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.copy_(randn(m.bias.shape) * 0.05)
    return module
