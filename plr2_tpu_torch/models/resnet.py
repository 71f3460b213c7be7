"""Dilated ResNet-18 trunk of the PSPNet colour encoder, the port of
plr2_tpu/models/resnet.py.

Deep 3-conv stem, PyTorch-semantics max pool (3x3, stride 2, padding 1),
layer3/layer4 dilated 2/4 with stride 1: output stride 8, 512 channels.
BatchNorm (`BatchNorm2d` below) has flax's train-mode semantics. Plain
`F.conv2d` via nn.Conv2d: these are XLA convolutions in the JAX package,
not TPU kernels. Attribute names follow the upstream pspnet-pytorch
extractor (conv1..3, bn1..3, layer{1..4}.{0,1}.{conv,bn}{1,2},
downsample.{0,1}).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train mode is flax's `nn.BatchNorm(momentum=
    0.9, epsilon=1e-5)` (plr2_tpu/models/resnet.py:40-46, :85-90).

    Train mode normalises with the batch mean and the biased batch variance
    (as torch does) and updates the running statistics itself, as flax
    does: ``0.9 * old + 0.1 * batch`` with the BIASED variance
    ``max(0, E[x^2] - E[x]^2)``. torch's own update uses the unbiased
    variance, a relative gap of 1/(n-1) at n = B*H*W values per channel.
    Eval mode is torch's. Under mixed precision (x bf16, parameters and
    statistics f32) both modes compute in f32 and return x's dtype.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if x.dtype != self.weight.dtype:
            # mixed precision (bf16 activations, f32 parameters and
            # statistics): statistics and normalisation in f32, the output
            # in x's dtype, as flax's BatchNorm(dtype=bfloat16) computes
            return self._forward(x.float()).to(x.dtype)
        return self._forward(x)

    def _forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, dilation, dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=False),
            BatchNorm2d(planes)) if downsample else None)

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + r)


class DilatedResNet18(nn.Module):
    """(B, 3, H, W) -> (B, 512, H/8, W/8)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = nn.Conv2d(64, 128, 3, 1, 1, bias=False)
        self.bn3 = BatchNorm2d(128)
        inplanes = 128
        for li, (planes, stride, dilation) in enumerate(
                ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)), start=1):
            down = stride != 1 or inplanes != planes
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(inplanes, planes, stride, dilation, down),
                BasicBlock(planes, planes, 1, dilation)))
            inplanes = planes

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return x
