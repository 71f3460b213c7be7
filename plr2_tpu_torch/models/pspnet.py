"""PSPNet colour encoder -> per-point 32-d embedding, the port of
plr2_tpu/models/pspnet.py (the `use_pallas=True` configuration).

- PSPModule: bins 1/2/3/6 with PyTorch adaptive-pool windows, a 1x1 conv
  per bin, half-pixel bilinear upscale of the priors, concat with the
  features, 1x1 bottleneck to 1024, ReLU. The pooling and the upscale are
  products with fixed matrices, as the JAX module computes them
  (`adaptive_avg_pool_2d`, `bilinear_upscale_mm`): the pool in f32, the
  upscale in the activations' dtype. Their backward passes are products
  too, where `nn.AdaptiveAvgPool2d`'s and bilinear `F.interpolate`'s add
  by atomics on the card, so a training step repeats bit for bit.
- PSPUpsample up_1..up_3: the decoder stages, each one launch of the
  `upconv3x3_prelu` kernel on NHWC activations.
- The embedding is gathered at `choose` BEFORE the final 1x1 conv and the
  log-softmax over channels (both per pixel, so the gather commutes), by
  `ops.gather.gather_rows`, whose backward sums each row's gradients in a
  fixed order.
- Train mode applies the reference's three channel dropouts (rates 0.3,
  0.15, 0.15 after psp, up_1 and up_2; flax `nn.Dropout` with
  `broadcast_dims=(1, 2)`, i.e. one keep/drop draw per sample and channel,
  kept values scaled by 1/(1-p)), with masks drawn from the
  `torch.Generator` the caller passes in, never from the global RNG. They
  are the identity in eval mode. `dropout_rates` may be set to zeros to
  switch them off (the parity tests do).

The trunk runs NCHW tensors in channels_last memory, so the PSP output
is already NHWC in memory and the permute before the decoder costs no
copy. Attribute names follow upstream lib/pspnet.py.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from plr2_tpu_torch.models.resnet import DilatedResNet18
from plr2_tpu_torch.ops.gather import gather_rows
from plr2_tpu_torch.ops.upconv import upconv3x3_prelu, upconv3x3_prelu_plain


def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic matrix of PyTorch's AdaptiveAvgPool
    windows: window i = [floor(i n / s), ceil((i + 1) n / s))."""
    a = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        lo = int(np.floor(i * n_in / n_out))
        hi = int(np.ceil((i + 1) * n_in / n_out))
        a[i, lo:hi] = 1.0 / (hi - lo)
    return a


def _bilinear_upscale_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel linear interpolation (upscale only): row i
    holds the two clamped taps' weights for the output coordinate
    (i + 0.5) n_in / n_out - 0.5."""
    a = np.zeros((n_out, n_in), dtype=np.float32)
    for i in range(n_out):
        c = (i + 0.5) * n_in / n_out - 0.5
        m = int(np.floor(c))
        f = c - m
        a[i, min(max(m, 0), n_in - 1)] += 1.0 - f
        a[i, min(max(m + 1, 0), n_in - 1)] += f
    return a


_MATRICES = {"pool": _adaptive_pool_matrix, "upscale": _bilinear_upscale_matrix}


@functools.lru_cache(maxsize=64)
def _matrix(kind: str, n_in: int, n_out: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_MATRICES[kind](n_in, n_out)).to(device, dtype)


def _apply_hw(x: torch.Tensor, kind: str, h_out: int, w_out: int,
              dtype: torch.dtype) -> torch.Tensor:
    """NHWC x -> (B, h_out, w_out, C): the (h_out, H) matrix over rows, then
    the (w_out, W) matrix over columns, two products in `dtype`."""
    b, h, w, c = x.shape
    rh = _matrix(kind, h, h_out, x.device, dtype)
    rw = _matrix(kind, w, w_out, x.device, dtype)
    y = torch.matmul(rh, x.to(dtype).reshape(b, h, w * c))
    y = torch.matmul(rw, y.reshape(b * h_out, w, c))
    return y.reshape(b, h_out, w_out, c)


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """NHWC adaptive average pool to (out_hw, out_hw), in f32 (JAX's f32
    matrices promote the product)."""
    return _apply_hw(x, "pool", out_hw, out_hw,
                     torch.promote_types(x.dtype, torch.float32))


def bilinear_upscale_mm(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC half-pixel bilinear upscale in x's dtype."""
    return _apply_hw(x, "upscale", h, w, x.dtype)


class AdaptivePool(nn.Module):
    """`adaptive_avg_pool_2d` on NCHW tensors, rounded back to the input's
    dtype for the bin's convolution (parameter-free, so the stages keep
    upstream's `stages.{i}.1.weight` names)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, f):
        p = adaptive_avg_pool_2d(f.permute(0, 2, 3, 1), self.size)
        return p.to(f.dtype).permute(0, 3, 1, 2)


class PSPModule(nn.Module):
    def __init__(self, features: int = 512, out_features: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList([
            nn.Sequential(AdaptivePool(s),
                          nn.Conv2d(features, features, 1, bias=False))
            for s in sizes])
        self.bottleneck = nn.Conv2d(features * (len(sizes) + 1),
                                    out_features, 1)

    def forward(self, f):
        h, w = f.shape[2:]
        priors = [bilinear_upscale_mm(stage(f).permute(0, 2, 3, 1), h, w)
                  .permute(0, 3, 1, 2) for stage in self.stages] + [f]
        return F.relu(self.bottleneck(torch.cat(priors, 1)))


class PSPUpsample(nn.Module):
    """NHWC (B, h, w, Cin) -> (B, 2h, 2w, Cout): 2x bilinear, 3x3 conv, PReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_kernels: bool = True):
        super().__init__()
        # upstream layout: Sequential(Upsample, Conv2d, PReLU)
        self.conv = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
            nn.Conv2d(in_channels, out_channels, 3, padding=1),
            nn.PReLU())
        self.use_kernels = use_kernels

    def forward(self, x):
        conv, prelu = self.conv[1], self.conv[2]
        w = conv.weight.permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
        fn = upconv3x3_prelu if self.use_kernels else upconv3x3_prelu_plain
        return fn(x.contiguous(), w, conv.bias, prelu.weight)


def channel_dropout(x: torch.Tensor, rate: float,
                    generator: torch.Generator) -> torch.Tensor:
    """NHWC x: each (sample, channel) kept with probability 1 - rate and
    scaled by 1/(1 - rate), or zeroed (flax Dropout, broadcast over H, W)."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit torch.Generator")
    keep_prob = 1.0 - rate
    u = torch.rand((x.shape[0], 1, 1, x.shape[3]), generator=generator,
                   device=generator.device).to(x.device)
    return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


class PSPNet(nn.Module):
    def __init__(self, emb_dim: int = 32, sizes: Sequence[int] = (1, 2, 3, 6),
                 psp_out: int = 1024, use_kernels: bool = True):
        super().__init__()
        self.feats = DilatedResNet18()
        self.psp = PSPModule(512, psp_out, sizes)
        self.up_1 = PSPUpsample(psp_out, 256, use_kernels)
        self.up_2 = PSPUpsample(256, 64, use_kernels)
        self.up_3 = PSPUpsample(64, 64, use_kernels)
        self.final = nn.Sequential(nn.Conv2d(64, emb_dim, 1),
                                   nn.LogSoftmax(dim=1))
        self.dropout_rates = (0.3, 0.15, 0.15)  # drop_1, drop_2a, drop_2b

    def forward(self, img, choose, generator=None):
        """img (B, H, W, 3) NHWC; choose (B, N) flat pixel indices ->
        the gathered log-softmax embedding (B, N, emb_dim). `generator`
        draws the dropout masks in train mode."""
        x = img.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        p = self.psp(self.feats(x)).permute(0, 2, 3, 1)  # NHWC
        for up, rate in zip((self.up_1, self.up_2, self.up_3),
                            self.dropout_rates):
            if self.training:
                p = channel_dropout(p, rate, generator)
            p = up(p)
        b, h, w, c = p.shape
        g = gather_rows(p.reshape(b, h * w, c), choose,
                        self.up_1.use_kernels)
        conv = self.final[0]
        e = F.linear(g, conv.weight.reshape(conv.out_channels, c), conv.bias)
        return torch.log_softmax(e, dim=-1)


class ModifiedResnet(nn.Module):
    """Upstream wrapper: holds the PSPNet as `.model`."""

    def __init__(self, emb_dim: int = 32, use_kernels: bool = True):
        super().__init__()
        self.model = PSPNet(emb_dim=emb_dim, use_kernels=use_kernels)

    def forward(self, img, choose, generator=None):
        return self.model(img, choose, generator)
