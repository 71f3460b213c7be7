"""PSPNet colour encoder -> per-point 32-d embedding, the port of
plr2_tpu/models/pspnet.py (the `use_pallas=True` configuration).

- PSPModule: bins 1/2/3/6 with PyTorch adaptive-pool windows, a 1x1 conv
  per bin, half-pixel bilinear upscale of the priors, concat with the
  features, 1x1 bottleneck to 1024, ReLU.
- PSPUpsample up_1..up_3: the decoder stages, each one launch of the
  `upconv3x3_prelu` kernel on NHWC activations.
- The embedding is gathered at `choose` BEFORE the final 1x1 conv and the
  log-softmax over channels (both per pixel, so the gather commutes).
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

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from plr2_tpu_torch.models.resnet import DilatedResNet18
from plr2_tpu_torch.ops.upconv import upconv3x3_prelu, upconv3x3_prelu_plain


class PSPModule(nn.Module):
    def __init__(self, features: int = 512, out_features: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(s),
                          nn.Conv2d(features, features, 1, bias=False))
            for s in sizes])
        self.bottleneck = nn.Conv2d(features * (len(sizes) + 1),
                                    out_features, 1)

    def forward(self, f):
        h, w = f.shape[2:]
        priors = [F.interpolate(stage(f), (h, w), mode="bilinear",
                                align_corners=False)
                  for stage in self.stages] + [f]
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
        g = torch.gather(p.reshape(b, h * w, c), 1,
                         choose.long().unsqueeze(-1).expand(b, -1, c))
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
