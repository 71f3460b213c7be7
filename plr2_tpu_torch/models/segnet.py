"""SegNet semantic segmentation and the segmenter builder, the port of
plr2_tpu/models/segnet.py (the reference's vanilla_segmentation/segnet.py):
a VGG16 encoder (2-2-3-3-3 blocks of 3x3 conv + BatchNorm + ReLU, each
block closed by a 2x2 max pool) and the mirrored decoder (each block opened
by the paired unpool), then a 3x3 classifier. It labels every pixel of a
frame, so the full pipeline can crop objects without PoseCNN's masks
(BASELINE config 5).

The unpool keeps the JAX package's rule, not `F.max_unpool2d`'s: the pool
returns a mask, `x == nearest_up(pooled)` divided by the number of ties in
each 2x2 window, and the unpool writes `nearest_up(y) * mask`. After a
ReLU, windows of zeros tie on every element: the mask then writes y/4 at
all four places, where an index unpool writes y at one. The mask is built
in the activations' dtype (bf16 in a bf16 segmenter) and carries no
gradient; the pool's gradient goes to the first maximum of each window in
row-major order, as XLA's max-pool gradient does (`F.max_pool2d`).

Everything here is plain PyTorch on every device: the JAX package computes
SegNet in plain XLA (its pool and unpool are elementwise), so no kernel is
owed. Activations are NHWC (B, H, W, C) tensors; each convolution sees them
as an NCHW view in channels_last memory, so no permute copies. H and W must
be multiples of 32 (five pool levels): the callers pad.

`build_segmenter("segnet" | "pspnet")` gives either segmenter: SegNet, or
the PSPNet colour encoder with a per-pixel classifier (`emb_dim =
num_classes`, no log-softmax, the full map through the decoder kernel:
`models/pspnet.py`). Both map (B, H, W, 3) normalised frames to (B, H, W,
num_classes) logits in their parameters' dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from plr2_tpu_torch.models.pspnet import PSPNet
from plr2_tpu_torch.models.resnet import BatchNorm2d
from plr2_tpu_torch.models.weights import init_random_
from plr2_tpu_torch.pipeline import resolve_device

VGG16_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def max_pool_with_mask(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC 2x2 / stride-2 max pool, and the tie-normalised argmax mask that
    the paired unpool reads."""
    pooled = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    with torch.no_grad():
        mask = (x == _nearest_up2(pooled)).to(x.dtype)
        b, h, w, c = mask.shape
        win = mask.reshape(b, h // 2, 2, w // 2, 2, c)
        counts = torch.clamp(win.sum((2, 4), keepdim=True), min=1.0)
        mask = (win / counts).reshape(b, h, w, c)
    return pooled, mask


def max_unpool(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Place decoder features at the encoder's maxima."""
    return _nearest_up2(y) * mask


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):  # NHWC -> NHWC
        y = F.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        return y.permute(0, 2, 3, 1)


class SegNet(nn.Module):
    """VGG16 encoder (2-2-3-3-3 conv blocks) + mirrored decoder; attribute
    names follow the JAX module's (`enc{b}_{c}`, `dec{b}_{c}`,
    `classifier`)."""

    def __init__(self, num_classes: int = 22,
                 enc_blocks: Sequence[Tuple[int, int]] = VGG16_BLOCKS):
        super().__init__()
        self.enc_blocks = tuple(tuple(b) for b in enc_blocks)
        cin = 3
        for bi, (n_convs, feats) in enumerate(self.enc_blocks):
            for ci in range(n_convs):
                setattr(self, f"enc{bi}_{ci}", ConvBNRelu(cin, feats))
                cin = feats
        dec = list(reversed(self.enc_blocks))
        for bi, (n_convs, feats) in enumerate(dec):
            # mirrored block: its last conv goes to the next block's width
            nxt = dec[bi + 1][1] if bi + 1 < len(dec) else self.enc_blocks[0][1]
            for ci in range(n_convs):
                cout = feats if ci < n_convs - 1 else nxt
                setattr(self, f"dec{bi}_{ci}", ConvBNRelu(cin, cout))
                cin = cout
        self.classifier = nn.Conv2d(cin, num_classes, 3, padding=1)

    def forward(self, x):
        """x (B, H, W, 3) -> logits (B, H, W, num_classes)."""
        x = x.to(self.classifier.weight.dtype)
        masks = []
        for bi, (n_convs, _) in enumerate(self.enc_blocks):
            for ci in range(n_convs):
                x = getattr(self, f"enc{bi}_{ci}")(x)
            x, mask = max_pool_with_mask(x)
            masks.append(mask)
        for bi, (n_convs, _) in enumerate(reversed(self.enc_blocks)):
            x = max_unpool(x, masks[len(masks) - 1 - bi])
            for ci in range(n_convs):
                x = getattr(self, f"dec{bi}_{ci}")(x)
        return self.classifier(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross entropy (the reference's CrossEntropyLoss2d):
    logits (B, H, W, C), labels (B, H, W) int."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -picked.mean()


def build_segmenter(arch: str, num_classes: int, dtype=torch.float32,
                    device="cuda", seed: Optional[int] = 0,
                    use_kernels: bool = True) -> nn.Module:
    """A segmenter in eval mode on `device`, its weights drawn from
    `torch.Generator().manual_seed(seed)` (or left uninitialised with
    seed=None, for a state dict), cast to `dtype`.

    "segnet": the reference-parity VGG16 encoder-decoder above.
    "pspnet": the PSPNet colour encoder (dilated ResNet-18 at stride 8,
    pyramid pooling, the three decoder stages on the `upconv3x3_prelu`
    kernel, or their plain versions with use_kernels=False) with a 1x1
    per-pixel classifier: far less full-resolution work than VGG16's 26
    convolutions at frame resolution.
    """
    if arch == "segnet":
        make = lambda: SegNet(num_classes=num_classes)  # noqa: E731
    elif arch == "pspnet":
        make = lambda: PSPNet(emb_dim=num_classes, use_kernels=use_kernels,  # noqa: E731
                              log_softmax_final=False)
    else:
        raise ValueError(f"unknown segmenter arch {arch!r} "
                         "(expected 'segnet' or 'pspnet')")
    dev = resolve_device(device)
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=dev).eval()
    if seed is not None:
        init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(dtype)
