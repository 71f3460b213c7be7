"""Plain PyTorch reference of DenseFusion's networks (Wang et al., CVPR
2019; j96w/DenseFusion lib/network.py and lib/pspnet.py), written as
functions over a flat parameter dict whose keys are upstream's module
names. Float32, `F.conv2d` / `F.linear` / `F.interpolate` only: no kernel,
no cache, no batching trick, and nothing of the program under test.

- PSPNet colour encoder: the dilated ResNet-18 extractor (deep 3-conv stem,
  3x3/2 max pool, layer3 / layer4 dilated 2 / 4 at stride 1: output
  stride 8), the PSP module (adaptive average pools 1/2/3/6, a 1x1 conv
  each, bilinear upsampling, concatenation with the features, 1x1
  bottleneck, ReLU), three upsampling stages (2x bilinear, 3x3 conv,
  PReLU), the final 1x1 conv and log-softmax over channels; the
  embedding is read at the `choose` pixels.
- Train mode: BatchNorm on the batch's statistics, and the three channel
  dropouts (after psp, up_1, up_2) as keep masks handed in.
- PoseNet: the dense-fusion trunk and three pose heads (r, t, c) of four
  1x1 convs, the query object's rows selected, sigmoid on c.
- PoseRefineNet: the refiner trunk (point mean) and its two heads.

The parameter shapes are listed here too (`posenet_shapes`,
`refiner_shapes`): the benchmark makes its weights from them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

PSP_SIZES = (1, 2, 3, 6)
DROPOUT_RATES = (0.3, 0.15, 0.15)
# (planes, stride, dilation) of layer1..layer4 of the dilated ResNet-18
RESNET_LAYERS = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))

Shape = Tuple[str, Tuple[int, ...], str]


def _bn(name: str, c: int) -> List[Shape]:
    return [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "bn_count")]


def _conv(name: str, cout: int, cin: int, k: int, bias: bool) -> List[Shape]:
    out = [(f"{name}.weight", (cout, cin, k, k) if k else (cout, cin),
            "weight")]
    return out + ([(f"{name}.bias", (cout,), "bias")] if bias else [])


def _conv1d(name: str, cout: int, cin: int) -> List[Shape]:
    return [(f"{name}.weight", (cout, cin, 1), "weight"),
            (f"{name}.bias", (cout,), "bias")]


def _linear(name: str, cout: int, cin: int) -> List[Shape]:
    return [(f"{name}.weight", (cout, cin), "weight"),
            (f"{name}.bias", (cout,), "bias")]


def _trunk(prefix: str) -> List[Shape]:
    out = (_conv(f"{prefix}.conv1", 64, 3, 3, False) + _bn(f"{prefix}.bn1", 64)
           + _conv(f"{prefix}.conv2", 64, 64, 3, False)
           + _bn(f"{prefix}.bn2", 64)
           + _conv(f"{prefix}.conv3", 128, 64, 3, False)
           + _bn(f"{prefix}.bn3", 128))
    inplanes = 128
    for li, (planes, stride, _) in enumerate(RESNET_LAYERS, start=1):
        for bi in range(2):
            b = f"{prefix}.layer{li}.{bi}"
            cin = inplanes if bi == 0 else planes
            out += (_conv(f"{b}.conv1", planes, cin, 3, False)
                    + _bn(f"{b}.bn1", planes)
                    + _conv(f"{b}.conv2", planes, planes, 3, False)
                    + _bn(f"{b}.bn2", planes))
            if bi == 0 and (stride != 1 or inplanes != planes):
                out += (_conv(f"{b}.downsample.0", planes, inplanes, 1, False)
                        + _bn(f"{b}.downsample.1", planes))
        inplanes = planes
    return out


def posenet_shapes(num_obj: int, emb: int = 32) -> List[Shape]:
    """(name, shape, kind) of every PoseNet tensor, upstream's names."""
    m = "cnn.model"
    out = _trunk(f"{m}.feats")
    for i in range(len(PSP_SIZES)):
        out += _conv(f"{m}.psp.stages.{i}.1", 512, 512, 1, False)
    out += _conv(f"{m}.psp.bottleneck", 1024, 512 * (len(PSP_SIZES) + 1), 1,
                 True)
    for name, cin, cout in (("up_1", 1024, 256), ("up_2", 256, 64),
                            ("up_3", 64, 64)):
        out += _conv(f"{m}.{name}.conv.1", cout, cin, 3, True)
        out += [(f"{m}.{name}.conv.2.weight", (1,), "prelu")]
    out += _conv(f"{m}.final.0", emb, 64, 1, True)
    for name, cout, cin in (("conv1", 64, 3), ("conv2", 128, 64),
                            ("e_conv1", 64, emb), ("e_conv2", 128, 64),
                            ("conv5", 512, 256), ("conv6", 1024, 512)):
        out += _conv1d(f"feat.{name}", cout, cin)
    for tag, od in (("r", 4), ("t", 3), ("c", 1)):
        for i, (cout, cin) in enumerate(((640, 1408), (256, 640), (128, 256),
                                         (num_obj * od, 128)), start=1):
            out += _conv1d(f"conv{i}_{tag}", cout, cin)
    return out


def refiner_shapes(num_obj: int, emb: int = 32) -> List[Shape]:
    """(name, shape, kind) of every PoseRefineNet tensor."""
    out = []
    for name, cout, cin in (("conv1", 64, 3), ("conv2", 128, 64),
                            ("e_conv1", 64, emb), ("e_conv2", 128, 64),
                            ("conv5", 512, 384), ("conv6", 1024, 512)):
        out += _conv1d(f"feat.{name}", cout, cin)
    for tag, od in (("r", 4), ("t", 3)):
        out += (_linear(f"conv1_{tag}", 512, 1024)
                + _linear(f"conv2_{tag}", 128, 512)
                + _linear(f"conv3_{tag}", num_obj * od, 128))
    return out


# ---------------------------------------------------------------- layers


class Precision:
    """How the reference rounds: `cast` is applied to every convolution's
    and matmul's operands (identity for the float32 reference; the
    controls round to a lower precision, `reference/precision.py`)."""

    def __init__(self, cast=None):
        self.cast = cast or (lambda x: x)

    def conv2d(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return F.conv2d(self.cast(x), self.cast(w), b, stride, padding,
                        dilation)

    def linear(self, x, w, b=None):
        return F.linear(self.cast(x), self.cast(w.reshape(w.shape[0], -1)), b)


FULL = Precision()


def _batch_norm(p, name, x, train: bool):
    if train:
        return F.batch_norm(x, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], True, 0.0, 1e-5)
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0,
                        1e-5)


def resnet18_dilated(p, x, train: bool, prec: Precision = FULL,
                     prefix: str = "cnn.model.feats"):
    """NCHW (B, 3, H, W) -> (B, 512, H/8, W/8)."""
    def cbr(name, bn, x, stride=1):
        y = prec.conv2d(x, p[f"{prefix}.{name}.weight"], None, stride, 1)
        return F.relu(_batch_norm(p, f"{prefix}.{bn}", y, train))

    x = cbr("conv1", "bn1", x, 2)
    x = cbr("conv2", "bn2", x)
    x = cbr("conv3", "bn3", x)
    x = F.max_pool2d(x, 3, 2, 1)
    for li, (_, stride, dil) in enumerate(RESNET_LAYERS, start=1):
        for bi in range(2):
            b = f"{prefix}.layer{li}.{bi}"
            s = stride if bi == 0 else 1
            if f"{b}.downsample.0.weight" in p:
                r = _batch_norm(p, f"{b}.downsample.1", prec.conv2d(
                    x, p[f"{b}.downsample.0.weight"], None, s), train)
            else:
                r = x
            y = F.relu(_batch_norm(p, f"{b}.bn1", prec.conv2d(
                x, p[f"{b}.conv1.weight"], None, s, dil, dil), train))
            y = _batch_norm(p, f"{b}.bn2", prec.conv2d(
                y, p[f"{b}.conv2.weight"], None, 1, dil, dil), train)
            x = F.relu(y + r)
    return x


def psp_embedding(p, img, choose, train: bool = False,
                  masks: Optional[Sequence[torch.Tensor]] = None,
                  prec: Precision = FULL):
    """img (B, H, W, 3) normalised, choose (B, N) flat pixel indices ->
    (B, N, emb) log-softmax embedding at the chosen pixels. `masks`: the
    three (B, C) keep masks of train mode's channel dropouts."""
    m = "cnn.model"
    f = resnet18_dilated(p, img.permute(0, 3, 1, 2), train, prec)
    h, w = f.shape[2:]
    priors = []
    for i, s in enumerate(PSP_SIZES):
        y = prec.conv2d(F.adaptive_avg_pool2d(f, s),
                        p[f"{m}.psp.stages.{i}.1.weight"])
        priors.append(F.interpolate(y, size=(h, w), mode="bilinear",
                                    align_corners=False))
    x = F.relu(prec.conv2d(torch.cat(priors + [f], 1),
                           p[f"{m}.psp.bottleneck.weight"],
                           p[f"{m}.psp.bottleneck.bias"]))
    for i, up in enumerate(("up_1", "up_2", "up_3")):
        if train:
            keep = masks[i].to(x.dtype)[:, :, None, None]
            x = x * keep / (1.0 - DROPOUT_RATES[i])
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        x = prec.conv2d(x, p[f"{m}.{up}.conv.1.weight"],
                        p[f"{m}.{up}.conv.1.bias"], 1, 1)
        x = F.prelu(x, p[f"{m}.{up}.conv.2.weight"])
    e = prec.conv2d(x, p[f"{m}.final.0.weight"], p[f"{m}.final.0.bias"])
    e = torch.log_softmax(e, dim=1)
    b, c = e.shape[:2]
    e = e.reshape(b, c, -1)
    return torch.gather(e, 2, choose[:, None, :].expand(b, c, -1)
                        ).transpose(1, 2)


def _lin(p, name, x, prec):
    return prec.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _two_scale(p, prefix, cloud, emb, prec):
    x = F.relu(_lin(p, f"{prefix}.conv1", cloud, prec))
    e = F.relu(_lin(p, f"{prefix}.e_conv1", emb, prec))
    feat_1 = torch.cat([x, e], -1)
    x = F.relu(_lin(p, f"{prefix}.conv2", x, prec))
    e = F.relu(_lin(p, f"{prefix}.e_conv2", e, prec))
    return feat_1, torch.cat([x, e], -1)


def _select(h, obj, num_obj, od):
    b, n = h.shape[:2]
    h = h.reshape(b, n, num_obj, od)
    return h[torch.arange(b, device=h.device), :, obj.long()]


def posenet(p, img, cloud, choose, obj, num_obj: int, train: bool = False,
            masks=None, prec: Precision = FULL):
    """-> pred_r (B, N, 4), pred_t (B, N, 3), pred_c (B, N) in (0, 1),
    emb (B, N, emb)."""
    emb = psp_embedding(p, img, choose, train, masks, prec)
    feat_1, feat_2 = _two_scale(p, "feat", cloud, emb, prec)
    x = F.relu(_lin(p, "feat.conv5", feat_2, prec))
    x = F.relu(_lin(p, "feat.conv6", x, prec))
    glob = x.mean(1, keepdim=True).expand(-1, x.shape[1], -1)
    feat = torch.cat([feat_1, feat_2, glob], -1)
    outs = []
    for tag, od in (("r", 4), ("t", 3), ("c", 1)):
        h = feat
        for i in range(1, 4):
            h = F.relu(_lin(p, f"conv{i}_{tag}", h, prec))
        outs.append(_select(_lin(p, f"conv4_{tag}", h, prec), obj, num_obj,
                            od))
    return outs[0], outs[1], torch.sigmoid(outs[2][..., 0]), emb


def refiner(p, cloud, emb, obj, num_obj: int, prec: Precision = FULL):
    """cloud (B, N, 3), emb (B, N, emb) -> dq (B, 4), dt (B, 3)."""
    feat_1, feat_2 = _two_scale(p, "feat", cloud, emb, prec)
    x = F.relu(_lin(p, "feat.conv5", torch.cat([feat_1, feat_2], -1), prec))
    x = F.relu(_lin(p, "feat.conv6", x, prec)).mean(1)
    outs = []
    for tag, od in (("r", 4), ("t", 3)):
        h = F.relu(_lin(p, f"conv1_{tag}", x, prec))
        h = F.relu(_lin(p, f"conv2_{tag}", h, prec))
        h = _lin(p, f"conv3_{tag}", h, prec).reshape(-1, num_obj, od)
        outs.append(h[torch.arange(h.shape[0], device=h.device), obj.long()])
    return outs[0], outs[1]


# ------------------------------------------------------------- pose math


def quat_matrix(q):
    """(..., 4) unit wxyz quaternion -> (..., 3, 3) rotation matrix R, for
    column vectors (x' = R x)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def unit(q):
    return q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def refine(p, cloud, emb, obj, q, t, iterations: int, num_obj: int,
           prec: Precision = FULL):
    """DenseFusion's iterative refinement: the cloud in the current pose's
    frame, the refiner's correction composed on the right."""
    for _ in range(iterations):
        r = quat_matrix(q)
        local = torch.einsum("bnk,bkj->bnj", cloud - t[:, None], r)
        dq, dt = refiner(p, local, emb, obj, num_obj, prec)
        t = torch.einsum("bij,bj->bi", r, dt) + t
        q = quat_mul(q, unit(dq))
    return q, t
