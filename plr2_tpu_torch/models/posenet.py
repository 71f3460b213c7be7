"""PoseNet / PoseRefineNet, the port of plr2_tpu/models/posenet.py with
`use_pallas=True`: the three pose heads run as one `mlp_head` kernel
launch each, and the query object's rows are selected after the ladder
(`select_obj`).

Layout is channel-last (B, N, C) throughout, so every 1x1 Conv1d of the
reference is `F.linear` over the last axis; the modules keep the
upstream Conv1d / Linear parameters (lib/network.py names and shapes) so
upstream-format state dicts load with `strict=True`.

  PoseNet(img (B,H,W,3), cloud (B,N,3), choose (B,N), obj (B,)[, generator])
    -> pred_r (B,N,4), pred_t (B,N,3), pred_c (B,N,1) in (0,1), emb (B,N,32)
  PoseRefineNet(cloud (B,N,3), emb (B,N,32), obj (B,))
    -> pred_r (B,1,4), pred_t (B,1,3)

PoseNet's train mode (`.train()`, the JAX `train=True`) is train-mode
BatchNorm in the ResNet and the PSP channel dropouts, whose masks come
from `generator` or are passed in (`masks`, drawn beforehand by
`PSPNet.draw_dropout_masks`); the heads keep their kernel, which has a backward
(`ops.mlp_head.mlp_head` is an autograd Function). Under
`models.remat.rematerialised` the forward checkpoints its stages.

The parallel layer (`parallel/`) sets two mesh axes (`parallel.mesh.Axis`)
on the networks and their trunks, JAX's `points_axis` and the `model` axis
of its tensor-parallel shardings:
- `points_axis`: cloud and choose hold one contiguous block of the points;
  the trunks' global point means become the mean over the axis
  (`_global_point_mean`, JAX's pmean).
- `model_axis`: the column / row pairs of `parallel/tensor_parallel.py`
  hold this rank's slices of their weights (feat conv5 -> conv6, the
  PoseNet heads conv1 -> conv2 and conv3 -> conv4, the refiner heads conv1
  -> conv2), and run as per-layer `F.linear` on the slices with Megatron's
  f / g pair around each pair (`_tp_pair`): JAX's XLA head path, which
  tensor parallelism needs there too. Kernel 1 consumes whole weights in
  one launch, so it does not run on tensor-parallel heads.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from plr2_tpu_torch.models.pspnet import ModifiedResnet
from plr2_tpu_torch.models.remat import stage
from plr2_tpu_torch.ops.mlp_head import mlp_head, mlp_head_plain


def _weight2d(layer: nn.Module) -> torch.Tensor:
    """Conv1d(k=1) (out, in, 1) or Linear (out, in) weight as (out, in)."""
    w = layer.weight
    return w.reshape(w.shape[0], w.shape[1])


def _lin(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The layer applied over the last axis of x."""
    return F.linear(x, _weight2d(layer), layer.bias)


def _global_point_mean(y: torch.Tensor, points_axis, keepdim: bool):
    """Mean over the point axis (dim 1), across `points_axis` when set:
    the mean of the equal-sized blocks' means."""
    local = y.mean(1, keepdim=keepdim)
    return local if points_axis is None else points_axis.pmean(local)


def _tp_pair(col: nn.Module, row: nn.Module, x: torch.Tensor, axis,
             relu_out: bool = True) -> torch.Tensor:
    """A column-parallel layer then a row-parallel one on this rank's
    weight slices: the input's gradient and the row layer's partial sums
    are summed over `axis` (f and g), and the row layer's replicated bias
    is added once, after the sum."""
    h = F.relu(F.linear(axis.copy(x), _weight2d(col), col.bias))
    y = axis.reduce(F.linear(h, _weight2d(row))) + row.bias
    return F.relu(y) if relu_out else y


def _pair(col: nn.Module, row: nn.Module, x: torch.Tensor, axis,
          relu_out: bool = True) -> torch.Tensor:
    """Two layers, sliced over `axis` when it is set (`_tp_pair`)."""
    if axis is not None:
        return _tp_pair(col, row, x, axis, relu_out)
    y = _lin(row, F.relu(_lin(col, x)))
    return F.relu(y) if relu_out else y


def _two_scale(m: nn.Module, cloud, emb):
    x = F.relu(_lin(m.conv1, cloud))
    e = F.relu(_lin(m.e_conv1, emb))
    feat_1 = torch.cat([x, e], -1)  # 128
    x = F.relu(_lin(m.conv2, x))
    e = F.relu(_lin(m.e_conv2, e))
    return feat_1, torch.cat([x, e], -1)  # 256


class PoseNetFeat(nn.Module):
    """Dense fusion trunk -> (B, N, 1408) per-point feature."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.e_conv1 = nn.Conv1d(32, 64, 1)
        self.e_conv2 = nn.Conv1d(64, 128, 1)
        self.conv5 = nn.Conv1d(256, 512, 1)
        self.conv6 = nn.Conv1d(512, 1024, 1)
        self.points_axis = self.model_axis = None

    def forward(self, cloud, emb):
        feat_1, feat_2 = _two_scale(self, cloud, emb)
        y = _pair(self.conv5, self.conv6, feat_2, self.model_axis)
        glob = _global_point_mean(y, self.points_axis, True)
        return torch.cat([feat_1, feat_2, glob.expand(-1, y.shape[1], -1)], -1)


def select_obj(h: torch.Tensor, obj: torch.Tensor, num_obj: int,
               out_dim: int) -> torch.Tensor:
    """(B, N, num_obj * out_dim) -> the query object's (B, N, out_dim)."""
    b, n = h.shape[:2]
    h = h.reshape(b, n, num_obj, out_dim)
    idx = obj.long().reshape(b, 1, 1, 1).expand(b, n, 1, out_dim)
    return torch.gather(h, 2, idx).squeeze(2)


class PoseNet(nn.Module):
    HEADS = (("r", 4), ("t", 3), ("c", 1))

    def __init__(self, num_points: int, num_obj: int, emb_dim: int = 32,
                 use_kernels: bool = True):
        super().__init__()
        self.num_obj = num_obj
        self.use_kernels = use_kernels
        self.remat = False  # models/remat.py `rematerialised`
        self.model_axis = None  # module docstring
        self.cnn = ModifiedResnet(emb_dim, use_kernels)
        self.feat = PoseNetFeat()
        for tag, od in self.HEADS:
            setattr(self, f"conv1_{tag}", nn.Conv1d(1408, 640, 1))
            setattr(self, f"conv2_{tag}", nn.Conv1d(640, 256, 1))
            setattr(self, f"conv3_{tag}", nn.Conv1d(256, 128, 1))
            setattr(self, f"conv4_{tag}", nn.Conv1d(128, num_obj * od, 1))

    def forward(self, img, cloud, choose, obj, generator=None, masks=None):
        dt = self.conv1_r.weight.dtype
        emb = self.cnn(img.to(dt), choose, generator, masks)
        feat = stage(self, self.feat, cloud.to(dt), emb)
        b, n, c = feat.shape
        x2d = feat.reshape(b * n, c)
        head = mlp_head if self.use_kernels else mlp_head_plain
        outs = []
        for tag, od in self.HEADS:
            layers = [getattr(self, f"conv{i}_{tag}") for i in range(1, 5)]
            if self.model_axis is not None:
                h = _tp_pair(*layers[:2], x2d, self.model_axis)
                h = _tp_pair(*layers[2:], h, self.model_axis, relu_out=False)
            else:
                h = head(x2d, [(_weight2d(m), m.bias) for m in layers])
            outs.append(select_obj(h.reshape(b, n, -1), obj, self.num_obj, od))
        pred_r, pred_t, pred_c = outs
        return pred_r, pred_t, torch.sigmoid(pred_c), emb


class PoseRefineNetFeat(nn.Module):
    """Refiner trunk: two-scale concat (384) -> 512 -> 1024 -> point mean."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.e_conv1 = nn.Conv1d(32, 64, 1)
        self.e_conv2 = nn.Conv1d(64, 128, 1)
        self.conv5 = nn.Conv1d(384, 512, 1)
        self.conv6 = nn.Conv1d(512, 1024, 1)
        self.points_axis = self.model_axis = None

    def forward(self, cloud, emb):
        feat_1, feat_2 = _two_scale(self, cloud, emb)
        y = _pair(self.conv5, self.conv6, torch.cat([feat_1, feat_2], -1),
                  self.model_axis)
        return _global_point_mean(y, self.points_axis, False)


class PoseRefineNet(nn.Module):
    HEADS = (("r", 4), ("t", 3))

    def __init__(self, num_points: int, num_obj: int):
        super().__init__()
        self.num_obj = num_obj
        self.feat = PoseRefineNetFeat()
        for tag, od in self.HEADS:
            setattr(self, f"conv1_{tag}", nn.Linear(1024, 512))
            setattr(self, f"conv2_{tag}", nn.Linear(512, 128))
            setattr(self, f"conv3_{tag}", nn.Linear(128, num_obj * od))
        self.model_axis = None  # PoseNet's docstring

    def forward(self, cloud, emb, obj):
        dt = self.conv1_r.weight.dtype
        feat = self.feat(cloud.to(dt), emb.to(dt))
        b = feat.shape[0]
        outs = []
        for tag, od in self.HEADS:
            h = _pair(getattr(self, f"conv1_{tag}"), getattr(self, f"conv2_{tag}"),
                      feat, self.model_axis)
            h = getattr(self, f"conv3_{tag}")(h).reshape(b, self.num_obj, od)
            idx = obj.long().reshape(b, 1, 1).expand(b, 1, od)
            outs.append(torch.gather(h, 1, idx))
        return outs[0], outs[1]
