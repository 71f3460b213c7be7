"""Refiner ADD(-S) loss, the port of plr2_tpu/losses/refine_loss.py
(upstream lib/loss_refiner.py, vectorised over the batch).

The refiner predicts one pose delta per sample in the re-centred frame:
  pred = mp R^T + t
  dis  = mean_j ||pred_j - target_j||          (ADD)
       = mean_j min_k ||pred_j - target_k||    (ADD-S, symmetric objects:
                                               always, there is no refine
                                               guard here)
and emits (new_points, new_target) re-centred by the delta, detached, for
the next iteration. No confidence term. As in the JAX function, ADD and
ADD-S are computed on every row (ADD-S in one `nn_distance` launch) and
`is_sym` selects: fixed shapes, nothing read back to the host, so a CUDA
graph can capture it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from plr2_tpu_torch.geometry.quaternion import (normalize_quaternion,
                                                quat_to_matrix_df)
from plr2_tpu_torch.losses.add_loss import is_symmetric, rotate_rows
from plr2_tpu_torch.ops.knn import nn_distance, safe_norm


class RefineLossOut(NamedTuple):
    dis: torch.Tensor         # (B,) mean distance (this IS the refiner loss)
    new_points: torch.Tensor  # (B, N, 3)
    new_target: torch.Tensor  # (B, M, 3)


def refine_loss(pred_r, pred_t, target, model_points, idx, points,
                sym_list: Sequence[int],
                use_kernels: bool = True) -> RefineLossOut:
    """pred_r (B,1,4), pred_t (B,1,3), target (B,M,3), model_points (B,M,3),
    idx (B,), points (B,N,3) -> RefineLossOut. `use_kernels=False` runs
    the match through the kernel's plain twin."""
    pred_r, pred_t, target, model_points, points = (
        x.float() for x in (pred_r, pred_t, target, model_points, points))
    rot = quat_to_matrix_df(normalize_quaternion(pred_r[:, 0]))  # (B, 3, 3)
    t = pred_t[:, 0]
    pred = rotate_rows(model_points, rot.transpose(-1, -2)) + t[:, None, :]

    dis = safe_norm(pred - target).mean(-1)  # (B,)
    if len(sym_list) > 0:
        adds = nn_distance(pred[:, None], target,
                           use_kernel=use_kernels).mean((-2, -1))
        dis = torch.where(is_symmetric(idx, sym_list), adds, dis)

    with torch.no_grad():
        new_points = rotate_rows(points - t[:, None, :], rot)
        new_target = rotate_rows(target - t[:, None, :], rot)
    return RefineLossOut(dis=dis, new_points=new_points, new_target=new_target)
