"""Pose-accuracy metrics: ADD, ADD-S, threshold success and the ADD-S AUC,
the port of plr2_tpu/eval/metrics.py.

The distances run on the device of their inputs (torch); the aggregation
is host NumPy, copied from the JAX module: `compute_auc` is the YCB
toolbox's VOCap accuracy-vs-threshold integral (thresholds up to 0.1 m,
scaled to [0, 100]), distances above the cap counted as failures.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from plr2_tpu_torch.geometry.quaternion import quat_to_matrix_df
from plr2_tpu_torch.ops.knn import pairwise_sq_dist


def _posed(model_points: torch.Tensor, q: torch.Tensor,
           t: torch.Tensor) -> torch.Tensor:
    """model_points (M, 3) under the pose (q wxyz, t), in f32. As in JAX,
    the rotation matrix is computed in q's dtype (bf16 in the bf16 mode)
    and promoted to f32 in the product with the points. The (M, 3) x (3, 3)
    product is written out elementwise, so it never rounds through TF32
    (JAX: a Precision.HIGHEST matmul)."""
    r = quat_to_matrix_df(q).float()
    return (model_points.float()[:, None, :] * r).sum(-1) + t.float()


def add_distance(model_points: torch.Tensor, q: torch.Tensor,
                 t: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """ADD: mean paired distance between predicted-pose and GT model points.

    model_points (M, 3); q (4,) wxyz; t (3,); target (M, 3) GT-posed points.
    """
    pred = _posed(model_points, q, t)
    return torch.linalg.norm(pred - target.float(), dim=-1).mean()


def adds_distance(model_points: torch.Tensor, q: torch.Tensor,
                  t: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """ADD-S: mean nearest-neighbour distance (symmetric objects)."""
    pred = _posed(model_points, q, t)
    d2 = pairwise_sq_dist(pred[None], target.float()[None])[0]
    return torch.sqrt(d2.amin(-1)).mean()


def pose_distance(model_points, q, t, target, symmetric: bool) -> torch.Tensor:
    return (adds_distance if symmetric else add_distance)(model_points, q, t,
                                                          target)


def success_rate(distances: Sequence[float], threshold: float) -> float:
    """Fraction of samples with distance below `threshold` (LineMOD:
    0.1 * object diameter; YCB '<2cm': 0.02)."""
    d = np.asarray(list(distances), dtype=np.float64)
    if d.size == 0:
        return 0.0
    return float(np.mean(d < threshold))


def accuracy_threshold_curve(distances: Sequence[float],
                             max_dist: float = 0.1,
                             num_thresholds: int = 100):
    """(thresholds, accuracy) arrays — the toolbox's plot_accuracy_keyframe
    curve (accuracy(t) = fraction of samples with distance <= t)."""
    d = np.asarray(list(distances), dtype=np.float64)
    ts = np.linspace(0.0, max_dist, num_thresholds + 1)
    if d.size == 0:
        return ts, np.zeros_like(ts)
    acc = (d[None, :] <= ts[:, None]).mean(axis=1)
    return ts, acc


def compute_auc(distances: Sequence[float], max_dist: float = 0.1) -> float:
    """ADD-S AUC in [0, 100], toolbox VOCap semantics."""
    d = np.asarray(list(distances), dtype=np.float64)
    if d.size == 0:
        return 0.0
    n = d.size
    d = np.where(d > max_dist, np.inf, d)
    d = np.sort(d)
    acc = np.cumsum(np.ones(n)) / n

    finite = np.isfinite(d)
    if not finite.any():
        return 0.0
    rec = d[finite]
    prec = acc[finite]
    mrec = np.concatenate([[0.0], rec, [max_dist]])
    mpre = np.concatenate([[0.0], prec, [prec[-1]]])
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    ap = np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]) * (1.0 / max_dist)
    return float(ap * 100.0)
