"""Confidence-weighted ADD(-S) pose loss, the port of
plr2_tpu/losses/add_loss.py `pose_loss` (upstream lib/loss.py
`loss_calculation`, vectorised over the batch).

  * per-point hypotheses: R_i from the normalised quaternion, candidate
    translation t_i = points_i + pred_t_i
  * ADD:   mean_j || (mp R_i^T + t_i)_j - target_j ||
  * ADD-S: mean_j min_k || (mp R_i^T + t_i)_j - target_k ||, for samples
    of symmetric objects, outside the refine stage (the reference's
    `if not refine:` guard)
  * loss = mean_i (dis_i c_i - w log c_i), with c clamped at 1e-12 inside
    the log
  * (new_points, new_target) re-centred by the best-confidence hypothesis
    (first index on ties), detached, for the refiner.

The ADD-S branch is JAX's four-way choice (`add_all`, `adds_all`,
`mixed`, `compact`), every one of which computes ADD-S on symmetric rows
and ADD elsewhere. JAX picks the branch on the device; the port picks it
on the host, from the batch's count of symmetric samples `n_sym` (the
caller knows its samples' object ids: `Sample.obj`), so no shape depends
on the data and nothing reads the device. Without `n_sym` the branch is
`mixed`: ADD and ADD-S on every row, then a select. `compact` (JAX's
`max_sym_slots`) runs the ADD-S match on K static slots, filled by a
stable argsort of the symmetric rows first, and copies the K results back
over the paired ADD. Each branch is one fixed-shape program, which is what
a CUDA graph can capture.

All coordinate math is broadcast elementwise products and sums in f32,
never `einsum` or `matmul`, so none of it can go through TF32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from plr2_tpu_torch.geometry.quaternion import (normalize_quaternion,
                                                quat_to_matrix_df)
from plr2_tpu_torch.ops.knn import nn_distance


class PoseLossOut(NamedTuple):
    loss: torch.Tensor        # scalar
    dis: torch.Tensor         # (B,) distance of the best-confidence hypothesis
    new_points: torch.Tensor  # (B, N, 3) cloud re-centred by the best pose
    new_target: torch.Tensor  # (B, M, 3) target re-centred by the best pose


def rotate_rows(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Row vectors (..., M, 3) times (..., 3, 3): points @ rot, as
    broadcast products and sums (k = 0, 1, 2 in order)."""
    return (points[..., :, 0, None] * rot[..., None, 0, :]
            + points[..., :, 1, None] * rot[..., None, 1, :]
            + points[..., :, 2, None] * rot[..., None, 2, :])


def transform_hypotheses(pred_r, pred_t, points, model_points):
    """pred_r (B,N,4) raw quaternions, pred_t (B,N,3), points (B,N,3),
    model_points (B,M,3) -> (pred (B,N,M,3) = mp R_i^T + t_i, rot
    (B,N,3,3), t (B,N,3))."""
    rot = quat_to_matrix_df(normalize_quaternion(pred_r))
    t = points + pred_t
    # pred[b,i,j,l] = sum_k mp[b,j,k] rot[b,i,l,k]
    mp = model_points[:, None, :, None, :]               # (B, 1, M, 1, 3)
    r = rot[:, :, None, :, :]                            # (B, N, 1, 3, 3)
    pred = (mp[..., 0] * r[..., 0] + mp[..., 1] * r[..., 1]
            + mp[..., 2] * r[..., 2])
    return pred + t[:, :, None, :], rot, t


def paired_add_mean(rot, t, model_points, target):
    """ADD: mean_j || rot_i mp_j + t_i - target_j || -> (B, N), without the
    (B, N, M, 3) hypothesis tensor: per output axis a chain of broadcast
    products and sums over (B, N, M), then the safe norm and the mean."""
    d2 = None
    for axis in range(3):
        p = (model_points[..., None, :, 0] * rot[..., :, None, axis, 0]
             + model_points[..., None, :, 1] * rot[..., :, None, axis, 1]
             + model_points[..., None, :, 2] * rot[..., :, None, axis, 2]
             + t[..., :, None, axis] - target[..., None, :, axis])
        d2 = p * p if d2 is None else d2 + p * p
    positive = d2 > 0
    return (torch.sqrt(torch.where(positive, d2, torch.ones_like(d2)))
            * positive).mean(-1)


def is_symmetric(idx: torch.Tensor, sym_list: Sequence[int]) -> torch.Tensor:
    """(B,) bool: the rows whose object is in `sym_list` (compared with
    Python ints: no host constant to copy, so a graph can capture it)."""
    out = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    for s in sym_list:
        out = out | (idx == int(s))
    return out


def loss_branch(batch: int, n_sym: Optional[int], refine: bool,
                sym_list: Sequence[int],
                max_sym_slots: Optional[int] = None) -> str:
    """JAX's case select of `pose_loss`, on host values: `n_sym` is the
    batch's count of symmetric samples, None where the caller does not
    know it (then `mixed`, which is right for any batch)."""
    if refine or len(sym_list) == 0 or n_sym == 0:
        return "add_all"
    if n_sym is None:
        return "mixed"
    if n_sym == batch:
        return "adds_all"
    if max_sym_slots is not None and 0 < max_sym_slots < batch \
            and n_sym <= max_sym_slots:
        return "compact"
    return "mixed"


def _adds_mean(pred_r, pred_t, points, model_points, target, use_kernels):
    """ADD-S per hypothesis (R, N): one match launch over the R rows."""
    pred, _, _ = transform_hypotheses(pred_r, pred_t, points, model_points)
    return nn_distance(pred, target, use_kernel=use_kernels).mean(-1)


def pose_loss(pred_r, pred_t, pred_c, target, model_points, idx, points,
              w: float, refine: bool, sym_list: Sequence[int],
              use_kernels: bool = True, max_sym_slots: Optional[int] = None,
              n_sym: Optional[int] = None) -> PoseLossOut:
    """pred_r (B,N,4), pred_t (B,N,3), pred_c (B,N,1), target (B,M,3),
    model_points (B,M,3), idx (B,), points (B,N,3) -> PoseLossOut.
    `n_sym` (a host int) and `max_sym_slots` pick the ADD-S branch
    (`loss_branch`); `use_kernels=False` runs the match through the
    kernel's plain twin."""
    # metric math is f32 whatever the network's dtype
    pred_r, pred_t, pred_c, target, model_points, points = (
        x.float() for x in (pred_r, pred_t, pred_c, target, model_points,
                            points))
    b = pred_r.shape[0]
    rot = quat_to_matrix_df(normalize_quaternion(pred_r))  # (B, N, 3, 3)
    t_cand = points + pred_t
    c = pred_c[..., 0]

    branch = loss_branch(b, n_sym, refine, sym_list, max_sym_slots)
    if branch == "adds_all":
        dis = _adds_mean(pred_r, pred_t, points, model_points, target,
                         use_kernels)
    else:
        dis = paired_add_mean(rot, t_cand, model_points, target)  # (B, N)
    if branch == "mixed":
        adds = _adds_mean(pred_r, pred_t, points, model_points, target,
                          use_kernels)
        dis = torch.where(is_symmetric(idx, sym_list)[:, None], adds, dis)
    elif branch == "compact":
        # the symmetric rows first (stable), then the rest, cut at K slots
        is_sym = is_symmetric(idx, sym_list)
        prio = (~is_sym).long() * b + torch.arange(b, device=idx.device)
        order = torch.argsort(prio, stable=True)[:max_sym_slots]
        rows = [x.index_select(0, order) for x in
                (pred_r, pred_t, points, model_points, target, is_sym, dis)]
        adds = _adds_mean(*rows[:5], use_kernels)
        upd = torch.where(rows[5][:, None], adds, rows[6])
        dis = dis.index_copy(0, order, upd)

    c_safe = torch.clamp(c, min=1e-12)
    loss = (dis * c - w * torch.log(c_safe)).mean()

    which = torch.argmax(c, dim=-1)  # (B,), first index on ties
    rows_b = torch.arange(c.shape[0], device=c.device)
    best_t = t_cand[rows_b, which]       # (B, 3)
    best_rot = rot[rows_b, which]        # (B, 3, 3)
    best_dis = dis[rows_b, which]        # (B,)
    with torch.no_grad():
        new_points = rotate_rows(points - best_t[:, None, :], best_rot)
        new_target = rotate_rows(target - best_t[:, None, :], best_rot)
    return PoseLossOut(loss=loss, dis=best_dis, new_points=new_points,
                       new_target=new_target)
