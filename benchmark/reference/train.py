"""Plain reference of DenseFusion's stage-1 training step (upstream
lib/loss.py `loss_calculation` and tools/train.py), in float32 autograd.

- The loss: every point's hypothesis (its normalised quaternion, and
  the point plus its predicted offset) applied to the model points; ADD,
  the mean distance to the paired target points, or for symmetric
  objects ADD-S, the mean distance to the nearest target point (the
  match held constant in the backward, as upstream's KNN extension
  does); loss = mean over the batch and points of dis * c - w log c.
- The step: BatchNorm on the batch's statistics and the channel dropouts'
  keep masks, drawn from the step's generator as the training contract
  draws them (`dropout_masks`); gradients by autograd; Adam (0.9, 0.999,
  1e-8). A batch step takes the batch's mean loss; a window of batch-1
  samples sums their gradients, then one Adam step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from benchmark.reference import model as M

TRAINABLE = ("weight", "bias", "bn_weight", "bn_bias", "prelu")
KEEP_CHANNELS = (1024, 256, 64)


def dropout_masks(generator: torch.Generator, batch: int):
    """The three (batch, C) keep masks of one forward: a uniform draw per
    sample and channel for drop_1, drop_2a and drop_2b in turn."""
    out = []
    for c, rate in zip(KEEP_CHANNELS, M.DROPOUT_RATES):
        u = torch.rand((batch, 1, 1, c), generator=generator,
                       device=generator.device)
        out.append((u < 1.0 - rate).reshape(batch, c))
    return out


def _rotations(pred_r):
    return M.quat_matrix(M.unit(pred_r))  # (B, N, 3, 3)


def hypothesis_points(pred_r, pred_t, points, model_points):
    """(B, N, M, 3): model point j under hypothesis i."""
    rot = _rotations(pred_r)
    return (torch.einsum("bmk,bnjk->bnmj", model_points, rot)
            + (points + pred_t)[:, :, None])


def nearest(pred, target, chunk: int = 100):
    """For one sample: pred (N, M, 3), target (M2, 3) -> the nearest target
    point of each prediction (N, M, 3), without gradient (first index on
    ties)."""
    out = []
    with torch.no_grad():
        for i in range(0, pred.shape[0], chunk):
            p = pred[i:i + chunk]
            d2 = ((p[:, :, None, 0] - target[None, None, :, 0]) ** 2
                  + (p[:, :, None, 1] - target[None, None, :, 1]) ** 2) \
                + (p[:, :, None, 2] - target[None, None, :, 2]) ** 2
            out.append(target[d2.argmin(-1)])
    return torch.cat(out)


def pose_loss(pred_r, pred_t, pred_c, target, model_points, idx, points,
              w: float, sym_list: Sequence[int]):
    """-> (loss, dis (B, N))."""
    pred = hypothesis_points(pred_r, pred_t, points, model_points)
    rows = []
    for b in range(pred.shape[0]):
        if int(idx[b]) in set(sym_list):
            goal = nearest(pred[b], target[b])
        else:
            goal = target[b][None]
        rows.append((pred[b] - goal).norm(dim=-1).mean(-1))
    dis = torch.stack(rows)
    loss = (dis * pred_c - w * torch.log(pred_c.clamp_min(1e-12))).mean()
    return loss, dis


def trainable(shapes) -> List[str]:
    return [n for n, _, kind in shapes if kind in TRAINABLE]


def forward_loss(p, batch: Dict, masks, num_obj, w, sym_list,
                 prec: M.Precision = M.FULL):
    pred_r, pred_t, pred_c, _ = M.posenet(
        p, batch["img"], batch["points"], batch["choose"], batch["idx"],
        num_obj, train=True, masks=masks, prec=prec)
    loss, _ = pose_loss(pred_r, pred_t, pred_c, batch["target"],
                        batch["model_points"], batch["idx"],
                        batch["points"], w, sym_list)
    return loss


def train(state: Dict, names: List[str], batches: List[Dict],
          masks: List, num_obj: int, w: float, lr: float,
          sym_list: Sequence[int], window: bool,
          prec: M.Precision = M.FULL):
    """Run len(batches) steps from `state` (a PoseNet state dict). Returns
    (losses: per step a list (one loss a batch step, one a window
    sample), first gradients {name: tensor}, final parameters)."""
    p = {n: t.detach().clone() for n, t in state.items()}
    params = [p[n].requires_grad_(True) for n in names]
    m = [torch.zeros_like(x) for x in params]
    v = [torch.zeros_like(x) for x in params]
    losses, first = [], None
    b1, b2, eps = 0.9, 0.999, 1e-8
    for s, (batch, mk) in enumerate(zip(batches, masks), start=1):
        if window:
            grads = [torch.zeros_like(x) for x in params]
            step_losses = []
            for i in range(batch["idx"].shape[0]):
                one = {k: x[i:i + 1] for k, x in batch.items()}
                loss = forward_loss(p, one, [x[i:i + 1] for x in mk],
                                    num_obj, w, sym_list, prec)
                for g, gi in zip(grads, torch.autograd.grad(loss, params)):
                    g += gi
                step_losses.append(float(loss.detach()))
        else:
            loss = forward_loss(p, batch, mk, num_obj, w, sym_list, prec)
            grads = torch.autograd.grad(loss, params)
            step_losses = [float(loss.detach())]
        losses.append(step_losses)
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        with torch.no_grad():
            for x, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vi.sqrt() / math.sqrt(1 - b2 ** s)).add_(eps)
                x.addcdiv_(mi, denom, value=-lr / (1 - b1 ** s))
    return losses, first, {n: p[n].detach() for n in names}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip=frozenset()) -> float:
    """The worst leaf's gap between two norms: |prog - ref| over the larger
    of the reference's norm of that leaf and the median leaf's."""
    keys = [k for k in ref if k not in skip]
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)
