"""Point-axis (sequence) parallelism over a `points` mesh axis, the port of
plr2_tpu/parallel/point_parallel.py.

The model's "sequence" is the sampled cloud: per-point work is pointwise,
and only two operations cross points, the trunks' global mean pool and
the ADD-S nearest-target match. Both split over the axis:

- `sp_chamfer` splits the TARGET cloud: each rank matches every query
  against its contiguous block of targets with `ops.knn.nn_match` (kernel
  4 on the card), computes the matched target's d2 in the kernel's own
  arithmetic, and the ranks' (d2, coordinates) are gathered exactly; the
  least d2 wins, the lowest rank on ties, which over contiguous blocks is
  the global first argmin. So the matched coordinates are bit-equal to
  `nn_match` on the whole target, and the distance and its gradient are
  `nn_distance`'s (the norm of the difference, the match held constant;
  the target gets no gradient). A target that does not divide is padded
  by repeating its first row (`_pad_wrap`), at the highest indices, which
  changes no first argmin.
- `make_sp_inference_step` / `make_sp_train_step` split the SAMPLED cloud
  and `choose`: every rank holds the whole crops, runs the whole CNN and
  its block of the points through the trunk, whose global means are means
  over the axis (`models/posenet.py` `points_axis`), and the heads. The
  best-confidence hypothesis is each rank's first argmax, then the highest
  of the ranks' (the lowest rank on ties: the global first argmax).

Training. Each rank's loss is the mean over its block of points; the
global loss is their mean. A rank backpropagates its loss divided by the
axis size through the means over the axis (whose backward sums the
gradients over the axis), and the parameters' gradients are then summed
over the axis, which gives the single-device gradient; the refine stage's
loss is the same on every rank and goes the same way. The refine stage's
handoff (cloud and target re-centred by the best hypothesis) uses the
cross-rank selection above, outside autograd, as the reference detaches
it. With `data_axis` the batch is also split over that axis, as in JAX:
BatchNorm's statistics and the gradients are then averaged over it too.
Every rank draws the global batch's dropout masks from the same generator
and keeps its block of them, so the masks are the single-device step's
(JAX folds the data shard's index into its key instead: the port draws
from `torch.Generator`s and cannot run threefry).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence

import torch

from plr2_tpu_torch.losses.add_loss import pose_loss, rotate_rows
from plr2_tpu_torch.losses.refine_loss import refine_loss
from plr2_tpu_torch.geometry.quaternion import quat_to_matrix_df
from plr2_tpu_torch.models.resnet import synced_statistics
from plr2_tpu_torch.ops.knn import nn_match, safe_norm
from plr2_tpu_torch.parallel.data_parallel import (BATCH_KEYS, adam,
                                                   count_symmetric,
                                                   deterministic_convs)
from plr2_tpu_torch.parallel.mesh import shard_batch
from plr2_tpu_torch.pipeline import PoseEstimate, full_f32
from plr2_tpu_torch.refine.iterative import initial_pose, iterative_refine


def _pad_wrap(target: torch.Tensor, k: int) -> torch.Tensor:
    """The target cloud padded to a multiple of k by repeating its first
    row (at the highest indices: no first argmin changes)."""
    pad = (-target.shape[0]) % k
    if pad == 0:
        return target
    return torch.cat([target, target[:1].expand((pad,) + target.shape[1:])], 0)


def _d2(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """((dx*dx + dy*dy) + dz*dz) of q - t, the knn kernel's d2."""
    d = q - t
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def sp_match(mesh, queries: torch.Tensor, target: torch.Tensor,
             axis: str = "points") -> torch.Tensor:
    """(P, 3) queries, (M2, 3) targets -> (P, 3): `nn_match`'s coordinates
    bit for bit, with the targets split over `axis` (module docstring).
    Every rank passes the same queries and the whole target."""
    ax = mesh.axis(axis)
    target = _pad_wrap(target.float(), ax.size)
    block = target[ax.block(target.shape[0], "the padded target")].contiguous()
    q = queries.float().contiguous()
    local = nn_match(q, block)
    both = ax.all_gather(torch.cat([_d2(q, local)[:, None], local], 1))
    winner = torch.argmin(both[..., 0], dim=0)  # the first: the lowest rank
    return both[winner, torch.arange(q.shape[0], device=q.device), 1:]


def sp_chamfer(mesh, pred: torch.Tensor, target: torch.Tensor,
               axis: str = "points") -> torch.Tensor:
    """(H, M, 3), (M2, 3) -> (H, M) nearest-target distances, with the
    target cloud split over `axis`: `ops.knn.nn_distance`'s value and
    gradient (the match held constant; no gradient into the target)."""
    matched = sp_match(mesh, pred.detach().reshape(-1, 3), target.detach(),
                       axis)
    return safe_norm(pred - matched.reshape(pred.shape))


@contextlib.contextmanager
def points_axis(pipe, axis):
    """Within the block both trunks of `pipe` pool over `axis`."""
    feats = (pipe.posenet.feat, pipe.refiner.feat)
    for f in feats:
        f.points_axis = axis
    try:
        yield
    finally:
        for f in feats:
            f.points_axis = None


def best_hypothesis(axis, pred_r, pred_t, pred_c, points):
    """`refine.iterative.initial_pose` over a cloud split on `axis`:
    (q0, t0, the best confidence), the global first argmax's."""
    q, t = initial_pose(pred_r, pred_t, pred_c, points)
    conf = pred_c[..., 0].amax(-1)
    confs, qs, ts = (axis.all_gather(x) for x in (conf, q, t))
    win = torch.argmax(confs, dim=0)  # the first: the lowest rank
    rows = torch.arange(win.shape[0], device=win.device)
    return qs[win, rows], ts[win, rows], confs[win, rows]


def _point_block(axis, n: int) -> slice:
    if n % axis.size:
        raise ValueError(f"sequence parallelism needs the point count to "
                         f"divide by the '{axis.name}' axis size: N={n}, "
                         f"K={axis.size}")
    return axis.block(n)


def make_sp_inference_step(pipe, mesh, refine_iterations: int = 2,
                           axis: str = "points"):
    """`step(img, cloud, choose, obj) -> PoseEstimate` with
    `pipe.estimate`'s semantics, the cloud and choose split over `axis`
    (N must divide by its size); every rank passes the whole batch and
    gets the whole result."""
    ax = mesh.axis(axis)

    @torch.no_grad()
    def step(img, cloud, choose, obj) -> PoseEstimate:
        rows = _point_block(ax, cloud.shape[1])
        cloud, choose = cloud[:, rows], choose[:, rows]
        with points_axis(pipe, ax), full_f32(pipe.dtype == torch.float32):
            pred_r, pred_t, pred_c, emb = pipe.run_posenet(img, cloud, choose, obj)
            q0, t0, conf = best_hypothesis(ax, pred_r, pred_t, pred_c, cloud)
            q, t = iterative_refine(pipe.run_refiner, cloud, emb, obj, q0, t0,
                                    refine_iterations)
        return PoseEstimate(quat=q, trans=t, confidence=conf)
    return step


class SPTrainStep:
    """`step(batch, generator) -> {"loss", "dis"}` over the points axis
    (and the data axis), `make_train_step`'s contract: the batch is the
    global batch, the same on every rank."""

    def __init__(self, pipe, mesh, sym_list: Sequence[int], w: float,
                 lr: float, axis: str, sym_slots: Optional[int],
                 refine_iterations: int, data_axis: Optional[str]):
        self.pipe = pipe
        self.mesh = mesh
        self.axis = mesh.axis(axis)
        self.data = None if data_axis is None else mesh.axis(data_axis)
        self.sym_list = tuple(sym_list)
        self.w = w
        self.sym_slots = sym_slots
        self.refine_iterations = refine_iterations
        self.use_kernels = pipe.posenet.use_kernels
        net = pipe.refiner if refine_iterations > 0 else pipe.posenet
        self.network = net
        self.optimizer = adam(net, lr)

    def _local(self, batch: Mapping, generator) -> Dict:
        """This rank's block: rows over the data axis, points over ours."""
        dev = self.pipe.device
        b = {k: torch.as_tensor(batch[k]).to(dev) for k in BATCH_KEYS}
        if "obj" in batch:
            b["obj"] = batch["obj"]
        b["masks"] = None
        if self.refine_iterations == 0:
            masks = self.pipe.posenet.cnn.model.draw_dropout_masks(
                b["idx"].shape[0], generator)
            b["masks"] = tuple(None if m is None else m.to(dev) for m in masks)
        if self.data is not None:
            if b["idx"].shape[0] % self.data.size:
                raise ValueError(
                    f"composed data sharding needs the batch to divide by "
                    f"the '{self.data.name}' axis size: "
                    f"B={b['idx'].shape[0]}, K={self.data.size}")
            b = shard_batch(self.mesh, b, self.data.name)
        rows = _point_block(self.axis, b["points"].shape[1])
        b["points"], b["choose"] = b["points"][:, rows], b["choose"][:, rows]
        return b

    def _stage1(self, b):
        pipe = self.pipe
        pipe.posenet.train()
        with synced_statistics(pipe.posenet, self.data):
            pred_r, pred_t, pred_c, _ = pipe.run_posenet(
                b["img"], b["points"], b["choose"], b["idx"], None, b["masks"])
        out = pose_loss(pred_r, pred_t, pred_c, b["target"], b["model_points"],
                        b["idx"], b["points"], w=self.w, refine=False,
                        sym_list=self.sym_list, use_kernels=self.use_kernels,
                        max_sym_slots=self.sym_slots,
                        n_sym=count_symmetric(b, self.sym_list))
        (out.loss / self.axis.size).backward()
        # the reported distance: the global best-confidence hypothesis's
        confs = self.axis.all_gather(pred_c[..., 0].detach().float().amax(-1))
        dists = self.axis.all_gather(out.dis.detach())
        win = torch.argmax(confs, dim=0)
        dis = dists[win, torch.arange(win.shape[0], device=win.device)].mean()
        loss = self.axis.all_reduce_(out.loss.detach().clone()) / self.axis.size
        return loss, dis

    def _refine(self, b):
        pipe = self.pipe
        pipe.posenet.eval()
        pipe.refiner.train()
        with torch.no_grad():
            pred_r, pred_t, pred_c, emb = pipe.run_posenet(
                b["img"], b["points"], b["choose"], b["idx"])
            points, target = b["points"].float(), b["target"].float()
            q0, t0, _ = best_hypothesis(self.axis, pred_r.float(),
                                        pred_t.float(), pred_c.float(), points)
            rot0 = quat_to_matrix_df(q0)
            new_points = rotate_rows(points - t0[:, None, :], rot0)
            new_target = rotate_rows(target - t0[:, None, :], rot0)
        loss = 0.0
        for _ in range(self.refine_iterations):
            dr, dt = pipe.run_refiner(new_points, emb, b["idx"])
            ro = refine_loss(dr, dt, new_target, b["model_points"], b["idx"],
                             new_points, sym_list=self.sym_list,
                             use_kernels=self.use_kernels)
            new_points, new_target = ro.new_points, ro.new_target
            loss = loss + ro.dis.mean()
        (loss / self.axis.size).backward()
        return loss.detach(), ro.dis.mean().detach()

    def __call__(self, batch: Mapping, generator=None) -> Dict[str, torch.Tensor]:
        b = self._local(batch, generator)
        self.optimizer.zero_grad(set_to_none=True)
        with points_axis(self.pipe, self.axis), deterministic_convs(), \
                full_f32(self.pipe.dtype == torch.float32):
            if self.refine_iterations > 0:
                loss, dis = self._refine(b)
            else:
                loss, dis = self._stage1(b)
        self.pipe.posenet.eval()
        self.pipe.refiner.eval()
        grads = [p.grad for p in self.network.parameters() if p.grad is not None]
        self.axis.all_reduce_tensors_(grads)
        metrics = torch.stack([loss.float(), dis.float()])
        if self.data is not None:
            self.data.all_reduce_tensors_(grads + [metrics], mean=True)
        self.optimizer.step()
        return {"loss": metrics[0], "dis": metrics[1]}


def make_sp_train_step(pipe, mesh, sym_list, w: float, lr: float,
                       axis: str = "points", sym_slots: Optional[int] = None,
                       refine_iterations: int = 0,
                       data_axis: Optional[str] = None) -> SPTrainStep:
    """The train step of `make_train_step` with the sampled cloud split
    over `axis` (and the batch over `data_axis`): stage 1 with
    `refine_iterations=0`, else the refine stage (frozen eval-mode PoseNet,
    gradients into the refiner). Module docstring."""
    return SPTrainStep(pipe, mesh, sym_list, w, lr, axis, sym_slots,
                       refine_iterations, data_axis)
