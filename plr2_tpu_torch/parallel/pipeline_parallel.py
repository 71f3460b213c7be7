"""Pipeline parallelism over the refinement iterations (a `pipe` mesh
axis), the port of plr2_tpu/parallel/pipeline_parallel.py.

The estimate's only sequential dependency is the iterative refiner. With
K ranks on a `pipe` axis, stage d runs refinement iteration d (or
`iters_per_stage` consecutive ones): at tick t it refines micro-batch
t - d, and the composed pose moves one stage on. The per-micro-batch
context (cloud, embedding, object ids, initial pose) is on every rank;
only the pose travels. The hand-off is JAX's `ppermute`, written as an
exact gather (`Axis.all_gather`: every stage's pose in its slot) from
which stage d + 1 reads stage d's; the last stage keeps the finished
poses, which a final gather hands to every rank. Each stage's arithmetic
is `refine.iterative.iterative_refine`'s, so the result is the
single-device refinement's. The only overhead is the (K - 1)-tick fill and
drain. As in JAX there is no pipelined training step: the refine stage's
loss is stopped between iterations, so a training ring would only be data
parallelism over the iterations plus the bubble.

`make_pp_estimate_step` runs PoseNet batch-split over the same ranks (the
pipe axis doubles as a data axis there), gathers what the ring needs, and
streams `num_micro` micro-batches through it. With `batch_axis` each
micro-batch is also split over that axis (a (data, pipe) composition):
each data rank runs its own ring over its rows, and the poses are
gathered over it at the end.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from plr2_tpu_torch.pipeline import PoseEstimate, full_f32
from plr2_tpu_torch.refine.iterative import initial_pose, iterative_refine


def _gather_dim1(axis, x: torch.Tensor) -> torch.Tensor:
    """The blocks of dim 1 split over `axis`, joined back in order."""
    parts = axis.all_gather(x)  # (K, M, rows, ...)
    return parts.transpose(0, 1).reshape((x.shape[0], -1) + tuple(x.shape[2:]))


def make_pp_refine(refiner: Callable, mesh, num_micro: int, axis: str = "pipe",
                   iters_per_stage: int = 1, batch_axis: Optional[str] = None):
    """Pipelined refinement over `mesh.shape[axis]` stages of
    `iters_per_stage` iterations each. `refiner(cloud, emb, obj) -> (dq,
    dt)` is the refiner call (`DenseFusionPipeline.run_refiner`).

    Returns fn(clouds, embs, objs, q0s, t0s) -> (q, t) over stacked
    micro-batches: clouds (num_micro, mb, N, 3), embs (num_micro, mb, N,
    E), objs (num_micro, mb), q0s (num_micro, mb, 4), t0s (num_micro, mb,
    3) -> (num_micro, mb, 4) and (num_micro, mb, 3), the same on every
    rank. With `batch_axis` the mb rows are split over that axis."""
    ax = mesh.axis(axis)
    bax = None if batch_axis is None else mesh.axis(batch_axis)
    stages, d = ax.size, ax.index

    @torch.no_grad()
    def pp_fn(clouds, embs, objs, q0s, t0s):
        if bax is not None:
            rows = bax.block(clouds.shape[1], "the micro-batch")
            clouds, embs, objs, q0s, t0s = (x[:, rows] for x in
                                            (clouds, embs, objs, q0s, t0s))
        q_in = t_in = None
        qbuf, tbuf = torch.zeros_like(q0s), torch.zeros_like(t0s)
        for tick in range(num_micro + stages - 1):
            m = tick - d  # the micro-batch at this stage on this tick
            if 0 <= m < num_micro:
                q, t = (q0s[m], t0s[m]) if d == 0 else (q_in, t_in)
                q, t = iterative_refine(refiner, clouds[m], embs[m], objs[m],
                                        q, t, iters_per_stage)
                if d == stages - 1:
                    qbuf[m], tbuf[m] = q, t
            else:
                q, t = torch.zeros_like(q0s[0]), torch.zeros_like(t0s[0])
            # ppermute (d -> d + 1): every stage's pose in its slot
            qs, ts = ax.all_gather(q), ax.all_gather(t)
            if d > 0:
                q_in, t_in = qs[d - 1], ts[d - 1]
        # only the last stage holds finished poses
        q, t = ax.all_gather(qbuf)[-1], ax.all_gather(tbuf)[-1]
        if bax is not None:
            q, t = _gather_dim1(bax, q), _gather_dim1(bax, t)
        return q, t

    return pp_fn


def make_pp_estimate_step(pipe, mesh, num_micro: int, axis: str = "pipe",
                          iters_per_stage: int = 1,
                          batch_axis: Optional[str] = None):
    """`step(img, cloud, choose, obj) -> PoseEstimate` with
    `pipe.estimate(..., refine_iterations=stages * iters_per_stage)`
    semantics; every rank passes the whole batch, whose size must divide
    into `num_micro` micro-batches (and each into the `batch_axis` size),
    and gets the whole result. PoseNet runs batch-split over the ranks of
    `axis` (and `batch_axis`); the refinement streams through the ring."""
    ax = mesh.axis(axis)
    bax = None if batch_axis is None else mesh.axis(batch_axis)
    refine = make_pp_refine(pipe.run_refiner, mesh, num_micro, axis,
                            iters_per_stage, batch_axis)

    def gather(x):  # PoseNet's blocks: batch-axis major, pipe minor
        x = ax.gather_rows(x)
        return x if bax is None else bax.gather_rows(x)

    @torch.no_grad()
    def step(img, cloud, choose, obj) -> PoseEstimate:
        b = img.shape[0]
        if b % num_micro:
            raise ValueError(
                f"pipelined refinement needs the batch to divide into "
                f"microbatches: B={b}, num_micro={num_micro}")
        if bax is not None and (b // num_micro) % bax.size:
            raise ValueError(
                f"composed data sharding needs the microbatch to divide by "
                f"the '{bax.name}' axis: mb={b // num_micro}, K={bax.size}")
        blocks = ax.size * (1 if bax is None else bax.size)
        if b % blocks:
            raise ValueError(f"PoseNet's batch split needs B={b} to divide "
                             f"by {blocks} ranks")
        k = b // blocks
        i = ax.index + (0 if bax is None else bax.index * ax.size)
        rows = slice(i * k, (i + 1) * k)
        with full_f32(pipe.dtype == torch.float32):
            pred_r, pred_t, pred_c, emb = pipe.run_posenet(
                img[rows], cloud[rows], choose[rows], obj[rows])
            q0, t0 = initial_pose(pred_r, pred_t, pred_c, cloud[rows])
            q0, t0, emb = gather(q0), gather(t0), gather(emb)
            conf = gather(pred_c[..., 0].amax(-1))

            def split(x):
                return x.reshape((num_micro, -1) + tuple(x.shape[1:]))
            q, t = refine(split(cloud), split(emb), split(obj), split(q0),
                          split(t0))
        return PoseEstimate(quat=q.reshape(b, 4), trans=t.reshape(b, 3),
                            confidence=conf)
    return step
