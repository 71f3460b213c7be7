"""Best hypothesis and iterative refinement, the port of
plr2_tpu/refine/iterative.py (the JAX `lax.scan` becomes a Python loop)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from plr2_tpu_torch.geometry.pointcloud import compose_pose, recenter_points
from plr2_tpu_torch.geometry.quaternion import normalize_quaternion


def initial_pose(pred_r, pred_t, pred_c, points) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-confidence hypothesis -> (q (B, 4), t (B, 3)).

    which = argmax(pred_c) (the first index wins ties); t = points[which] +
    pred_t[which]; q = the normalized pred_r row.
    """
    which = torch.argmax(pred_c[..., 0], dim=-1)  # (B,)

    def take(a):
        idx = which.reshape(-1, 1, 1).expand(-1, 1, a.shape[-1])
        return torch.gather(a, 1, idx)[:, 0]

    return normalize_quaternion(take(pred_r)), take(points) + take(pred_t)


def iterative_refine(refiner_fn: Callable, cloud, emb, obj, q0, t0,
                     num_iterations: int):
    """`num_iterations` steps of: new_cloud = (cloud - t) @ R(q); (dq, dt) =
    refiner(new_cloud, emb, obj); (q, t) <- (q, t) composed with (dq, dt).
    Each operation sees the dtypes it sees in JAX: with a bf16 refiner, q
    stays bf16 and t (f32 + bf16) stays f32."""
    q, t = q0, t0
    for _ in range(num_iterations):
        dq, dt = refiner_fn(recenter_points(cloud, q, t), emb, obj)
        q, t = compose_pose(q, t, normalize_quaternion(dq[:, 0]), dt[:, 0])
    return q, t
