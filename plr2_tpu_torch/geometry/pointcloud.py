"""Depth backprojection, pose application, composition and re-centring,
the port of plr2_tpu/geometry/pointcloud.py.

Poses are (q, t) with q a wxyz quaternion; clouds are row-vector (..., N, 3)
arrays. These products touch metric coordinates, so in f32 they must run
in full f32: PyTorch's float32 matmul does unless
`torch.backends.cuda.matmul.allow_tf32` is switched on (the pipeline's f32
mode switches it off). Operands of two dtypes are promoted as jnp.matmul
promotes them (torch.matmul itself refuses mixed dtypes): a bf16 rotation
applied to an f32 cloud gives f32.
"""

from __future__ import annotations

import torch

from plr2_tpu_torch.geometry.quaternion import quat_multiply, quat_to_matrix_df


def backproject_depth(depth, ymap, xmap, cam_cx, cam_cy, cam_fx, cam_fy,
                      cam_scale):
    """Pinhole backprojection of flat (N,) selected pixels -> (N, 3):
    z = depth / cam_scale, x = (xmap - cx) z / fx, y = (ymap - cy) z / fy
    (xmap the column, ymap the row), the JAX function's arithmetic."""
    z = depth / cam_scale
    x = (xmap - cam_cx) * z / cam_fx
    y = (ymap - cam_cy) * z / cam_fy
    return torch.stack([x, y, z], dim=-1)


def transform_points(points, r, t):
    """(..., N, 3) @ r^T + t: the reference's np.dot(points, R.T) + t, as
    broadcast products and sums in the inputs' dtype (never TF32)."""
    out = (points[..., :, 0, None] * r[..., None, :, 0]
           + points[..., :, 1, None] * r[..., None, :, 1]
           + points[..., :, 2, None] * r[..., None, :, 2])
    return out + t[..., None, :]


def apply_pose_quat(points, q, t):
    """Apply the pose of a normalised wxyz quaternion and a translation."""
    return transform_points(points, quat_to_matrix_df(q), t)


def _matmul(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def compose_pose(q_outer, t_outer, q_inner, t_inner):
    """Apply inner first, then outer: R = R_o R_i, t = R_o t_i + t_o."""
    q = quat_multiply(q_outer, q_inner)
    r_outer = quat_to_matrix_df(q_outer)
    t = _matmul(r_outer, t_inner.unsqueeze(-1)).squeeze(-1) + t_outer
    return q, t


def recenter_points(points, q, t):
    """Express `points` in the frame of pose (q, t): (p - t) @ R(q)."""
    return _matmul(points - t.unsqueeze(-2), quat_to_matrix_df(q))
