"""Quaternion utilities (wxyz), the port of plr2_tpu/geometry/quaternion.py.

`quat_to_matrix_df` is the reference loss's `base` matrix R(q) for
ROW-VECTOR point clouds: transformed points are `points @ R(q)`.
"""

from __future__ import annotations

import torch


def normalize_quaternion(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize along the last axis: q / max(|q|, eps)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def quat_to_matrix_df(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) normalized wxyz quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b, wxyz, broadcasting over leading dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Arbitrary-norm wxyz quaternion -> R(q) (normalising first)."""
    return quat_to_matrix_df(normalize_quaternion(q))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion.

    Branch-free Shepperd extraction as in the JAX function: all four
    candidate solutions, selected by the largest pivot (the first on
    ties), halved and normalised.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    def _safe(x):
        return torch.clamp(torch.sqrt(torch.clamp(x, min=0.0)), min=1e-12)

    sw, sx, sy, sz = _safe(qw2), _safe(qx2), _safe(qy2), _safe(qz2)
    cands = torch.stack([
        torch.stack([sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
        torch.stack([(m21 - m12) / sx, sx, (m10 + m01) / sx, (m02 + m20) / sx], -1),
        torch.stack([(m02 - m20) / sy, (m10 + m01) / sy, sy, (m21 + m12) / sy], -1),
        torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m21 + m12) / sz, sz], -1),
    ], -2)  # (..., 4 candidates, 4)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :] * 0.5
    return normalize_quaternion(q)
