"""This package's own copy of plr2_tpu/geometry/transformations.py.

Host-side (NumPy) transform helpers with the Gohlke `transformations.py`
API subset the reference actually uses (upstream lib/transformations.py is
~1900 LoC of which the datasets/eval use a handful of functions — SURVEY.md
section 2 #10). The implementations follow the standard public-domain
quaternion/Euler numeric recipes (e.g. `quaternion_matrix` uses the usual
normalized-outer-product formulation that Gohlke's module also uses); the
module is a from-scratch subset, not a vendored copy of the 1900-line file.

Conventions match Gohlke: quaternions are (w, x, y, z); `quaternion_matrix`
returns a 4x4 homogeneous matrix.
"""

from __future__ import annotations

import math

import numpy as np

_EPS = np.finfo(float).eps * 4.0


def quaternion_matrix(quaternion):
    """4x4 homogeneous rotation matrix from a wxyz quaternion."""
    q = np.array(quaternion, dtype=np.float64, copy=True)
    n = np.dot(q, q)
    if n < _EPS:
        return np.identity(4)
    q *= math.sqrt(2.0 / n)
    q = np.outer(q, q)
    w, x, y, z = 0, 1, 2, 3
    m = np.identity(4)
    m[0, 0] = 1.0 - q[y, y] - q[z, z]
    m[0, 1] = q[x, y] - q[z, w]
    m[0, 2] = q[x, z] + q[y, w]
    m[1, 0] = q[x, y] + q[z, w]
    m[1, 1] = 1.0 - q[x, x] - q[z, z]
    m[1, 2] = q[y, z] - q[x, w]
    m[2, 0] = q[x, z] - q[y, w]
    m[2, 1] = q[y, z] + q[x, w]
    m[2, 2] = 1.0 - q[x, x] - q[y, y]
    return m


def quaternion_from_matrix(matrix):
    """wxyz quaternion from a rotation matrix (3x3 or 4x4)."""
    m = np.array(matrix, dtype=np.float64, copy=False)[:3, :3]
    tr = np.trace(m)
    if tr > 0.0:
        s = math.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0.0:
        q = -q
    return q / np.linalg.norm(q)


def quaternion_multiply(q1, q0):
    """Hamilton product of wxyz quaternions."""
    w0, x0, y0, z0 = q0
    w1, x1, y1, z1 = q1
    return np.array(
        [
            w1 * w0 - x1 * x0 - y1 * y0 - z1 * z0,
            w1 * x0 + x1 * w0 + y1 * z0 - z1 * y0,
            w1 * y0 - x1 * z0 + y1 * w0 + z1 * x0,
            w1 * z0 + x1 * y0 - y1 * x0 + z1 * w0,
        ]
    )


def euler_matrix(ai, aj, ak, axes="sxyz"):
    """4x4 homogeneous matrix from Euler angles (static xyz only)."""
    if axes != "sxyz":
        raise NotImplementedError("only 'sxyz' is used by the pipeline")
    si, sj, sk = math.sin(ai), math.sin(aj), math.sin(ak)
    ci, cj, ck = math.cos(ai), math.cos(aj), math.cos(ak)
    rx = np.array([[1, 0, 0], [0, ci, -si], [0, si, ci]])
    ry = np.array([[cj, 0, sj], [0, 1, 0], [-sj, 0, cj]])
    rz = np.array([[ck, -sk, 0], [sk, ck, 0], [0, 0, 1]])
    m = np.identity(4)
    m[:3, :3] = rz @ ry @ rx
    return m


def quaternion_from_euler(ai, aj, ak, axes="sxyz"):
    return quaternion_from_matrix(euler_matrix(ai, aj, ak, axes))


def random_quaternion(rand=None):
    """Uniform random unit quaternion (Shoemake)."""
    if rand is None:
        rand = np.random.rand(3)
    r1 = math.sqrt(1.0 - rand[0])
    r2 = math.sqrt(rand[0])
    t1 = 2.0 * math.pi * rand[1]
    t2 = 2.0 * math.pi * rand[2]
    return np.array(
        [math.cos(t2) * r2, math.sin(t1) * r1, math.cos(t1) * r1, math.sin(t2) * r2]
    )


def random_rotation_matrix(rand=None):
    return quaternion_matrix(random_quaternion(rand))
