"""Seeded synthetic RGB-D frames with known poses: a frozen copy of the
program's `data/synthetic.py` (box and knobbed-box surface models, posed,
projected through a pinhole camera and z-buffer splatted into depth,
label and colour), so the traffic does not move when the program does.
One addition: each model point carries a fixed colour offset (a texture
drawn from the frame seed and the object id), so the colour encoder sees
texture inside an object and not one flat colour.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


def random_rotation(rand: np.ndarray) -> np.ndarray:
    """A uniform random rotation from three uniforms (Shoemake)."""
    r1, r2 = np.sqrt(1.0 - rand[0]), np.sqrt(rand[0])
    t1, t2 = 2 * math.pi * rand[1], 2 * math.pi * rand[2]
    w, x, y, z = (np.cos(t2) * r2, np.sin(t1) * r1, np.cos(t1) * r1,
                  np.sin(t2) * r2)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def box_model_points(n: int, extent, seed: int) -> np.ndarray:
    """~n points uniformly on the surface of a box centred at the origin
    (half-extents `extent`)."""
    rng = np.random.default_rng(seed)
    ex, ey, ez = extent
    areas = np.array([ey * ez, ey * ez, ex * ez, ex * ez, ex * ey, ex * ey])
    counts = np.maximum((areas / areas.sum() * n).astype(int), 1)
    pts = []
    for face, cnt in enumerate(counts):
        u, v = rng.uniform(-1, 1, cnt), rng.uniform(-1, 1, cnt)
        axis, sign = face // 2, 1.0 if face % 2 == 0 else -1.0
        p = np.empty((cnt, 3))
        if axis == 0:
            p[:, 0], p[:, 1], p[:, 2] = sign * ex, u * ey, v * ez
        elif axis == 1:
            p[:, 1], p[:, 0], p[:, 2] = sign * ey, u * ex, v * ez
        else:
            p[:, 2], p[:, 0], p[:, 1] = sign * ez, u * ex, v * ey
        pts.append(p)
    out = np.concatenate(pts)[:n]
    if len(out) < n:
        out = np.pad(out, ((0, n - len(out)), (0, 0)), mode="wrap")
    return out.astype(np.float32)


def knobbed_box_model_points(n: int, extent, seed: int) -> np.ndarray:
    """A box with a knob near one corner of its +x face: no rotation of
    the box maps it onto itself (an asymmetric object)."""
    rng = np.random.default_rng(seed)
    base = box_model_points(n - n // 6, extent, seed)
    ex, ey, ez = extent
    k = n - len(base)
    phi = rng.uniform(0, 2 * np.pi, k)
    cos_th = rng.uniform(0, 1, k)
    sin_th = np.sqrt(1 - cos_th ** 2)
    rad = 0.35 * ey
    knob = np.stack([ex + rad * cos_th,
                     0.5 * ey + rad * sin_th * np.cos(phi),
                     0.5 * ez + rad * sin_th * np.sin(phi)], axis=1)
    return np.concatenate([base, knob]).astype(np.float32)


def make_model_library(num_objects: int, mesh_points: int, seed: int,
                       sym_ids=(), extent=(0.03, 0.065)) -> Dict[int, np.ndarray]:
    """1-based id -> (mesh_points, 3) model: plain boxes for the symmetric
    ids, knobbed boxes for the rest."""
    rng = np.random.default_rng(seed)
    lib = {}
    for i in range(1, num_objects + 1):
        ext = tuple(rng.uniform(*extent, 3))
        maker = box_model_points if i in sym_ids else knobbed_box_model_points
        lib[i] = maker(mesh_points, ext, seed * 100 + i)
    return lib


def render_frame(objects: Dict[int, np.ndarray],
                 poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
                 intr: Dict[str, float], img_h: int, img_w: int,
                 seed: int, densify: int = 12):
    """Z-buffer splat each posed model -> (color uint8 (H, W, 3), depth
    uint16 (H, W) raw units, label int32 (H, W))."""
    rng = np.random.default_rng(seed)
    zbuf = np.full((img_h, img_w), np.inf)
    label = np.zeros((img_h, img_w), np.int32)
    color = np.full((img_h, img_w, 3), 30, np.uint8)
    for obj_id, mp in objects.items():
        r, t = poses[obj_id]
        jit = rng.normal(scale=0.004, size=(densify, *mp.shape))
        world = (mp[None] + jit).reshape(-1, 3) @ r.T + t
        z = world[:, 2]
        ok = z > 1e-6
        u = np.round(world[ok, 0] / z[ok] * intr["fx"] + intr["cx"]).astype(int)
        v = np.round(world[ok, 1] / z[ok] * intr["fy"] + intr["cy"]).astype(int)
        zz = z[ok]
        inb = (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
        u, v, zz = u[inb], v[inb], zz[inb]
        order = np.argsort(-zz)  # far first, near overwrite
        u, v, zz = u[order], v[order], zz[order]
        closer = zz < zbuf[v, u] + 1e-9
        u, v, zz = u[closer], v[closer], zz[closer]
        zbuf[v, u] = zz
        label[v, u] = obj_id
        base = np.array([(obj_id * 67) % 200 + 55, (obj_id * 131) % 200 + 55,
                         (obj_id * 29) % 200 + 55], np.int64)
        tex = np.random.default_rng(seed * 1000 + obj_id).integers(
            -40, 41, size=(len(mp), 3))
        tex = np.broadcast_to(tex, (densify, *tex.shape)).reshape(-1, 3)
        tex = tex[ok][inb][order][closer]
        color[v, u] = np.clip(base + tex, 0, 255).astype(np.uint8)
    depth = np.where(np.isfinite(zbuf), zbuf * intr["cam_scale"], 0.0)
    return color, np.clip(depth, 0, 65535).astype(np.uint16), label
