"""Synthetic RGB-D fixture generator, this package's own NumPy copy of
plr2_tpu/data/synthetic.py (the same frames for the same seeds).

Produces frames with exactly known poses for unit/integration tests and
benchmarks (SURVEY.md section 4): a dense box-surface model point cloud is
posed, projected with the LineMOD-style intrinsics, and z-buffer-splatted
into depth/label/color images. This replaces dataset downloads the same way
the reference's smoke runs rely on real LineMOD frames.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from plr2_tpu_torch.geometry import transformations as tfs

DEFAULT_INTRINSICS = dict(cx=325.26110, cy=242.04899, fx=572.41140,
                          fy=573.57043, cam_scale=1000.0)


def box_model_points(n: int, extent=(0.04, 0.05, 0.06), seed: int = 0) -> np.ndarray:
    """~n points uniformly on the surface of a box centred at origin."""
    rng = np.random.default_rng(seed)
    ex, ey, ez = extent
    areas = np.array([ey * ez, ey * ez, ex * ez, ex * ez, ex * ey, ex * ey])
    counts = np.maximum((areas / areas.sum() * n).astype(int), 1)
    pts: List[np.ndarray] = []
    for face, cnt in enumerate(counts):
        u = rng.uniform(-1, 1, cnt)
        v = rng.uniform(-1, 1, cnt)
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


@dataclasses.dataclass
class SyntheticFrame:
    color: np.ndarray   # (H, W, 3) uint8
    depth: np.ndarray   # (H, W) uint16 raw depth
    label: np.ndarray   # (H, W) int32 object id (0 = background)
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]]  # obj -> (R, t)
    intrinsics: Dict[str, float]


def distinct_palette(num_objects: int) -> Dict[int, np.ndarray]:
    """1-based id -> RGB uint8, maximally separated on an HSV wheel (the
    default id-hash palette below puts ids i and i + 6 close together)."""
    import colorsys

    out = {}
    for i in range(1, num_objects + 1):
        h = (i - 1) / num_objects
        s = 0.85 if i % 2 else 0.55
        v = 0.95 if i % 3 else 0.55
        rgb = colorsys.hsv_to_rgb(h, s, v)
        out[i] = (np.asarray(rgb) * 255).astype(np.uint8)
    return out


def render_frame(
    objects: Dict[int, np.ndarray],
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]],
    img_h: int = 480,
    img_w: int = 640,
    intrinsics: Dict[str, float] | None = None,
    densify: int = 12,
    seed: int = 0,
    colors: Dict[int, np.ndarray] | None = None,
) -> SyntheticFrame:
    """Z-buffer splat each posed model into depth/label/color.

    objects: obj_id -> (M, 3) model points; poses: obj_id -> (R (3,3), t (3,)).
    `densify` replicates each model point with small jitter so the splat
    covers a contiguous pixel region (mask without holes at this resolution).
    """
    intr = dict(DEFAULT_INTRINSICS if intrinsics is None else intrinsics)
    rng = np.random.default_rng(seed)
    zbuf = np.full((img_h, img_w), np.inf, dtype=np.float64)
    label = np.zeros((img_h, img_w), dtype=np.int32)
    color = np.full((img_h, img_w, 3), 30, dtype=np.uint8)

    for obj_id, mp in objects.items():
        r, t = poses[obj_id]
        pts = mp
        if densify > 1:
            jit = rng.normal(scale=0.004, size=(densify, *mp.shape)).astype(np.float32)
            pts = (mp[None] + jit).reshape(-1, 3)
        world = pts @ r.T + t  # row-vector convention, as the datasets
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
        base = (np.asarray(colors[obj_id], np.uint8) if colors is not None
                else np.array([(obj_id * 67) % 200 + 55,
                               (obj_id * 131) % 200 + 55,
                               (obj_id * 29) % 200 + 55], dtype=np.uint8))
        color[v, u] = base

    depth = np.where(np.isfinite(zbuf), zbuf * intr["cam_scale"], 0.0)
    depth = np.clip(depth, 0, 65535).astype(np.uint16)
    return SyntheticFrame(color=color, depth=depth, label=label,
                          poses=dict(poses), intrinsics=intr)


def knobbed_box_model_points(n: int, extent=(0.04, 0.05, 0.06),
                             seed: int = 0) -> np.ndarray:
    """Box surface with a protruding knob near one corner of the +x face.

    A plain cuboid has a 4-element rotational symmetry group (180° about
    each axis) that a flat-colored splat cannot disambiguate — an ADD
    (non-symmetric) metric then has an irreducible floor. The knob breaks
    every one of those symmetries, so objects OUTSIDE the symmetric
    subset are genuinely pose-identifiable from geometry, like the
    asymmetric YCB meshes (config-5 journey, tools/journey_config5.py)."""
    rng = np.random.default_rng(seed)
    base = box_model_points(n - n // 6, extent, seed=seed)
    ex, ey, ez = extent
    k = n - len(base)
    # hemisphere of radius ~0.35*ey sticking out of the +x face corner
    phi = rng.uniform(0, 2 * np.pi, k)
    cos_th = rng.uniform(0, 1, k)
    sin_th = np.sqrt(1 - cos_th**2)
    rad = 0.35 * ey
    knob = np.stack([
        ex + rad * cos_th,
        0.5 * ey + rad * sin_th * np.cos(phi),
        0.5 * ez + rad * sin_th * np.sin(phi),
    ], axis=1).astype(np.float32)
    return np.concatenate([base, knob]).astype(np.float32)


def make_model_library(num_objects: int, model_points: int = 500,
                       seed: int = 0,
                       sym_ids: Tuple[int, ...] = ()) -> Dict[int, np.ndarray]:
    """Fixed 1-based-id model library shared across frames (unlike
    make_scene, which regenerates models per frame): symmetric ids get
    plain boxes (their cuboid symmetry group is real, scored with ADD-S),
    all others get knobbed asymmetric boxes."""
    rng = np.random.default_rng(seed)
    lib = {}
    for i in range(1, num_objects + 1):
        ext = tuple(rng.uniform(0.03, 0.065, 3))
        maker = box_model_points if i in sym_ids else knobbed_box_model_points
        lib[i] = maker(model_points, ext, seed=seed * 100 + i)
    return lib


def make_library_scene(models: Dict[int, np.ndarray],
                       visible_ids, seed: int,
                       img_h: int = 480, img_w: int = 640,
                       intrinsics: Dict[str, float] | None = None,
                       colors: Dict[int, np.ndarray] | None = None
                       ) -> SyntheticFrame:
    """Render a frame of library objects at random poses, spread
    laterally so masks don't fully overlap."""
    rng = np.random.default_rng(seed)
    visible_ids = list(visible_ids)
    poses = {}
    for j, i in enumerate(visible_ids):
        r, t = random_pose(rng)
        if len(visible_ids) > 1:
            t[0] = -0.18 + 0.36 * j / (len(visible_ids) - 1)
        poses[i] = (r, t)
    return render_frame({i: models[i] for i in visible_ids}, poses,
                        img_h=img_h, img_w=img_w, intrinsics=intrinsics,
                        seed=seed, colors=colors)


def random_pose(rng: np.random.Generator,
                z_range=(0.6, 1.1)) -> Tuple[np.ndarray, np.ndarray]:
    r = tfs.random_rotation_matrix(rng.random(3))[:3, :3].astype(np.float32)
    t = np.array([
        rng.uniform(-0.15, 0.15),
        rng.uniform(-0.1, 0.1),
        rng.uniform(*z_range),
    ], dtype=np.float32)
    return r, t


def make_scene(num_objects: int = 1, model_points: int = 500, seed: int = 0,
               img_h: int = 480, img_w: int = 640):
    """Convenience: random boxes + poses -> (frame, models dict)."""
    rng = np.random.default_rng(seed)
    models = {}
    poses = {}
    for i in range(1, num_objects + 1):
        ext = tuple(rng.uniform(0.03, 0.06, 3))
        models[i] = box_model_points(model_points, ext, seed=seed + i)
        # spread objects laterally so masks don't fully overlap
        r, t = random_pose(rng)
        t[0] = -0.15 + 0.3 * (i - 1) / max(1, num_objects - 1) if num_objects > 1 else t[0]
        poses[i] = (r, t)
    frame = render_frame(models, poses, img_h=img_h, img_w=img_w, seed=seed)
    return frame, models
