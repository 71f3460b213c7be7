"""The traffic's inputs, made from the run's seed: frame pools for the
serve cells and sample pools for the training cells.

Scenes are drawn from the configuration (objects, mesh points, symmetric
ids, camera) and the traffic file (objects a frame, canvas, pool size):
distinct object ids a frame, uniform over the configuration's objects,
spread across the view at random rotations, at a distance where an object
`object_span_m` across fills at most the canvas. A frame where a window
would not fit the canvas is drawn again, so every window fits.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.gen import synthetic
from benchmark.reference.frame import (IMAGENET_MEAN, IMAGENET_STD,
                                       snap_bbox)


def camera(cfg: Dict) -> Dict[str, float]:
    return dict(cfg["camera"])


def intr_vec(cfg: Dict) -> np.ndarray:
    c = cfg["camera"]
    return np.array([c["cx"], c["cy"], c["fx"], c["fy"], c["cam_scale"]],
                    np.float32)


def library(cfg: Dict, seed: int) -> Dict[int, np.ndarray]:
    """1-based id -> model points; symmetric objects (0-based indices in
    the configuration) are plain boxes."""
    sym = {i + 1 for i in cfg["symmetric"]}
    return synthetic.make_model_library(cfg["num_objects"], cfg["mesh_points"],
                                        seed % (2 ** 31), tuple(sym))


def _windows(label: np.ndarray, ids, img_h, img_w):
    out = {}
    for i in ids:
        m = label == i
        if not m.any():
            out[i] = None
            continue
        r, c = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
        out[i] = snap_bbox(r[0], r[-1] + 1, c[0], c[-1] + 1, img_h, img_w)
    return out


def draw_frame(rng: np.random.Generator, cfg: Dict, lib, k: int,
               canvas: int, span: float):
    """One frame of k distinct objects whose windows fit the canvas:
    (color, depth uint16, label, ids, poses, render seed)."""
    cam = camera(cfg)
    h, w = cfg["img_h"], cfg["img_w"]
    z0 = cam["fx"] * span / canvas
    while True:
        ids = [int(i) + 1 for i in rng.choice(cfg["num_objects"], k,
                                              replace=False)]
        poses = {}
        for j, i in enumerate(ids):
            z = rng.uniform(z0, z0 + 0.4)
            half_w = z * min(cam["cx"], w - cam["cx"]) / cam["fx"]
            half_h = z * min(cam["cy"], h - cam["cy"]) / cam["fy"]
            lateral = (-1 + 2 * j / (k - 1)) if k > 1 else rng.uniform(-1, 1)
            x = 0.65 * half_w * lateral + rng.uniform(-0.02, 0.02)
            y = rng.uniform(-0.5, 0.5) * half_h
            poses[i] = (synthetic.random_rotation(rng.random(3)),
                        np.array([x, y, z]))
        seed = int(rng.integers(0, 2 ** 31))
        color, depth, label = synthetic.render_frame(
            {i: lib[i] for i in ids}, poses, cam, h, w, seed)
        wins = _windows(label, ids, h, w)
        if all(b is not None and b[1] - b[0] <= canvas
               and b[3] - b[2] <= canvas for b in wins.values()):
            return color, depth, label, ids, poses, wins


def serve_pool(cfg: Dict, traffic: Dict, seed: int) -> Dict[str, np.ndarray]:
    """`pool_frames` frames of `objects_per_frame` objects, as host arrays:
    colors (P, H, W, 3) uint8, depths (P, H, W) f32 raw units, labels
    (P, H, W) int32, obj_ids (P, K) int64, model_points (P, K, M, 3) f32,
    seeds (P,) int64 frame seeds, intr (5,) f32."""
    rng = np.random.default_rng(seed)
    lib = library(cfg, seed)
    p, k = traffic["pool_frames"], traffic["objects_per_frame"]
    frames = [draw_frame(rng, cfg, lib, k, traffic["canvas"],
                         traffic["object_span_m"]) for _ in range(p)]
    return dict(
        colors=np.stack([f[0] for f in frames]),
        depths=np.stack([f[1] for f in frames]).astype(np.float32),
        labels=np.stack([f[2] for f in frames]),
        obj_ids=np.array([f[3] for f in frames], np.int64),
        model_points=np.stack([np.stack([lib[i] for i in f[3]])
                               for f in frames]),
        seeds=rng.integers(0, 2 ** 31, p).astype(np.int64),
        intr=intr_vec(cfg))


def _sample(rng, color, depth, label, obj_id, pose, window, mp, cfg,
            canvas, num_points):
    """One training sample of the object: its crop on the canvas (top-left,
    zero elsewhere), `num_points` mask pixels drawn uniformly (all of them,
    wrap-padded, when fewer), their backprojected cloud, the posed model."""
    cam = cfg["camera"]
    rmin, rmax, cmin, cmax = window
    mask = (label[rmin:rmax, cmin:cmax] == obj_id) & (
        depth[rmin:rmax, cmin:cmax] > 0)
    pix = np.flatnonzero(mask)
    if len(pix) > num_points:
        pix = np.sort(rng.choice(pix, num_points, replace=False))
    else:
        pix = pix[np.arange(num_points) % len(pix)]
    ww = cmax - cmin
    rows, cols = pix // ww, pix % ww
    z = depth[rmin:rmax, cmin:cmax].reshape(-1)[pix] / cam["cam_scale"]
    cloud = np.stack([(cols + cmin - cam["cx"]) * z / cam["fx"],
                      (rows + rmin - cam["cy"]) * z / cam["fy"], z], -1)
    img = np.zeros((canvas, canvas, 3), np.float32)
    img[:rmax - rmin, :ww] = (color[rmin:rmax, cmin:cmax] / 255.0
                              - IMAGENET_MEAN) / IMAGENET_STD
    r, t = pose
    return dict(img=img, points=cloud.astype(np.float32),
                choose=(rows * canvas + cols).astype(np.int64),
                target=(mp @ r.T + t).astype(np.float32),
                model_points=mp, idx=obj_id - 1)


def train_pool(cfg: Dict, traffic: Dict, seed: int, count: int) -> List[Dict]:
    """`count` training samples (NumPy dicts: img, points, choose, target,
    model_points, idx), every object id drawn uniformly, each sample from
    an object with at least `min_sample_pixels` mask pixels."""
    rng = np.random.default_rng(seed)
    lib = library(cfg, seed)
    out: List[Dict] = []
    while len(out) < count:
        color, depth, label, ids, poses, wins = draw_frame(
            rng, cfg, lib, traffic["objects_per_frame"], traffic["canvas"],
            traffic["object_span_m"])
        for i in ids:
            if len(out) == count:
                break
            npix = int(((label == i) & (depth > 0)).sum())
            if npix < traffic["min_sample_pixels"]:
                continue
            out.append(_sample(rng, color, depth, label, i, poses[i],
                               wins[i], lib[i], cfg, traffic["canvas"],
                               cfg["num_points"]))
    return out


def stack(samples: List[Dict]) -> Dict[str, np.ndarray]:
    """Samples -> one batch of arrays with a leading batch axis, and `obj`
    the host object indices."""
    out = {k: np.stack([s[k] for s in samples])
           for k in ("img", "points", "choose", "target", "model_points")}
    out["idx"] = np.array([s["idx"] for s in samples], np.int64)
    out["obj"] = tuple(int(s["idx"]) for s in samples)
    return out
