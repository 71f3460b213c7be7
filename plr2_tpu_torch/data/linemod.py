"""LineMOD dataset loader (13 objects, 500 points), the port of
plr2_tpu/data/linemod.py.

Host side: file decode only (PNG and gt.yml / models_info.yml through
data/codecs.py, which needs neither PIL nor PyYAML; PLY vertex parsing).
Everything after raw arrays runs in the device preprocessing
(data/preprocess.py) or the native data plane (data/prefetch.py).

Layout (upstream Linemod_preprocessed):
  root/data/{obj:02d}/rgb/{frame:04d}.png
  root/data/{obj:02d}/depth/{frame:04d}.png
  root/data/{obj:02d}/mask/{frame:04d}.png
  root/data/{obj:02d}/gt.yml        # cam_R_m2c (9), cam_t_m2c (3, mm), obj_id
  root/data/{obj:02d}/info.yml
  root/data/{obj:02d}/{train,test}.txt
  root/models/obj_{obj:02d}.ply     # vertices in mm
  root/models/models_info.yml       # diameters (mm)

Units: depth images and model PLYs are in millimetres; the pipeline works
in metres (model points / 1000, translation / 1000, and an effective
cam_scale of 1000 on raw depth — equivalent to the reference's
cam_scale=1.0 followed by cloud/1000).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from plr2_tpu_torch.data.codecs import read_png, read_yaml
from plr2_tpu_torch.data.frame_cache import FrameCache

OBJLIST = [1, 2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15]
SYM_OBJ_IDX = (7, 8)  # eggbox (id 10), glue (id 11) in OBJLIST positions
INTRINSICS = dict(cx=325.26110, cy=242.04899, fx=572.41140, fy=573.57043,
                  cam_scale=1000.0)


def parse_ply_vertices(path: str) -> np.ndarray:
    """Minimal ASCII-PLY vertex reader (the reference's ply_vtx contract)."""
    with open(path, "r") as f:
        assert f.readline().strip() == "ply"
        n = 0
        while True:
            line = f.readline().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        pts = np.empty((n, 3), dtype=np.float32)
        for i in range(n):
            vals = f.readline().split()
            pts[i] = [float(vals[0]), float(vals[1]), float(vals[2])]
    return pts


def largest_component_mask(mask: np.ndarray) -> np.ndarray:
    """Largest 8-connected blob of a binary mask.

    The upstream eval crops predicted SegNet masks through mask_to_bbox —
    the bounding rect of the LARGEST cv2 contour (upstream lib/utils and
    datasets/linemod/dataset.py, mode=='eval') — so scattered
    false-positive pixels elsewhere in the frame never inflate the crop
    window. Connected components reproduce that behavior without cv2."""
    from scipy import ndimage

    lab, n = ndimage.label(mask, structure=np.ones((3, 3), dtype=np.int32))
    if n <= 1:
        return mask
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    return lab == sizes.argmax()


def subsample_model_points(pts: np.ndarray, num: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Random subset of `num` model points (reference: random.sample delete)."""
    if len(pts) <= num:
        reps = -(-num // len(pts))
        return np.tile(pts, (reps, 1))[:num]
    keep = rng.choice(len(pts), size=num, replace=False)
    keep.sort()
    return pts[keep]


class LinemodDataset:
    """Index over (object, frame) pairs from the split files."""

    def __init__(self, root: str, mode: str = "train", num_points: int = 500,
                 num_mesh_points: int = 500, add_noise: bool = True,
                 noise_trans: float = 0.03, seed: int = 0,
                 objlist: Optional[List[int]] = None,
                 segnet_results: Optional[str] = None,
                 cache_mb: int = 0):
        """`segnet_results`: directory of predicted masks in the upstream
        eval layout `{segnet_results}/{obj:02d}_label/{frame:04d}_label.png`
        (pixel==255 -> object). When set, get_raw uses these instead of the
        GT masks — the reference's mode=='eval' path (upstream
        datasets/linemod/dataset.py and tools/eval_linemod.py).
        An empty predicted mask marks the sample `lost=True` ("Lost
        detection" in the upstream eval log): the evaluator skips it."""
        self.root = root
        self.mode = mode
        self.segnet_results = segnet_results
        self.num_points = num_points
        self.add_noise = add_noise and mode == "train"
        self.noise_trans = noise_trans
        self.objlist = objlist or OBJLIST
        # bounded LRU over the frame decode (deterministic: color/depth/
        # mask come straight from files); see data/frame_cache.py
        self._frame_cache = FrameCache(cache_mb)
        rng = np.random.default_rng(seed)

        self.items: List[Dict] = []
        self.meta: Dict[int, Dict] = {}
        self.model_points: Dict[int, np.ndarray] = {}
        self.diameters: Dict[int, float] = {}

        info_path = os.path.join(root, "models", "models_info.yml")
        models_info = {}
        if os.path.exists(info_path):
            models_info = read_yaml(info_path)

        for obj in self.objlist:
            obj_dir = os.path.join(root, "data", f"{obj:02d}")
            split_file = os.path.join(obj_dir, f"{mode}.txt")
            if not os.path.exists(split_file):
                continue
            with open(split_file) as f:
                frames = [int(l.strip()) for l in f if l.strip()]
            self.meta[obj] = read_yaml(os.path.join(obj_dir, "gt.yml"))
            ply = os.path.join(root, "models", f"obj_{obj:02d}.ply")
            pts_mm = parse_ply_vertices(ply)
            self.model_points[obj] = subsample_model_points(
                pts_mm, num_mesh_points, rng) / 1000.0
            if obj in models_info:
                self.diameters[obj] = models_info[obj]["diameter"] / 1000.0
            for fr in frames:
                self.items.append({"obj": obj, "frame": fr})

        if not self.items:
            raise FileNotFoundError(
                f"no LineMOD data under {root!r} (mode={mode}); expected "
                "data/<obj>/{rgb,depth,mask,gt.yml,train.txt,test.txt}")

    def __len__(self) -> int:
        return len(self.items)

    def _decode_frame(self, obj: int, fr: int):
        """Pure (deterministic) decode of one frame -> cacheable."""
        obj_dir = os.path.join(self.root, "data", f"{obj:02d}")
        color = read_png(os.path.join(obj_dir, "rgb", f"{fr:04d}.png"), "RGB")
        depth = np.asarray(
            read_png(os.path.join(obj_dir, "depth", f"{fr:04d}.png")),
            dtype=np.float32)
        if self.segnet_results is not None:
            label = read_png(os.path.join(
                self.segnet_results, f"{obj:02d}_label",
                f"{fr:04d}_label.png"))
            if label.ndim == 3:
                label = label[..., 0]
            mask = label == 255
        else:
            mask_img = read_png(os.path.join(obj_dir, "mask", f"{fr:04d}.png"))
            if mask_img.ndim == 3:
                mask = mask_img[..., 0] > 128
            else:
                mask = mask_img > 128
        return color, depth, mask

    def get_raw(self, i: int) -> Dict:
        """Decode one frame to raw arrays + GT pose (host side)."""
        it = self.items[i]
        obj, fr = it["obj"], it["frame"]
        color, depth, mask = self._frame_cache.get(
            (obj, fr), lambda: self._decode_frame(obj, fr))

        gt_list = self.meta[obj][fr]
        gt = next(g for g in gt_list if g.get("obj_id", obj) == obj)
        r = np.asarray(gt["cam_R_m2c"], dtype=np.float32).reshape(3, 3)
        t = np.asarray(gt["cam_t_m2c"], dtype=np.float32) / 1000.0

        valid = mask & (depth > 0)
        # GT masks: bbox from the label alone. Predicted masks: bbox from
        # the largest blob (upstream mask_to_bbox), so stray false-positive
        # pixels don't blow the window up to the whole frame; sampling
        # still uses every predicted pixel inside the window, as upstream.
        bbox_mask = (largest_component_mask(mask)
                     if self.segnet_results is not None else mask)
        return dict(
            color=color, depth=depth, mask=valid,
            bbox_mask=bbox_mask,
            lost=not valid.any(),
            target_r=r, target_t=t,
            model_points=self.model_points[obj],
            obj_idx=self.objlist.index(obj),
            intrinsics=INTRINSICS,
        )
