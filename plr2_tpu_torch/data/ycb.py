"""YCB-Video dataset loader (21 objects, 1000 points), the port of
plr2_tpu/data/ycb.py. PNGs are read by data/codecs.py (no PIL), meta.mat
files by scipy.io.

Layout (upstream YCB_Video_Dataset):
  root/data/NNNN/NNNNNN-{color.png,depth.png,label.png,meta.mat}
  root/data_syn/NNNNNN-{...}            # synthetic renders
  root/dataset_config/classes.txt        # 21 class names
  root/dataset_config/train_data_list.txt / test_data_list.txt
  root/models/<class>/points.xyz         # model point clouds (metres)

meta.mat fields: poses (3,4,K), cls_indexes (K,), factor_depth, intrinsic_matrix.
Two camera intrinsics sets: sequences 0000-0059 use cam_1, >=0060 cam_2
(the reference hard-codes both). Synthetic frames are composited onto a
random real frame's background when real frames are available.

Per-visit randomness (the object of a frame, the synthetic background,
the occluders, the resample) is drawn from the dataset's own NumPy
generator, in the JAX package's order, so `get_raw(i)` gives the JAX
loader's samples bit for bit. `get_raw(i, rng=...)` and
`get_frame(i, rng=...)` draw from the generator given instead: the
prefetcher passes one seeded from the dataset index, so its samples do not
depend on which worker thread or process made them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from plr2_tpu_torch.data.codecs import read_png
from plr2_tpu_torch.data.frame_cache import FrameCache

CAM_1 = dict(cx=312.9869, cy=241.3109, fx=1066.778, fy=1067.487, cam_scale=10000.0)
CAM_2 = dict(cx=323.7872, cy=279.6921, fx=1077.836, fy=1078.189, cam_scale=10000.0)
SYM_OBJ_IDX = (12, 15, 18, 19, 20)
NUM_OBJECTS = 21


def load_points_xyz(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32)


class YCBDataset:
    """Index over frames from the data lists; each visit picks one labelled
    object of the frame (the upstream YCB dataset's sampling unit).

    Reference-contract behaviours beyond the basic loader (all from the
    upstream datasets/ycb/dataset.py __getitem__):

    * Mesh-resolution switch: the joint refine stage scores ADD(-S)
      against `num_mesh_points_large` (2600) model points instead of the
      PoseNet-stage `num_mesh_points` (500). `set_refine(True)` switches
      (the Trainer calls it when the refine margin fires).
    * Occluder augmentation (`add_front`): on noisy train samples, the
      foreground objects of a random synthetic frame are composited IN
      FRONT of the image and their pixels removed from the object mask:
      up to `front_attempts` tries, accepted only when the object keeps
      > `front_keep_px` visible pixels.
    * Minimum-visible resample: samples whose valid mask has <=
      `minimum_num_pt` pixels are replaced by a fresh random index
      (the upstream re-draws instead of returning degenerate zeros).
    """

    def __init__(self, root: str, mode: str = "train", num_points: int = 1000,
                 num_mesh_points: int = 500, add_noise: bool = True,
                 noise_trans: float = 0.03, seed: int = 0,
                 num_mesh_points_large: int = 2600, refine: bool = False,
                 add_front: bool = True, front_num: int = 2,
                 front_attempts: int = 5, front_keep_px: int = 1000,
                 minimum_num_pt: int = 50, cache_mb: int = 0):
        self.root = root
        self.mode = mode
        self.num_points = num_points
        self.add_noise = add_noise and mode == "train"
        self.noise_trans = noise_trans
        self.refine = refine
        self.add_front = add_front and self.add_noise
        self.front_num = front_num
        self.front_attempts = front_attempts
        self.front_keep_px = front_keep_px
        self.minimum_num_pt = minimum_num_pt
        # bounded LRU over the PURE frame decode (everything before the
        # per-visit compositing / occluder randomness); see
        # data/frame_cache.py
        self._frame_cache = FrameCache(cache_mb)
        rng = np.random.default_rng(seed)

        self._rng = np.random.default_rng(seed + 0x5EED)
        list_file = os.path.join(
            root, "dataset_config",
            "train_data_list.txt" if mode == "train" else "test_data_list.txt")
        with open(list_file) as f:
            self.frames = [l.strip() for l in f if l.strip()]
        self.real_frames = [p for p in self.frames if not p.startswith("data_syn")]
        self.syn_frames = [p for p in self.frames if p.startswith("data_syn")]

        classes_file = os.path.join(root, "dataset_config", "classes.txt")
        with open(classes_file) as f:
            self.classes = [l.strip() for l in f if l.strip()]

        # two fixed subsamples per class: the PoseNet-stage mesh and the
        # refine-stage high-resolution mesh (upstream num_pt_mesh_small /
        # num_pt_mesh_large)
        self.model_points: Dict[int, np.ndarray] = {}
        self.model_points_large: Dict[int, np.ndarray] = {}
        for ci, cname in enumerate(self.classes):
            xyz = os.path.join(root, "models", cname, "points.xyz")
            if os.path.exists(xyz):
                pts = load_points_xyz(xyz)
                self.model_points[ci] = self._subsample(pts, num_mesh_points,
                                                        rng)
                self.model_points_large[ci] = self._subsample(
                    pts, num_mesh_points_large, rng)

        # one item per FRAME: get_raw(i) picks ONE random visible object of
        # frame i per visit
        self.items: List[Dict] = [{"frame": fp} for fp in self.frames]
        if not self.items:
            raise FileNotFoundError(f"no YCB data lists under {root!r}")

    @staticmethod
    def _subsample(pts: np.ndarray, n: int, rng) -> np.ndarray:
        if len(pts) <= n:
            return pts
        keep = rng.choice(len(pts), n, replace=False)
        keep.sort()
        return pts[keep]

    def set_refine(self, refine: bool) -> None:
        """Switch to the refine-stage mesh resolution (2600 points)."""
        self.refine = refine

    def get_num_points_mesh(self) -> int:
        """Upstream get_num_points_mesh(): large mesh once refine starts."""
        which = self.model_points_large if self.refine else self.model_points
        return len(next(iter(which.values())))

    def __len__(self) -> int:
        return len(self.items)

    def _intrinsics(self, frame_path: str) -> Dict[str, float]:
        if frame_path.startswith("data_syn"):
            return CAM_1
        seq = int(frame_path.split("/")[1])
        return CAM_1 if seq < 60 else CAM_2

    def _decode_frame(self, fp: str) -> Dict:
        """Pure frame decode (no per-visit randomness), cacheable."""
        import scipy.io as sio

        base = os.path.join(self.root, fp)
        color = read_png(base + "-color.png", "RGB")
        depth = np.asarray(read_png(base + "-depth.png"), dtype=np.float32)
        label = np.asarray(read_png(base + "-label.png"), dtype=np.int32)
        meta = sio.loadmat(base + "-meta.mat")
        cls_indexes = meta["cls_indexes"].flatten().astype(np.int32)
        poses = meta["poses"]  # (3, 4, K)
        intr = dict(self._intrinsics(fp))
        intr["cam_scale"] = float(meta["factor_depth"].flatten()[0])
        objects = {}
        for k, ci in enumerate(cls_indexes):
            objects[int(ci) - 1] = {  # cls_indexes are 1-based
                "target_r": poses[:, :3, k].astype(np.float32),
                "target_t": poses[:, 3, k].astype(np.float32),
            }
        return dict(color=color, depth=depth, label=label, objects=objects,
                    intrinsics=intr)

    def get_frame(self, i: int, rng: Optional[np.random.Generator] = None) -> Dict:
        """Decode a full frame: color/depth/label + all object poses; a
        synthetic frame composited over a real background drawn from `rng`
        (default: the dataset's generator)."""
        rng = self._rng if rng is None else rng
        fp = self.items[i]["frame"]
        fr = dict(self._frame_cache.get(
            ("frame", fp), lambda: self._decode_frame(fp)))

        if fp.startswith("data_syn") and self.real_frames:
            # composite synthetic foreground over a random real background
            # (fresh draw per visit: the reference re-randomizes every
            # __getitem__, so every epoch composites differently)
            bg_path = os.path.join(
                self.root,
                self.real_frames[rng.integers(len(self.real_frames))])
            bg = self._frame_cache.get(
                ("color", bg_path),
                lambda: read_png(bg_path + "-color.png", "RGB"))
            fg = fr["label"] > 0
            fr["color"] = np.where(fg[..., None], fr["color"], bg)
        return fr

    def _front_occluder(self, color: np.ndarray, mask: np.ndarray, rng):
        """Composite `front_num` objects of a random synthetic frame in
        front of the sample; returns (color, mask) or None if no attempt
        kept enough of the object visible (upstream add_front loop)."""
        for _ in range(self.front_attempts):
            fp = self.syn_frames[int(rng.integers(len(self.syn_frames)))]
            base = os.path.join(self.root, fp)
            f_label = self._frame_cache.get(
                ("label", fp),
                lambda: np.asarray(read_png(base + "-label.png"), np.int32))
            present = np.unique(f_label)
            present = present[present > 0]
            if len(present) < self.front_num:
                continue
            chosen = rng.choice(present, self.front_num, replace=False)
            front_mask = np.isin(f_label, chosen)
            kept = mask & ~front_mask
            if int(kept.sum()) <= self.front_keep_px:
                continue
            f_color = self._frame_cache.get(
                ("color2", fp), lambda: read_png(base + "-color.png", "RGB"))
            color = np.where(front_mask[..., None], f_color, color)
            return color, kept
        return None

    def get_raw(self, i: int, obj_idx: Optional[int] = None,
                rng: Optional[np.random.Generator] = None) -> Dict:
        """One (frame, object) sample in the common raw-dict format; the
        visit's draws come from `rng` (default: the dataset's generator)."""
        rng = self._rng if rng is None else rng
        for _attempt in range(20):
            raw = self._get_raw_once(i, obj_idx, rng)
            if int(raw["mask"].sum()) > self.minimum_num_pt:
                return raw
            # too few visible pixels -> re-draw a fresh index (upstream
            # returns __getitem__ of a random other sample)
            i = int(rng.integers(len(self.items)))
            obj_idx = None
        return raw  # pathological dataset; let preprocessing zero-pad

    def _get_raw_once(self, i: int, obj_idx: Optional[int] = None,
                      rng: Optional[np.random.Generator] = None) -> Dict:
        rng = self._rng if rng is None else rng
        fr = self.get_frame(i, rng)
        objs = sorted(fr["objects"])
        if obj_idx is None:
            # fresh draw per visit so all labelled objects of a frame are
            # trained on across epochs
            obj_idx = objs[int(rng.integers(len(objs)))]
        pose = fr["objects"][obj_idx]
        color = fr["color"]
        mask = (fr["label"] == obj_idx + 1) & (fr["depth"] > 0)
        if self.add_front and self.syn_frames:
            out = self._front_occluder(color, mask, rng)
            if out is not None:
                color, mask = out
        points = (self.model_points_large if self.refine
                  else self.model_points)[obj_idx]
        return dict(
            color=color, depth=fr["depth"], mask=mask,
            # upstream snaps the crop window from the LABEL mask alone
            # (get_bbox(mask_label), before the depth intersection and
            # unaffected by add_front): depth holes must not shrink the crop
            bbox_mask=fr["label"] == obj_idx + 1,
            target_r=pose["target_r"], target_t=pose["target_t"],
            model_points=points,
            obj_idx=obj_idx,
            intrinsics=fr["intrinsics"],
        )
