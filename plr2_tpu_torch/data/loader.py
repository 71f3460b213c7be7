"""Raw frame -> Sample: the crop window on the host (integer math), the
preprocessing on the sample's device; the port of plr2_tpu/data/loader.py.

`SyntheticPoseDataset` and `SyntheticSceneDataset` are in-memory datasets
over generated frames (NumPy, the same frames as the JAX package's for the
same seeds) with the `get_raw` contract of the real loaders.

`iterate_samples` draws each sample's randomness (`preprocess.Draws`) from
one `torch.Generator`, in dataset order (shuffled by NumPy's generator from
`seed`, as the JAX iterator shuffles).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from plr2_tpu_torch.data import synthetic as synth
from plr2_tpu_torch.data.bbox import get_bbox_from_mask
from plr2_tpu_torch.data.preprocess import Draws, Sample, draw, preprocess_crop


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def raw_to_sample(raw: Dict, draws: Draws, num_points: int,
                  add_noise: bool = False, img_h: Optional[int] = None,
                  img_w: Optional[int] = None, device="cpu") -> Sample:
    """Crop by the reference's bbox rules, then preprocess on `device`."""
    ih = img_h or raw["depth"].shape[0]
    iw = img_w or raw["depth"].shape[1]
    if raw.get("bbox") is not None:
        # an explicit pre-snapped window (the PoseCNN eval protocol)
        rmin, rmax, cmin, cmax = raw["bbox"]
    else:
        # upstream crops around the label mask alone (before the depth
        # validity intersection); loaders that tell them apart pass
        # `bbox_mask`
        rmin, rmax, cmin, cmax = get_bbox_from_mask(
            raw.get("bbox_mask", raw["mask"]), ih, iw)
    intr = raw["intrinsics"]
    intr_vec = torch.tensor([intr["cx"], intr["cy"], intr["fx"], intr["fy"],
                             intr["cam_scale"]], dtype=torch.float32)
    win = (slice(rmin, rmax), slice(cmin, cmax))
    return preprocess_crop(
        _t(raw["color"][win], device), _t(raw["depth"][win], device,
                                          torch.float32),
        _t(raw["mask"][win], device), rmin, cmin, intr_vec,
        _t(raw["model_points"], device, torch.float32),
        _t(raw["target_r"], device, torch.float32),
        _t(raw["target_t"], device, torch.float32), int(raw["obj_idx"]),
        draws, num_points=num_points, add_noise=add_noise)


class SyntheticPoseDataset:
    """Generated frames with known poses; same get_raw contract as the real
    loaders. One sample per (frame, object)."""

    def __init__(self, num_frames: int = 8, num_objects: int = 3,
                 model_points: int = 500, num_points: int = 500,
                 seed: int = 0, img_h: int = 480, img_w: int = 640):
        self.num_points = num_points
        self.frames: List[synth.SyntheticFrame] = []
        self.models: Dict[int, np.ndarray] = {}
        self.items: List[Dict] = []
        for f in range(num_frames):
            frame, models = synth.make_scene(
                num_objects=num_objects, model_points=model_points,
                seed=seed * 1000 + f, img_h=img_h, img_w=img_w)
            self.models.update(models)
            fi = len(self.frames)
            self.frames.append(frame)
            for obj_id in frame.poses:
                self.items.append({"frame": fi, "obj": obj_id,
                                   "models": models})
        self.diameters = {
            obj_id - 1: float(np.linalg.norm(
                m.max(0) - m.min(0)))
            for obj_id, m in self.models.items()
        }

    def __len__(self) -> int:
        return len(self.items)

    def get_raw(self, i: int) -> Dict:
        it = self.items[i]
        frame = self.frames[it["frame"]]
        obj = it["obj"]
        r, t = frame.poses[obj]
        return dict(
            color=frame.color,
            depth=frame.depth.astype(np.float32),
            mask=(frame.label == obj) & (frame.depth > 0),
            target_r=r, target_t=t,
            model_points=it["models"][obj],
            obj_idx=obj - 1,  # 0-based class index
            intrinsics=frame.intrinsics,
        )


class SyntheticSceneDataset:
    """Scene dataset over a FIXED model library (config-5 journey,
    tools/journey_config5.py): every frame renders a random subset of the
    same `models` (1-based ids), so object identities persist across
    frames — the YCB-style regime where a 21-way per-object head can
    actually learn per-object features. Same `get_raw` contract as the
    real loaders plus `frames`/`models` for the full-pipeline evaluator
    (eval/full_pipeline.evaluate_full_pipeline consumes SyntheticFrame's
    color/depth/label/poses/intrinsics directly)."""

    def __init__(self, models: Dict[int, np.ndarray], num_frames: int,
                 objects_per_frame: int = 5, num_points: int = 1000,
                 seed: int = 0, img_h: int = 480, img_w: int = 640,
                 distinct_colors: bool = False):
        self.num_points = num_points
        self.models = dict(models)
        self.frames: List[synth.SyntheticFrame] = []
        self.items: List[Dict] = []
        rng = np.random.default_rng(seed)
        ids = np.asarray(sorted(models))
        # distinct_colors: well-separated HSV palette instead of the
        # id-hash colors whose near-collision pairs cap per-pixel
        # object-identity segmentation (synthetic.distinct_palette)
        palette = (synth.distinct_palette(int(ids.max()))
                   if distinct_colors else None)
        for f in range(num_frames):
            k = min(objects_per_frame, len(ids))
            visible = rng.choice(ids, size=k, replace=False)
            frame = synth.make_library_scene(
                self.models, sorted(int(i) for i in visible),
                seed=seed * 7919 + f, img_h=img_h, img_w=img_w,
                colors=palette)
            fi = len(self.frames)
            self.frames.append(frame)
            for obj_id in frame.poses:
                self.items.append({"frame": fi, "obj": obj_id})
        self.diameters = {
            obj_id - 1: float(np.linalg.norm(m.max(0) - m.min(0)))
            for obj_id, m in self.models.items()
        }

    def __len__(self) -> int:
        return len(self.items)

    def get_raw(self, i: int) -> Dict:
        it = self.items[i]
        frame = self.frames[it["frame"]]
        obj = it["obj"]
        r, t = frame.poses[obj]
        return dict(
            color=frame.color,
            depth=frame.depth.astype(np.float32),
            mask=(frame.label == obj) & (frame.depth > 0),
            target_r=r, target_t=t,
            model_points=self.models[obj],
            obj_idx=obj - 1,
            intrinsics=frame.intrinsics,
        )


def iterate_samples(dataset, generator: torch.Generator, num_points: int,
                    add_noise: bool = False, noise_trans: float = 0.03,
                    shuffle: bool = False, seed: int = 0,
                    device="cpu") -> Iterator[Sample]:
    """Single-sample iterator (the reference's batch-1 DataLoader shape)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in order:
        d = draw(generator, noise_trans)
        yield raw_to_sample(dataset.get_raw(int(i)), d, num_points,
                            add_noise=add_noise, device=device)


def stack_samples(samples: List[Sample], crop: int) -> Sample:
    """Batch same-or-smaller crops into one fixed (crop, crop) batch: each
    crop top-left in a zero canvas, `choose` re-strided to the canvas
    width (the batched modes' spatial contract)."""
    out_img, out_choose = [], []
    for s in samples:
        h, w = s.img.shape[0], s.img.shape[1]
        if h > crop or w > crop:
            raise ValueError(f"crop {h}x{w} exceeds canvas {crop}")
        img = s.img.new_zeros((crop, crop, 3))
        img[:h, :w] = s.img
        out_img.append(img)
        out_choose.append((s.choose // w) * crop + s.choose % w)
    return Sample(
        points=torch.stack([s.points for s in samples]),
        choose=torch.stack(out_choose),
        img=torch.stack(out_img),
        target=torch.stack([s.target for s in samples]),
        model_points=torch.stack([s.model_points for s in samples]),
        idx=torch.stack([s.idx for s in samples]),
        obj=(None if any(s.obj is None for s in samples)
             else tuple(s.obj for s in samples)),
    )
