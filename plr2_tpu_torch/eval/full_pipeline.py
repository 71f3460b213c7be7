"""The full pipeline (BASELINE config 5), the port of
plr2_tpu/eval/full_pipeline.py: segmentation masks -> every detected
object's crop -> one batched estimate a frame with 4-iteration refinement
-> ADD(-S) against ground truth, lost detections scored as failures, and
optionally the per-frame poses as YCB-toolbox `.mat` files (`poses` (K, 7)
[wxyz quat | xyz trans] rows, `cls_indexes` (K,)).

Two modes over the same protocol:
- host mode: masks from the ground-truth labels, a segmenter
  (`seg_predict`, e.g. `segment_frame`), or PoseCNN results
  (`data/posecnn.py` `PoseCNNMasks`; with `rois` the crop windows snap from
  the detection boxes and the unit is the detection list, the upstream
  eval_ycb iteration). Each object's crop is cut on the host
  (`raw_to_sample` on the pipeline's device), a frame's crops are stacked
  on a canvas that grows to fit (`stack_samples`), and estimated as one
  batch.
- device mode (`device_pipeline=True`): the frame program of `serving.py`
  (`FrameEstimator`, one CUDA graph on the card), with the segmenter
  inside it when `seg_model` is given.

Draws. JAX keys each sample by fold_in(fold_in(key0, frame), object id).
The port cannot run threefry: `key_words(frame_index, obj_ids) -> (K, 2)`
gives the choose hash's key words of a frame's objects (the tests pass
JAX's); by default they derive from (frame index, object id) by
`serving.frame_key_words`, which is what the device mode derives for
the same frame seed, so host and device modes draw the same pixels.
"""

from __future__ import annotations

import os
import types
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from plr2_tpu_torch.data.linemod import largest_component_mask
from plr2_tpu_torch.data.loader import raw_to_sample, stack_samples
from plr2_tpu_torch.data.preprocess import Draws
from plr2_tpu_torch.eval.metrics import compute_auc, pose_distance, success_rate
from plr2_tpu_torch.eval.segment import segment_frame  # noqa: F401  (JAX's home)
from plr2_tpu_torch.pipeline import DenseFusionPipeline
from plr2_tpu_torch.serving import FrameEstimator, frame_key_words

KeyWords = Callable[[int, Sequence[int]], np.ndarray]
INTR_KEYS = ("cx", "cy", "fx", "fy", "cam_scale")


@dataclass
class FullPipelineResult:
    auc: float = 0.0
    under_2cm: float = 0.0
    mean_distance: float = 0.0        # over detected objects (finite dis)
    num_objects: int = 0              # scored GT objects incl. lost ones
    num_frames: int = 0
    # GT objects whose mask the segmenter missed (or below the pixel
    # floor): scored as distance inf, as the YCB toolbox counts undetected
    # objects as failures
    lost_detections: int = 0
    # ROI mode only: PoseCNN detections of classes with no GT pose in the
    # frame, estimated and exported but never scored
    extra_detections: int = 0
    per_frame_poses: List[Dict] = field(default_factory=list)
    # raw ADD(-S) distances per object id: input to eval/report.py
    per_object_distances: Dict[int, List[float]] = field(default_factory=dict)


def ycb_frames_and_models(ds, max_frames: Optional[int] = None):
    """YCBDataset -> (frames, models) in this module's contract: frames
    with 1-based label-id pose dicts and a 1-based id -> model points map.
    The eval CLI and the offline re-evaluation (tools/plot_accuracy.py)
    share it, so both see the same ground truth."""
    frames, models = [], {}
    n = len(ds) if max_frames is None else min(len(ds), max_frames)
    for i in range(n):
        fr = ds.get_frame(i)
        poses = {oid + 1: (o["target_r"], o["target_t"])
                 for oid, o in fr["objects"].items()}
        frames.append(types.SimpleNamespace(
            color=fr["color"], depth=fr["depth"], label=fr["label"],
            poses=poses, intrinsics=fr["intrinsics"]))
        for oid in fr["objects"]:
            models[oid + 1] = ds.model_points[oid]
    return frames, models


def default_key_words(frame_index: int, obj_ids: Sequence[int]) -> np.ndarray:
    """The key words the device mode derives for frame seed `frame_index`."""
    return frame_key_words(torch.tensor(frame_index),
                           torch.as_tensor(list(obj_ids), dtype=torch.int64)
                           ).numpy()


def _finish(result: FullPipelineResult, dists: List[float]) -> FullPipelineResult:
    result.num_objects = len(dists)
    if dists:
        # AUC and < 2 cm count lost detections (inf) as failures; the mean
        # is over detected objects, so it stays a distance
        result.auc = compute_auc(dists)
        result.under_2cm = success_rate(dists, 0.02)
        finite = [d for d in dists if np.isfinite(d)]
        result.mean_distance = float(np.mean(finite)) if finite else float("inf")
    return result


def _save_mat(save_mat_dir: str, fi: int, frame_poses: Dict) -> None:
    import scipy.io as sio
    os.makedirs(save_mat_dir, exist_ok=True)
    sio.savemat(os.path.join(save_mat_dir, f"{fi:06d}.mat"),
                {"poses": np.stack(list(frame_poses.values()))
                 if frame_poses else np.zeros((0, 7)),
                 "cls_indexes": np.asarray(list(frame_poses), np.int32)})


def _pose_row(quat: torch.Tensor, trans: torch.Tensor) -> np.ndarray:
    return np.concatenate([quat.float().cpu().numpy(),
                           trans.float().cpu().numpy()])


def evaluate_full_pipeline(
    pipe: DenseFusionPipeline,
    frames,                      # color / depth / label / poses / intrinsics
    models: Dict[int, np.ndarray],
    sym_list: Tuple[int, ...],
    refine_iterations: int = 4,
    seg_predict=None,            # None: ground-truth labels
    crop_canvas: int = 240,
    num_points: Optional[int] = None,
    min_mask_pixels: int = 50,
    save_mat_dir: str = "",
    device_pipeline: bool = False,  # the frame program of serving.py
    seg_variables=None,             # with device_pipeline: a state dict
    seg_model=None,                 # with device_pipeline: the segmenter
    key_words: Optional[KeyWords] = None,
) -> FullPipelineResult:
    """The config-5 protocol over `frames` on the pipeline's device, in its
    mode (f32, or bf16 after `cast`). `sym_list` holds 0-based indices
    (id - 1)."""
    key_words = key_words or default_key_words
    if device_pipeline:
        return _evaluate_device_pipeline(
            pipe, frames, models, sym_list, refine_iterations, seg_predict,
            crop_canvas, min_mask_pixels, save_mat_dir, seg_model,
            seg_variables, key_words)
    n_pts = num_points or pipe.num_points
    # sequential mask providers (PoseCNNMasks) track the frame order
    if seg_predict is not None and hasattr(seg_predict, "reset"):
        seg_predict.reset()
    # PoseCNN results with `rois` switch to the upstream eval_ycb
    # iteration: windows snap from the DETECTION box, and the unit is the
    # detection list, not the GT object list
    use_rois = seg_predict is not None and hasattr(seg_predict, "detections")
    dists: List[float] = []
    result = FullPipelineResult()

    def _lost(obj_id):
        dists.append(float("inf"))
        result.per_object_distances.setdefault(obj_id, []).append(float("inf"))
        result.lost_detections += 1

    for fi, frame in enumerate(frames):
        label = (seg_predict(frame.color) if seg_predict is not None
                 else frame.label)
        img_h, img_w = frame.depth.shape
        det_map = None
        if use_rois:
            dets = seg_predict.detections(fi, img_h, img_w)
            if dets is not None:
                det_map = {}
                for obj_id, box in dets:
                    det_map.setdefault(obj_id, box)
        queued = []  # (obj_id, mask, r_gt, t_gt, bbox, scored)

        if det_map is not None:
            for obj_id, (r_gt, t_gt) in frame.poses.items():
                box = det_map.get(obj_id)
                if box is None:  # a GT object PoseCNN never detected
                    _lost(obj_id)
                    continue
                mask = (label == obj_id) & (frame.depth > 0)
                rmin, rmax, cmin, cmax = box
                # the upstream lost-detection check counts valid mask
                # pixels INSIDE the detection window
                if mask[rmin:rmax, cmin:cmax].sum() < min_mask_pixels:
                    _lost(obj_id)
                    continue
                queued.append((obj_id, mask, r_gt, t_gt, box, True))
            for obj_id, box in det_map.items():
                if obj_id in frame.poses:
                    continue
                result.extra_detections += 1
                if obj_id not in models:
                    continue  # no mesh to estimate against
                mask = (label == obj_id) & (frame.depth > 0)
                rmin, rmax, cmin, cmax = box
                if mask[rmin:rmax, cmin:cmax].sum() < min_mask_pixels:
                    continue
                queued.append((obj_id, mask, np.eye(3, dtype=np.float32),
                               np.zeros(3, np.float32), box, False))
        else:
            for obj_id, (r_gt, t_gt) in frame.poses.items():
                mask = (label == obj_id) & (frame.depth > 0)
                if mask.sum() < min_mask_pixels:
                    _lost(obj_id)
                    continue
                queued.append((obj_id, mask, r_gt, t_gt, None, True))
        if not queued:
            # no detected object in this frame: an empty poses entry, as
            # the device mode gives (lost GT objects were scored above)
            result.per_frame_poses.append({})
            result.num_frames += 1
            if save_mat_dir:
                _save_mat(save_mat_dir, fi, {})
            continue

        words = key_words(fi, [q[0] for q in queued])
        samples = []
        for (obj_id, mask, r_gt, t_gt, bbox, _), kw in zip(queued, words):
            raw = dict(
                color=frame.color, depth=frame.depth.astype(np.float32),
                mask=mask, target_r=r_gt, target_t=t_gt,
                model_points=models[obj_id], obj_idx=obj_id - 1,
                intrinsics=frame.intrinsics, bbox=bbox)
            if seg_predict is not None and bbox is None:
                # the predicted-mask protocol (upstream mask_to_bbox): the
                # window snaps from the LARGEST blob of the predicted
                # label, so stray pixels elsewhere cannot inflate it; the
                # depth-intersected mask still drives the sampling
                raw["bbox_mask"] = largest_component_mask(label == obj_id)
            draws = Draws((int(kw[0]), int(kw[1])), torch.ones(4),
                          torch.arange(4), torch.zeros(3))
            samples.append(raw_to_sample(raw, draws, n_pts, add_noise=False,
                                         device=pipe.device))

        # a canvas that grows for oversized (e.g. noisy-mask) crops
        canvas = max([crop_canvas] + [max(s.img.shape[0], s.img.shape[1])
                                      for s in samples])
        batch = stack_samples(samples, crop=canvas)
        est = pipe.estimate(batch.img, batch.points, batch.choose, batch.idx,
                            refine_iterations=refine_iterations)

        frame_poses = {}
        for bi, (obj_id, *_, scored) in enumerate(queued):
            if scored:
                dis = float(pose_distance(
                    batch.model_points[bi], est.quat[bi], est.trans[bi],
                    batch.target[bi], symmetric=(obj_id - 1) in sym_list))
                dists.append(dis)
                result.per_object_distances.setdefault(obj_id, []).append(dis)
            frame_poses[obj_id] = _pose_row(est.quat[bi], est.trans[bi])
        result.per_frame_poses.append(frame_poses)
        result.num_frames += 1
        if save_mat_dir:
            _save_mat(save_mat_dir, fi, frame_poses)
    return _finish(result, dists)


def _evaluate_device_pipeline(pipe, frames, models, sym_list,
                              refine_iterations, seg_predict, crop_canvas,
                              min_mask_pixels, save_mat_dir, seg_model,
                              seg_variables, key_words) -> FullPipelineResult:
    """The same protocol through the frame program (serving.py): one
    program a frame instead of a host crop and stack per object. Object
    slots are padded to the largest per-frame object count, so every frame
    replays one graph."""
    frames = list(frames)
    result = FullPipelineResult()
    if not frames:
        return result
    k_slots = max(len(f.poses) for f in frames)
    h, w = frames[0].depth.shape
    fe = FrameEstimator(pipe, canvas=crop_canvas, img_h=h, img_w=w,
                        refine_iterations=refine_iterations,
                        min_mask_pixels=min_mask_pixels, seg_model=seg_model)
    if seg_predict is not None and hasattr(seg_predict, "reset"):
        seg_predict.reset()
    dists: List[float] = []

    for fi, frame in enumerate(frames):
        label = (seg_predict(frame.color) if seg_predict is not None
                 else frame.label)
        obj_ids = sorted(frame.poses)
        if not obj_ids:
            result.num_frames += 1
            result.per_frame_poses.append({})
            continue
        pad = k_slots - len(obj_ids)
        oid = np.asarray(obj_ids + [0] * pad, np.int64)
        mps = np.stack([models[o] for o in obj_ids]
                       + [models[obj_ids[0]]] * pad).astype(np.float32)
        tr = np.stack([frame.poses[o][0] for o in obj_ids]
                      + [np.eye(3, dtype=np.float32)] * pad).astype(np.float32)
        tt = np.stack([frame.poses[o][1] for o in obj_ids]
                      + [np.zeros(3, np.float32)] * pad).astype(np.float32)
        intr = np.asarray([frame.intrinsics[k] for k in INTR_KEYS], np.float32)
        words = np.asarray(key_words(fi, oid.tolist()), np.int64)
        poses, samples = fe.run_with_samples(
            frame.color, frame.depth.astype(np.float32),
            None if seg_model is not None else np.asarray(label, np.int32),
            oid, mps, intr, seg_variables=seg_variables, target_r=tr,
            target_t=tt, key_words=words)
        seg_variables = None  # copied in once

        valid = poses.valid.cpu().numpy()
        frame_poses = {}
        for bi, obj_id in enumerate(obj_ids):
            if not valid[bi]:
                dists.append(float("inf"))
                result.per_object_distances.setdefault(obj_id, []).append(
                    float("inf"))
                result.lost_detections += 1
                continue
            dis = float(pose_distance(
                samples.model_points[bi], poses.quat[bi], poses.trans[bi],
                samples.target[bi], symmetric=(obj_id - 1) in sym_list))
            dists.append(dis)
            result.per_object_distances.setdefault(obj_id, []).append(dis)
            frame_poses[obj_id] = _pose_row(poses.quat[bi], poses.trans[bi])
        result.per_frame_poses.append(frame_poses)
        result.num_frames += 1
        if save_mat_dir:
            _save_mat(save_mat_dir, fi, frame_poses)
    return _finish(result, dists)
