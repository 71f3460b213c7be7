"""PoseCNN segmentation-results loader, the port of plr2_tpu/data/posecnn.py
(scipy only).

The reference's tools/eval_ycb.py consumes precomputed PoseCNN outputs
(results_PoseCNN_RSS2018/%06d.mat with a per-pixel `labels` map and
`rois`/`poses` detections, SURVEY.md section 2 #12). This module loads
those files so the full pipeline can evaluate with PoseCNN masks exactly
like the reference, as an alternative to GT labels or the in-repo SegNet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from plr2_tpu_torch.data.bbox import snap_bbox


def roi_bbox(roi_row: np.ndarray, img_h: int = 480, img_w: int = 640
             ) -> Tuple[int, int, int, int]:
    """Snap the crop window from a PoseCNN detection row — the upstream
    eval protocol's `get_bbox(posecnn_rois)` (upstream tools/eval_ycb.py):
    rois rows are [_, cls, x1, y1, x2, y2]; the tight box
    is (y1+1, y2-1, x1+1, x2-1), then the usual border-list snap."""
    rmin = int(roi_row[3]) + 1
    rmax = int(roi_row[5]) - 1
    cmin = int(roi_row[2]) + 1
    cmax = int(roi_row[4]) - 1
    return snap_bbox(rmin, rmax, cmin, cmax, img_h, img_w)


def load_posecnn_result(mat_path: str) -> Dict:
    """-> dict(labels (H, W) int32, rois (K, >=2) or None, poses or None)."""
    import scipy.io as sio

    m = sio.loadmat(mat_path)
    out = {"labels": np.asarray(m["labels"], dtype=np.int32)}
    out["rois"] = np.asarray(m["rois"]) if "rois" in m else None
    out["poses"] = np.asarray(m["poses"]) if "poses" in m else None
    return out


class PoseCNNMasks:
    """Callable mask provider for the full-pipeline evaluator's
    `seg_predict` slot (JAX's evaluate_full_pipeline; the port's waits for
    ROADMAP A6), keyed by frame order: results dir contains %06d.mat in the same
    order as the evaluated keyframe list (the reference convention)."""

    def __init__(self, results_dir: str):
        self.results_dir = results_dir
        self._index = 0

    def reset(self) -> None:
        """Restart the sequential frame counter (called automatically by
        evaluate_full_pipeline at the start of each run)."""
        self._index = 0

    def detected_objects(self, frame_idx: int) -> Optional[List[int]]:
        r = self._load(frame_idx)
        if r["rois"] is None:
            return None
        return [int(x) for x in r["rois"][:, 1]]

    def detections(self, frame_idx: int, img_h: int = 480, img_w: int = 640
                   ) -> Optional[List[Tuple[int, Tuple[int, int, int, int]]]]:
        """The upstream eval_ycb iteration unit: the frame's PoseCNN
        detections as (object id, ROI-snapped crop window) in rois-row
        order. None when the .mat carries no `rois` (labels-only dumps) —
        callers then fall back to mask-derived windows over GT objects."""
        r = self._load(frame_idx)
        if r["rois"] is None:
            return None
        return [(int(row[1]), roi_bbox(row, img_h, img_w))
                for row in np.atleast_2d(r["rois"])]

    def _load(self, frame_idx: int) -> Dict:
        return load_posecnn_result(
            os.path.join(self.results_dir, f"{frame_idx:06d}.mat"))

    def labels_for_frame(self, frame_idx: int) -> np.ndarray:
        return self._load(frame_idx)["labels"]

    def __call__(self, color: np.ndarray) -> np.ndarray:
        """Sequential-call protocol used by evaluate_full_pipeline (one call
        per frame, in order)."""
        labels = self.labels_for_frame(self._index)
        self._index += 1
        return labels
