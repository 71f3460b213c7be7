"""Predicted masks for the LineMOD evaluation, the port of
plr2_tpu/eval/segment.py.

The reference's tools/eval_linemod.py reads precomputed SegNet masks from
`Linemod_preprocessed/segnet_results/{obj:02d}_label/{frame:04d}_label.png`
(pixel 255 = object). `write_segnet_results` renders them from the port's
segmenter (`models/segnet.py`), so the predicted-mask protocol runs end to
end (`tools.eval_linemod --segnet_results`). Frames are read and masks
written by `data/codecs.py` (`read_png`, `write_png`): no PIL.

Classes of a LineMOD segmenter: 0 = background, k = objlist position
k - 1 (14 classes for the 13-object list).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from plr2_tpu_torch.data.codecs import read_png, write_png
from plr2_tpu_torch.data.linemod import OBJLIST
from plr2_tpu_torch.data.preprocess import normalize_frames


def write_segnet_results(
    dataset_root: str,
    out_dir: str,
    predict_labels: Callable[[np.ndarray], np.ndarray],
    objlist: Optional[List[int]] = None,
    split: str = "test",
) -> int:
    """Render predicted masks of every frame of the split files into the
    upstream segnet_results layout.

    `predict_labels(color (H, W, 3) uint8) -> (H, W) int labels`, where
    label objlist.index(obj) + 1 marks the object's pixels. Returns the
    number of masks written."""
    objlist = objlist or OBJLIST
    written = 0
    for obj in objlist:
        obj_dir = os.path.join(dataset_root, "data", f"{obj:02d}")
        split_file = os.path.join(obj_dir, f"{split}.txt")
        if not os.path.exists(split_file):
            continue
        with open(split_file) as f:
            frames = [int(line.strip()) for line in f if line.strip()]
        label_dir = os.path.join(out_dir, f"{obj:02d}_label")
        os.makedirs(label_dir, exist_ok=True)
        cls = objlist.index(obj) + 1
        for fr in frames:
            color = read_png(os.path.join(obj_dir, "rgb", f"{fr:04d}.png"), "RGB")
            labels = np.asarray(predict_labels(color))
            mask = (labels == cls).astype(np.uint8) * 255
            write_png(os.path.join(label_dir, f"{fr:04d}_label.png"), mask)
            written += 1
    return written


def segment_frame(seg_trainer, color: np.ndarray) -> np.ndarray:
    """The (H, W) label map a trained `SegTrainer` predicts for one uint8
    frame, normalised as `SegTrainer.train_epoch` normalises crops."""
    x = normalize_frames(torch.from_numpy(np.ascontiguousarray(color))
                         .to(seg_trainer.device))
    return seg_trainer.predict(x[None])[0].cpu().numpy()


def segnet_predictor(seg_trainer) -> Callable[[np.ndarray], np.ndarray]:
    """A trained `SegTrainer` as the `predict_labels` callable."""
    return functools.partial(segment_frame, seg_trainer)
