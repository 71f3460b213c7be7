"""The synthetic data path: bbox snapping, the NumPy frame generator,
per-crop preprocessing and the sample iterator (the port of the parts of
plr2_tpu/data that synthetic training runs)."""

from plr2_tpu_torch.data.bbox import BORDER_LIST, get_bbox_from_mask, snap_bbox
from plr2_tpu_torch.data.loader import (SyntheticPoseDataset,
                                        SyntheticSceneDataset, iterate_samples,
                                        raw_to_sample, stack_samples)
from plr2_tpu_torch.data.preprocess import (Draws, Sample, draw,
                                            preprocess_crop, sample_choose)

__all__ = ["BORDER_LIST", "get_bbox_from_mask", "snap_bbox",
           "SyntheticPoseDataset", "SyntheticSceneDataset", "iterate_samples",
           "raw_to_sample", "stack_samples", "Draws", "Sample", "draw",
           "preprocess_crop", "sample_choose"]
