"""The data path: bbox snapping, the NumPy frame generator, per-crop
preprocessing and the sample iterator (synthetic frames), the LineMOD,
YCB-Video and PoseCNN loaders, the PNG / YAML readers they use
(`codecs`), the frame cache, and the native data plane with its
prefetcher (`prefetch`): the port of plr2_tpu/data."""

from plr2_tpu_torch.data.bbox import BORDER_LIST, get_bbox_from_mask, snap_bbox
from plr2_tpu_torch.data.linemod import LinemodDataset
from plr2_tpu_torch.data.loader import (SyntheticPoseDataset,
                                        SyntheticSceneDataset, iterate_samples,
                                        raw_to_sample, stack_samples)
from plr2_tpu_torch.data.preprocess import (Draws, Sample, draw,
                                            preprocess_crop, sample_choose)
from plr2_tpu_torch.data.ycb import YCBDataset

__all__ = ["BORDER_LIST", "get_bbox_from_mask", "snap_bbox", "LinemodDataset",
           "SyntheticPoseDataset", "SyntheticSceneDataset", "iterate_samples",
           "raw_to_sample", "stack_samples", "Draws", "Sample", "draw",
           "preprocess_crop", "sample_choose", "YCBDataset"]
