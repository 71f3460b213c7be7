"""Frame serving: full RGB-D frames -> per-object refined poses, the port of
plr2_tpu/serving.py (`FramePoses`, `FrameEstimator`).

The JAX package runs the whole per-frame chain as one XLA program:

    [segmenter label map (optional)] -> per-object mask -> border-list
    bbox (device twin) -> canvas crop -> fused choose / backproject /
    normalise preprocessing -> one PoseNet batch over every object -> best
    hypothesis -> refinement.

Here the same chain is one sequence of CUDA work with no host sync in it
(no `.item()`, no `nonzero`, no host copy: `data/bbox.py`'s device twins
and `data/preprocess.py`'s batched functions), and on a CUDA pipeline it
is captured as ONE CUDA graph per set of static knobs: canvas, K (or F
frames x K slots), num_points, refine iterations, the pipeline's dtype,
the segmenter's scale and dtype, poses only or with the samples, and
which optional inputs were given.
The first call of a knob set runs the program eagerly (the warm-up: the
PSP matrices cached, the kernels' shared-memory limits set, cuDNN's
algorithms picked, the device constants made), copies its inputs into
static buffers and captures the program with `torch.cuda.graph`; later
calls copy their inputs in and `replay()`. The f32 program is captured
inside `pipeline.full_f32`, as `estimate` runs it. `graphs=False` runs the
same program eagerly (a CPU pipeline always does). A capture that fails
raises: there is no fallback.

Crop windows are cut at the canvas top-left over a zero background, as
the host chain's `stack_samples` places them, so on the wrap-sampling path
the program equals host bbox -> `raw_to_sample` -> `stack_samples` ->
`estimate` given the same key words.

Keys. JAX folds the frame key by each object id, so an object draws the
same pixels in any slot. The port cannot run threefry: every entry point
takes optional per-slot `key_words` ((K, 2) or (F, K, 2) int64, the two
words the choose hash reads; the tests pass JAX's), and by default derives
them on the device from (frame seed, object id) by an integer mix of its
own (`frame_key_words`), so they depend on the object id and not on the
slot, as JAX's do.

Segmentation on the device: with `seg_model` (a segmenter of
`models/segnet.py` `build_segmenter`, either architecture, in its own
dtype) the frame's `label` is ignored and the program segments the frames
itself (`_segment`: normalise, zero-pad to a multiple of 32 * seg_scale,
an s x s average pool when seg_scale = s > 1, the segmenter, argmax,
nearest upsample by s, cut to the frame), inside the same graph. The
segmenter is put in eval mode. `seg_variables` (a state dict) are copied
into the segmenter's parameters in place, so a graph already captured
replays with them; casting the segmenter (new parameter storage) drops
the graphs, as `pipe.cast` does.

Frames over a mesh (`mesh`, a `parallel.mesh.Mesh` with a `data` axis
of n ranks, each with its own estimator and pipeline on its device):
`run_frames` is given the same F frames on every rank, F divisible by n;
each rank runs its contiguous block of F / n frames through its own graph,
and the `FramePoses` of all F frames come back to every rank (an exact
gather, `Axis.gather_rows`). `run` and `run_with_samples` ignore the mesh,
as JAX's do.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from plr2_tpu_torch.data.bbox import device_bbox_from_mask
from plr2_tpu_torch.data.preprocess import (Sample, _M32, _mul32,
                                            normalize_frames, preprocess_crops)
from plr2_tpu_torch.pipeline import DenseFusionPipeline, full_f32
from plr2_tpu_torch.utils.cuda_graphs import capture as _capture
from plr2_tpu_torch.utils.cuda_graphs import clone as _clone
from plr2_tpu_torch.utils.cuda_graphs import weights_key


class FramePoses(NamedTuple):
    quat: torch.Tensor        # (K, 4) wxyz, normalized
    trans: torch.Tensor       # (K, 3)
    confidence: torch.Tensor  # (K,) best per-point confidence
    valid: torch.Tensor       # (K,) bool: active slot with enough mask pixels
    # (K,) bool: a detection whose snapped window exceeds the canvas, the
    # one drop reason a larger canvas fixes (tools/serve.py
    # --auto_grow_canvas); always implies not valid
    oversized: torch.Tensor


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 values in [0, 2^32)."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def frame_key_words(seeds: torch.Tensor, obj_ids: torch.Tensor) -> torch.Tensor:
    """The default choose-hash key words of each slot: seeds (...,) frame
    seeds and obj_ids (..., K) -> (..., K, 2) int64 words in [0, 2^32),
    a function of (seed, object id) only, computed on their device."""
    s = seeds.to(torch.int64)[..., None] & _M32
    o = obj_ids.to(torch.int64) & _M32
    w0 = _fmix32((_mul32(s, 0x9E3779B1) + o) & _M32)
    w1 = _fmix32((w0 + _mul32(o, 0x85EBCA77) + 0x27D4EB2F) & _M32)
    return torch.stack([w0, w1], dim=-1)


class FrameEstimator:
    """Runs the frame program of `pipe` (its dtype decides f32 / bf16).

    seg_model: optional segmenter (`build_segmenter`); when given, the
        frames are segmented on the device and `label` is ignored.
    seg_scale: s >= 1; s > 1 runs the segmenter on an s-times smaller
        frame (s x s average pool) and nearest-upsamples its labels: about
        s^2 less segmenter work, at s-pixel mask quantisation.
    graphs: on a CUDA pipeline, capture one CUDA graph per knob set and
        replay it (True), or run the program eagerly (False).
    mesh: a mesh whose `data` axis splits `run_frames`' frames (module
        docstring).
    """

    def __init__(self, pipe: DenseFusionPipeline, *, canvas: int = 240,
                 img_h: int = 480, img_w: int = 640,
                 refine_iterations: int = 4, min_mask_pixels: int = 50,
                 seg_model: Any = None, seg_scale: int = 1, mesh: Any = None,
                 graphs: bool = True):
        if canvas > img_h or canvas > img_w:
            raise ValueError("canvas must fit inside the frame")
        if seg_scale < 1:
            raise ValueError("seg_scale must be >= 1")
        self.pipe = pipe
        self.data_axis = None if mesh is None else mesh.axis("data")
        self.canvas = canvas
        self.img_h = img_h
        self.img_w = img_w
        self.refine_iterations = refine_iterations
        self.min_mask_pixels = min_mask_pixels
        self.seg_model = None if seg_model is None else seg_model.eval()
        self.seg_scale = seg_scale
        self.graphs = graphs and pipe.device.type == "cuda"
        self._graphs = {}
        self._weights = None

    # -- F frames x K slots: mask -> bbox -> canvas crop -> preprocessing --

    def _frame_samples(self, colors, depths, labels, obj_ids, model_points,
                       target_r, target_t, intr, words):
        """(F, H, W, ...) frames and (F, K) slots -> a Sample over the F*K
        slots (leading axis) and valid / oversized (F*K,)."""
        f, k = obj_ids.shape
        c, dev = self.canvas, obj_ids.device
        h, w = labels.shape[1:]
        # pad bottom and right by the canvas: a window starting anywhere in
        # the image never leaves the padded frame, so it lands at the
        # canvas top-left over zeros, as stack_samples places it
        colors_p = colors.new_zeros((f, h + c, w + c, 3))
        colors_p[:, :h, :w] = colors
        depths_p = depths.new_zeros((f, h + c, w + c))
        depths_p[:, :h, :w] = depths
        labels_p = labels.new_zeros((f, h + c, w + c))
        labels_p[:, :h, :w] = labels
        # the depth-intersected mask, as the host chain builds raw["mask"]
        mask = ((labels_p[:, None] == obj_ids[:, :, None, None])
                & (depths_p[:, None] > 0)).reshape(f * k, h + c, w + c)
        npix = mask.sum((-2, -1))
        # the mask is padded: clamp windows against the REAL image
        rmin, rmax, cmin, cmax = device_bbox_from_mask(mask, self.img_h,
                                                       self.img_w)
        ar = torch.arange(c, device=dev)
        # dynamic_slice's start clamp (only a window larger than the image,
        # flagged oversized below, starts above row or column 0)
        rows = (torch.clamp(rmin, min=0)[:, None] + ar)[:, :, None]
        cols = (torch.clamp(cmin, min=0)[:, None] + ar)[:, None, :]
        slot = torch.arange(f * k, device=dev)[:, None, None]
        frame = slot // k
        inwin = ((ar[None, :, None] < (rmax - rmin)[:, None, None])
                 & (ar[None, None, :] < (cmax - cmin)[:, None, None]))
        flat = obj_ids.reshape(-1)
        # clamp the head index of inactive or out-of-range slots (their
        # outputs are discarded through `valid`)
        idx = torch.clamp(flat - 1, 0, self.pipe.num_objects - 1)
        sample = preprocess_crops(
            colors_p[frame, rows, cols], depths_p[frame, rows, cols],
            mask[slot, rows, cols] & inwin, rmin, cmin,
            intr[:, None, :].expand(f, k, 5).reshape(f * k, 5),
            model_points.reshape((f * k,) + model_points.shape[2:]),
            target_r.reshape(f * k, 3, 3), target_t.reshape(f * k, 3), idx,
            words.reshape(f * k, 2), self.pipe.num_points)
        # stack_samples zero-pads the NORMALISED crop: zero the background
        # after normalisation to match
        sample = sample._replace(img=torch.where(
            inwin[..., None], sample.img, torch.zeros((), device=dev)))
        # a window larger than the canvas would be truncated: flag the slot
        # (a larger canvas serves it) rather than return a wrong pose
        fits = (rmax - rmin <= c) & (cmax - cmin <= c)
        detected = (flat > 0) & (npix >= self.min_mask_pixels)
        return sample, detected & fits, detected & ~fits

    def _seg_dtype(self) -> Optional[torch.dtype]:
        if self.seg_model is None:
            return None
        return next(self.seg_model.parameters()).dtype

    def _segment(self, colors: torch.Tensor) -> torch.Tensor:
        """(F, H, W, 3) uint8 frames -> (F, H, W) int32 labels, on the
        device and without a sync."""
        s = self.seg_scale
        unit = 32 * s
        f, h, w = colors.shape[:3]
        norm = F.pad(normalize_frames(colors),
                     (0, 0, 0, -(-w // unit) * unit - w,
                      0, -(-h // unit) * unit - h))
        if s > 1:
            _, hp, wp, c = norm.shape
            norm = norm.reshape(f, hp // s, s, wp // s, s, c).mean((2, 4))
        with full_f32(self._seg_dtype() == torch.float32):
            labels = self.seg_model(norm).argmax(-1).to(torch.int32)
        if s > 1:
            _, hs, ws = labels.shape
            labels = labels[:, :, None, :, None].expand(
                f, hs, s, ws, s).reshape(f, hs * s, ws * s)
        return labels[:, :h, :w]

    def _program(self, with_samples, colors, depths, labels, obj_ids,
                 model_points, intr, seeds, words, target_r, target_t):
        """The frame program over (F, ...) inputs: FramePoses with (F, K)
        fields, and the (F, K, ...) samples when `with_samples`."""
        f, k = obj_ids.shape
        dev = obj_ids.device
        if self.seg_model is not None:
            with torch.no_grad():
                labels = self._segment(colors)
        if words is None:
            words = frame_key_words(seeds, obj_ids)
        if target_r is None:
            target_r = torch.eye(3, device=dev).expand(f, k, 3, 3)
        if target_t is None:
            target_t = torch.zeros((f, k, 3), device=dev)
        with torch.no_grad(), full_f32(self.pipe.dtype == torch.float32):
            samples, valid, oversized = self._frame_samples(
                colors, depths, labels, obj_ids, model_points, target_r,
                target_t, intr, words)
            est = self.pipe.estimate(samples.img, samples.points,
                                     samples.choose, samples.idx,
                                     refine_iterations=self.refine_iterations)
        poses = FramePoses(
            quat=est.quat.reshape(f, k, 4), trans=est.trans.reshape(f, k, 3),
            confidence=est.confidence.reshape(f, k),
            valid=valid.reshape(f, k), oversized=oversized.reshape(f, k))
        if not with_samples:
            return poses
        return poses, Sample(*(x.reshape((f, k) + x.shape[1:])
                               for x in samples))

    # -- dispatch: eager, or one CUDA graph per knob set --

    def _knobs(self, with_samples: bool, args: Sequence) -> tuple:
        """The static knobs a call's graph is keyed by: canvas, num_points,
        refine iterations, dtype, poses only or with samples, each input's
        shape and dtype (None where not given: K or (F, K) is the shape of
        obj_ids), the segmenter's scale and dtype (None without one)."""
        return (self.canvas, self.pipe.num_points, self.refine_iterations,
                self.pipe.dtype, with_samples,
                tuple(None if a is None else (tuple(a.shape), a.dtype)
                      for a in args), self.seg_scale, self._seg_dtype())

    def _dispatch(self, with_samples, args):
        if not self.graphs:
            return self._program(with_samples, *args)
        weights = weights_key(self.pipe)
        if self.seg_model is not None:
            weights += (next(self.seg_model.parameters()).data_ptr(),)
        if weights != self._weights:  # the pipeline was cast: new graphs
            self._graphs.clear()
            self._weights = weights
        key = self._knobs(with_samples, args)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = _capture(
                lambda *a: self._program(with_samples, *a), args)
        else:
            for static, a in zip(entry.inputs, args):
                if a is not None:
                    static.copy_(a)
        entry.graph.replay()
        return _clone(entry.outputs)

    def _inputs(self, colors, depths, labels, obj_ids, model_points, intr,
                keys, key_words, target_r, target_t):
        """Every input as a tensor on the pipeline's device (a no-op for
        device tensors of the right dtype), in the program's order."""
        dev = self.pipe.device

        def t(x, dtype):
            if x is None:
                return None
            if isinstance(x, int):  # a seed: filled on the device, no copy
                return torch.full((), x, dtype=dtype, device=dev)
            return torch.as_tensor(x, dtype=dtype, device=dev)
        seeds = None if key_words is not None else t(keys, torch.int64)
        if self.seg_model is not None:
            labels = None  # the program segments the frames itself
        return (t(colors, torch.uint8), t(depths, torch.float32),
                t(labels, torch.int32), t(obj_ids, torch.int64),
                t(model_points, torch.float32), t(intr, torch.float32),
                seeds, t(key_words, torch.int64), t(target_r, torch.float32),
                t(target_t, torch.float32))

    def _load_seg(self, seg_variables: Optional[Mapping]) -> None:
        """Copy a segmenter state dict into the segmenter in place (a
        captured graph reads the new values)."""
        if seg_variables is None:
            return
        if self.seg_model is None:
            raise ValueError("seg_variables given to a FrameEstimator "
                             "without seg_model")
        self.seg_model.load_state_dict(seg_variables, strict=True)

    def _single(self, with_samples, color, depth, label, obj_ids,
                model_points, intr_vec, key, seg_variables, target_r,
                target_t, key_words):
        self._load_seg(seg_variables)
        args = self._inputs(color, depth, label, obj_ids, model_points,
                            intr_vec, key, key_words, target_r, target_t)
        # one frame is the F = 1 case of the frame-batch program
        args = tuple(None if a is None else a[None] for a in args)
        out = self._dispatch(with_samples, args)
        if not with_samples:
            return FramePoses(*(x[0] for x in out))
        poses, samples = out
        return (FramePoses(*(x[0] for x in poses)),
                Sample(*(x[0] for x in samples)))

    # -- public surface --

    def run(self, color, depth, label, obj_ids, model_points, intr_vec,
            key=0, seg_variables=None, target_r=None, target_t=None,
            key_words: Optional[torch.Tensor] = None) -> FramePoses:
        """Poses of up to K = len(obj_ids) objects of one frame.

        color (H, W, 3) uint8; depth (H, W) f32 raw units; label (H, W)
        int (ignored, and may be None, with a seg_model); obj_ids (K,) 1-based label ids, <= 0 for inactive slots;
        model_points (K, M, 3); intr_vec (5,) [cx cy fx fy cam_scale];
        key: the frame seed (an int or a 0-d int tensor) the slots' key
        words derive from, unless `key_words` (K, 2) gives them.
        target_r / target_t (optional ground truth) only set the samples'
        `target` (`run_with_samples`). Arrays may be NumPy or tensors on
        any device; tensors on the pipeline's device are not copied."""
        return self._single(False, color, depth, label, obj_ids,
                            model_points, intr_vec, key, seg_variables,
                            target_r, target_t, key_words)

    def run_with_samples(self, color, depth, label, obj_ids, model_points,
                         intr_vec, key=0, seg_variables=None, target_r=None,
                         target_t=None,
                         key_words: Optional[torch.Tensor] = None):
        """run(), and the preprocessed (K, ...) Sample batch (for
        evaluation: sample.target holds the GT-posed model points when
        target_r / target_t are given)."""
        return self._single(True, color, depth, label, obj_ids, model_points,
                            intr_vec, key, seg_variables, target_r, target_t,
                            key_words)

    def run_frames(self, colors, depths, labels, obj_ids, model_points,
                   intr_vecs, keys, seg_variables=None, target_r=None,
                   target_t=None,
                   key_words: Optional[torch.Tensor] = None) -> FramePoses:
        """F frames at once (a leading F axis on every argument; obj_ids
        (F, K), keys (F,) frame seeds, key_words (F, K, 2)): FramePoses
        with (F, K, ...) fields. The F*K crops share one PoseNet batch and
        the F frames one segmenter batch. Over a mesh each rank runs its
        block of the frames and every rank gets the poses of all F."""
        self._load_seg(seg_variables)
        args = self._inputs(colors, depths, labels, obj_ids, model_points,
                            intr_vecs, keys, key_words, target_r, target_t)
        if self.data_axis is None:
            return self._dispatch(False, args)
        rows = self.data_axis.block(args[3].shape[0], "run_frames' frames")
        poses = self._dispatch(False, tuple(
            a if a is None or a.dim() == 0 else a[rows] for a in args))
        return FramePoses(*(self.data_axis.gather_rows(x) for x in poses))
