"""Per-crop preprocessing: mask -> choose-sampling -> depth backprojection
-> colour jitter -> image normalisation, the port of
plr2_tpu/data/preprocess.py. It runs on the device of its inputs.

The JAX function draws its randomness from a key inside the function. The
port cannot reproduce threefry, so every draw is an explicit argument
(`Draws`): the two key words of the choose hash, the colour-jitter factors
and op order, and the translation noise `add_t`. `draw` takes them from a
`torch.Generator`. Given the same draws, `sample_choose` picks the same
pixels as the JAX function bit for bit, and `preprocess_crop` computes the
same sample.

`sample_choose` is the reference's sampling contract:
  * more than `num_points` masked pixels -> a uniform random subset, in
    ascending pixel order (JAX: top_k over coordinate-hash scores, whose
    ties go to the lowest index; here a stable descending sort, which
    breaks ties the same way)
  * fewer (or exactly `num_points`) -> the masked pixels in order,
    wrap-padded cyclically
  * none -> all zeros (the reference returns a zero sample).
Indices are int64 (torch's index type; JAX returns int32).

`sample_choose_batch` and `preprocess_crops` are the batched, branch-free
twins that the frame-serving program runs (`plr2_tpu_torch/serving.py`):
slots on a leading axis, key words as a (K, 2) int64 tensor, crop origins
and object indices as tensors, no noise. They compute both sampling
candidates for every slot and pick per slot, as the JAX function does, so
nothing reads a count back to the host: no `.item()`, no `nonzero`, and
the constants they need are cached on each device (`_constant`).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from plr2_tpu_torch.geometry.pointcloud import (backproject_depth,
                                                transform_points)

# ImageNet normalisation of the reference's torchvision transform
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the reference's ColorJitter(0.2, 0.2, 0.2, 0.05)
JITTER = (0.2, 0.2, 0.2, 0.05)

_M32 = 0xFFFFFFFF


class _SampleTensors(NamedTuple):
    points: torch.Tensor        # (N, 3) backprojected cloud
    choose: torch.Tensor        # (N,) flat indices into the crop
    img: torch.Tensor           # (H, W, 3) normalised crop
    target: torch.Tensor        # (M, 3) GT-posed model points
    model_points: torch.Tensor  # (M, 3)
    idx: torch.Tensor           # () object index


class Sample(_SampleTensors):
    """The reference's per-sample 6-tuple (channel-last image).

    `obj` is the object index on the host (an int; a tuple of ints for a
    stack of samples), so a trainer picks the loss's ADD-S branch without
    reading the device; None where it is not known. It is an attribute
    beside the tuple, not a field: a Sample iterates, compares and
    unpacks as its six tensors, and `_replace` leaves it None."""

    obj: Any = None

    def __new__(cls, points, choose, img, target, model_points, idx,
                obj: Any = None):
        self = super().__new__(cls, points, choose, img, target,
                               model_points, idx)
        self.obj = obj
        return self


class Draws(NamedTuple):
    """Every random draw of one `preprocess_crop` call."""

    key_words: Tuple[int, int]  # the choose hash's two uint32 key words
    factors: torch.Tensor       # (4,) brightness, contrast, saturation, hue
    order: torch.Tensor         # (4,) permutation of the op ids 0..3
    add_t: torch.Tensor         # (3,) translation noise


def draw(generator: torch.Generator, noise_trans: float = 0.03) -> Draws:
    """One sample's draws from `generator` (a CPU generator: the same seed
    gives the same samples on every device). Each call takes the same
    number of values, whether or not the sample is augmented."""
    words = torch.randint(0, 2 ** 32, (2,), generator=generator)
    u = torch.rand(4, generator=generator)
    b, c, s, h = JITTER
    lo = torch.tensor([max(0.0, 1 - b), max(0.0, 1 - c), max(0.0, 1 - s), -h])
    hi = torch.tensor([1 + b, 1 + c, 1 + s, h])
    order = torch.randperm(4, generator=generator)
    add_t = (torch.rand(3, generator=generator) * 2 - 1) * noise_trans
    return Draws((int(words[0]), int(words[1])), lo + (hi - lo) * u, order,
                 add_t)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def coord_scores(key_words: Union[Tuple[int, int], torch.Tensor], h: int,
                 w: int, device=None) -> torch.Tensor:
    """(h * w,) int64 scores in [0, 2^31) keyed by each pixel's
    window-relative (row, col): the JAX `_coord_scores` murmur3-style uint32
    mix, in int64 arithmetic masked to 32 bits. `key_words` is a pair of
    ints, or an int64 tensor (..., 2) of pairs (on the scores' device),
    which gives (..., h * w) scores, one row per pair."""
    if isinstance(key_words, torch.Tensor):
        device = key_words.device
        k0, k1 = (key_words[..., i, None] & _M32 for i in (0, 1))
    else:
        k0, k1 = (int(k) & _M32 for k in key_words)
    r = torch.arange(h, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    x = (_mul32(r, 0x9E3779B1) ^ _mul32(c, 0x85EBCA77)).reshape(-1)
    x = (x + k0) & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = (x + k1) & _M32
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x >> 1


def sample_choose(mask_flat: torch.Tensor, num_points: int,
                  key_words: Tuple[int, int],
                  width: Optional[int] = None) -> torch.Tensor:
    """mask_flat (P,) bool -> (num_points,) int64 flat indices of the
    chosen pixels. `width` is the window's row stride (the hash keys off
    (row, col)); without it the mask is one row."""
    p = mask_flat.shape[0]
    count = int(mask_flat.sum())
    dev = mask_flat.device
    if count == 0:
        return torch.zeros(num_points, dtype=torch.int64, device=dev)
    if count <= num_points:
        ordered = torch.nonzero(mask_flat).flatten()
        return ordered[torch.arange(num_points, device=dev) % count]
    w = width or p
    scores = torch.where(mask_flat, coord_scores(key_words, p // w, w, dev),
                         torch.full((), -1, dtype=torch.int64, device=dev))
    order = torch.sort(scores, descending=True, stable=True).indices
    return torch.sort(order[:num_points]).values


def sample_choose_batch(mask_flat: torch.Tensor, num_points: int,
                        key_words: torch.Tensor,
                        width: Optional[int] = None) -> torch.Tensor:
    """`sample_choose` of K masks at once, branch-free: mask_flat (K, P)
    bool, key_words (K, 2) int64 -> (K, num_points) int64, each row equal
    to `sample_choose` of that row and its words.

    Both candidates are computed for every row, as the JAX function does:
    the wrap path (the masked indices in ascending order by a stable sort,
    taken at j % max(count, 1)) and the subset path (a stable descending
    sort of the coordinate scores with -1 at unmasked pixels, the first
    num_points, sorted ascending). Each row then takes the subset where
    its count exceeds num_points and is zeroed where its count is 0."""
    k, p = mask_flat.shape
    if num_points > p:
        raise ValueError(f"num_points {num_points} exceeds the {p} pixels "
                         "of a window")
    dev = mask_flat.device
    count = mask_flat.sum(-1, keepdim=True)  # (K, 1)
    j = torch.arange(num_points, device=dev)
    # masked pixels first, each group in ascending index order
    ordered = torch.sort((~mask_flat).to(torch.uint8), dim=-1,
                         stable=True).indices
    wrap = torch.gather(ordered, 1, j % torch.clamp(count, min=1))
    w = width or p
    scores = torch.where(mask_flat, coord_scores(key_words, p // w, w),
                         torch.full((), -1, dtype=torch.int64, device=dev))
    top = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[:, :num_points]
    subset = torch.sort(top, dim=-1).values
    choose = torch.where(count > num_points, subset, wrap)
    return torch.where(count > 0, choose, torch.zeros_like(choose))


def normalize_frames(colors: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3) frames -> a segmenter's f32 input in [-1, 1], as the
    JAX segmentation trainer normalises them: (x / 255 - 0.5) / 0.5."""
    return (colors.float() / 255.0 - 0.5) / 0.5


def normalize_image(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W, 3) -> normalised float32, torchvision semantics."""
    x = img_u8.float() / 255.0
    return _normalize01(x)


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """`values` as a tensor on `device`, made once per device and dtype (a
    copy from the host at every call would sync, and a CUDA graph cannot
    capture one)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _normalize01(x: torch.Tensor) -> torch.Tensor:
    mean = _constant(IMAGENET_MEAN, x.device, torch.float32)
    std = _constant(IMAGENET_STD, x.device, torch.float32)
    return (x - mean) / std


# --- ColorJitter: torchvision's float-tensor formulas, as the JAX package
# transcribes them (_blend with clamp, grayscale weights 0.2989/0.587/0.114,
# contrast toward the grayscale mean, hue through exact RGB <-> HSV) -------


def _blend(img1, img2, ratio):
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def _rgb_to_grayscale(x):
    """(..., 3) -> (..., 1)."""
    w = _constant((0.2989, 0.587, 0.114), x.device, x.dtype)
    return (x * w).sum(-1, keepdim=True)


def adjust_brightness(x, factor):
    return _blend(x, torch.zeros_like(x), factor)


def adjust_contrast(x, factor):
    mean = _rgb_to_grayscale(x).mean(dim=(-3, -2, -1), keepdim=True)
    return _blend(x, mean, factor)


def adjust_saturation(x, factor):
    return _blend(x, _rgb_to_grayscale(x), factor)


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.amax(-1)
    minc = x.amin(-1)
    eqc = maxc == minc
    one = torch.ones_like(maxc)
    cr = maxc - minc
    s = cr / torch.where(eqc, one, maxc)
    cr_div = torch.where(eqc, one, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    zero = torch.zeros_like(maxc)
    hr = torch.where(maxc == r, bc - gc, zero)
    hg = torch.where((maxc == g) & (maxc != r), 2.0 + rc - bc, zero)
    hb = torch.where((maxc != g) & (maxc != r), 4.0 + gc - rc, zero)
    h = torch.remainder((hr + hg + hb) / 6.0 + 1.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.to(torch.int64) % 6
    p = torch.clamp(v * (1.0 - s), 0.0, 1.0)
    q = torch.clamp(v * (1.0 - s * f), 0.0, 1.0)
    t = torch.clamp(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    sel = i[..., None]
    return torch.stack([
        torch.gather(torch.stack([v, q, p, p, t, v], -1), -1, sel)[..., 0],
        torch.gather(torch.stack([t, v, v, q, p, p], -1), -1, sel)[..., 0],
        torch.gather(torch.stack([p, p, t, v, v, q], -1), -1, sel)[..., 0],
    ], dim=-1)


def adjust_hue(x, factor):
    hsv = _rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + factor, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


_JITTER_OPS = (adjust_brightness, adjust_contrast, adjust_saturation,
               adjust_hue)


def apply_jitter_ops(img01, factors, order):
    """Brightness / contrast / saturation / hue with `factors` (4,), applied
    in the permutation `order` (4,) of the op ids 0..3."""
    factors = torch.as_tensor(factors, dtype=img01.dtype).to(img01.device)
    for op in torch.as_tensor(order).tolist():
        img01 = _JITTER_OPS[op](img01, factors[op])
    return img01


def color_jitter(img01: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """ColorJitter(0.2, 0.2, 0.2, 0.05) with factors and order from
    `generator` (`draw`'s draws)."""
    d = draw(generator)
    return apply_jitter_ops(img01, d.factors, d.order)


def preprocess_crop(color_crop: torch.Tensor,   # (H, W, 3) uint8
                    depth_crop: torch.Tensor,   # (H, W) float32 raw depth
                    mask_crop: torch.Tensor,    # (H, W) bool
                    row0: int, col0: int,       # crop origin in the image
                    intrinsics: torch.Tensor,   # (5,) cx, cy, fx, fy, scale
                    model_points: torch.Tensor,  # (M, 3)
                    target_r: torch.Tensor,     # (3, 3)
                    target_t: torch.Tensor,     # (3,)
                    obj_idx: int,
                    draws: Draws,
                    num_points: int,
                    add_noise: bool = False) -> Sample:
    """One crop window -> Sample, on the device of the crop tensors."""
    h, w = depth_crop.shape
    dev = depth_crop.device
    choose = sample_choose(mask_crop.reshape(-1), num_points, draws.key_words,
                           width=w)
    depth_sel = depth_crop.reshape(-1)[choose]
    rows = (choose // w).float() + float(row0)
    cols = (choose % w).float() + float(col0)
    cx, cy, fx, fy, cam_scale = intrinsics.float().to(dev).unbind(0)
    cloud = backproject_depth(depth_sel, rows, cols, cx, cy, fx, fy, cam_scale)

    img01 = color_crop.float() / 255.0
    if add_noise:
        img01 = apply_jitter_ops(img01, draws.factors, draws.order)
        add_t = draws.add_t.float().to(dev)
        cloud = cloud + add_t
    else:
        add_t = torch.zeros(3, device=dev)
    target = transform_points(model_points.float(), target_r.float(),
                              target_t.float()) + add_t
    return Sample(points=cloud, choose=choose, img=_normalize01(img01),
                  target=target, model_points=model_points.float(),
                  idx=torch.tensor(int(obj_idx), device=dev), obj=int(obj_idx))


def preprocess_crops(color_crops: torch.Tensor,   # (K, H, W, 3) uint8
                     depth_crops: torch.Tensor,   # (K, H, W) f32 raw depth
                     mask_crops: torch.Tensor,    # (K, H, W) bool
                     row0: torch.Tensor,          # (K,) int crop origins
                     col0: torch.Tensor,          # (K,)
                     intrinsics: torch.Tensor,    # (5,) or (K, 5) cx cy fx fy scale
                     model_points: torch.Tensor,  # (K, M, 3)
                     target_r: torch.Tensor,      # (K, 3, 3)
                     target_t: torch.Tensor,      # (K, 3)
                     obj_idx: torch.Tensor,       # (K,) int
                     key_words: torch.Tensor,     # (K, 2) int64
                     num_points: int) -> Sample:
    """K crop windows -> one batched Sample (fields with a leading K axis),
    `preprocess_crop` with add_noise=False on each window, computed
    without a host sync: every argument but num_points is a tensor on the
    crops' device. Row k equals `preprocess_crop` of window k given the
    same key words (tests/test_torch_port_serving.py)."""
    k, h, w = depth_crops.shape
    choose = sample_choose_batch(mask_crops.reshape(k, h * w), num_points,
                                 key_words, width=w)
    depth_sel = torch.gather(depth_crops.reshape(k, h * w), 1, choose)
    rows = (choose // w).float() + row0.float()[:, None]
    cols = (choose % w).float() + col0.float()[:, None]
    # (5,) or one row per window: each (1 or K, 1) beside the (K, N) maps
    cx, cy, fx, fy, cam_scale = intrinsics.float().reshape(-1, 1, 5).unbind(-1)
    cloud = backproject_depth(depth_sel, rows, cols, cx, cy, fx, fy, cam_scale)
    target = transform_points(model_points.float(), target_r.float(),
                              target_t.float())
    return Sample(points=cloud, choose=choose,
                  img=_normalize01(color_crops.float() / 255.0),
                  target=target, model_points=model_points.float(),
                  idx=obj_idx)
