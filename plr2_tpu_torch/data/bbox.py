"""Bounding-box snapping with the reference's border-list semantics
(upstream datasets/*/dataset.py `get_bbox`, SURVEY.md section 2 #8/#9):
this package's own copy of plr2_tpu/data/bbox.py. The host functions take
NumPy masks and Python ints; their device twins (`device_snap_bbox`,
`device_bbox_from_mask`, used by the frame-serving program in
`plr2_tpu_torch/serving.py`) take tensors batched over leading slot axes
and compute the same windows in int64 tensor arithmetic on the mask's
device, with no host sync.

The reference snaps each mask bbox dimension UP to the next multiple-of-40
entry of `BORDER_LIST`, re-centres the window, and clamps it into the
image. Crops therefore come in at most ~17 distinct sizes per axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

BORDER_LIST = [-1, 40, 80, 120, 160, 200, 240, 280, 320,
               360, 400, 440, 480, 520, 560, 600, 640, 680]


def get_bbox_from_mask(mask: np.ndarray, img_h: int = 480, img_w: int = 640
                       ) -> Tuple[int, int, int, int]:
    """mask (H, W) bool -> (rmin, rmax, cmin, cmax) snapped window.

    Replicates the reference algorithm: tight bbox of the mask, +1 on max,
    snap each side length up through BORDER_LIST, re-centre, shift fully
    inside the image.
    """
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if not rows.any():
        return 0, min(40, img_h), 0, min(40, img_w)
    rmin, rmax = np.flatnonzero(rows)[[0, -1]]
    cmin, cmax = np.flatnonzero(cols)[[0, -1]]
    rmax += 1
    cmax += 1
    return snap_bbox(int(rmin), int(rmax), int(cmin), int(cmax), img_h, img_w)


def snap_bbox(rmin: int, rmax: int, cmin: int, cmax: int,
              img_h: int = 480, img_w: int = 640) -> Tuple[int, int, int, int]:
    """Snap a tight bbox to the border-list window (reference arithmetic)."""
    r_b = rmax - rmin
    for tt in range(len(BORDER_LIST) - 1):
        if BORDER_LIST[tt] < r_b <= BORDER_LIST[tt + 1]:
            r_b = BORDER_LIST[tt + 1]
            break
    c_b = cmax - cmin
    for tt in range(len(BORDER_LIST) - 1):
        if BORDER_LIST[tt] < c_b <= BORDER_LIST[tt + 1]:
            c_b = BORDER_LIST[tt + 1]
            break
    center = [int((rmin + rmax) / 2), int((cmin + cmax) / 2)]
    rmin = center[0] - int(r_b / 2)
    rmax = center[0] + int(r_b / 2)
    cmin = center[1] - int(c_b / 2)
    cmax = center[1] + int(c_b / 2)
    if rmin < 0:
        rmax -= rmin
        rmin = 0
    if cmin < 0:
        cmax -= cmin
        cmin = 0
    if rmax > img_h:
        rmin -= rmax - img_h
        rmax = img_h
    if cmax > img_w:
        cmin -= cmax - img_w
        cmax = img_w
    return rmin, rmax, cmin, cmax


# --- device twins of the two functions above, equal to them on every
# window (tests/test_torch_port_serving.py): batched over leading axes,
# no .item(), no nonzero, so a frame program that calls them captures
# into one CUDA graph. ----------------------------------------------------

def _snap_len_device(n: torch.Tensor) -> torch.Tensor:
    """Snap side lengths UP through BORDER_LIST (host loop semantics:
    lengths beyond the last entry stay unsnapped)."""
    # BORDER_LIST[1:] is 40, 80, ..., 680: built on the device, no copy
    border = 40 * torch.arange(1, len(BORDER_LIST), device=n.device,
                               dtype=torch.int64)
    i = torch.searchsorted(border, n.contiguous(), right=False)
    snapped = border[torch.clamp(i, max=border.shape[0] - 1)]
    return torch.where(n > border[-1], n, snapped)


def device_snap_bbox(rmin, rmax, cmin, cmax, img_h: int, img_w: int):
    """`snap_bbox` on int64 tensors of any (equal) shape: the same integer
    arithmetic (every intermediate is non-negative where the host floors,
    so `//` equals `int(x / 2)`)."""
    r_b = _snap_len_device(rmax - rmin)
    c_b = _snap_len_device(cmax - cmin)
    cr, cc = (rmin + rmax) // 2, (cmin + cmax) // 2
    rmin, rmax = cr - r_b // 2, cr + r_b // 2
    cmin, cmax = cc - c_b // 2, cc + c_b // 2
    rmax = rmax + torch.clamp(-rmin, min=0)
    rmin = torch.clamp(rmin, min=0)
    cmax = cmax + torch.clamp(-cmin, min=0)
    cmin = torch.clamp(cmin, min=0)
    rmin = rmin - torch.clamp(rmax - img_h, min=0)
    rmax = torch.clamp(rmax, max=img_h)
    cmin = cmin - torch.clamp(cmax - img_w, min=0)
    cmax = torch.clamp(cmax, max=img_w)
    return rmin, rmax, cmin, cmax


def _first_true(v: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where there is none):
    argmax returns the first maximal index."""
    return torch.argmax(v.to(torch.uint8), dim=-1)


def device_bbox_from_mask(mask: torch.Tensor, img_h: Optional[int] = None,
                          img_w: Optional[int] = None):
    """`get_bbox_from_mask` on (..., H, W) bool masks -> four int64 tensors
    (rmin, rmax, cmin, cmax) of shape (...), the empty-mask default
    (0, min(40, img_h), 0, min(40, img_w)) included.

    img_h / img_w override the clamp bounds: a caller that hands in a
    zero-padded mask (the serving program pads bottom and right by its
    canvas) passes the real image size here, so windows near the bottom or
    right edge shift inside the image as the host function shifts them."""
    h, w = mask.shape[-2:]
    img_h = h if img_h is None else img_h
    img_w = w if img_w is None else img_w
    rows = mask.any(dim=-1)
    cols = mask.any(dim=-2)
    nonempty = rows.any(dim=-1)
    rmin = _first_true(rows)
    rmax = h - _first_true(rows.flip(-1))  # last index + 1
    cmin = _first_true(cols)
    cmax = w - _first_true(cols.flip(-1))
    snapped = device_snap_bbox(rmin, rmax, cmin, cmax, img_h, img_w)
    default = (0, min(40, img_h), 0, min(40, img_w))
    return tuple(torch.where(nonempty, s, torch.full_like(s, d))
                 for s, d in zip(snapped, default))
