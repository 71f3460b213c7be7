"""Bounding-box snapping with the reference's border-list semantics
(upstream datasets/*/dataset.py `get_bbox`, SURVEY.md section 2 #8/#9):
this package's own copy of the host part of plr2_tpu/data/bbox.py. The
device bbox of the JAX package (its serving path) is not ported yet.

The reference snaps each mask bbox dimension UP to the next multiple-of-40
entry of `BORDER_LIST`, re-centres the window, and clamps it into the
image. Crops therefore come in at most ~17 distinct sizes per axis.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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
