"""Plain reference of the frame program that a serve cell times, and the
judge of its answers.

Per frame and object slot, in NumPy (the same semantics as DenseFusion's
dataset code and the port's documented serving contract):
- the slot's mask: label == id and depth > 0; its pixel count;
- the border-list window (upstream `get_bbox`): the tight box, +1 on the
  maxima, each side snapped up through 40, 80, ..., 680, re-centred,
  shifted inside the image; `valid` = an object id > 0 with at least
  `min_mask_pixels` mask pixels whose window fits the canvas,
  `oversized` = such a slot whose window does not;
- the crop: the window at the canvas's top-left over zeros;
- the points: more masked pixels than `num_points` -> the `num_points`
  with the highest coordinate hash (lowest index on ties) in ascending
  order; fewer -> the masked pixels in order, wrap-padded; none -> zeros.
  The hash and the per-slot key words follow the serving contract
  (murmur3-style 32-bit mixes of the window-relative row and column, and
  of the frame seed and object id);
- the cloud by pinhole backprojection, the image normalised with
  ImageNet's mean and std and zero outside the window.
Then PoseNet (`model.posenet`, eval mode), every hypothesis kept.

The judge (`judge`) reads the program's answer for a slot (quaternion,
translation, confidence, flags) and scores it against these hypotheses:
- `flags`: slots whose `valid` or `oversized` differ (exact);
- `conf_gap`: |the program's confidence - the reference's best| over
  valid slots (the best confidence is continuous in the weights, so ties
  do not move it);
- `pose_gap`: the hypotheses the program may have picked are those whose
  reference confidence lies within the cell's `candidate_window` of the
  reference's best (bf16 rounds the confidences, and with random weights
  many points tie to rounding), and at least the `least` most confident;
  each is refined by the reference, and the slot's gap is the least mean
  distance, over the slot's model points, between the program's pose and
  a candidate's, relative to the candidate's mean distance of those
  points from the camera (random weights move a pose by metres, so a
  distance in metres would scale with the weights and not with the
  error). A pose refined from a hypothesis that the reference ranks
  below the window matches no candidate: the pick is judged too. Every
  valid slot of every answer is judged; the driver reports the widest
  slot's gap (`pose_gap`), the 90th percentile (`pose_gap_p90`) and the
  median (`pose_gap_median`); a cell's limits say which it compares.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import model as M

BORDER = [-1] + [40 * i for i in range(1, 18)]
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
M32 = 0xFFFFFFFF


def _mul(x, c):
    return (x * np.uint64(c)) & np.uint64(M32)


def _fmix(x):
    x = _mul(x ^ (x >> np.uint64(16)), 0x85EBCA6B)
    x = _mul(x ^ (x >> np.uint64(13)), 0xC2B2AE35)
    return x ^ (x >> np.uint64(16))


def key_words(seed: int, obj_id: int):
    """The slot's two hash words from (frame seed, object id)."""
    s = np.uint64(int(seed) & M32)
    o = np.uint64(int(obj_id) & M32)
    w0 = _fmix((_mul(s, 0x9E3779B1) + o) & np.uint64(M32))
    w1 = _fmix((w0 + _mul(o, 0x85EBCA77) + np.uint64(0x27D4EB2F))
               & np.uint64(M32))
    return int(w0), int(w1)


def coord_scores(words, h: int, w: int) -> np.ndarray:
    """(h * w,) int64 hash scores of the window-relative pixels."""
    k0, k1 = (np.uint64(k & M32) for k in words)
    r = np.arange(h, dtype=np.uint64)[:, None]
    c = np.arange(w, dtype=np.uint64)[None, :]
    x = (_mul(r, 0x9E3779B1) ^ _mul(c, 0x85EBCA77)).reshape(-1)
    x = (x + k0) & np.uint64(M32)
    x = _mul(x ^ (x >> np.uint64(16)), 0x7FEB352D)
    x = (x + k1) & np.uint64(M32)
    x = _mul(x ^ (x >> np.uint64(15)), 0x846CA68B)
    x = x ^ (x >> np.uint64(16))
    return (x >> np.uint64(1)).astype(np.int64)


def _snap(n: int) -> int:
    for a, b in zip(BORDER[:-1], BORDER[1:]):
        if a < n <= b:
            return b
    return n


def snap_bbox(rmin, rmax, cmin, cmax, img_h, img_w):
    r_b, c_b = _snap(rmax - rmin), _snap(cmax - cmin)
    cr, cc = int((rmin + rmax) / 2), int((cmin + cmax) / 2)
    rmin, rmax = cr - int(r_b / 2), cr + int(r_b / 2)
    cmin, cmax = cc - int(c_b / 2), cc + int(c_b / 2)
    if rmin < 0:
        rmax, rmin = rmax - rmin, 0
    if cmin < 0:
        cmax, cmin = cmax - cmin, 0
    if rmax > img_h:
        rmin, rmax = rmin - (rmax - img_h), img_h
    if cmax > img_w:
        cmin, cmax = cmin - (cmax - img_w), img_w
    return rmin, rmax, cmin, cmax


def choose_pixels(mask_flat: np.ndarray, num_points: int, words, h, w):
    idx = np.flatnonzero(mask_flat)
    if len(idx) == 0:
        return np.zeros(num_points, np.int64)
    if len(idx) <= num_points:
        return idx[np.arange(num_points) % len(idx)].astype(np.int64)
    scores = coord_scores(words, h, w)[idx]
    top = idx[np.lexsort((idx, -scores))[:num_points]]
    return np.sort(top).astype(np.int64)


def prepare_slot(color, depth, label, obj_id, seed, intr, canvas,
                 num_points, min_mask_pixels, num_obj):
    """One slot of one frame -> its crop, cloud, choose and flags."""
    img_h, img_w = label.shape
    c = canvas
    mask = (label == obj_id) & (depth > 0)
    npix = int(mask.sum())
    rows, cols = np.flatnonzero(mask.any(1)), np.flatnonzero(mask.any(0))
    if len(rows):
        box = snap_bbox(rows[0], rows[-1] + 1, cols[0], cols[-1] + 1, img_h,
                        img_w)
    else:
        box = (0, min(40, img_h), 0, min(40, img_w))
    rmin, rmax, cmin, cmax = box
    fits = rmax - rmin <= c and cmax - cmin <= c
    detected = obj_id > 0 and npix >= min_mask_pixels
    r0, c0 = max(rmin, 0), max(cmin, 0)
    hh, ww = min(rmax - rmin, c), min(cmax - cmin, c)
    win = np.zeros((c, c), bool)
    win[:hh, :ww] = True
    pad = lambda a: np.pad(a, [(0, c), (0, c)] + [(0, 0)] * (a.ndim - 2))
    crop = lambda a: pad(a)[r0:r0 + c, c0:c0 + c]
    mwin = crop(mask) & win
    words = key_words(seed, obj_id)
    choose = choose_pixels(mwin.reshape(-1), num_points, words, c, c)
    d = crop(depth).reshape(-1)[choose].astype(np.float32)
    cx, cy, fx, fy, scale = (np.float32(v) for v in intr)
    z = d / scale
    x = ((choose % c).astype(np.float32) + np.float32(c0) - cx) * z / fx
    y = ((choose // c).astype(np.float32) + np.float32(r0) - cy) * z / fy
    img = (crop(color).astype(np.float32) / 255.0 - IMAGENET_MEAN) \
        / IMAGENET_STD
    img = np.where(win[..., None], img, 0.0).astype(np.float32)
    return dict(img=img, cloud=np.stack([x, y, z], -1).astype(np.float32),
                choose=choose, obj=min(max(obj_id - 1, 0), num_obj - 1),
                valid=bool(detected and fits),
                oversized=bool(detected and not fits))


def prepare_frames(pool: Dict, frame_ids: Sequence[int], canvas: int,
                   num_points: int, min_mask_pixels: int, num_obj: int):
    """Every slot of the given pool frames, in (frame, slot) order."""
    out = []
    for f in frame_ids:
        for k, oid in enumerate(pool["obj_ids"][f]):
            s = prepare_slot(pool["colors"][f], pool["depths"][f],
                             pool["labels"][f], int(oid),
                             int(pool["seeds"][f]), pool["intr"], canvas,
                             num_points, min_mask_pixels, num_obj)
            s["model_points"] = pool["model_points"][f, k]
            out.append(s)
    return out


def _stack(slots, key, device):
    return torch.from_numpy(np.stack([s[key] for s in slots])).to(device)


@torch.no_grad()
def hypotheses(params, slots: List[Dict], num_obj: int, device,
               prec: M.Precision = M.FULL, block: int = 40):
    """PoseNet over the slots in blocks: per slot pred_r (N, 4), pred_t,
    conf (N,), emb, cloud as tensors on `device`. `params`: {"posenet":
    ..., "refiner": ...} state dicts (`gen/weights.py`)."""
    out = []
    for i in range(0, len(slots), block):
        part = slots[i:i + block]
        cloud = _stack(part, "cloud", device)
        r, t, c, e = M.posenet(params["posenet"], _stack(part, "img", device),
                               cloud,
                               _stack(part, "choose", device),
                               torch.tensor([s["obj"] for s in part],
                                            device=device), num_obj,
                               prec=prec)
        for j in range(len(part)):
            out.append(dict(r=r[j], t=t[j], c=c[j], emb=e[j],
                            cloud=cloud[j]))
    return out


@torch.no_grad()
def serve(params, slots, hyps, num_obj, iterations, prec: M.Precision):
    """The reference's own answers (best hypothesis, refined), the answers
    a control puts in the program's place."""
    answers = []
    for s, h in zip(slots, hyps):
        i = int(torch.argmax(h["c"]))
        q = M.unit(h["r"][i])[None]
        t = (h["cloud"][i] + h["t"][i])[None]
        obj = torch.tensor([s["obj"]], device=q.device)
        q, t = M.refine(params["refiner"], h["cloud"][None], h["emb"][None],
                        obj, q, t, iterations, num_obj, prec)
        answers.append(dict(quat=q[0].cpu().numpy(), trans=t[0].cpu().numpy(),
                            confidence=float(h["c"][i]), valid=s["valid"],
                            oversized=s["oversized"]))
    return answers


def relative_add(q1, t1, q2, t2, model_points):
    """Mean distance between the model points under one pose (q1, t1) and
    under each of C candidate poses (q2 (C, 4), t2 (C, 3)), over each
    candidate's mean distance of the points from the camera: (C,)."""
    p1 = model_points @ M.quat_matrix(q1).T + t1
    p2 = torch.einsum("mk,cjk->cmj", model_points, M.quat_matrix(q2)) \
        + t2[:, None]
    return ((p2 - p1[None]).norm(dim=-1).mean(-1)
            / p2.norm(dim=-1).mean(-1).clamp_min(1e-12))


@torch.no_grad()
def judge(params, slots, hyps, answers, num_obj, iterations, window,
          least: int = 8, chunk: int = 128):
    """Score the program's answers (one dict per slot: quat, trans,
    confidence, valid, oversized) -> {flags, conf_gap, pose_gaps (one a
    valid slot), candidates (the count of each judged slot), deficits (how
    far below the best the reference ranks the candidate that matched
    each judged slot best)}."""
    flags, conf_gap, gaps, counts, deficits = 0, 0.0, [], [], []
    for s, h, a in zip(slots, hyps, answers):
        if bool(a["valid"]) != s["valid"] or \
                bool(a["oversized"]) != s["oversized"]:
            flags += 1
            continue
        if not s["valid"]:
            continue
        dev = h["c"].device
        cp = float(a["confidence"])
        if not np.isfinite(cp):
            conf_gap = float("inf")
            gaps.append(float("inf"))
            continue
        best_c = float(h["c"].max())
        conf_gap = max(conf_gap, abs(cp - best_c))
        cand = torch.nonzero(h["c"] >= best_c - window).flatten()
        if len(cand) < least:
            cand = torch.argsort(h["c"], descending=True)[:least]
        counts.append(len(cand))
        qp = torch.as_tensor(np.asarray(a["quat"], np.float32), device=dev)
        tp = torch.as_tensor(np.asarray(a["trans"], np.float32), device=dev)
        mp = torch.from_numpy(s["model_points"]).to(dev)
        best, deficit = float("inf"), float("inf")
        for j in range(0, len(cand), chunk):
            ci = cand[j:j + chunk]
            n = len(ci)
            q = M.unit(h["r"][ci])
            t = h["cloud"][ci] + h["t"][ci]
            obj = torch.full((n,), s["obj"], device=dev)
            q, t = M.refine(params["refiner"], h["cloud"].expand(n, -1, -1),
                            h["emb"].expand(n, -1, -1), obj, q, t,
                            iterations, num_obj)
            gap = relative_add(qp, tp, q, t, mp).nan_to_num(float("inf"))
            i = int(gap.argmin())
            if float(gap[i]) < best:
                best = float(gap[i])
                deficit = best_c - float(h["c"][ci[i]])
        gaps.append(best)
        deficits.append(deficit)
    return dict(flags=flags, conf_gap=conf_gap, pose_gaps=gaps,
                candidates=counts, deficits=deficits)
