"""Nearest-neighbour search for the ADD-S loss, the port of
plr2_tpu/ops/knn.py and of the TPU kernels of plr2_tpu/ops/pallas_knn.py.

Three CUDA kernels (``csrc/knn.cu``, whose header says what bounds them on
the H100 and how they are designed), each beside its plain PyTorch twin:

- ``nn_argmin``    replaces ``nn_argmin_pallas``: the first-argmin target
  index of each query, d2 from the exact per-coordinate difference.
- ``nn_match``     replaces ``nn_match_pallas``: that target's coordinates.
- ``nn_match_mxu`` replaces ``nn_match_pallas_mxu``: the same contract,
  d2 from the augmented product [a, |a|^2, 1] . [-2b, 1, |b|^2].

Each takes queries (P, 3) and targets (M2, 3), as the JAX functions do, or
a batch: queries (S, P, 3) against per-sample targets (S, M2, 3), so every
symmetric sample of a training step goes in one launch. Inputs are f32.
Indices are int64 (torch's index type; the JAX kernels return int32).

A wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; only for CPU tensors does it run its plain twin,
which repeats the kernel's arithmetic in elementwise ops of the same order
and takes the first index of the least d2 (``torch.argmin``). The twins
chunk over P (``CHUNK`` query rows in all, as ``nn_match_cm`` does), so
they never hold the whole (S, P, M2) matrix. The loss path never calls a
twin while a card is present.

``nn_distance`` = ``safe_norm(pred - nn_match(pred.detach(),
target.detach()))``: autograd of the norm with the match held constant is
the gather-through-argmin gradient of the upstream KNN extension
(``nn_distance_pallas``). JAX's ``chamfer_min_distance`` runs the same
function through its chunked XLA form; here it runs through the kernel.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from plr2_tpu_torch.ops import _build

CHUNK = 65536  # query rows per plain-twin block (nn_match_cm's chunk)

launches = {"nn_match": 0, "nn_argmin": 0, "nn_match_mxu": 0}


def safe_norm(diff: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero gradient where the norm is exactly zero
    (torch.norm's backward convention; a plain sqrt gives NaN there)."""
    s = (diff * diff).sum(dim)
    positive = s > 0
    return torch.sqrt(torch.where(positive, s, torch.ones_like(s))) * positive


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) x (..., M, 3) -> (..., P, M) squared distances in the
    product form |a|^2 - 2 a.b + |b|^2, clamped at 0 (the JAX function at
    its default "highest" precision: an f32 product, never TF32)."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    ab = (a[..., :, None, :] * b[..., None, :, :]).sum(-1)
    return torch.clamp(a2 - 2.0 * ab + b2.transpose(-1, -2), min=0.0)


# ---------------- plain twins ----------------


def _d2_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (S, C, 3), b (S, M2, 3) -> (S, C, M2): ((dx*dx + dy*dy) + dz*dz)."""
    d2 = None
    for k in range(3):
        d = a[:, :, None, k] - b[:, None, :, k]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def _d2_augmented(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (S, C, 3), b (S, M2, 3) -> (S, C, M2): a.(-2b) term by term, then
    + |a|^2, then + |b|^2 (the kernel's order; each product rounded)."""
    a2 = (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) + a[..., 2] * a[..., 2]
    b2 = (b[..., 0] * b[..., 0] + b[..., 1] * b[..., 1]) + b[..., 2] * b[..., 2]
    nb = -2.0 * b
    acc = a[:, :, None, 0] * nb[:, None, :, 0]
    acc = acc + a[:, :, None, 1] * nb[:, None, :, 1]
    acc = acc + a[:, :, None, 2] * nb[:, None, :, 2]
    return (acc + a2[:, :, None]) + b2[:, None, :]


def _first_argmin(q: torch.Tensor, t: torch.Tensor,
                  d2_fn: Callable) -> torch.Tensor:
    """q (S, P, 3), t (S, M2, 3) -> (S, P) int64, in blocks of query rows."""
    s, p, _ = q.shape
    rows = max(1, CHUNK // max(s, 1))
    q, t = q.float(), t.float()
    out = torch.empty((s, p), dtype=torch.int64, device=q.device)
    for i in range(0, p, rows):
        out[:, i:i + rows] = torch.argmin(d2_fn(q[:, i:i + rows], t), dim=-1)
    return out


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (S, M2, 3), idx (S, P) -> (S, P, 3)."""
    return torch.gather(t.float(), 1, idx[..., None].expand(-1, -1, 3))


def _batched(fn):
    """Lift a (S, P, 3), (S, M2, 3) function to the unbatched form too."""
    @functools.wraps(fn)
    def run(queries, targets):
        if targets.dim() == 2:
            return fn(queries[None], targets[None])[0]
        return fn(queries, targets)
    return run


@_batched
def nn_argmin_plain(queries, targets):
    """First-argmin target index of each query (exact-difference d2)."""
    return _first_argmin(queries, targets, _d2_exact)


@_batched
def nn_match_plain(queries, targets):
    """Coordinates of the first-argmin target (exact-difference d2)."""
    return _gather(targets, _first_argmin(queries, targets, _d2_exact))


@_batched
def nn_match_mxu_plain(queries, targets):
    """Coordinates of the first-argmin target (augmented-product d2)."""
    return _gather(targets, _first_argmin(queries, targets, _d2_augmented))


# ---------------- kernel wrappers ----------------

_KERNELS = {"nn_argmin": ("plr2_nn_argmin", nn_argmin_plain),
            "nn_match": ("plr2_nn_match", nn_match_plain),
            "nn_match_mxu": ("plr2_nn_match_mxu", nn_match_mxu_plain)}


def _check(name: str, q: torch.Tensor, t: torch.Tensor) -> None:
    _build.require_cuda([q, t], name)
    _build.require_contiguous([q, t], name)
    for u in (q, t):
        if u.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {u.dtype}")
    if (q.dim() != 3 or t.dim() != 3 or q.shape[2] != 3 or t.shape[2] != 3
            or q.shape[0] != t.shape[0]):
        raise ValueError(f"{name}: expected queries (S, P, 3) and targets "
                         f"(S, M2, 3), got {tuple(q.shape)} and "
                         f"{tuple(t.shape)}")
    if t.shape[1] < 1:
        raise ValueError(f"{name}: no targets")
    if max(q.shape[0], q.shape[1], t.shape[1]) >= 2 ** 31:
        raise ValueError(f"{name}: sizes exceed the kernel's int range")


def _launch(name: str, queries: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    symbol, plain = _KERNELS[name]
    if queries.device.type == "cpu":
        return plain(queries, targets)
    unbatched = targets.dim() == 2
    q, t = (queries[None], targets[None]) if unbatched else (queries, targets)
    _check(name, q, t)
    s, p, _ = q.shape
    out = torch.empty((s, p) if name == "nn_argmin" else (s, p, 3),
                      device=q.device,
                      dtype=torch.int64 if name == "nn_argmin" else torch.float32)
    err = getattr(_build.lib(), symbol)(q.data_ptr(), t.data_ptr(),
                                        out.data_ptr(), s, p, t.shape[1],
                                        _build.stream_of(q))
    _build.check(err, name)
    launches[name] += 1
    return out[0] if unbatched else out


def nn_argmin(queries: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(P, 3), (M2, 3) -> (P,) or (S, P, 3), (S, M2, 3) -> (S, P) int64."""
    return _launch("nn_argmin", queries, targets)


def nn_match(queries: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(P, 3), (M2, 3) -> (P, 3) or (S, P, 3), (S, M2, 3) -> (S, P, 3)."""
    return _launch("nn_match", queries, targets)


def nn_match_mxu(queries: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """`nn_match` with the augmented-product d2."""
    return _launch("nn_match_mxu", queries, targets)


# ---------------- distances ----------------


def nn_index(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Index of the nearest target of each pred point (the upstream KNN
    extension's `inds`, 0-based), through the argmin kernel: the exact
    difference d2 of `nn_argmin_pallas`. JAX's `nn_index` selects with the
    product form of `pairwise_sq_dist`, which picks the same target except
    where two distances tie to within its cancellation."""
    return nn_argmin(pred.float().contiguous(), target.float().contiguous())


def nn_distance(pred: torch.Tensor, target: torch.Tensor,
                mxu: bool = False, use_kernel: bool = True) -> torch.Tensor:
    """Nearest-target distance of each pred point, through one kernel launch.

    pred (H, M, 3) with target (M2, 3) -> (H, M), or pred (S, H, M, 3) with
    per-sample targets (S, M2, 3) -> (S, H, M). The gradient w.r.t. pred
    flows through ||pred - matched|| with the match held constant; target
    gets none. `mxu=True` matches through the augmented-product kernel;
    `use_kernel=False` through the plain twin on any device.
    """
    if use_kernel:
        match = nn_match_mxu if mxu else nn_match
    else:
        match = nn_match_mxu_plain if mxu else nn_match_plain
    lead = target.shape[:-2]
    q = pred.detach().float().reshape(*lead, -1, 3).contiguous()
    matched = match(q, target.detach().float().contiguous())
    return safe_norm(pred - matched.reshape(pred.shape))


def chamfer_min_distance(pred: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """(H, M, 3), (M2, 3) -> (H, M) nearest-target distances (batched as
    `nn_distance`)."""
    return nn_distance(pred, target)


# FP32 instruction slots a second of an H100 SXM: 132 SMs x 128 lanes x
# 1.98 GHz, the 67 TFLOP/s of the data sheet over 2 (it counts an FFMA as
# two FLOP)
FP32_SLOTS_PER_S = 33.5e12


def issue_slots(queries: int, targets: int, augmented: bool = False) -> int:
    """FP32 issue slots of the d2 arithmetic, the kernels' bound: 8 a
    query-target pair for the exact difference, which may not fuse into an
    FFMA (3 __fsub_rn, 3 __fmul_rn, 2 __fadd_rn), 5 for the augmented
    product (FMUL, 2 FFMA, 2 FADD). At 5 x 500k x 500 pairs that is 0.299
    and 0.187 ms at `FP32_SLOTS_PER_S`."""
    return (5 if augmented else 8) * queries * targets
