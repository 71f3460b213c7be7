"""The choose gather with a deterministic backward.

`gather_rows(y, idx)` takes rows y[b, idx[b, n], :] of y (B, HW, C) into
(B, N, C), as the JAX package's `plr2_tpu/ops/gather.py` `gather_rows`
does. Its forward is `torch.gather`. Its backward sums the incoming
gradients of every row in a fixed order: each sample's indices are
stable-sorted (equal indices stay in ascending n), and the segment of each
row is added in that order, in f32, and rounded once to the gradient's
dtype. `torch.gather`'s own backward adds by atomics on the card, so where
`choose` repeats an index (a mask with fewer pixels than N) two runs of one
step would differ. JAX's backward is a one-hot product; the port gathers
at the full decoder resolution, where that one-hot is (B, N, HW), 3.3 GB
at batch 32, so it sums segments instead.

`gather_rows_backward` launches the CUDA kernel (``csrc/gather.cu``, whose
header says what bounds it and how it is designed) for CUDA tensors and
raises on anything it does not take; only for CPU tensors does it run
`gather_rows_backward_plain`, `index_add_` into f32 zeros, which on the
CPU adds in ascending n: the kernel's order, so the two agree bit for bit.
With `use_kernel=False` (a pipeline built with use_kernels=False) the
backward is the plain version on any device; on the card its index_add_
adds by atomics, like torch.gather's.
"""

from __future__ import annotations

import torch

from plr2_tpu_torch.ops import _build

launches = 0


def gather_rows_backward_plain(ct: torch.Tensor, idx: torch.Tensor,
                               hw: int) -> torch.Tensor:
    """(B, N, C) gradient, (B, N) indices -> (B, HW, C): index_add_ of f32
    copies, rounded once to ct's dtype."""
    b, n, c = ct.shape
    rows = (idx.long() + torch.arange(b, device=idx.device)[:, None] * hw)
    dy = torch.zeros((b * hw, c), device=ct.device, dtype=torch.float32)
    dy.index_add_(0, rows.reshape(-1), ct.reshape(b * n, c).float())
    return dy.reshape(b, hw, c).to(ct.dtype)


def _check(ct: torch.Tensor, idx: torch.Tensor) -> None:
    what = "gather_rows_backward"
    _build.require_cuda([ct, idx], what)
    _build.require_dtype([ct], what)
    _build.require_contiguous([ct], what)
    if ct.dim() != 3 or idx.shape != ct.shape[:2]:
        raise ValueError(f"{what}: expected ct (B, N, C) and idx (B, N), got "
                         f"{tuple(ct.shape)} and {tuple(idx.shape)}")


def gather_rows_backward(ct: torch.Tensor, idx: torch.Tensor,
                         hw: int) -> torch.Tensor:
    """The segment sum through the CUDA kernel (the plain version for CPU
    tensors)."""
    global launches
    if ct.device.type == "cpu":
        return gather_rows_backward_plain(ct, idx, hw)
    _check(ct, idx)
    b, n, c = ct.shape
    sidx, perm = torch.sort(idx.long(), dim=1, stable=True)
    dy = torch.empty((b, hw, c), device=ct.device, dtype=ct.dtype)
    err = _build.lib().plr2_gather_rows_backward(
        _build.DTYPE_CODES[ct.dtype], ct.data_ptr(), sidx.data_ptr(),
        perm.data_ptr(), dy.data_ptr(), b, n, hw, c, _build.stream_of(ct))
    _build.check(err, "gather_rows_backward")
    launches += 1
    return dy


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, idx, use_kernel):
        ctx.save_for_backward(idx)
        ctx.hw, ctx.use_kernel = y.shape[1], use_kernel
        return torch.gather(y, 1, idx[..., None].expand(-1, -1, y.shape[2]))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        fn = gather_rows_backward if ctx.use_kernel else gather_rows_backward_plain
        return fn(g.contiguous(), idx, ctx.hw), None, None


def gather_rows(y: torch.Tensor, idx: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
    """(B, HW, C), (B, N) int -> (B, N, C) rows y[b, idx[b, n], :]."""
    return _GatherRows.apply(y, idx.long(), use_kernel)


def bytes_moved(b: int, n: int, hw: int, c: int, item: int) -> int:
    """The backward's bytes: ct and the indices read once, dy written once."""
    return item * b * n * c + 8 * b * n + item * b * hw * c
