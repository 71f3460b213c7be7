"""PSP decoder stage: 2x bilinear upsample + 3x3 conv + bias + PReLU.

Replaces the TPU kernel ``plr2_tpu/ops/pallas_upsample.py``
``fused_upconv3x3_prelu``. Source: ``csrc/upconv.cu``,
whose header says what bounds it on the H100 (operations) and what its
design does about it: bf16 is an implicit GEMM on the tensor cores
(``wgmma`` fed by TMA) that reads the weights as ``pack_weights`` lays
them out and needs Cin to be a multiple of 8 (``tc_widths``); f32 is an
implicit GEMM on the FP32 cores that reads the weights as
``pack_weights_f32`` lays them out (HWIO itself when Cout is a multiple
of 4) and takes any widths. Same signature as the JAX kernel: x NHWC
(B, H, W, Cin), w HWIO (3, 3, Cin, Cout), bias (Cout,), alpha a
one-element tensor; returns (B, 2H, 2W, Cout).

The f32 launch follows ``f32_plan``: the tile, by the grid's waves, and
the split S. Where the tile's blocks fill under half the card's slots
(one crop: up_1 at a 240 px crop has 64 blocks for 264 slots), S blocks
of a thread-block cluster share each output tile, rank r taking the r-th
contiguous S-th of the input-channel chunks; they reduce their partial
sums through distributed shared memory, in rank order (so a launch
repeats bit for bit), inside the same kernel's epilogue. No second kernel
and no workspace: the stage stays one ``upconv_sgemm_kernel`` launch,
whose device time is all the stage's. The slots come from the card
(``card_slots``): a cluster's blocks share a GPC, so an H100 holds 264
blocks unsplit and in clusters of 2, but only 248 in clusters of 4 and
240 in clusters of 8. ``split_launches`` counts the launches with S > 1.

``upconv3x3_prelu_forward`` launches the kernel for CUDA tensors and
raises on anything the kernel does not take; only for CPU tensors does it
run ``upconv3x3_prelu_plain``, which repeats the kernel's arithmetic: the
half-pixel upsample computed in f32 and rounded to the input dtype, the
conv accumulated in f32, bias and PReLU in f32, one rounding at the end.

``upconv3x3_prelu`` is that forward as a ``torch.autograd.Function``. Its
backward recomputes ``upconv3x3_prelu_plain`` under autograd and returns
its gradients, as the JAX custom VJP's ``_bwd`` (``pallas_upsample.py:
300-304``) takes the VJP of the plain XLA composition: the TPU kernel has
no backward kernel, so none is owed here.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from plr2_tpu_torch.ops import _build

launches = 0
split_launches = 0

# the f32 kernel's tiles (csrc/upconv.cu `plr2_upconv3x3_prelu`): output
# rows, output columns and output channels a block, input channels a chunk
F32_TILES = ((8, 8, 256, 4), (8, 16, 128, 8), (16, 16, 64, 8))
# the splits a launch may take (8: the portable cluster size)
SPLITS = (1, 2, 4, 8)


def _upsample2x_axis(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Half-pixel 2x along `dim`: even 0.25 v[t-1] + 0.75 v[t], odd
    0.75 v[t] + 0.25 v[t+1], edges clamped; interleaved."""
    n = v.shape[dim]
    prev = torch.cat([v.narrow(dim, 0, 1), v.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([v.narrow(dim, 1, n - 1), v.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * v
    odd = 0.75 * v + 0.25 * nxt
    shape = list(v.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim + 1).reshape(shape)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """NHWC half-pixel bilinear 2x upsample, in f32 (f64 for f64 input;
    columns, then rows)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return _upsample2x_axis(_upsample2x_axis(x, 2), 1)


def upconv3x3_prelu_plain(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    up = upsample2x_bilinear(x).to(x.dtype).to(acc)
    y = F.conv2d(up.permute(0, 3, 1, 2), w.to(acc).permute(3, 2, 0, 1),
                 bias.to(acc), padding=1)
    y = torch.where(y >= 0, y, alpha.to(acc).reshape(()) * y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check(x, w, bias, alpha) -> None:
    what = "upconv3x3_prelu"
    ts = [x, w, bias, alpha]
    _build.require_cuda(ts, what)
    _build.require_dtype(ts, what)
    _build.require_contiguous(ts, what)
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{what}: expected x (B, H, W, Cin) and w (3, 3, Cin, "
                         f"Cout), got {tuple(x.shape)} and {tuple(w.shape)}")
    if bias.shape != (w.shape[3],) or alpha.numel() != 1:
        raise ValueError(f"{what}: expected bias ({w.shape[3]},) and a "
                         f"one-element alpha, got {tuple(bias.shape)} and "
                         f"{tuple(alpha.shape)}")


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> (9, Cout, Cin): one (Cout, Cin) matrix per
    tap (tap = 3 dy + dx), K-major rows, the B operand the bf16 kernel's
    TMA loads tile by tile (64 output channels x 64 input channels)."""
    cin, cout = w.shape[2], w.shape[3]
    return w.permute(0, 1, 3, 2).reshape(9, cout, cin).contiguous()


def pack_weights_f32(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> (9, Cin, round4(Cout)): one (Cin, Cout)
    matrix per tap (tap = 3 dy + dx), Cout contiguous and zero-padded to a
    multiple of 4, so the f32 kernel copies weight rows 16 bytes at a time.
    Without padding this is a view of w (no copy)."""
    cin, cout = w.shape[2], w.shape[3]
    wp = w.reshape(9, cin, cout)
    pad = -cout % 4
    return F.pad(wp, (0, pad)) if pad else wp


def tc_widths(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise ValueError unless the bf16 kernel takes these widths: Cin is
    the row of x and of the packed weights that TMA loads, so it must be a
    multiple of 8. B, H, W and Cout may be anything."""
    _build.require_multiple_of_8(
        [x.shape[3]], ("Cin",), "upconv3x3_prelu",
        f"x {tuple(x.shape)} and w {tuple(w.shape)}")


@functools.lru_cache(maxsize=None)
def _card_slots(index: int) -> dict:
    with torch.cuda.device(index):
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        lib = _build.lib()
        slots = {1: 2 * sms}
        for split in SPLITS[1:]:
            held = [lib.plr2_upconv_f32_clusters(tile, split)
                    for tile in range(len(F32_TILES))]
            if min(held) <= 0:
                raise RuntimeError(f"upconv3x3_prelu: the card holds no "
                                   f"cluster of {split} f32 blocks ({held})")
            slots[split] = split * min(held)
    return slots


def card_slots(device: torch.device) -> dict:
    """The f32 kernel's blocks that a CUDA device holds at once, by split:
    two an SM (``__launch_bounds__``) unsplit, and S times the clusters of
    S that ``cudaOccupancyMaxActiveClusters`` counts (the least over the
    tiles), read once a device."""
    index = device.index
    return _card_slots(torch.cuda.current_device() if index is None else index)


def f32_plan(b: int, h: int, w: int, cin: int, cout: int,
             slots: dict) -> tuple:
    """(tile, split) of the f32 kernel for x (b, h, w, cin) -> cout
    channels on a card that holds `slots[S]` blocks at once in clusters of
    S (``card_slots``; `slots[1]`: two blocks an SM).

    The tile (an index of ``F32_TILES``): 16 x 16 x 64 below 128 output
    channels; else 8 x 16 x 128, or 8 x 8 x 256 (Cout >= 256) where that
    takes fewer waves: all three do the same work a block, up_1's
    40-pixel rows take three 16-wide tiles (48 columns) but five 8-wide
    ones, and the 8 x 8 x 256 tile runs about 5% slower a block (four
    shared-memory wavefronts a weight load, chunks of 4).

    The split: the largest S of ``SPLITS`` such that the tile's blocks
    times S still fit one wave of the card's clusters of S and S is at
    most the number of input-channel chunks; 1 (the plain launch)
    wherever the blocks alone fill over half the slots."""
    def blocks(tile):
        th, tw, nb, _ = F32_TILES[tile]
        return b * -(-2 * h // th) * -(-2 * w // tw) * -(-cout // nb)

    def waves(tile):
        return -(-blocks(tile) // slots[1])

    if cout < 128:
        tile = 2
    else:
        tile = 0 if cout >= 256 and 20 * waves(0) < 19 * waves(1) else 1
    n, chunks = blocks(tile), -(-cin // F32_TILES[tile][3])
    fits = [s for s in SPLITS if 0 < n * s <= slots[s] and s <= chunks]
    return tile, max(fits, default=1)


def upconv3x3_prelu_forward(x: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor,
                            alpha: torch.Tensor) -> torch.Tensor:
    """The stage through the CUDA kernel (plain PyTorch for CPU tensors)."""
    global launches, split_launches
    if x.device.type == "cpu":
        return upconv3x3_prelu_plain(x, w, bias, alpha)
    _check(x, w, bias, alpha)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    if x.dtype == torch.bfloat16:
        tc_widths(x, w)
        w = pack_weights(w)
        tile, split = 0, 1  # not read by the bf16 kernel
    else:
        w = pack_weights_f32(w)
        tile, split = f32_plan(b, h, wd, cin, cout, card_slots(x.device))
    x, w = _build.aligned16(x), _build.aligned16(w)
    out = torch.empty((b, 2 * h, 2 * wd, cout), device=x.device, dtype=x.dtype)
    err = _build.lib().plr2_upconv3x3_prelu(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        bias.data_ptr(), alpha.data_ptr(), out.data_ptr(), b, h, wd, cin, cout,
        _build.stream_of(x), tile, split)
    _build.check(err, "upconv3x3_prelu")
    launches += 1
    split_launches += split > 1
    return out


class _UpConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, alpha):
        ctx.save_for_backward(x, w, bias, alpha)
        return upconv3x3_prelu_forward(x, w, bias, alpha)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = upconv3x3_prelu_plain(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def upconv3x3_prelu(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    alpha: torch.Tensor) -> torch.Tensor:
    """`upconv3x3_prelu_forward` with the JAX package's backward (above)."""
    return _UpConv.apply(x, w, bias, alpha)


def flops(b: int, h: int, w: int, cin: int, cout: int) -> int:
    """2 x multiply-adds of the conv over the (2h, 2w) map."""
    return 2 * b * (2 * h) * (2 * w) * 9 * cin * cout
