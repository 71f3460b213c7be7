"""The pose-head ladder x -> 640 -> 256 -> 128 -> K as one CUDA kernel.

Replaces the TPU kernel ``plr2_tpu/ops/pallas_fusion.py``
``fused_mlp_head``. Source: ``csrc/mlp_head.cu``, whose header says what
bounds it on the H100 and how it is built: bf16 on the tensor cores
(``wgmma`` fed by TMA), f32 on the FP32 cores. The bf16 kernel pads every
width to 64 on chip (TMA reads zeros past an edge), so it needs no padded
copies; it needs C, N1, N2 and N3 to be multiples of 8 (``tc_widths``).
The f32 kernel is one register-tiled SGEMM launch per layer: it reads
each layer's weights as W^T padded to multiples of 4
(``pack_weights_f32``, packed at every call) and x with its columns
padded to a multiple of 4 (``pad_x_f32``: a copy only where C is not
one), and keeps h1-h3 in a scratch tensor of ``scratch_floats`` floats
that the wrapper takes from torch's caching allocator; any widths.

Weights are in the torch ``Linear`` / ``Conv1d`` layout, (out, in): the
PoseNet heads hold ``Conv1d`` weights of shape (out, in, 1), viewed as
(out, in) without a copy. (The JAX kernel takes (in, out).)

``mlp_head_forward`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; only for CPU tensors does it run
``mlp_head_plain``, the same function in plain PyTorch, which repeats the
kernel's arithmetic: products of working-dtype operands accumulated in
f32, bias added in f32, ReLU, rounding to the input dtype between layers.

``mlp_head`` is that forward as a ``torch.autograd.Function``. Its backward
is plain PyTorch on every device, the port of the JAX custom VJP's
``_bwd`` (``pallas_fusion.py:82-102``): it rematerialises h1-h3 and runs
matmuls, as the JAX package does with plain XLA. The TPU kernel has no
backward kernel, so none is owed here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from plr2_tpu_torch.ops import _build

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]

launches = 0


def mlp_head_plain(x: torch.Tensor, params: Params) -> torch.Tensor:
    """x (P, C) -> (P, K) through 4 (w (out, in), b (out,)) layers."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)  # f32, or f64 for f64 input
    h = x
    for i, (w, b) in enumerate(params):
        h = torch.matmul(h.to(acc), w.to(acc).t()) + b.to(acc)
        if i < len(params) - 1:
            h = torch.relu(h)
        h = h.to(dt)
    return h


def _check(x: torch.Tensor, params: Params) -> None:
    what = "mlp_head"
    if len(params) != 4:
        raise ValueError(f"{what}: expected 4 layers, got {len(params)}")
    flat = [x] + [t for wb in params for t in wb]
    _build.require_cuda(flat, what)
    _build.require_dtype(flat, what)
    _build.require_contiguous(flat, what)
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (P, C), got {tuple(x.shape)}")
    c_in = x.shape[1]
    for i, (w, b) in enumerate(params):
        if w.dim() != 2 or w.shape[1] != c_in or b.shape != (w.shape[0],):
            raise ValueError(
                f"{what}: layer {i + 1} expects w (N, {c_in}) and b (N,), "
                f"got {tuple(w.shape)} and {tuple(b.shape)}")
        c_in = w.shape[0]


def tc_widths(x: torch.Tensor, params: Params) -> None:
    """Raise ValueError unless the bf16 kernel takes these widths: the
    inputs of every layer (C, N1, N2, N3) are rows that TMA loads, so they
    must be multiples of 8. P and N4 may be anything."""
    widths = [x.shape[1]] + [w.shape[0] for w, _ in params[:-1]]
    _build.require_multiple_of_8(
        widths, ("C", "N1", "N2", "N3"), "mlp_head",
        f"x {tuple(x.shape)} and weights {[tuple(w.shape) for w, _ in params]}")


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def pack_weights_f32(params: Params) -> list:
    """(w (N, K), b) -> (W^T (round4(K), round4(N)), b): the f32 kernel's B
    operand, rows of 16 bytes that it copies into shared memory 4 columns
    at a time. The padding is zeros: the hidden columns past N come out as
    relu(0 + 0) = 0, and the rows past K meet x's zero padding
    (``pad_x_f32``). Every packed tensor starts on 16 bytes."""
    return [(_build.aligned16(F.pad(w.t(), (0, _round4(w.shape[0]) - w.shape[0],
                                            0, _round4(w.shape[1]) - w.shape[1]))
                              .contiguous()), b) for w, b in params]


def pad_x_f32(x: torch.Tensor) -> torch.Tensor:
    """x with its columns zero-padded to a multiple of 4 (a copy only when C
    is not one), so the f32 kernel loads rows of x 16 bytes at a time;
    16-byte aligned."""
    pad = -x.shape[1] % 4
    return _build.aligned16(F.pad(x, (0, pad)) if pad else x)


def scratch_floats(rows: int, widths: Sequence[int]) -> int:
    """Floats of the f32 kernel's scratch for widths (C, N1, N2, N3, N4):
    h1 and then h3 in rows of round4(max(N1, N3)), h2 beside them in rows
    of round4(N2), as csrc/mlp_head.cu `launch_f32` lays them out."""
    return rows * (_round4(max(widths[1], widths[3])) + _round4(widths[2]))


def mlp_head_forward(x: torch.Tensor, params: Params) -> torch.Tensor:
    """The ladder through the CUDA kernel (plain PyTorch for CPU tensors)."""
    global launches
    if x.device.type == "cpu":
        return mlp_head_plain(x, params)
    _check(x, params)
    n1, n2, n3, n4 = (w.shape[0] for w, _ in params)
    scratch = None
    if x.dtype == torch.bfloat16:
        tc_widths(x, params)
        x = _build.aligned16(x)
        params = [(_build.aligned16(w), b) for w, b in params]
    else:
        x = pad_x_f32(x)
        params = pack_weights_f32(params)
        scratch = torch.empty(scratch_floats(x.shape[0], (x.shape[1], n1, n2, n3, n4)),
                              device=x.device, dtype=x.dtype)
    (w1, b1), (w2, b2), (w3, b3), (w4, b4) = params
    out = torch.empty((x.shape[0], n4), device=x.device, dtype=x.dtype)
    err = _build.lib().plr2_mlp_head(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), w4.data_ptr(),
        b4.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        x.shape[0], x.shape[1], n1, n2, n3, n4, _build.stream_of(x))
    _build.check(err, "mlp_head")
    launches += 1
    return out


class _MLPHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *flat):
        params = list(zip(flat[0::2], flat[1::2]))
        ctx.save_for_backward(x, *flat)
        return mlp_head_forward(x, params)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        (w1, b1), (w2, b2), (w3, b3), (w4, b4) = zip(flat[0::2], flat[1::2])
        # weights are (out, in): h = x w^T + b; dW = g^T h_in; dh_in = g W
        h1 = torch.relu(F.linear(x, w1, b1))
        h2 = torch.relu(F.linear(h1, w2, b2))
        h3 = torch.relu(F.linear(h2, w3, b3))
        g = g.to(x.dtype)
        grads = [g.t() @ h3, g.sum(0)]
        g3 = (g @ w4) * (h3 > 0)
        grads = [g3.t() @ h2, g3.sum(0)] + grads
        g2 = (g3 @ w3) * (h2 > 0)
        grads = [g2.t() @ h1, g2.sum(0)] + grads
        g1 = (g2 @ w2) * (h1 > 0)
        grads = [g1.t() @ x, g1.sum(0)] + grads
        dx = g1 @ w1 if ctx.needs_input_grad[0] else None
        return (dx, *grads)


def mlp_head(x: torch.Tensor, params: Params) -> torch.Tensor:
    """`mlp_head_forward` with the JAX package's backward (see above)."""
    return _MLPHead.apply(x, *(t for wb in params for t in wb))


def flops(rows: int, widths: Sequence[int]) -> int:
    """Multiply-adds x 2 of the ladder: widths = (C, N1, N2, N3, N4)."""
    return 2 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
