"""The int8 pose-head ladder as one CUDA kernel.

Replaces the TPU kernel ``plr2_tpu/ops/pallas_quant.py``
``quantized_mlp_head`` (``_qmlp_body``), the int8 counterpart of
``ops.mlp_head``: per layer, each row's activations are quantised to int8
with a symmetric per-row scale, multiplied by per-output-channel int8
weights into int32, and dequantised with the bias added (ReLU on every
layer but the last). Inference only: the JAX kernel has no VJP, so this is
no autograd Function. Source: ``csrc/quant.cu``, whose header says what
bounds it on the H100 (bytes) and how it is built.

Weights are in the torch ``Linear`` / ``Conv1d`` layout, (out, in), as
``models.posenet._weight2d`` gives them (the JAX function takes (in, out)).
The kernel reads them by TMA, whose row strides are multiples of 16 bytes:
``pack_weights`` pads a matrix whose ``in`` is not a multiple of 16 with
zero columns (a copy per call, never on the main path's widths). It keeps
a layer's whole output row block in the wgmma accumulators, so a layer has
at most ``MAX_WIDTH`` outputs, and x's row in registers, so x has at most
``MAX_INPUT`` columns; ``smem_plan`` mirrors the kernel's shared-memory
layout.

Stochastic rounding, ``floor(h / a + u)``, draws ``u`` from the port's own
counter-based generator: Philox-4x32-10 (Salmon et al., SC'11) keyed by
``(seed, layer)`` with the counter ``(column // 4, global row, 0, 0)``; the
four output words are the bits of columns ``4 (column // 4) + 0..3``, and
``u = (bits >> 8) 2^-24``. A draw depends on neither block size nor launch
layout. The TPU PRNG (``pltpu.prng_random_bits``) cannot be reproduced off
the TPU, and JAX's interpret mode always rounds to nearest, so only the
deterministic path has a JAX counterpart; the stochastic one is held
against ``philox4x32`` below, which repeats the kernel's generator bit for
bit in int64 arithmetic masked to 32 bits.

``quantized_mlp_head`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; only for CPU tensors does it run
``quantized_mlp_head_plain``, the same function op by op in the JAX order,
whose f32 steps the kernel reproduces bit for bit (``/`` and round half to
even correctly rounded, the epilogue as two products and a sum, each
rounded). Its int32 product is a float64 matmul of the codes, which is
exact: |acc| <= 127^2 * Cin < 2^53 (f32 would not be: 2.27e7 > 2^24 at
Cin = 1408).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from plr2_tpu_torch.ops import _build

QParams = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

launches = 0

MAX_LAYERS = 8  # csrc/quant.cu kMaxLayers
MAX_WIDTH = 640  # kMaxWidth: a layer's outputs, all in the accumulators
MAX_INPUT = 2304  # 128 kXVec: x's columns, a row held by one warp
SMEM_LIMIT = 232448  # shared memory a block may use on the H100
_ROWS, _SLICE, _CODE_TILE, _MAX_STAGES = 64, 64, 64 * 128, 4
# row maxima and scales, a layer's scales and biases, the barriers
_SMEM_TAIL = 3 * _ROWS * 4 + 2 * MAX_WIDTH * 4 + 16 * _MAX_STAGES
_MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def quantize_weights(params) -> Tuple:
    """((w (out, in), b (out,)) x L) -> ((w_i8 (out, in) int8, scale (out,)
    f32, b (out,) f32) x L): per output channel, scale = max(max|w| / 127,
    1e-12) and w_i8 = clip(round(w / scale), -127, 127), round half to
    even. The port of ``pallas_quant.py`` ``quantize_weights``."""
    out = []
    for w, b in params:
        w = w.float()
        amax = w.abs().amax(dim=1)
        scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
        w_i8 = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
        out.append((w_i8.to(torch.int8).contiguous(), scale, b.float().contiguous()))
    return tuple(out)


def _mulhilo(a: int, b: torch.Tensor):
    """(a * b) >> 32 and (a * b) & 0xFFFFFFFF for a 32-bit constant `a` and
    int64 `b` in [0, 2^32): `a` is split into 16-bit halves so that every
    partial product stays below 2^48."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    x, y = a_lo * b, a_hi * b
    hi = (y + (x >> 16)) >> 16
    lo = (((y & 0xFFFF) << 16) + x) & _MASK
    return hi, lo


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, key0: int, key1: int):
    """Philox-4x32-10 of the counters (c0, c1, 0, 0) under (key0, key1):
    four int64 tensors of 32-bit words (the generator of csrc/quant.cu)."""
    ctr = [c0.to(torch.int64) & _MASK, c1.to(torch.int64) & _MASK,
           torch.zeros_like(c0, dtype=torch.int64),
           torch.zeros_like(c0, dtype=torch.int64)]
    k0, k1 = key0 & _MASK, key1 & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK, (k1 + _PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(_PHILOX_M[0], ctr[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], ctr[2])
        ctr = [hi1 ^ ctr[1] ^ k0, lo1, hi0 ^ ctr[3] ^ k1, lo0]
    return ctr


def rounding_noise(rows: int, cols: int, seed: int, layer: int,
                   device=None) -> torch.Tensor:
    """(rows, cols) f32 u in [0, 1) of layer `layer`: the kernel's
    stochastic-rounding draws for global rows 0..rows-1."""
    groups = (cols + 3) // 4
    r = torch.arange(rows, device=device, dtype=torch.int64)
    g = torch.arange(groups, device=device, dtype=torch.int64)
    words = philox4x32(g[None, :].expand(rows, groups),
                       r[:, None].expand(rows, groups), seed, layer)
    bits = torch.stack(words, dim=-1).reshape(rows, 4 * groups)[:, :cols]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def activation_codes(h: torch.Tensor, seed: int = 0, layer: int = 0,
                     stochastic: bool = False):
    """Per-row int8 quantisation of f32 h (P, C), op by op as
    ``_qmlp_body``: a = max(amax|h| / 127, 1e-12) per row; codes =
    clip(round(h / a)) or, stochastic, clip(floor(h / a + u)). Returns
    (codes (P, C) int8, a (P, 1) f32). The divisions are by tensors: on
    CUDA, torch turns division by a Python scalar into a product with its
    reciprocal, which is not correctly rounded."""
    amax = h.abs().amax(dim=1, keepdim=True)
    a = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    scaled = h / a
    if stochastic:
        u = rounding_noise(h.shape[0], h.shape[1], seed, layer, device=h.device)
        q = torch.floor(scaled + u)
    else:
        q = torch.round(scaled)
    return torch.clamp(q, -127, 127).to(torch.int8), a


def quantized_mlp_head_plain(x: torch.Tensor, qparams: QParams, seed: int = 0,
                             stochastic: bool = True) -> torch.Tensor:
    """x (P, C0) f32 -> (P, K) f32 through L int8 layers (ReLU between),
    op by op in the order of ``_qmlp_body``."""
    h = x.float()
    for layer, (w_i8, s, b) in enumerate(qparams):
        codes, a = activation_codes(h, seed, layer, stochastic)
        acc = torch.matmul(codes.double(), w_i8.double().t())  # exact int32
        h = acc.float() * a * s + b
        if layer < len(qparams) - 1:
            h = torch.relu(h)
    return h


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 -> the matrix the kernel's TMA reads: (N, round16(K)),
    zero past column K, 16-byte aligned. `w` itself where K is a multiple
    of 16 and its data is aligned."""
    n, k = w.shape
    kw = _round_up(k, 16)
    if kw == k and w.data_ptr() % 16 == 0:
        return w
    out = torch.zeros((n, kw), dtype=torch.int8, device=w.device)
    out[:, :k] = w
    return out


def smem_plan(widths: Sequence[int]) -> Tuple[int, int]:
    """(ring stages, shared-memory bytes a block) of the kernel for the
    ladder `widths` = (C0, N1, ..., NL), as csrc/quant.cu `plan_ladder`
    lays it out: a ring of stages of round128(max N) rows x 64 bytes of
    weights, the codes of the widest layer input in 64 x 128 tiles, the
    row maxima and scales, a layer's scales and biases, the barriers, 1 KB
    of alignment; at least two stages. Raises ValueError where the kernel
    does not take the widths."""
    what = "quantized_mlp_head"
    c0, outs = widths[0], list(widths[1:])
    if not 1 <= len(outs) <= MAX_LAYERS:
        raise ValueError(f"{what}: expected 1..{MAX_LAYERS} layers, got {len(outs)}")
    if not 1 <= c0 <= MAX_INPUT:
        raise ValueError(f"{what}: x has {c0} columns; the kernel holds a row "
                         f"in registers and takes 1..{MAX_INPUT}")
    for i, n in enumerate(outs):
        if not 1 <= n <= MAX_WIDTH:
            raise ValueError(f"{what}: layer {i + 1} has {n} outputs; the kernel "
                             f"keeps a layer's outputs in its accumulators and "
                             f"takes 1..{MAX_WIDTH}")
    stage = _round_up(max(outs), 128) * _SLICE
    fixed = 1024 + _round_up(max(widths[:-1]), 128) // 128 * _CODE_TILE + _SMEM_TAIL
    stages = min(_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    if stages < 2:
        raise ValueError(f"{what}: widths {tuple(widths)} need more than "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return stages, fixed + stages * stage


def _check(x: torch.Tensor, qparams: QParams) -> None:
    what = "quantized_mlp_head"
    if not 1 <= len(qparams) <= MAX_LAYERS:
        raise ValueError(f"{what}: expected 1..{MAX_LAYERS} layers, got {len(qparams)}")
    flat = [x] + [t for layer in qparams for t in layer]
    _build.require_cuda(flat, what)
    _build.require_contiguous(flat, what)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"{what}: x must be (P, C) float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    c_in = x.shape[1]
    for i, (w, s, b) in enumerate(qparams):
        if w.dtype != torch.int8 or s.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError(f"{what}: layer {i + 1} must be (int8 w, float32 "
                            f"scale, float32 b), got {w.dtype}, {s.dtype}, {b.dtype}")
        n = w.shape[0]
        if w.dim() != 2 or w.shape[1] != c_in or s.shape != (n,) or b.shape != (n,):
            raise ValueError(
                f"{what}: layer {i + 1} expects w (N, {c_in}), scale (N,) and "
                f"b (N,), got {tuple(w.shape)}, {tuple(s.shape)}, {tuple(b.shape)}")
        c_in = n
    smem_plan((x.shape[1], *(w.shape[0] for w, _, _ in qparams)))


def quantized_mlp_head(x: torch.Tensor, qparams: QParams, seed: int = 0,
                       stochastic: bool = True) -> torch.Tensor:
    """x (P, C0) f32 -> (P, K) f32 through the CUDA kernel (plain PyTorch
    for CPU tensors). `qparams` as `quantize_weights` returns them."""
    global launches
    if x.device.type == "cpu":
        return quantized_mlp_head_plain(x, qparams, seed, stochastic)
    _check(x, qparams)
    num = len(qparams)
    packed = [pack_weights(w) for w, _, _ in qparams]
    ptrs = [(ctypes.c_void_p * num)(*(t.data_ptr() for t in tensors)) for tensors in
            (packed, [s for _, s, _ in qparams], [b for _, _, b in qparams])]
    dims = (ctypes.c_int * (num + 1))(x.shape[1], *(w.shape[0] for w, _, _ in qparams))
    out = torch.empty((x.shape[0], dims[num]), device=x.device, dtype=torch.float32)
    err = _build.lib().plr2_quantized_mlp_head(
        x.data_ptr(), *ptrs, dims, num, x.shape[0], seed & 0xFFFFFFFF,
        int(stochastic), out.data_ptr(), _build.stream_of(x))
    _build.check(err, "quantized_mlp_head")
    launches += 1
    return out
