"""Operations and bytes from the model's shapes, and the card's peaks:
the benchmark's own yardstick, so the program cannot move it.

Counts are of multiply-adds x 2 in convolutions and matmuls (the pooling,
normalisation and elementwise work is left out). The kernel counts copy
the program's arithmetic as it stood when the benchmark was written
(`ops/upconv.flops`, `ops/mlp_head.flops`), frozen here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 SXM5 data sheet, dense rates at 700 W
PEAK_FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12,
              "fp8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12
ITEM = {"float32": 4, "bfloat16": 2}

# the dilated ResNet-18 extractor: (cin, cout, kernel, stride) in order,
# the spatial size divided by the product of the strides so far
_STEM = ((3, 64, 3, 2), (64, 64, 3, 1), (64, 128, 3, 1))
_LAYERS = ((64, 1), (128, 2), (256, 1), (512, 1))
PSP_SIZES = (1, 2, 3, 6)
# the three decoder stages: (cin, cout)
DECODER = ((1024, 256), (256, 64), (64, 64))
# PoseNet heads: (C, N1, N2, N3) before the per-object last layer
HEAD = (1408, 640, 256, 128)
HEAD_OUT = (4, 3, 1)


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * k * k * cin * cout


def trunk_flops(canvas: int) -> int:
    """The extractor on one canvas x canvas crop (output stride 8)."""
    s = canvas // 2
    total = _conv(s, s, 3, 64, 3) + _conv(s, s, 64, 64, 3) \
        + _conv(s, s, 64, 128, 3)
    s = (s + 1) // 2  # the 3x3/2 max pool
    inplanes = 128
    for planes, stride in _LAYERS:
        s = (s + stride - 1) // stride
        for bi in range(2):
            cin = inplanes if bi == 0 else planes
            total += _conv(s, s, cin, planes, 3) + _conv(s, s, planes,
                                                         planes, 3)
            if bi == 0 and (stride != 1 or inplanes != planes):
                total += _conv(s, s, inplanes, planes, 1)
        inplanes = planes
    return total


def decoder_calls(batch: int, canvas: int) -> List[Tuple]:
    """The three decoder stages of one forward: (b, h, w, cin, cout) at
    the stage's input size."""
    h = canvas // 8
    out = []
    for cin, cout in DECODER:
        out.append((batch, h, h, cin, cout))
        h *= 2
    return out


def upconv_flops(b: int, h: int, w: int, cin: int, cout: int) -> int:
    """A 2x bilinear upsample then a 3x3 conv over the (2h, 2w) map."""
    return 2 * b * (2 * h) * (2 * w) * 9 * cin * cout


def upconv_bytes(b, h, w, cin, cout, item: int) -> int:
    """Input read once, weights, bias and slope read once, output written
    once."""
    return item * (b * h * w * cin + 9 * cin * cout + cout + 1
                   + b * 4 * h * w * cout)


def head_widths(num_obj: int) -> List[Tuple[int, ...]]:
    return [HEAD + (num_obj * od,) for od in HEAD_OUT]


def head_flops(rows: int, widths: Sequence[int]) -> int:
    return 2 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def head_bytes(rows: int, widths: Sequence[int], item: int) -> int:
    """Input rows read once, every layer's weights and biases once, the
    output written once."""
    weights = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    return item * (rows * widths[0] + weights + rows * widths[-1])


def psp_flops(canvas: int) -> int:
    s = canvas // 8
    bins = sum(2 * n * n * 512 * 512 for n in PSP_SIZES)
    return bins + _conv(s, s, 512 * (len(PSP_SIZES) + 1), 1024, 1)


def fusion_flops(points: int) -> int:
    """PoseNet's point trunk on one crop."""
    return 2 * points * (3 * 64 + 32 * 64 + 2 * 64 * 128 + 256 * 512
                         + 512 * 1024)


def posenet_flops(canvas: int, points: int, num_obj: int) -> int:
    """One PoseNet forward on one crop (the final 1x1 conv only at the
    chosen pixels)."""
    dec = sum(upconv_flops(*c) for c in decoder_calls(1, canvas))
    final = 2 * points * 64 * 32
    heads = sum(head_flops(points, w) for w in head_widths(num_obj))
    return (trunk_flops(canvas) + psp_flops(canvas) + dec + final
            + fusion_flops(points) + heads)


def refiner_flops(points: int, num_obj: int) -> int:
    """One refiner iteration on one pose."""
    trunk = 2 * points * (3 * 64 + 32 * 64 + 2 * 64 * 128 + 384 * 512
                          + 512 * 1024)
    heads = 2 * sum(1024 * 512 + 512 * 128 + 128 * num_obj * od
                    for od in (4, 3))
    return trunk + heads


def bound_s(flops: int, nbytes: int, dtype: str) -> float:
    """The least time the card could take: operations at the dtype's peak
    or bytes at the memory's, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def forward_kernel_work(batch: int, canvas: int, points: int, num_obj: int,
                        dtype: str) -> Dict[str, float]:
    """Seconds of bound of one PoseNet forward's kernel calls at `batch`
    crops: {"upconv3x3_prelu": s, "mlp_head": s}."""
    item = ITEM[dtype]
    up = sum(bound_s(upconv_flops(*c), upconv_bytes(*c, item), dtype)
             for c in decoder_calls(batch, canvas))
    rows = batch * points
    head = sum(bound_s(head_flops(rows, w), head_bytes(rows, w, item), dtype)
               for w in head_widths(num_obj))
    return {"upconv3x3_prelu": up, "mlp_head": head}
