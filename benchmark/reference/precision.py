"""The precisions the reference runs in.

`float32` is the reference itself: full float32, TF32 off for cuDNN and
cuBLAS. The controls are the reference computed one step below what a
cell's configuration states (the step that would tempt an optimisation):
- `tf32` for a float32 cell: both TF32 flags on, a 10-bit mantissa in
  every convolution and matmul;
- `fp8` for a bfloat16 cell: every convolution's and matmul's operands
  rounded to float8 e4m3 with one scale per tensor (amax / 448), the
  products accumulated in float32.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference.model import Precision

E4M3_MAX = 448.0

CONTROL_OF = {"float32": "tf32", "bfloat16": "fp8"}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, back in x's dtype."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def precision(name: str) -> Precision:
    if name == "fp8":
        return Precision(fp8_round)
    if name in ("float32", "tf32"):
        return Precision()
    raise ValueError(f"unknown reference precision {name!r}")


@contextlib.contextmanager
def tf32_flags(name: str):
    """Both TF32 flags on for `tf32`, off otherwise; restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
