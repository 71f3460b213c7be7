"""End-to-end estimate: PoseNet -> best hypothesis -> PoseRefineNet
iterations, the port of plr2_tpu/pipeline.py `DenseFusionPipeline` in its
`use_pallas=True` configuration.

The pipeline lives on one device, "cuda" unless the caller asks for
another; asking for CUDA where there is none raises. With
`use_kernels=True` (the default) the decoder stages and pose heads run the
hand-written CUDA kernels (plain PyTorch only for CPU tensors); with
`use_kernels=False` they run the kernels' plain versions on any device,
which is how a run on the card compares the two.

Modes: float32 (reference parity); after `cast(torch.bfloat16)`, the
bf16 fast-inference mode (the counterpart of `cast_variables`): network
parameters and activations in bf16; and, built with
`dtype=torch.bfloat16`, mixed precision (the JAX pipeline built with
`dtype=bfloat16` over f32 variables, as its Trainer trains): parameters,
BatchNorm statistics and the optimizer's state stay f32, and each call
(`run_posenet`, `run_refiner`) casts the parameters to bf16 with autograd
through the cast, so the bf16 kernels run on bf16 activations and the
gradients reach the f32 parameters. BatchNorm keeps its scale and shift
in f32 and normalises in f32 (flax's `BatchNorm(dtype=bfloat16)`); the
losses cast their inputs to f32. The pose arithmetic (best hypothesis,
re-centring, composition) sees the dtypes it sees in the JAX pipeline at
`dtype=bfloat16`: the quaternion is normalised and composed in bf16, the
translation is f32 (f32 cloud + bf16 offset, torch's promotion as jnp's),
and `estimate` returns a bf16 `quat` and `confidence`.

The f32 mode runs with TF32 off for both cuDNN convolutions and cuBLAS
matmuls (`full_f32`), whatever the caller set: cuDNN defaults to TF32,
which keeps a 10-bit mantissa. The flags are restored on return; the bf16
mode leaves them as the caller set them.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, NamedTuple, Optional

import torch

from plr2_tpu_torch.models.posenet import PoseNet, PoseRefineNet
from plr2_tpu_torch.models.resnet import BatchNorm2d
from plr2_tpu_torch.models.weights import (init_random_, posenet_state_dict,
                                           refinenet_state_dict)
from plr2_tpu_torch.refine.iterative import initial_pose, iterative_refine


class PoseEstimate(NamedTuple):
    quat: torch.Tensor        # (B, 4) wxyz, normalized
    trans: torch.Tensor       # (B, 3)
    confidence: torch.Tensor  # (B,) max per-point confidence


@contextlib.contextmanager
def full_f32(enabled: bool):
    """Within the block, f32 convolutions and matmuls run in full f32 (both
    TF32 flags off); the caller's flags are restored on exit. A no-op when
    not `enabled`."""
    if not enabled:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


class DenseFusionPipeline:
    def __init__(self, num_points: int, num_objects: int, emb_dim: int = 32,
                 use_kernels: bool = True, device="cuda",
                 seed: Optional[int] = 0, dtype=torch.float32):
        """Builds PoseNet and PoseRefineNet in eval mode on `device`, with
        weights from `torch.Generator().manual_seed(seed)` (or left
        uninitialised with seed=None, for `load_jax_variables`). `dtype` is
        the compute dtype: float32, or bfloat16 for mixed precision over
        f32 parameters."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
        self.device = resolve_device(device)
        self.num_points, self.num_objects = num_points, num_objects
        with torch.device("meta"):
            posenet = PoseNet(num_points, num_objects, emb_dim, use_kernels)
            refiner = PoseRefineNet(num_points, num_objects)
        self.posenet = posenet.to_empty(device=self.device).eval()
        self.refiner = refiner.to_empty(device=self.device).eval()
        if seed is not None:
            g = torch.Generator().manual_seed(seed)
            init_random_(self.posenet, g)
            init_random_(self.refiner, g)
        self.dtype = dtype
        self.mixed = dtype != torch.float32
        # parameters that mixed precision keeps f32: BatchNorm's scale and
        # shift (flax's BatchNorm computes in f32 whatever its dtype)
        self._keep_f32 = {
            net: {f"{mn}.{pn}" for mn, m in net.named_modules()
                  if isinstance(m, BatchNorm2d)
                  for pn, _ in m.named_parameters(recurse=False)}
            for net in (self.posenet, self.refiner)}

    def load_jax_variables(self, variables: Mapping) -> "DenseFusionPipeline":
        """Load the JAX pipeline's {"posenet": ..., "refiner": ...} variables
        (nested dicts of numpy arrays)."""
        self.posenet.load_state_dict(posenet_state_dict(variables["posenet"]),
                                     strict=True)
        self.refiner.load_state_dict(refinenet_state_dict(variables["refiner"]),
                                     strict=True)
        return self

    def cast(self, dtype=torch.bfloat16) -> "DenseFusionPipeline":
        """Cast the float parameters and statistics of both networks."""
        self.posenet.to(dtype)
        self.refiner.to(dtype)
        self.dtype = dtype
        self.mixed = False
        return self

    def _call(self, net, *args):
        if not self.mixed:
            return net(*args)
        keep = self._keep_f32[net]
        params = {n: p if n in keep else p.to(self.dtype)
                  for n, p in net.named_parameters()}
        return torch.func.functional_call(net, params, args)

    def run_posenet(self, img, cloud, choose, obj, generator=None, masks=None):
        """PoseNet in the pipeline's mode (mixed precision casts the
        parameters for this call); train-mode dropout takes `masks`
        (`PSPNet.draw_dropout_masks`) or draws from `generator`."""
        return self._call(self.posenet, img, cloud, choose, obj, generator,
                          masks)

    def run_refiner(self, cloud, emb, obj):
        """PoseRefineNet in the pipeline's mode."""
        return self._call(self.refiner, cloud, emb, obj)

    @torch.no_grad()
    def estimate(self, img, cloud, choose, obj,
                 refine_iterations: int = 2) -> PoseEstimate:
        """(B,H,W,3) crop + (B,N,3) cloud + (B,N) choose + (B,) obj -> pose."""
        with full_f32(self.dtype == torch.float32):
            pred_r, pred_t, pred_c, emb = self.run_posenet(img, cloud, choose,
                                                           obj)
            q0, t0 = initial_pose(pred_r, pred_t, pred_c, cloud)
            q, t = iterative_refine(self.run_refiner, cloud, emb, obj, q0, t0,
                                    refine_iterations)
        return PoseEstimate(quat=q, trans=t, confidence=pred_c[..., 0].amax(-1))
