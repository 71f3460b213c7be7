"""plr2_tpu_torch: the PyTorch/CUDA port of plr2_tpu for one NVIDIA H100.

Imports torch and numpy only (never jax, flax or plr2_tpu). Kernels that
the JAX package wrote in Pallas for the TPU are hand-written CUDA here
(`plr2_tpu_torch/csrc`, built at first use by `ops/_build.py`).
"""

from plr2_tpu_torch.pipeline import DenseFusionPipeline, PoseEstimate

__all__ = ["DenseFusionPipeline", "PoseEstimate"]
