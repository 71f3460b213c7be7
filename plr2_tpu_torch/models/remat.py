"""Rematerialisation of PoseNet's forward in the backward, the port of
`jax.checkpoint` in plr2_tpu/parallel/data_parallel.py `make_train_step(
remat=True)`.

JAX checkpoints the whole forward as one region. Eagerly, one region
saves nothing: the backward recomputes the region whole before its first
gradient, so every activation is alive again at the same time, which is
when the step's memory peaks. The port checkpoints PoseNet's stages one by
one instead (the ResNet trunk, the PSP module, each decoder stage, the
fusion trunk): only the tensors between stages are kept, and a stage's
activations come back just before its own backward. The function and its
gradients are the same (tests/test_torch_port_remat.py: bit for bit).

A stage is recomputed with the parameters it ran with: under mixed
precision those are the call's bf16 casts, which `functional_call` binds
again in the recompute. The recompute leaves BatchNorm's running
statistics alone (`frozen_statistics`), so they are updated once, as
JAX's functional BatchNorm is.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from plr2_tpu_torch.models.resnet import frozen_statistics


def stage(owner: nn.Module, module: nn.Module, *args):
    """`module(*args)`, rematerialised in the backward where `owner.remat`
    is set and gradients are being recorded."""
    if not (owner.remat and torch.is_grad_enabled()):
        return module(*args)
    params = dict(module.named_parameters())  # the tensors in use now

    def run(*a):
        return torch.func.functional_call(module, params, a)
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_statistics(module)))


@contextlib.contextmanager
def rematerialised(posenet: nn.Module, enabled: bool = True):
    """Within the block PoseNet's forward checkpoints its stages."""
    nets = (posenet, posenet.cnn.model)
    for n in nets:
        n.remat = enabled
    try:
        yield
    finally:
        for n in nets:
            n.remat = False
