"""Debugging helper, the port of plr2_tpu/utils/debug.py `checked`
(JAX's checkify with float and index checks).

`checked(fn)` runs `fn` under a dispatch mode that looks at every
floating output of every PyTorch operator, forward and backward, and
raises FloatingPointError naming the first operator whose output holds a
NaN or an Inf; around it `torch.autograd.detect_anomaly` adds the
forward's trace to an error raised in a backward that `fn` runs. The
outputs of the factories that leave memory uninitialised (`empty` and
its kin) are not looked at: the kernel or operator that fills them is,
through what reads them next. A hand-written CUDA kernel is one launch
from a wrapper, not an operator: its output is looked at by the next
operator that reads it.

Index checks: on the CPU an out-of-range index raises IndexError or
RuntimeError in the operator itself, checked or not. On the card the
indexing kernels check the index with a device-side assert, which
surfaces as a CUDA error ("device-side assert triggered") at the next
synchronisation and leaves the CUDA context unusable: run with
CUDA_LAUNCH_BLOCKING=1 to see the operator.

JAX's `interpret_pallas` has no twin: the port's kernels run their plain
PyTorch versions on CPU tensors, which is how they are debugged there.

Every operator synchronises with the device once when checked, so a
checked call is slow; `fn`'s result is returned unchanged.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "empty_permuted")


class _FiniteOutputs(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for t in tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(f"nan generated by {func}")
            if bool(torch.isinf(t).any()):
                raise FloatingPointError(f"inf generated by {func}")
        return out


def checked(fn: Callable) -> Callable:
    """`fn` that RAISES on the first NaN or Inf an operator produces
    instead of propagating it (module docstring):

        loss_fn = checked(my_loss)
        loss = loss_fn(params, batch)   # raises FloatingPointError
    """
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.autograd.detect_anomaly(check_nan=True), _FiniteOutputs():
            return fn(*args, **kwargs)
    return run
