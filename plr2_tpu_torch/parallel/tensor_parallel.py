"""Tensor parallelism (Megatron's column / row pairs) over a `model` mesh
axis, the port of plr2_tpu/parallel/tensor_parallel.py.

A column-parallel layer keeps a slice of its output features (weight rows
and bias); its activation comes out feature-sliced with no communication.
The row-parallel layer after it keeps the matching slice of its input
features (weight columns) and its whole bias; its partial products are
summed over `model` (one all-reduce a pair), and the bias is added once.
The pairs, as in JAX (every sliced width is a multiple of 8):

  PoseNetFeat        conv5 (256 -> 512) column  -> conv6 (512 -> 1024) row
  PoseNet heads      conv1 (1408 -> 640) column -> conv2 (640 -> 256) row
                     conv3 (256 -> 128) column  -> conv4 (128 -> K) row
  PoseRefineNetFeat  conv5 (384 -> 512) column  -> conv6 (512 -> 1024) row
  PoseRefineNet      conv1 (1024 -> 512) column -> conv2 (512 -> 128) row
                     conv3: replicated

The rules are keyed by the port's upstream parameter names
(`models/weights.py`: "posenet.conv1_r.weight", "refiner.feat.conv5.bias").
A spec is JAX's PartitionSpec in torch's (out, in[, 1]) layout: a tuple of
axis names or None per dimension, trailing dimensions replicated; so JAX's
column kernel P(None, "model") over (in, out) is ("model",) here.

`shard_variables` keeps this rank's slices of a {"posenet", "refiner"}
tree of state dicts; `shard_pipeline` puts them into a pipeline's modules
as their parameters and sets the networks' `model_axis`, after which the
sliced layers run as per-layer `F.linear` with Megatron's f / g pair
around each pair (`models/posenet.py` `_tp_pair`). That is JAX's XLA head
path, which tensor parallelism needs in JAX too
(plr2_tpu/train/batch_trainer.py:46-50): kernel 1 consumes whole weights
in one launch, so the tensor-parallel heads do not run it; every path
without tensor parallelism does. The colour CNN stays replicated.
`gathered` puts the whole weights back for a while (a checkpoint's save
or restore), then the slices of what they then hold.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Mapping

import torch
import torch.nn as nn

_COL = {"weight": ("model",), "bias": ("model",)}
_ROW = {"weight": (None, "model"), "bias": ()}
_HEADS = {
    "posenet": {"conv1": _COL, "conv2": _ROW, "conv3": _COL, "conv4": _ROW},
    "refiner": {"conv1": _COL, "conv2": _ROW},  # conv3 replicated
}
_FEAT = {"conv5": _COL, "conv6": _ROW}
_HEAD_RE = re.compile(r"^conv(\d+)_[rtc]$")


def tp_spec(name: str) -> tuple:
    """The spec of one parameter, `name` = "<net>.<upstream name>" with
    <net> "posenet" or "refiner"; () is replicated (the CNN, the small
    trunk layers, the refiner's last head layer, BatchNorm's buffers)."""
    net, *mods, leaf = name.split(".")
    if len(mods) == 2 and mods[0] == "feat" and mods[1] in _FEAT:
        return _FEAT[mods[1]].get(leaf, ())
    m = _HEAD_RE.match(mods[0]) if len(mods) == 1 else None
    if m and net in _HEADS:
        return _HEADS[net].get(f"conv{m.group(1)}", {}).get(leaf, ())
    return ()


def _named(variables: Mapping):
    for net, state in variables.items():
        for name, t in state.items():
            yield net, name, t, tp_spec(f"{net}.{name}")


def tp_shardings(mesh, variables: Mapping) -> Dict:
    """{net: {name: spec}} for a {"posenet", "refiner"} tree of state
    dicts; raises ValueError where a sliced dimension does not divide by
    the `model` axis size."""
    size = mesh.axis("model").size
    out: Dict = {net: {} for net in variables}
    for net, name, t, spec in _named(variables):
        for dim, ax in zip(t.shape, spec):
            if ax == "model" and dim % size:
                raise ValueError(f"{net}.{name}: dim {dim} not divisible by "
                                 f"model axis size {size}")
        out[net][name] = spec
    return out


def _slice(t: torch.Tensor, spec: tuple, axis) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax == "model":
            t = t.narrow(dim, axis.block(t.shape[dim]).start,
                         t.shape[dim] // axis.size)
    return t


def shard_variables(mesh, variables: Mapping) -> Dict:
    """This rank's slices of a {"posenet", "refiner"} tree of state dicts
    (tensors; copies, contiguous)."""
    axis = mesh.axis("model")
    specs = tp_shardings(mesh, variables)
    return {net: {name: _slice(torch.as_tensor(t), specs[net][name],
                               axis).contiguous().clone()
                  for name, t in state.items()}
            for net, state in variables.items()}


def sharded_param_count(variables: Mapping) -> int:
    """Elements of the tree's parameters that a `model` axis slices."""
    return sum(int(torch.as_tensor(t).numel())
               for _, _, t, spec in _named(variables) if "model" in spec)


def _sharded_params(pipe):
    """(module, attribute, spec) of every sliced parameter of the pipeline."""
    for net_name, net in (("posenet", pipe.posenet), ("refiner", pipe.refiner)):
        for name, _ in net.named_parameters():
            spec = tp_spec(f"{net_name}.{name}")
            if "model" in spec:
                mod, attr = name.rsplit(".", 1)
                yield net.get_submodule(mod), attr, spec


def _set_axis(pipe, axis) -> None:
    for net in (pipe.posenet, pipe.refiner):
        net.model_axis = axis
        net.feat.model_axis = axis


def shard_pipeline(mesh, pipe):
    """Slice `pipe`'s column / row layers to this rank's parameters and run
    them tensor-parallel over `mesh`'s `model` axis (in place; build the
    optimizer after). Returns `pipe`."""
    axis = mesh.axis("model")
    tp_shardings(mesh, {"posenet": pipe.posenet.state_dict(),
                        "refiner": pipe.refiner.state_dict()})
    with torch.no_grad():
        for module, attr, spec in list(_sharded_params(pipe)):
            full = getattr(module, attr)
            setattr(module, attr, nn.Parameter(
                _slice(full.data, spec, axis).contiguous().clone()))
    _set_axis(pipe, axis)
    return pipe


def _join(parts: torch.Tensor, spec: tuple) -> torch.Tensor:
    """(size, *slice) gathered slices -> the whole tensor."""
    return torch.cat(list(parts), dim=spec.index("model"))


@contextlib.contextmanager
def gathered(mesh, pipe):
    """Within the block a sharded `pipe` holds its whole weights (gathered
    over `model`: every rank enters); on exit each rank's parameters take
    their slices of the whole weights as they then are (a checkpoint
    loaded in the block lands in the slices). The slice parameters stay
    the same objects, so optimizers and graphs keep them."""
    axis = mesh.axis("model")
    saved = []
    with torch.no_grad():
        for module, attr, spec in list(_sharded_params(pipe)):
            part = getattr(module, attr)
            setattr(module, attr, nn.Parameter(_join(axis.all_gather(part.data),
                                                     spec)))
            saved.append((module, attr, spec, part))
    try:
        yield pipe
    finally:
        with torch.no_grad():
            for module, attr, spec, part in saved:
                part.copy_(_slice(getattr(module, attr).data, spec, axis))
                setattr(module, attr, part)
