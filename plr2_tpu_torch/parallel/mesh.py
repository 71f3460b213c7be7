"""Process-group meshes, the port of plr2_tpu/parallel/mesh.py.

The JAX package scales as one controller over a `jax.sharding.Mesh`: a
program is traced once, its inputs carry shardings, and XLA inserts the
collectives. PyTorch's idiom is one process per device, joined by
`torch.distributed`; here a mesh is that idiom laid out like JAX's:

- `init_distributed` joins the process group (torchrun's environment, or
  the caller's `init_method`, `rank`, `world_size`) over the backend the
  caller names: "nccl" for one card a process, "gloo" for the CPU or for
  ranks that share one card (NCCL refuses two ranks on one GPU). It never
  picks a backend or a device itself.
- `make_mesh` lays the world's ranks out over named axes in row-major
  order, so adjacent ranks land on the trailing axis, as JAX lays out
  device ids, and makes one process group per axis: the ranks that differ
  from this one only along it (`Axis`).
- `batch_sharding` / `shard_batch` keep this rank's contiguous block of
  the leading axis, JAX's `P("data")` layout: rank r of a `data` axis of
  size n holds rows [r B/n, (r+1) B/n). Every rank draws the same global
  batch (and dropout masks) from the same seeded generators and keeps its
  block, which is what makes a mesh step compute the single-device step.
  `replicated` broadcasts from rank 0.

The collectives are methods of `Axis`, written on `all_reduce` (sum),
`all_gather_into_tensor` and `broadcast`, which NCCL and gloo both carry
for CUDA tensors (gloo aborts on a send / recv of one), so one code path
runs over either backend, on the card and on the CPU:

- `all_gather` is exact for every value, -0.0 and NaN included;
- `psum` is differentiable both ways (the backward sums the gradients
  over the axis: JAX's psum inside shard_map); `copy` (identity forward,
  sum backward) and `reduce` (sum forward, identity backward) are
  Megatron's f / g pair for tensor parallelism;
- `all_reduce_` and `all_reduce_tensors_` sum in place without autograd
  (the gradient reduction: one flat buffer, one all-reduce).

Every collective adds one to `launches` where it is issued (a CUDA graph
issues its captured collectives again at each replay without counting).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

launches = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def init_distributed(backend: str, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> Tuple[int, int, int]:
    """Join the process group; returns (rank, world_size, local_rank).

    Without arguments the group is the one torchrun describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT: `env://`); a caller
    that spawns its own ranks passes `init_method` (`tcp://localhost:port`
    or `file://path`), `rank` and `world_size`. `backend` is "nccl" (one
    card a rank; the caller then sets `torch.cuda.set_device(local_rank)`)
    or "gloo" (CPU tensors, or ranks that share one card)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return rank, world_size, local_rank


class _PSum(torch.autograd.Function):
    """Sum over the axis; the backward sums the gradients over it too."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.contiguous().clone()), None


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward, sum of the gradients backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class Axis:
    """One named axis of a `Mesh` as seen from this rank: its size, this
    rank's coordinate `index` on it, and the process group of the `ranks`
    along it (global ranks, in coordinate order)."""

    def __init__(self, name: str, ranks: Sequence[int], index: int, group):
        self.name = name
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the axis in place (no autograd); returns x."""
        dist.all_reduce(x, group=self.group)
        launches["all_reduce"] += 1
        return x

    def all_reduce_tensors_(self, tensors: Sequence[torch.Tensor],
                            mean: bool = False) -> None:
        """Sum (or average) same-dtype tensors over the axis in place,
        through one flat buffer and one all-reduce (no autograd)."""
        flat = self.all_reduce_(torch.cat([t.reshape(-1) for t in tensors]))
        if mean:
            flat /= self.size
        torch._foreach_copy_(list(tensors), [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the axis (the gradient is summed too)."""
        return _PSum.apply(x, self)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable mean over the axis, `psum(x) / size`."""
        return self.psum(x) / self.size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x unchanged; its gradient is summed over the axis (the input of
        a column-parallel layer)."""
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the axis; its gradient passes unchanged (the
        output of a row-parallel layer)."""
        return _Reduce.apply(x, self)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's x along the axis, in coordinate
        order, bit for bit (no autograd)."""
        flat = x.detach().reshape(-1).contiguous()
        out = flat.new_empty((self.size * flat.numel(),))
        dist.all_gather_into_tensor(out, flat, group=self.group)
        launches["all_gather"] += 1
        return out.view((self.size,) + tuple(x.shape))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks of the leading axis that `batch_sharding` split over
        this axis, joined back in order: (size * B, ...)."""
        return self.all_gather(x).reshape((-1,) + tuple(x.shape[1:]))

    def block(self, n: int, what: str = "rows") -> slice:
        """This rank's contiguous block of n items split over the axis."""
        if n % self.size:
            raise ValueError(f"{what}: {n} does not divide by the "
                             f"'{self.name}' axis size {self.size}")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


class Mesh:
    """The world's ranks laid out over named axes (row-major: adjacent
    ranks on the trailing axis), with one process group per axis."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int, axes: Dict[str, Axis], backend: str):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = rank
        self.size = int(np.prod(shape))
        self.backend = backend
        self._axes = axes

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, {self.backend})"

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise ValueError(f"mesh {self.axis_names} has no {name!r} axis")
        return self._axes[name]

    @property
    def coords(self) -> Dict[str, int]:
        return {n: a.index for n, a in self._axes.items()}

    def any(self, flag: bool, device) -> bool:
        """Whether `flag` is True on any rank: one all-reduce over the
        world, so every rank calls it at the same point of its program."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        dist.all_reduce(t)
        launches["all_reduce"] += 1
        return bool(t.item())


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the `n_devices` ranks of the process group (all of
    them: every rank must call this, with the same arguments), e.g.
    ``make_mesh(4, ("data", "model"), shape=(2, 2))`` for 2-way data x
    2-way tensor parallelism."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed (or run under torchrun) first")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans every rank: n_devices={n} but the "
                         f"process group has {world}")
    if shape is not None:
        if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
            raise ValueError(f"mesh shape {tuple(shape)} does not lay out "
                             f"{n} devices over axes {tuple(axis_names)}")
    elif len(axis_names) == 1:
        shape = (n,)
    else:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    rank = dist.get_rank()
    layout = np.arange(n).reshape(shape)
    coords = np.unravel_index(rank, shape)
    axes = {}
    for i, name in enumerate(axis_names):
        # every rank creates every group, in one order (new_group is
        # collective over the world)
        lines = np.moveaxis(layout, i, -1).reshape(-1, shape[i])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                axes[name] = Axis(name, [int(r) for r in line],
                                  int(coords[i]), group)
    return Mesh(axis_names, shape, rank, axes, dist.get_backend())


def batch_sharding(mesh: Mesh, axis: str = "data"):
    """The function that keeps this rank's block of a tensor's leading
    axis (JAX's `P("data")`): rank r of n holds rows [r B/n, (r+1) B/n)."""
    ax = mesh.axis(axis)

    def shard(x):
        return x[ax.block(len(x), "the batch")]
    return shard


def replicated(mesh: Mesh):
    """The function that gives every rank rank 0's tensor (in place)."""
    del mesh  # a mesh spans the whole process group

    def replicate(x: torch.Tensor) -> torch.Tensor:
        dist.broadcast(x, src=0)
        launches["broadcast"] += 1
        return x
    return replicate


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """This rank's block of every tensor (or sequence, such as a batch's
    host object ids) of a dict, tuple or list, by `batch_sharding`."""
    shard = batch_sharding(mesh, axis)
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_batch(mesh, v, axis) for v in tree))
    if isinstance(tree, (tuple, list)) and not all(
            isinstance(v, (int, np.integer)) for v in tree):
        return type(tree)(shard_batch(mesh, v, axis) for v in tree)
    return None if tree is None else shard(tree)
