"""CUDA graph capture, shared by frame serving (`serving.py`) and the
graphed trainers (`train/graphs.py`).

`capture(fn, args)` runs `fn` once eagerly on a side stream (the warm-up:
lazy initialisation such as cached device constants, the kernels'
shared-memory limits and cuDNN's algorithm choices happens there, outside
the capture), then captures `fn` on static copies of `args` as one CUDA
graph. Later calls copy their inputs into `Graph.inputs` (`copy_into`) and
`graph.replay()`; the outputs of the captured call live in the graph's
memory and are overwritten by every replay, so a caller keeps a `clone`.
Graphs that are replayed one at a time, each one's outputs copied before
the next replay, may share one memory pool (`pool`: the first graph's
`graph.pool()`): a later graph then reuses the blocks that an earlier
one freed, where they fit. A capture that fails raises.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class Graph(NamedTuple):
    graph: Any            # torch.cuda.CUDAGraph
    inputs: tuple         # static input buffers (None where not given)
    outputs: Any          # static outputs of the captured program


def clone(tree):
    """A copy of a tensor, or of a (Named)tuple or dict of tensors, tuples
    and Nones."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    parts = [clone(t) for t in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def copy_into(static, tree) -> None:
    """Copy `tree` into the static buffers of the same structure."""
    if isinstance(static, torch.Tensor):
        static.copy_(tree)
    elif isinstance(static, dict):
        for k, v in static.items():
            copy_into(v, tree[k])
    elif static is not None:
        for s, t in zip(static, tree):
            copy_into(s, t)


def weights_key(pipe) -> tuple:
    """What a captured graph holds of a `DenseFusionPipeline`: its dtype
    and the storage of its parameters (`cast` replaces it; an in-place
    update such as Adam's or `load_state_dict` does not, and a replay
    reads the new values)."""
    return (pipe.dtype, pipe.mixed,
            *(next(n.parameters()).data_ptr()
              for n in (pipe.posenet, pipe.refiner)))


def capture(fn: Callable, args: tuple,
            after_warmup: Optional[Callable[[], None]] = None,
            pool=None) -> Graph:
    """Warm `fn` up eagerly on a side stream, call `after_warmup` (to undo
    the warm-up's side effects), then capture fn(*static copies of args)
    as one CUDA graph, in the memory pool `pool` (another graph's
    `graph.pool()`) or a private one."""
    static = clone(tuple(args))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    if after_warmup is not None:
        after_warmup()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        outputs = fn(*static)
    return Graph(graph, static, outputs)
