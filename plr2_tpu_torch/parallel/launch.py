"""Ranks on one host without torchrun: `spawn_ranks(fn, world_size, args)`
starts `world_size` spawned processes, joins them into one process group
(`init_distributed` over a `file://` store in a fresh temporary
directory, so concurrent launches never share a port), runs
`fn(*args)` in each and returns the ranks' results in rank order. The
tests run their meshes this way on gloo CPU ranks, and chip_smoke.py its
two gloo ranks on one card. `fn` must be importable by name (a module's
top-level function) and return something picklable; a rank that raises
fails the launch with its traceback. Users launch with torchrun."""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback


def _rank_main(fn, rank, world_size, store, backend, threads, args, results):
    import torch
    import torch.distributed as dist

    from plr2_tpu_torch.parallel.mesh import init_distributed
    if threads:
        torch.set_num_threads(threads)
    try:
        init_distributed(backend, f"file://{store}", rank, world_size)
        # by value: a tensor sent through the queue itself would be shared
        # memory that dies with this process
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args: tuple = (), backend: str = "gloo",
                threads: int = 1, timeout: float = 600.0) -> list:
    """[fn(*args) of rank 0, ..., of rank world_size - 1]; each rank runs
    with `threads` torch threads (0: torch's default)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, store, backend, threads,
                                   args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        raise RuntimeError(
                            f"spawn_ranks: {len(out)} of {world_size} ranks "
                            f"reported (exit codes {[p.exitcode for p in procs]})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                out[rank] = pickle.loads(value)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world_size)]
