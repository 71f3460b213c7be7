"""Bounded LRU cache for decoded frames (host side), the port of
plr2_tpu/data/frame_cache.py.

Real-data epochs re-decode the same PNG / meta files every pass. The
cacheable unit is the PURE decode: everything before per-visit randomness
(YCB's background compositing and front occluders draw fresh every visit,
augmentation runs later on the device), so cached entries are
deterministic and shared across epochs.

Entries are byte-accounted numpy arrays (and nested dicts/lists of
them), marked read-only so a downstream mutation raises instead of
corrupting the cache. Thread-safe (the threaded prefetch loader calls
get_raw concurrently). A pickled cache (a dataset sent to a spawned
worker process) arrives empty with the same capacity: each worker holds
its own copy, so budget `cache_mb` accordingly.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable

import numpy as np


def _freeze(x: Any) -> Any:
    if isinstance(x, np.ndarray):
        x.setflags(write=False)
        return x
    if isinstance(x, dict):
        return {k: _freeze(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_freeze(v) for v in x)
    return x


def _nbytes(x: Any) -> int:
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 64  # scalars/strings: nominal


class FrameCache:
    """LRU keyed by anything hashable, capped at `capacity_mb` megabytes.

    capacity_mb <= 0 disables caching (get() always calls `make`)."""

    def __init__(self, capacity_mb: int):
        self.capacity = int(capacity_mb) * 1024 * 1024
        self._data: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, make: Callable[[], Any]) -> Any:
        if self.capacity <= 0:
            return make()
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
        value = _freeze(make())  # decode outside the lock
        size = _nbytes(value)
        with self._lock:
            if key not in self._data and size <= self.capacity:
                self._data[key] = value
                self._bytes += size
                while self._bytes > self.capacity:
                    _, old = self._data.popitem(last=False)
                    self._bytes -= _nbytes(old)
            self.misses += 1
        return value

    def __getstate__(self):
        return {"capacity_mb": self.capacity // (1024 * 1024)}

    def __setstate__(self, state):
        self.__init__(state["capacity_mb"])
