"""ctypes bindings for the port's host data plane (``native/src/dataplane.cpp``).

The source is compiled by ONE ``g++ -O3 -shared -fPIC -std=c++17`` call
into ``plr2_tpu_torch/_build/<hash>/libplr2_dataplane.so``, where the hash
covers the source and the flags: a rerun with an unchanged source loads the
existing library. The build writes a temporary name and ``os.replace``s it
into place, so threads, xdist workers or spawned processes that build at
once never load a partial file. There is no fallback: if no compiler is
found or the build fails, the first call raises with the compiler's
output. Nothing is built at import time.

The compiler is ``$CXX`` if set, else ``g++`` or ``c++`` on ``$PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "src" / "dataplane.cpp"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libplr2_dataplane.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
CXX_TIMEOUT_S = 300

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_INT, _U8P = ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)
_I32P, _F32P = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "plr2_snap_bbox": ([_INT] * 6 + [ctypes.POINTER(_INT)], None),
    "plr2_mask_bbox_choose": ([_U8P, _INT, _INT, _INT, ctypes.c_uint64,
                               ctypes.POINTER(_INT), _I32P], _INT),
    "plr2_mask_bbox": ([_U8P, _INT, _INT, ctypes.POINTER(_INT)], _INT),
    "plr2_choose_in_bbox": ([_U8P] + [_INT] * 7 + [ctypes.c_uint64, _I32P],
                            _INT),
    "plr2_backproject": ([_F32P, _I32P] + [_INT] * 4 + [ctypes.c_float] * 5
                         + [_F32P], None),
    "plr2_parse_ply": ([ctypes.c_char_p, _F32P, _INT], _INT),
    "plr2_png_unfilter": ([_U8P, _INT, _INT, _INT], _INT),
}


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, g++ or c++ on $PATH): "
                       "the native data plane cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Tuple[Path, Optional[str]]:
    """Compile the data plane unless it exists. Returns its path and the
    compiler's messages, or None when an existing library was reused."""
    out = library_path()
    if out.is_file():
        return out, None
    cxx = find_cxx()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=CXX_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} exceeded {CXX_TIMEOUT_S} s: {cmd}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native data plane failed to build "
                           f"({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def lib() -> ctypes.CDLL:
    """The loaded data-plane library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()[0]))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def _u8(a: np.ndarray):
    """`a` as contiguous uint8 and a pointer to its data."""
    m = np.ascontiguousarray(a, dtype=np.uint8)
    return m, m.ctypes.data_as(_U8P)


def snap_bbox(rmin: int, rmax: int, cmin: int, cmax: int,
              img_h: int = 480, img_w: int = 640) -> Tuple[int, int, int, int]:
    out = (ctypes.c_int * 4)()
    lib().plr2_snap_bbox(rmin, rmax, cmin, cmax, img_h, img_w, out)
    return out[0], out[1], out[2], out[3]


def mask_bbox_choose(mask: np.ndarray, num_points: int, seed: int = 0):
    """mask (H, W) bool -> (bbox (4,), choose (num_points,) int32, count)."""
    m, ptr = _u8(mask)
    bbox = (ctypes.c_int * 4)()
    choose = np.empty(num_points, dtype=np.int32)
    count = lib().plr2_mask_bbox_choose(ptr, m.shape[0], m.shape[1],
                                        num_points, seed, bbox,
                                        choose.ctypes.data_as(_I32P))
    return (bbox[0], bbox[1], bbox[2], bbox[3]), choose, count


def mask_bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """Snapped border-list bbox of `mask` alone (H, W) bool."""
    m, ptr = _u8(mask)
    bbox = (ctypes.c_int * 4)()
    lib().plr2_mask_bbox(ptr, m.shape[0], m.shape[1], bbox)
    return bbox[0], bbox[1], bbox[2], bbox[3]


def choose_in_bbox(mask: np.ndarray, bbox: Tuple[int, int, int, int],
                   num_points: int, seed: int = 0):
    """Choose sampling of `mask` pixels inside a given bbox window ->
    (choose (num_points,) int32 crop-flat indices, count)."""
    m, ptr = _u8(mask)
    choose = np.empty(num_points, dtype=np.int32)
    count = lib().plr2_choose_in_bbox(ptr, m.shape[0], m.shape[1], bbox[0],
                                      bbox[1], bbox[2], bbox[3], num_points,
                                      seed, choose.ctypes.data_as(_I32P))
    return choose, count


def backproject(depth_crop: np.ndarray, choose: np.ndarray, crop_w: int,
                row0: int, col0: int, cx: float, cy: float, fx: float,
                fy: float, cam_scale: float) -> np.ndarray:
    d = np.ascontiguousarray(depth_crop, dtype=np.float32).reshape(-1)
    ch = np.ascontiguousarray(choose, dtype=np.int32)
    cloud = np.empty((len(ch), 3), dtype=np.float32)
    lib().plr2_backproject(d.ctypes.data_as(_F32P), ch.ctypes.data_as(_I32P),
                           len(ch), crop_w, row0, col0, cx, cy, fx, fy,
                           cam_scale, cloud.ctypes.data_as(_F32P))
    return cloud


def parse_ply(path: str, max_pts: int = 300000) -> np.ndarray:
    out = np.empty((max_pts, 3), dtype=np.float32)
    n = lib().plr2_parse_ply(str(path).encode(), out.ctypes.data_as(_F32P),
                             max_pts)
    if n < 0:
        raise IOError(f"failed to parse PLY {path!r}")
    return out[:n].copy()


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int,
                 what: str = "PNG") -> np.ndarray:
    """Inflated PNG scanlines (`height` rows of a filter byte and `stride`
    bytes) -> the unfiltered (height, stride) uint8 rows."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{what}: {len(raw)} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    buf = np.frombuffer(raw, np.uint8).copy()
    bad = lib().plr2_png_unfilter(buf.ctypes.data_as(_U8P), height, stride,
                                  bpp)
    if bad:
        raise ValueError(f"{what}: row {bad - 1} has filter type "
                         f"{buf[(bad - 1) * (stride + 1)]} (not 0-4)")
    return buf.reshape(height, stride + 1)[:, 1:]
