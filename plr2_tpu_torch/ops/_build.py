"""Build and load the port's CUDA kernels.

All sources in ``plr2_tpu_torch/csrc/*.cu`` are compiled by ONE ``nvcc``
call for ``sm_90a`` into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds, not minutes), which is loaded
with ``ctypes``. The library goes to ``plr2_tpu_torch/_build/<hash>/``,
where the hash covers the sources and the flags: a rerun with unchanged
sources loads the existing library. The build writes a temporary name and
``os.replace``s it into place, so a cut build never leaves a partial
library behind. There is no fallback: if ``nvcc`` is missing or the build
fails, this raises with nvcc's output.

Nothing here runs at import time; the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libplr2_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_TIMEOUT_S = 600

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    "plr2_mlp_head": [_I] + [_P] * 11 + [_I] * 6 + [_P],
    "plr2_upconv3x3_prelu": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    "plr2_nn_argmin": [_P] * 3 + [_I] * 3 + [_P],
    "plr2_nn_match": [_P] * 3 + [_I] * 3 + [_P],
    "plr2_nn_match_mxu": [_P] * 3 + [_I] * 3 + [_P],
    "plr2_quantized_mlp_head": [_P] * 5 + [_I, _I, _U, _I, _P, _P],
    "plr2_gather_rows_backward": [_I] + [_P] * 4 + [_I] * 4 + [_P],
}

_lib = None


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
            "and $PATH): the port's CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Tuple[Path, Optional[str]]:
    """Compile csrc/*.cu into one .so unless it exists. Returns its path and
    nvcc's messages (per-kernel registers and spills), or None when an
    existing library was reused."""
    out = library_path()
    if out.is_file():
        return out, None
    nvcc = find_nvcc()
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc exceeded {NVCC_TIMEOUT_S} s: {cmd}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stderr


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()[0]))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.plr2_error_string.argtypes = [_I]
        handle.plr2_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().plr2_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(tensors, what: str) -> None:
    """Every tensor on one CUDA device; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: all tensors must be on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")


def require_dtype(tensors, what: str) -> None:
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dt} not supported (float32, bfloat16)")
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"{what}: all tensors must be {dt}, got {t.dtype}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it where its data does not start on 16 bytes, as a
    TMA load needs."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require_multiple_of_8(widths, names, what: str, shapes: str) -> None:
    """The bf16 tensor-core kernels read rows by TMA, whose row strides
    must be multiples of 16 bytes: these bf16 widths multiples of 8."""
    bad = [f"{n} = {c}" for n, c in zip(names, widths) if c % 8]
    if bad:
        raise ValueError(f"{what}: the bf16 kernel needs {', '.join(names)} to "
                         f"be multiples of 8 (16-byte TMA row strides), got "
                         f"{', '.join(bad)} for {shapes}")


def require_contiguous(tensors, what: str) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
