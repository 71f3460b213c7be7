#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plr2_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed time; any failure raises and exits
non-zero, and there is no CPU fallback:

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles plr2_tpu_torch/csrc/*.cu with one nvcc call (into the
   git-ignored plr2_tpu_torch/_build/) and prints the wall time; scans
   the library's SASS (cuobjdump, beside nvcc): each bf16 tensor-core
   kernel must hold HGMMA (wgmma) instructions, each f32 kernel FFMA and
   no HMMA or HGMMA (no TF32 on the tensor cores), each instantiation of
   the int8 ladder IGMMA (s8 wgmma) and no IMMA (mma.sync), and no knn
   kernel any tensor-core instruction.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in f32 and bf16, at the shapes the main path gives it (batch 8; f32
   also at batch 128, where it picks other tiles); then both dtypes at
   ragged shapes that fill no tile (heads at 977 and 8000 rows, K = 21,
   63, 84, and a narrow ladder; decoder stages at odd sizes, Cin 64 and
   1024, Cout 24 and 256, batch 1 and 3; f32 also Cin 6 and 37, Cout 10
   and 130, and a head of C = 202).
4. knn: the three ADD-S nearest-neighbour kernels (nn_match, nn_argmin,
   nn_match_mxu) against their plain twins at the stage-1 shape (5
   symmetric samples x 500k queries x 500 targets) and at YCB's 2600-point
   large mesh, plus duplicate targets at both sizes (the first index must
   win) and a ragged size (10,007 queries x 1029 targets).
5. gradients: the mlp_head and upconv3x3_prelu autograd Functions against
   autograd of their plain versions at the training shapes (batch 32).
6. main path: DenseFusionPipeline.estimate at YCB width (21 objects, 1000
   points, 160 px crops, 2 refine iterations, batch 8, seeded random
   weights) in f32 and bf16; checks the kernel launch counts of the run,
   finite outputs and unit quaternions, and q/t against the same pipeline
   run through the plain versions on the card.
7. train: one f32 stage-1 step and one refine-stage step of
   make_train_step at batch 32 (500 mesh points, YCB's symmetric objects),
   each once through the kernels and once through the plain versions from
   the same state and dropout seed; checks the launch counts of each step,
   loss, dis, gradients, updated parameters and BN running statistics;
   then 3 more stage-1 steps with finite losses.
8. timing: estimate frames/s at batch 8 and 128, per-kernel times at the
   main-path shapes beside the plain version, one PyTorch library call of
   the same function, and the bound of the H100 (also at batch 128);
   profiler tables of one f32 and one bf16 estimate at batch 128;
   train-step ms and samples/s of both stages; a profiler table of a
   stage-1 step.
9. tf32: the f32 estimate runs with TF32 off whatever the caller set (a
   hook on a PoseNet convolution reads the flags); then the f32 PoseNet at
   batch 128 with cuDNN TF32 on and off: ms and the best-hypothesis pose
   gap, the size of what the estimate's own switch closes.
10. quant: the int8 pose-head ladder (quantized_mlp_head) on the seeded
   PoseNet's three heads and fused 1408-d features at batch 8 (8000 rows):
   launch counts of the path, the kernel against its plain version in both
   rounding modes (exact), determinism per seed, accuracy against the f32
   head kernel (tests/test_quant.py's bounds), a small ladder of another
   depth at 40 rows; exactness in both modes also at batch 128 (128,000
   rows), on random rows of the YCB widths at 977 rows, on a ragged ladder
   (200 -> 72 -> 40 -> 24 -> 5) and on x of 202 columns; times at batch 8
   and 128 (stochastic rounding, the op's default, and to nearest) beside
   the f32 and bf16 head kernels, the plain version, a torch._int_mm
   chain and the bound.

The second-to-last line is a JSON object with one entry per kernel and
dtype; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# main-path configuration (bench.py's flagship shape)
NUM_OBJ, NUM_POINTS, CROP, ITERS = 21, 1000, 160, 2
BATCH, BATCH_BIG = 8, 128
# PSP decoder stages at 160 px: (h, w, Cin, Cout) of the low-res input
STAGES = {"up_1": (20, 20, 1024, 256), "up_2": (40, 40, 256, 64),
          "up_3": (80, 80, 64, 64)}
HEAD_WIDTHS = (1408, 640, 256, 128)
HEAD_OUT = {"r": 4, "t": 3, "c": 1}

# H100 SXM published dense peaks (NVIDIA data sheet, 700 W); int8 in ops/s
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version on the card: |k - p| <= atol + rtol |p|. f32:
# the same f32 products summed in another order. bf16: outputs (and, in
# the ladder, the activations between layers) are rounded to bf16, so a
# sum that lands near a rounding boundary may round one ulp (2^-8 relative)
# the other way, and the ladder carries such flips on.
TOL = {"f32": (1e-4, 1e-4), "bf16": (3e-2, 3e-2)}
# estimate, kernel pipeline vs plain-version pipeline, on q and t of the
# frames that pick the same best hypothesis. Near-ties in confidence may
# pick different hypotheses (only allowed within CONF_TIE).
POSE_TOL = {"f32": 1e-3, "bf16": 5e-2}
CONF_TIE = {"f32": 1e-5, "bf16": 1e-2}

# training slice: bench.py --train's batch, YCB's mesh sizes and
# symmetric objects (plr2_tpu/config.py:139), the reference w and lr
TRAIN_BATCH, MESH_POINTS, MESH_LARGE = 32, 500, 2600
SYM_LIST, W, LR = (12, 15, 18, 19, 20), 0.015, 1e-4
# stage-1 ADD-S match: the symmetric samples of idx = arange(32) % 21
NUM_SYM = sum(int(i % NUM_OBJ in SYM_LIST) for i in range(TRAIN_BATCH))
# nn_match_mxu vs its twin: the kernel fuses a.(-2b) into FMAs and the twin
# rounds each product, so they may pick different targets only where two
# targets' augmented d2 agree to within rounding of the summed terms
# (|a|^2, |b|^2 and 2 a.b, which cancel down to d2)
MXU_TIE = 1e-6
# train step, kernels vs plain versions on the card (f32): relative error
# of loss and dis; each parameter's gradient in relative L2 norm: f32 sums
# over 32,000 rows or 51,200 pixels in another order, and ReLU masks of
# near-zero activations that the kernel's forward and the cuBLAS recompute
# in the ladder's backward may put on different sides of 0 (measured on an
# H100 80GB HBM3 at 700 W: 1.9e-4 on the colour encoder, and 1.4e-4 of the
# largest entry on the heads); BN statistics as |d| <= atol + rtol |ref|
STEP_TOL = {"loss": 1e-5, "grad_l2": 1e-3, "bn": (1e-5, 1e-4)}

# int8 head ladder: kernel vs plain version must agree exactly (the same f32
# steps, each correctly rounded, and exact int32 sums); accuracy against the
# f32 head kernel as tests/test_quant.py:47-49 bounds it
QUANT_SEED = 1234
QUANT_ACC = {"median": 0.05, "mean": 0.15}
QUANT_SMALL, QUANT_SMALL_ROWS = (128, 64, 32, 16), 40  # tests/test_quant.py
# and ragged ladders at 977 rows (no whole 64-row block): the YCB widths
# on random rows, widths of no multiple of 16 or 128, and x of 202 columns
# (not a multiple of 4: scalar loads, weights padded by the wrapper)
QUANT_RAGGED = [(977, HEAD_WIDTHS + (NUM_OBJ * od,)) for od in HEAD_OUT.values()] \
    + [(977, (200, 72, 40, 24, 5)), (977, (202, 40, 24, 12, 5))]
# a unit quaternion after the estimate: f32 exact to rounding; bf16 is
# normalised and composed in bf16 as in JAX and not renormalised after the
# last composition, so each component carries a few bf16 ulps (3.9e-3)
QUAT_NORM_TOL = {"f32": 1e-5, "bf16": 3e-2}

DEVICE = "cuda"

SOURCES = {"mlp_head": ("plr2_tpu_torch/csrc/mlp_head.cu",
                        "plr2_tpu/ops/pallas_fusion.py:55"),
           "upconv3x3_prelu": ("plr2_tpu_torch/csrc/upconv.cu",
                               "plr2_tpu/ops/pallas_upsample.py:255")}
KNN_SOURCES = {"nn_match": "plr2_tpu/ops/pallas_knn.py:121",
               "nn_argmin": "plr2_tpu/ops/pallas_knn.py:66",
               "nn_match_mxu": "plr2_tpu/ops/pallas_knn.py:197"}
QUANT_SOURCE = ("plr2_tpu_torch/csrc/quant.cu", "plr2_tpu/ops/pallas_quant.py:117")
KERNEL_NAMES = (*SOURCES, *KNN_SOURCES, "quantized_mlp_head")
# the bf16 tensor-core kernels, by a substring of their SASS function names
TC_KERNELS = {"mlp_head": "mlp_head_wgmma_kernel",
              "upconv3x3_prelu": "upconv_wgmma_kernel"}
# the f32 FP32-core kernels: FFMA only, no tensor-core instruction (TF32
# would run as HMMA or HGMMA), in every template instantiation
F32_KERNELS = {"mlp_head": "head_sgemm_kernel",
               "upconv3x3_prelu": "upconv_sgemm_kernel"}
# the int8 ladder: s8 wgmma (IGMMA) and no mma.sync (IMMA) in both
# instantiations (nearest and stochastic rounding); the knn kernels: FP32
# cores only (no HMMA, HGMMA or IGMMA)
INT8_KERNEL = "qmlp_wgmma_kernel"
KNN_KERNELS = ("nn_kernel", "nn_mxu_kernel")
SASS_OPS = ("FFMA", "HMMA", "HGMMA", "IMMA", "IGMMA")
# ragged shapes for the f32 and bf16 kernels: head (rows, widths) and
# decoder (batch, h, w, Cin, Cout); none fills every tile
RAGGED_HEADS = [(rows, HEAD_WIDTHS + (NUM_OBJ * od,)) for rows in (977, 8000)
                for od in HEAD_OUT.values()] + [(977, (200, 72, 40, 24, 5))]
RAGGED_STAGES = [(1, 5, 7, 64, 24), (3, 21, 13, 1024, 256),
                 (3, 5, 7, 1024, 24), (1, 21, 13, 64, 256)]
# f32 only (the bf16 kernel needs Cin % 8 == 0): Cin not a multiple of 4
# (the footprint's 4-byte copies) and Cout not a multiple of 4 (padded
# weight rows, scalar stores)
F32_STAGES = [(2, 5, 7, 6, 10), (1, 9, 6, 37, 130)]
# and a head whose x rows are not 16 bytes (C = 202: scalar loads of A)
F32_HEADS = [(977, (202, 40, 24, 12, 5))]
PATH_NAMES = {"f32": "estimate_f32", "bf16": "estimate_bf16"}


def counts(**launched):
    """The launch counts a path should show: `launched`, every other kernel 0."""
    return {name: launched.get(name, 0) for name in KERNEL_NAMES}


def phase(name):
    def deco(fn):
        def run(*a, **k):
            print(f"== phase {name}", flush=True)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            print(f"== phase {name} done in {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return out
        return run
    return deco


def import_port():
    if not (ROOT / "plr2_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"plr2_tpu_torch not found beside {__file__}: run "
                         "chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import plr2_tpu_torch  # noqa: F401


@phase("device")
def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # f32 products and convolutions in full f32 (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"card: {smi}")
    return smi


@phase("build")
def build_phase():
    from plr2_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.lib()
    wall = time.perf_counter() - t0
    print(f"kernel library {path}: {'built' if log is not None else 'reused'}"
          f", wall {wall:.2f} s")
    for line in (log or "").splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "C7515" in line):
            print("  ptxas:", line.strip())
    sass = count_sass(path, _build.find_nvcc())
    bad = []
    for name, sub in TC_KERNELS.items():
        n = min((c["HGMMA"] for f, c in sass.items() if sub in f), default=0)
        print(f"  SASS: {n} HGMMA instructions in {name} (bf16 {sub}; "
              f"must be > 0) {'ok' if n else 'FAIL'}")
        bad += [] if n else [f"{name} bf16 has no HGMMA"]
    for name, sub in F32_KERNELS.items():
        fns = {f: c for f, c in sass.items() if sub in f}
        for f, c in sorted(fns.items()):
            ok = c["FFMA"] > 0 and c["HMMA"] == 0 and c["HGMMA"] == 0
            print(f"  SASS: {c['FFMA']} FFMA, {c['HMMA']} HMMA, {c['HGMMA']} HGMMA "
                  f"in f32 {f[:90]} (FFMA > 0, no tensor-core instruction) "
                  f"{'ok' if ok else 'FAIL'}")
            bad += [] if ok else [f"{name} f32 {f}: {c}"]
        bad += [] if fns else [f"no f32 {sub} in the library"]
    fns = {f: c for f, c in sass.items() if INT8_KERNEL in f}
    for f, c in sorted(fns.items()):
        ok = c["IGMMA"] > 0 and c["IMMA"] == 0
        print(f"  SASS: {c['IGMMA']} IGMMA, {c['IMMA']} IMMA in int8 {f[:90]} "
              f"(IGMMA > 0, no mma.sync) {'ok' if ok else 'FAIL'}")
        bad += [] if ok else [f"int8 {f}: {c}"]
    bad += [] if len(fns) == 2 else [f"{len(fns)} int8 {INT8_KERNEL} in the library, not 2"]
    for sub in KNN_KERNELS:
        fns = {f: c for f, c in sass.items() if sub in f}
        for f, c in sorted(fns.items()):
            tc = c["HMMA"] + c["HGMMA"] + c["IGMMA"] + c["IMMA"]
            print(f"  SASS: {c['FFMA']} FFMA, {tc} tensor-core instructions in "
                  f"knn {f[:90]} (must be 0) {'ok' if tc == 0 else 'FAIL'}")
            bad += [] if tc == 0 else [f"knn {f}: {c}"]
        bad += [] if fns else [f"no knn {sub} in the library"]
    if bad:
        raise AssertionError(f"SASS check failed: {bad}")
    return wall


def count_sass(lib_path, nvcc):
    """FFMA, HMMA, HGMMA, IMMA and IGMMA instructions of each function in
    the library's SASS (cuobjdump, beside nvcc), by mangled function name."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    per_fn, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            per_fn[fn] = {op: 0 for op in SASS_OPS}
        elif fn is not None:
            for op in per_fn[fn]:
                if f" {op}." in line or f" {op} " in line:
                    per_fn[fn][op] += 1
    return per_fn


def _rand(shape, gen, scale=1.0, dtype=None):
    t = torch.randn(shape, generator=gen) * scale
    return t.to(device=DEVICE, dtype=dtype)


def stage_inputs(name, dtype, gen, batch=None):
    h, w, cin, cout = STAGES[name]
    batch = batch or BATCH
    x = _rand((batch, h, w, cin), gen, 1.0, dtype)
    wk = _rand((3, 3, cin, cout), gen, (9 * cin) ** -0.5, dtype)
    bias = _rand((cout,), gen, 0.1, dtype)
    alpha = torch.full((1,), 0.25, device=DEVICE, dtype=dtype)
    return x, wk, bias, alpha


def head_inputs(tag, dtype, gen, batch=None):
    rows = (batch or BATCH) * NUM_POINTS
    widths = HEAD_WIDTHS + (NUM_OBJ * HEAD_OUT[tag],)
    x = _rand((rows, widths[0]), gen, 1.0, dtype)
    params = [(_rand((o, i), gen, i ** -0.5, dtype), _rand((o,), gen, 0.1, dtype))
              for i, o in zip(widths[:-1], widths[1:])]
    return x, params


def compare(what, got, ref, tol):
    atol, rtol = tol
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != {tuple(r.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (g - r).abs()
    max_abs = float(err.max())
    max_rel = max_abs / max(float(r.abs().max()), 1e-30)
    worst = float((err - rtol * r.abs()).max())
    ok = worst <= atol
    print(f"  {what}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(tol |d| <= {atol:g} + {rtol:g}|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return max_abs


@phase("kernels")
def kernels_phase():
    from plr2_tpu_torch.ops import mlp_head, upconv
    errs = {}
    gen = torch.Generator().manual_seed(1)
    # the f32 kernels pick their tiles by the grid's waves: batch 128 takes
    # other tiles than batch 8, so both are checked
    for dt_name, dtype, batch in (("f32", torch.float32, BATCH),
                                  ("bf16", torch.bfloat16, BATCH),
                                  ("f32", torch.float32, BATCH_BIG)):
        for name in STAGES:
            args = stage_inputs(name, dtype, gen, batch)
            got = upconv.upconv3x3_prelu(*args)
            torch.cuda.synchronize()
            ref = upconv.upconv3x3_prelu_plain(*args)
            e = compare(f"upconv3x3_prelu {name} {dt_name} "
                        f"{tuple(args[0].shape)}", got, ref, TOL[dt_name])
            errs[("upconv3x3_prelu", dt_name)] = max(
                errs.get(("upconv3x3_prelu", dt_name), 0.0), e)
            del args, got, ref
        for tag in HEAD_OUT:
            x, params = head_inputs(tag, dtype, gen, batch)
            got = mlp_head.mlp_head(x, params)
            torch.cuda.synchronize()
            ref = mlp_head.mlp_head_plain(x, params)
            e = compare(f"mlp_head {tag} {dt_name} {tuple(x.shape)}->"
                        f"{params[-1][0].shape[0]}", got, ref, TOL[dt_name])
            errs[("mlp_head", dt_name)] = max(
                errs.get(("mlp_head", dt_name), 0.0), e)
            del x, params, got, ref
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        heads = RAGGED_HEADS + (F32_HEADS if dtype == torch.float32 else [])
        for rows, widths in heads:
            x = _rand((rows, widths[0]), gen, 1.0, dtype)
            params = [(_rand((o, i), gen, i ** -0.5, dtype), _rand((o,), gen, 0.1, dtype))
                      for i, o in zip(widths[:-1], widths[1:])]
            got = mlp_head.mlp_head(x, params)
            torch.cuda.synchronize()
            e = compare(f"mlp_head ragged {dt_name} {rows} rows {widths}", got,
                        mlp_head.mlp_head_plain(x, params), TOL[dt_name])
            errs[("mlp_head", dt_name)] = max(errs[("mlp_head", dt_name)], e)
        stages = RAGGED_STAGES + (F32_STAGES if dtype == torch.float32 else [])
        for b, h, w, cin, cout in stages:
            x = _rand((b, h, w, cin), gen, 1.0, dtype)
            args = (x, _rand((3, 3, cin, cout), gen, (9 * cin) ** -0.5, dtype),
                    _rand((cout,), gen, 0.1, dtype),
                    torch.full((1,), 0.25, device=DEVICE, dtype=dtype))
            got = upconv.upconv3x3_prelu(*args)
            torch.cuda.synchronize()
            e = compare(f"upconv3x3_prelu ragged {dt_name} {tuple(x.shape)}->{cout}",
                        got, upconv.upconv3x3_prelu_plain(*args), TOL[dt_name])
            errs[("upconv3x3_prelu", dt_name)] = max(
                errs[("upconv3x3_prelu", dt_name)], e)
    return errs


def knn_inputs(gen, m2, queries=None):
    """The stage-1 ADD-S match: NUM_SYM samples x (NUM_POINTS hypotheses x
    MESH_POINTS mesh points) queries against m2 targets, at mesh scale."""
    p = queries or NUM_POINTS * MESH_POINTS
    return _rand((NUM_SYM, p, 3), gen, 0.05), _rand((NUM_SYM, m2, 3), gen, 0.05)


def mxu_disagreements(q, got, ref):
    """Rows where nn_match_mxu and its twin matched different targets; each
    must be a near-tie of the twin's augmented d2 (see MXU_TIE)."""
    from plr2_tpu_torch.ops import knn
    rows = (got != ref).any(-1).nonzero(as_tuple=True)
    if not rows[0].numel():
        return 0, 0.0
    a, bk, bp = q[rows][:, None], got[rows][:, None], ref[rows][:, None]
    d2k = knn._d2_augmented(a, bk).flatten()
    d2p = knn._d2_augmented(a, bp).flatten()
    scale = (a * a).sum((-2, -1)) + (bp * bp).sum((-2, -1))
    return int(rows[0].numel()), float(((d2k - d2p).abs() / scale).max())


@phase("knn")
def knn_phase():
    from plr2_tpu_torch.ops import knn
    gen = torch.Generator().manual_seed(4)
    errs = {name: 0.0 for name in KNN_SOURCES}
    for m2 in (MESH_POINTS, MESH_LARGE):
        q, t = knn_inputs(gen, m2)
        shape = f"q {tuple(q.shape)} t {tuple(t.shape)}"
        idx = knn.nn_argmin(q, t)
        match = knn.nn_match(q, t)
        mxu = knn.nn_match_mxu(q, t)
        torch.cuda.synchronize()
        idx_p = knn.nn_argmin_plain(q, t)
        match_p = knn.nn_match_plain(q, t)
        mxu_p = knn.nn_match_mxu_plain(q, t)
        n_idx = int((idx != idx_p).sum())
        n_match = int((match != match_p).any(-1).sum())
        picked = torch.gather(t, 1, idx[..., None].expand(-1, -1, 3))
        n_diff, worst = mxu_disagreements(q, mxu, mxu_p)
        print(f"  nn_argmin {shape}: {n_idx} indices differ from the twin "
              f"(exact: must be 0) {'ok' if n_idx == 0 else 'FAIL'}")
        print(f"  nn_match {shape}: {n_match} rows differ from the twin "
              f"(exact: must be 0) {'ok' if n_match == 0 else 'FAIL'}")
        print(f"  nn_match_mxu {shape}: {n_diff} rows pick another target "
              f"than the twin; largest |d2 difference| / (|a|^2 + |b|^2) "
              f"{worst:.3e} (tol {MXU_TIE:g}) "
              f"{'ok' if worst <= MXU_TIE else 'FAIL'}")
        if n_idx or n_match or not torch.equal(match, picked):
            raise AssertionError(f"exact-difference knn kernels disagree "
                                 f"with their plain twins at {shape}")
        if worst > MXU_TIE:
            raise AssertionError(f"nn_match_mxu disagrees with its twin "
                                 f"beyond near-ties at {shape}")
        errs["nn_argmin"] = max(errs["nn_argmin"], float((idx - idx_p).abs().max()))
        errs["nn_match"] = max(errs["nn_match"], float((match - match_p).abs().max()))
        errs["nn_match_mxu"] = max(errs["nn_match_mxu"],
                                   float((mxu - mxu_p).abs().max()))
        del q, t, idx, match, mxu, idx_p, match_p, mxu_p, picked
    # duplicate targets: every odd target repeats the even one before it,
    # so each query ties exactly between two indices and the even one wins
    q, t = knn_inputs(gen, MESH_POINTS, queries=100_000)
    t[:, 1::2] = t[:, 0::2]
    idx = knn.nn_argmin(q, t)
    same = [torch.equal(f(q, t), g(q, t)) for f, g in (
        (knn.nn_argmin, knn.nn_argmin_plain), (knn.nn_match, knn.nn_match_plain),
        (knn.nn_match_mxu, knn.nn_match_mxu_plain))]
    odd = int((idx % 2).sum())
    print(f"  ties (duplicate targets) {tuple(q.shape)}: {odd} odd indices "
          f"(must be 0); kernels equal their twins: {same}")
    if odd or not all(same):
        raise AssertionError("knn kernels do not take the first index on ties")
    # the same at the large mesh, where the mxu kernel is held to MXU_TIE
    q, t = knn_inputs(gen, MESH_LARGE, queries=100_000)
    t[:, 1::2] = t[:, 0::2]
    idx = knn.nn_argmin(q, t)
    odd = int((idx % 2).sum())
    same = [torch.equal(f(q, t), g(q, t)) for f, g in (
        (knn.nn_argmin, knn.nn_argmin_plain), (knn.nn_match, knn.nn_match_plain))]
    n_diff, worst = mxu_disagreements(q, knn.nn_match_mxu(q, t),
                                      knn.nn_match_mxu_plain(q, t))
    print(f"  ties (duplicate targets) {tuple(q.shape)} x {MESH_LARGE}: {odd} odd "
          f"indices (must be 0); exact kernels equal their twins: {same}; "
          f"nn_match_mxu: {n_diff} rows differ, worst {worst:.3e} (tol {MXU_TIE:g})")
    if odd or not all(same) or worst > MXU_TIE:
        raise AssertionError("knn kernels do not take the first index on ties "
                             "at the large mesh")
    # distinct targets at exactly the same d2: a query at the origin and
    # the six unit points +-e_i (d2 = 1 in both forms, exactly) among far
    # points, two of them in one group of 8 and the rest later; the first
    # (index 13) must win
    far = _rand((NUM_SYM, 1029, 3), gen, 1.0)
    far = far / far.norm(dim=-1, keepdim=True) * 4.0
    unit = torch.cat([torch.eye(3, device=DEVICE), -torch.eye(3, device=DEVICE)])
    for k, m in zip((13, 14, 300, 301, 1024, 1028), unit):
        far[:, k] = m
    q0 = torch.zeros((NUM_SYM, 10_007, 3), device=DEVICE)
    got = [f(q0, far) for f in (knn.nn_match, knn.nn_match_mxu)]
    first = int((knn.nn_argmin(q0, far) != 13).sum())
    wrong = [int((g != unit[0]).any(-1).sum()) for g in got]
    print(f"  equal-d2 ties {tuple(q0.shape)} x 1029: nn_argmin misses index "
          f"13 on {first} rows, nn_match / nn_match_mxu on {wrong} (must be 0)")
    if first or any(wrong):
        raise AssertionError("knn kernels do not take the first of equal d2")
    # a ragged size: P not a multiple of a block's queries, M2 of no whole
    # group or chunk
    q, t = _rand((NUM_SYM, 10_007, 3), gen, 0.05), _rand((NUM_SYM, 1029, 3), gen, 0.05)
    same = [torch.equal(f(q, t), g(q, t)) for f, g in (
        (knn.nn_argmin, knn.nn_argmin_plain), (knn.nn_match, knn.nn_match_plain))]
    n_diff, worst = mxu_disagreements(q, knn.nn_match_mxu(q, t),
                                      knn.nn_match_mxu_plain(q, t))
    print(f"  ragged q {tuple(q.shape)} t {tuple(t.shape)}: exact kernels equal "
          f"their twins: {same}; nn_match_mxu {n_diff} rows differ, worst "
          f"{worst:.3e} (tol {MXU_TIE:g})")
    if not all(same) or worst > MXU_TIE:
        raise AssertionError("knn kernels disagree with their twins at a ragged size")
    return errs


@phase("gradients")
def grad_phase():
    """The kernels' autograd Functions against autograd of the plain
    versions, f32, at the training shapes; the cotangent is scaled by
    1/sqrt(rows) so gradients are O(1), under the f32 kernel tolerance."""
    from plr2_tpu_torch.ops import mlp_head, upconv
    gen = torch.Generator().manual_seed(5)
    tol = TOL["f32"]

    def both(fn_k, fn_p, args, cot):
        leaves = [[a.clone().requires_grad_(True) for a in args] for _ in range(2)]
        for fn, ls in ((fn_k, leaves[0]), (fn_p, leaves[1])):
            (fn(*ls) * cot).sum().backward()
        return [(k.grad, p.grad) for k, p in zip(*leaves)]

    for name in STAGES:
        args = stage_inputs(name, torch.float32, gen, TRAIN_BATCH)
        b, h, w, _ = args[0].shape
        cot = _rand((b, 2 * h, 2 * w, args[1].shape[3]), gen,
                    (b * 4 * h * w) ** -0.5)
        for arg, (gk, gp) in zip(("x", "w", "bias", "alpha"), both(
                upconv.upconv3x3_prelu, upconv.upconv3x3_prelu_plain, args, cot)):
            compare(f"d{arg} upconv3x3_prelu {name} f32 {tuple(args[0].shape)}",
                    gk, gp, tol)
    for tag in HEAD_OUT:
        x, params = head_inputs(tag, torch.float32, gen, TRAIN_BATCH)
        flat = [x] + [t for wb in params for t in wb]
        cot = _rand((x.shape[0], params[-1][0].shape[0]), gen, x.shape[0] ** -0.5)

        def unflat(fn):
            return lambda x, *f: fn(x, list(zip(f[0::2], f[1::2])))
        grads = both(unflat(mlp_head.mlp_head), unflat(mlp_head.mlp_head_plain),
                     flat, cot)
        for arg, (gk, gp) in zip(["x"] + [f"{n}{i}" for i in range(1, 5)
                                          for n in ("w", "b")], grads):
            compare(f"d{arg} mlp_head {tag} f32 {tuple(x.shape)}", gk, gp, tol)


def train_batch(seed=6):
    """A seeded batch at the slice's shape: `target` is `model_points` under
    a random rigid pose per sample, so it is not a copy of it."""
    from plr2_tpu_torch.geometry import quat_to_matrix_df
    g = torch.Generator().manual_seed(seed)
    b = TRAIN_BATCH
    img = torch.randn((b, CROP, CROP, 3), generator=g)
    points = torch.randn((b, NUM_POINTS, 3), generator=g) * 0.1
    choose = torch.randint(0, CROP * CROP, (b, NUM_POINTS), generator=g)
    mp = torch.randn((b, MESH_POINTS, 3), generator=g) * 0.05
    q = torch.randn((b, 4), generator=g)
    rot = quat_to_matrix_df(q / q.norm(dim=-1, keepdim=True))
    target = (mp[..., :, None, :] * rot[:, None]).sum(-1) \
        + torch.randn((b, 1, 3), generator=g) * 0.05
    batch = dict(img=img, points=points, choose=choose, target=target,
                 model_points=mp, idx=torch.arange(b) % NUM_OBJ)
    return {k: v.to(DEVICE) for k, v in batch.items()}


def compare_steps(what, mod_k, mod_p, step_k, step_p, met_k, met_p, before):
    """Kernel step vs plain step from the same state: loss, dis, gradients
    (from Adam's first moment), updated parameters (each within what Adam
    makes of gradients that differ as measured) and BN running stats."""
    worst = {}
    for key in ("loss", "dis"):
        k, p = float(met_k[key]), float(met_p[key])
        worst[key] = abs(k - p) / max(abs(p), 1e-30)
    params_p = dict(mod_p.named_parameters())
    grad_err, max_param, bad = 0.0, 0.0, []
    for name, pk in mod_k.named_parameters():
        pp = params_p[name]
        gk = step_k.optimizer.state[pk]["exp_avg"].double() / 0.1
        gp = step_p.optimizer.state[pp]["exp_avg"].double() / 0.1
        err = gk - gp
        rel = float(err.norm() / gp.norm().clamp(min=1e-300))
        grad_err = max(grad_err, rel)
        if rel > STEP_TOL["grad_l2"]:
            bad.append((name, "grad", rel))
        d = float(err.abs().max())
        margin = (gp.abs() - d).clamp(min=0)
        bound = torch.where(margin > 0, LR * d / margin.clamp(min=1e-300),
                            torch.full_like(margin, 2 * LR)).clamp(max=2 * LR)
        b0 = before[name].double()
        slack = 1e-7 + 2.4e-7 * b0.abs()
        diff = ((pk.detach().double() - b0) - (pp.detach().double() - b0)).abs()
        if bool((diff > bound + slack).any()):
            bad.append((name, "update", float((diff - bound).max())))
        max_param = max(max_param, float(diff.max()))
    max_bn = 0.0
    state_p = mod_p.state_dict()
    atol, rtol = STEP_TOL["bn"]
    for name, tk in mod_k.state_dict().items():
        if "running" in name:
            tp = state_p[name]
            dev = float(((tk - tp).abs() - rtol * tp.abs()).max())
            max_bn = max(max_bn, float((tk - tp).abs().max()))
            if dev > atol:
                bad.append((name, "bn", dev))
    ok = (not bad and worst["loss"] <= STEP_TOL["loss"]
          and worst["dis"] <= STEP_TOL["loss"])
    print(f"  {what} kernels vs plain: loss {float(met_k['loss']):.6f} / "
          f"{float(met_p['loss']):.6f} (rel {worst['loss']:.2e}), dis "
          f"{float(met_k['dis']):.6f} / {float(met_p['dis']):.6f} (rel "
          f"{worst['dis']:.2e}), tol {STEP_TOL['loss']:g}")
    print(f"    gradients: largest relative L2 error {grad_err:.2e} (tol "
          f"{STEP_TOL['grad_l2']:g}); largest updated-parameter difference {max_param:.3e} (lr {LR:g}; "
          f"bound: Adam's step for the measured gradient gap); largest BN "
          f"running-stat difference {max_bn:.3e} (tol {atol:g} + {rtol:g}|ref|) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel step disagrees with the plain "
                             f"step: {bad[:5]}")
    return {"max_param_diff": max_param, "max_bn_diff": max_bn,
            "grad_l2": grad_err, **worst}


def run_step(step, batch, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    met = step(batch, gen)
    torch.cuda.synchronize()
    return met


@phase("train")
def train_phase():
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    from plr2_tpu_torch.parallel import make_train_step
    kern = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    plain = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, use_kernels=False,
                                device=DEVICE, seed=0)
    batch = train_batch()
    print(f"  batch {TRAIN_BATCH}, {NUM_SYM} symmetric samples: the stage-1 "
          f"ADD-S match is {NUM_SYM} x {NUM_POINTS * MESH_POINTS} queries "
          f"against {MESH_POINTS} targets")
    launches, result = {}, {}
    for stage, iters, expect in (
            ("train_stage1", 0, counts(mlp_head=3, upconv3x3_prelu=3, nn_match=1)),
            ("train_refine", ITERS, counts(mlp_head=3, upconv3x3_prelu=3,
                                           nn_match=ITERS))):
        mod_k, mod_p = ((kern.refiner, plain.refiner) if iters
                        else (kern.posenet, plain.posenet))
        if iters:  # the same state: PoseNet as the kernel run left it
            plain.posenet.load_state_dict(kern.posenet.state_dict())
        before = {k: v.detach().clone() for k, v in mod_k.named_parameters()}
        step_k = make_train_step(kern, SYM_LIST, W, LR, refine_iterations=iters)
        step_p = make_train_step(plain, SYM_LIST, W, LR, refine_iterations=iters)
        reset_launch_counts()
        met_k = run_step(step_k, batch, seed=11)
        seen = launch_counts()
        print(f"  launches in one {stage} step: {seen}")
        if seen != expect:
            raise AssertionError(f"{stage}: expected launches {expect}, got {seen}")
        met_p = run_step(step_p, batch, seed=11)
        if launch_counts() != seen:
            raise AssertionError(f"{stage}: the plain step launched a kernel")
        launches[stage] = seen
        result[stage] = compare_steps(stage, mod_k, mod_p, step_k, step_p,
                                      met_k, met_p, before)
        result[stage]["step"] = step_k
    del plain
    torch.cuda.empty_cache()
    losses = [float(run_step(result["train_stage1"]["step"], batch, seed=12 + i)["loss"])
              for i in range(3)]
    print(f"  3 more stage-1 steps: losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite stage-1 loss")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 was switched on")
    return kern, batch, launches, result


def step_ms(step, batch, reps):
    run_step(step, batch, seed=20)
    t0 = time.perf_counter()
    for i in range(reps):
        step(batch, torch.Generator(device=DEVICE).manual_seed(21 + i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_step(step, batch):
    """The ten CUDA kernels of one stage-1 step that take the most device
    time, and the device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile
    run_step(step, batch, seed=30)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step(step, batch, seed=31)
        wall = (time.perf_counter() - t0) * 1e3
    total = top_device_kernels(prof, wall, "one stage-1 step")
    return wall, total


def main_inputs(batch, seed=2):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn((batch, CROP, CROP, 3), generator=g)
    cloud = torch.randn((batch, NUM_POINTS, 3), generator=g) * 0.1
    choose = torch.randint(0, CROP * CROP, (batch, NUM_POINTS), generator=g)
    obj = torch.arange(batch) % NUM_OBJ
    return [t.to(DEVICE) for t in (img, cloud, choose, obj)]


def check_pose(dt_name, est):
    q, t = est.quat, est.trans
    if not (torch.isfinite(q).all() and torch.isfinite(t).all()
            and torch.isfinite(est.confidence).all()):
        raise AssertionError(f"estimate {dt_name}: non-finite output")
    if q.shape != (BATCH, 4) or t.shape != (BATCH, 3):
        raise AssertionError(f"estimate {dt_name}: shapes {q.shape} {t.shape}")
    norm_err = float((q.float().norm(dim=-1) - 1).abs().max())
    if norm_err > QUAT_NORM_TOL[dt_name]:
        raise AssertionError(f"estimate {dt_name}: |q| off 1 by {norm_err}")
    print(f"  estimate {dt_name}: finite, max ||q|-1| {norm_err:.2e}")


@phase("main path")
def main_path_phase():
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, reset_launch_counts
    kern = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    plain = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, use_kernels=False,
                                device=DEVICE, seed=0)
    inputs = main_inputs(BATCH)
    launches = {}
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dtype != torch.float32:
            kern.cast(dtype)
            plain.cast(dtype)
        reset_launch_counts()
        est = kern.estimate(*inputs, refine_iterations=ITERS)
        torch.cuda.synchronize()
        seen = launch_counts()
        print(f"  launches in one estimate ({dt_name}): {seen}")
        if seen != counts(mlp_head=3, upconv3x3_prelu=3):
            raise AssertionError("expected 3 mlp_head + 3 upconv3x3_prelu "
                                 f"launches per PoseNet forward, got {seen}")
        launches[dt_name] = seen
        check_pose(dt_name, est)
        ref = plain.estimate(*inputs, refine_iterations=ITERS)
        if launch_counts() != seen:
            raise AssertionError("the plain pipeline launched a kernel")
        # which hypothesis each run picked, from the same PoseNet outputs
        with torch.no_grad():
            ck = kern.posenet(*inputs)[2][..., 0].float()
            cp = plain.posenet(*inputs)[2][..., 0].float()
        reset_launch_counts()
        ik, ip = ck.argmax(-1), cp.argmax(-1)
        same = ik == ip
        rows = torch.arange(BATCH, device=DEVICE)
        gap = float((ck[rows, ik] - ck[rows, ip]).abs().max())
        if gap > CONF_TIE[dt_name]:
            raise AssertionError(f"estimate {dt_name}: runs picked hypotheses "
                                 f"whose confidences differ by {gap}")
        dq = float((est.quat.float() - ref.quat.float())[same].abs().max()) \
            if same.any() else 0.0
        dtr = float((est.trans - ref.trans)[same].abs().max()) if same.any() else 0.0
        ok = dq <= POSE_TOL[dt_name] and dtr <= POSE_TOL[dt_name]
        print(f"  estimate {dt_name} kernels vs plain: {int(same.sum())}/{BATCH} "
              f"frames pick the same hypothesis (others within {gap:.2e} "
              f"confidence); max |dq| {dq:.3e} max |dt| {dtr:.3e} "
              f"(tol {POSE_TOL[dt_name]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"estimate {dt_name}: kernel pipeline "
                                 "disagrees with the plain-version pipeline")
    del plain
    torch.cuda.empty_cache()
    return kern, launches


def time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def upconv_library(x, w, bias, alpha):
    """The decoder stage as PyTorch library calls in the working dtype
    (cuDNN): a yardstick of speed only, never on the port's path."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    y = F.conv2d(y, w.permute(3, 2, 0, 1), bias, padding=1)
    return F.prelu(y, alpha.reshape(1))


@phase("timing")
def timing_phase(kern, launches, errs):
    frames, tables = {}, {}
    gen = torch.Generator().manual_seed(3)
    for dt_name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        kern.cast(dtype)
        for batch, reps in ((BATCH, 10), (BATCH_BIG, 3)):
            inputs = main_inputs(batch)
            ms = time_ms(lambda: kern.estimate(*inputs, refine_iterations=ITERS),
                         reps, warmup=1)
            del inputs
            frames[f"{dt_name}_b{batch}"] = batch * 1e3 / ms
            print(f"  estimate {dt_name} batch {batch}: {ms:.3f} ms "
                  f"= {batch * 1e3 / ms:.1f} frames/s")
            t = tables[(dt_name, batch)] = kernel_table(
                dt_name, dtype, gen, batch, with_plain=batch == BATCH)
            kms = {k: v["ms"] for k, v in t.items()}
            print(f"    kernels of its PoseNet forward: mlp_head x3 "
                  f"{kms['mlp_head']:.3f} ms + upconv3x3_prelu x3 "
                  f"{kms['upconv3x3_prelu']:.3f} ms = "
                  f"{100 * sum(kms.values()) / ms:.1f}% of the estimate")

    entries = []
    for dt_name in ("f32", "bf16"):
        paths = (("f32", "train_stage1", "train_refine") if dt_name == "f32"
                 else ("bf16",))
        for kname, t in tables[(dt_name, BATCH)].items():
            by_path = {PATH_NAMES.get(pth, pth): launches[pth][kname]
                       for pth in paths}
            bound, bound_by = bound_of(t, dt_name)
            entry = {
                "name": f"{kname}_{dt_name}", "route": "cuda",
                "source": SOURCES[kname][0], "replaces": SOURCES[kname][1],
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": errs[(kname, dt_name)],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": t["library_ms"]}
            b = tables[(dt_name, BATCH_BIG)][kname]
            entry.update({"ms_b128": b["ms"], "library_ms_b128": b["library_ms"],
                          "bound_ms_b128": bound_of(b, dt_name)[0]})
            entries.append(entry)
    profile = {"f32": profile_estimate(kern, BATCH_BIG)}  # kern is f32 here
    kern.cast(torch.bfloat16)
    profile["bf16"] = profile_estimate(kern, BATCH_BIG)
    return frames, entries, profile


def bound_of(t, dt_name):
    """The H100's least time for a kernel's work: max(operations / peak,
    bytes / HBM rate), and which of the two it is."""
    ops_ms = t["flops"] / PEAK_FLOPS[dt_name] * 1e3
    bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def kernel_table(dt_name, dtype, gen, batch, with_plain):
    """Per PoseNet forward at `batch` (3 decoder stages, 3 heads): kernel,
    plain-version (if `with_plain`) and library ms, FLOP and bytes."""
    from plr2_tpu_torch.ops import mlp_head, upconv
    item = torch.empty((), dtype=dtype).element_size()
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "flops": 0, "bytes": 0} for k in SOURCES}
    for name, (h, w, cin, cout) in STAGES.items():
        args = stage_inputs(name, dtype, gen, batch)
        t = tot["upconv3x3_prelu"]
        k = time_ms(lambda: upconv.upconv3x3_prelu(*args), 10)
        p = time_ms(lambda: upconv.upconv3x3_prelu_plain(*args), 5) if with_plain else 0.0
        lib = time_ms(lambda: upconv_library(*args), 10)
        b = args[0].shape[0]
        fl = upconv.flops(b, h, w, cin, cout)
        by = item * (b * h * w * cin + 9 * cin * cout + cout + 1
                     + b * 4 * h * w * cout)
        print(f"  upconv3x3_prelu {name} {dt_name} batch {batch}: kernel {k:.3f} ms "
              f"({fl / k / 1e9:.1f} TFLOP/s), "
              + (f"plain {p:.3f} ms, " if with_plain else "")
              + f"library {lib:.3f} ms")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                       ("flops", fl), ("bytes", by)):
            t[key] += v
        del args
    for tag, od in HEAD_OUT.items():
        x, params = head_inputs(tag, dtype, gen, batch)
        rows = x.shape[0]
        widths = HEAD_WIDTHS + (NUM_OBJ * od,)
        t = tot["mlp_head"]
        k = time_ms(lambda: mlp_head.mlp_head(x, params), 10)
        p = time_ms(lambda: mlp_head.mlp_head_plain(x, params), 5) if with_plain else 0.0

        def library():
            h = x
            for i, (wt, b) in enumerate(params):
                h = torch.addmm(b, h, wt.t())
                if i < 3:
                    h = torch.relu(h)
            return h
        lib = time_ms(library, 10)
        fl = mlp_head.flops(rows, widths)
        by = item * (rows * widths[0] + rows * widths[-1] + sum(
            wt.numel() + b.numel() for wt, b in params))
        print(f"  mlp_head {tag} {dt_name} batch {batch}: kernel {k:.3f} ms "
              f"({fl / k / 1e9:.1f} TFLOP/s), "
              + (f"plain {p:.3f} ms, " if with_plain else "")
              + f"library {lib:.3f} ms")
        for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                       ("flops", fl), ("bytes", by)):
            t[key] += v
        del x, params
    for kname, t in tot.items():
        bound, bound_by = bound_of(t, dt_name)
        print(f"  {kname} {dt_name} batch {batch}, per forward: kernel "
              f"{t['ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound "
              f"{bound:.4f} ms ({bound_by})")
    torch.cuda.empty_cache()
    return tot


def top_device_kernels(prof, wall, what, n=10):
    """Print the `n` CUDA kernels with the most device time in a profile
    (device-side events only: adding the host-side ops would count each
    kernel twice) and the device's busy share of `wall`."""
    from torch.autograd import DeviceType
    kernels = [(e.self_device_time_total / 1e3, e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(ms for ms, _ in kernels)
    print(f"  profiler, {what}: wall {wall:.3f} ms, device busy "
          f"{total:.3f} ms ({100 * total / wall:.1f}% of the wall time, idle "
          f"{100 - 100 * total / wall:.1f}%), "
          f"{sum(e.count for _, e in kernels)} kernel launches")
    if not kernels:
        print("  the profiler recorded no device time: the times above "
              "(CUDA events or host clock around synchronised work) stand alone")
    for ms, e in sorted(kernels, key=lambda v: -v[0])[:n]:
        print(f"    {ms:9.3f} ms {100 * ms / max(total, 1e-12):5.1f}%  x{e.count:<5d} "
              f"{e.key[:100]}")
    return total


def profile_estimate(kern, batch):
    """The CUDA kernels of one estimate at `batch` in the pipeline's dtype
    that take the most device time, and the device's idle share of its
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    inputs = main_inputs(batch)
    kern.estimate(*inputs, refine_iterations=ITERS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern.estimate(*inputs, refine_iterations=ITERS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dt_name = "bf16" if kern.dtype == torch.bfloat16 else "f32"
    busy = top_device_kernels(prof, wall, f"one {dt_name} estimate at batch {batch}", 12)
    del inputs
    torch.cuda.empty_cache()
    return {"wall_ms": wall, "device_ms": busy}


@phase("train timing")
def train_timing_phase(kern, batch, result, launches, errs):
    """Train-step ms and samples/s of both stages (host clock around
    synchronised steps), a profiler table of a stage-1 step, and the knn
    kernels at the stage-1 shape beside their twins, a PyTorch library
    yardstick (torch.cdist + argmin + gather, timed here only) and the
    H100's bound."""
    from plr2_tpu_torch.ops import knn
    from plr2_tpu_torch.parallel import make_train_step
    times = {}
    refine = make_train_step(kern, SYM_LIST, W, LR, refine_iterations=ITERS)
    for stage, step in (("stage1", result["train_stage1"]["step"]),
                        ("refine", refine)):
        ms = step_ms(step, batch, 5)
        times[f"{stage}_ms"] = ms
        times[f"{stage}_samples_per_s"] = TRAIN_BATCH * 1e3 / ms
        print(f"  {stage} step f32 batch {TRAIN_BATCH}: {ms:.3f} ms = "
              f"{TRAIN_BATCH * 1e3 / ms:.1f} samples/s")
    times["profile_wall_ms"], times["profile_device_ms"] = profile_step(
        result["train_stage1"]["step"], batch)

    gen = torch.Generator().manual_seed(7)
    q, t = knn_inputs(gen, MESH_POINTS)
    s, p, m2 = q.shape[0], q.shape[1], t.shape[1]

    def library_index():
        return torch.cdist(q, t).argmin(-1)

    def library_match():
        return torch.gather(t, 1, library_index()[..., None].expand(-1, -1, 3))
    entries = []
    for name, fn, plain, lib, out_bytes in (
            ("nn_match", knn.nn_match, knn.nn_match_plain, library_match, 12),
            ("nn_argmin", knn.nn_argmin, knn.nn_argmin_plain, library_index, 8),
            ("nn_match_mxu", knn.nn_match_mxu, knn.nn_match_mxu_plain,
             library_match, 12)):
        k = time_ms(lambda: fn(q, t), 10)
        pl = time_ms(lambda: plain(q, t), 3, warmup=1)
        lb = time_ms(lib, 3, warmup=1)
        slots = knn.issue_slots(s * p, m2, augmented=name == "nn_match_mxu")
        ops_ms = slots / knn.FP32_SLOTS_PER_S * 1e3
        bytes_ms = (12 * s * p + 12 * s * m2 + out_bytes * s * p) / HBM_BYTES_PER_S * 1e3
        by_path = {pth: launches[pth][name] for pth in ("train_stage1", "train_refine")}
        print(f"  {name} f32 q {tuple(q.shape)} t {tuple(t.shape)}: kernel "
              f"{k:.3f} ms ({slots / k / 1e9:.1f} T FP32 slots/s at "
              f"{slots // (s * p * m2)} a pair), plain {pl:.3f} ms, library "
              f"{lb:.3f} ms, bound {max(ops_ms, bytes_ms):.3f} ms "
              f"({100 * max(ops_ms, bytes_ms) / k:.0f}% of it reached)")
        entries.append({
            "name": name, "route": "cuda",
            "source": "plr2_tpu_torch/csrc/knn.cu",
            "replaces": KNN_SOURCES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": k, "plain_ms": pl,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lb,
            "bound_operations": f"FP32 issue slots, {slots // (s * p * m2)} a pair, "
                                f"at {knn.FP32_SLOTS_PER_S:.3g}/s"})
    return times, entries


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set_tf32(cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@phase("tf32")
def tf32_phase(kern):
    """The f32 estimate switches TF32 off itself; then the gap that switch
    closes: the f32 PoseNet at batch 128 with cuDNN TF32 on and off (the
    flags the process had set), its time and its best-hypothesis pose."""
    from plr2_tpu_torch.refine import initial_pose
    if kern.dtype != torch.float32:
        raise AssertionError("tf32 phase needs the f32 pipeline")
    inputs = main_inputs(BATCH)
    conv = next(m for m in kern.posenet.modules() if isinstance(m, torch.nn.Conv2d))
    seen = []
    hook = conv.register_forward_pre_hook(lambda m, a: seen.append(_tf32_flags()))
    est = {}
    try:
        for caller in (False, True):
            _set_tf32(caller, caller)
            est[caller] = kern.estimate(*inputs, refine_iterations=ITERS)
            if _tf32_flags() != (caller, caller):
                raise AssertionError("estimate did not restore the TF32 flags")
    finally:
        hook.remove()
        _set_tf32(False, False)
    gap = max(float((est[True].quat - est[False].quat).abs().max()),
              float((est[True].trans - est[False].trans).abs().max()))
    print(f"  f32 estimate with the caller's TF32 flags on: the convolutions "
          f"saw {sorted(set(seen))} (must be (False, False) only); pose "
          f"against flags off differs by {gap:.3e}")
    if set(seen) != {(False, False)}:
        raise AssertionError(f"the f32 estimate ran with TF32 flags {seen}")

    inputs = main_inputs(BATCH_BIG)
    out = {}
    for on in (False, True):
        torch.backends.cudnn.allow_tf32 = on
        try:
            with torch.no_grad():
                ms = time_ms(lambda: kern.posenet(*inputs), 3, warmup=1)
                pred_r, pred_t, pred_c, _ = kern.posenet(*inputs)
                q, t = initial_pose(pred_r, pred_t, pred_c, inputs[1])
        finally:
            torch.backends.cudnn.allow_tf32 = False
        out[on] = (ms, q, t, pred_c[..., 0].argmax(-1), pred_c)
    same = out[True][3] == out[False][3]
    dq = float((out[True][1] - out[False][1])[same].abs().max()) if same.any() else 0.0
    dt = float((out[True][2] - out[False][2])[same].abs().max()) if same.any() else 0.0
    dc = float((out[True][4] - out[False][4]).abs().max())
    print(f"  f32 PoseNet batch {BATCH_BIG}: cuDNN TF32 off {out[False][0]:.3f} ms, "
          f"on {out[True][0]:.3f} ms; {int(same.sum())}/{BATCH_BIG} frames pick "
          f"the same hypothesis, on those max |dq| {dq:.3e} max |dt| {dt:.3e}; "
          f"max |d confidence| {dc:.3e}")
    return {"off_ms": out[False][0], "on_ms": out[True][0], "same": int(same.sum()),
            "dq": dq, "dt": dt, "dconf": dc}


def head_features(pipe, batch):
    """The fused per-point features PoseNet feeds its heads, as
    `PoseNet.forward` computes them: (batch * NUM_POINTS, 1408) f32."""
    img, cloud, choose, _ = main_inputs(batch)
    with torch.no_grad():
        feat = pipe.posenet.feat(cloud, pipe.posenet.cnn(img, choose))
    return feat.reshape(-1, feat.shape[-1]).contiguous()


def head_layers(pipe, tag):
    """Head `tag`'s four (w (out, in), b) f32 layers of the seeded PoseNet."""
    layers = [getattr(pipe.posenet, f"conv{i}_{tag}") for i in range(1, 5)]
    return [(m.weight.detach().reshape(m.weight.shape[0], -1).contiguous(),
             m.bias.detach()) for m in layers]


def int_mm_library(x, qparams):
    """The int8 ladder as PyTorch library calls: torch._int_mm (cuBLASLt) on
    int8 codes and weights padded to 8 output columns, the quantise and
    dequantise as elementwise torch ops. A yardstick of speed only, never on
    the port's path."""
    padded = []
    for w, s, b in qparams:
        n, k = w.shape
        wp = torch.zeros(((n + 7) // 8 * 8, k), dtype=torch.int8, device=w.device)
        wp[:n] = w
        padded.append((wp.t(), s, b, n))  # (K, N8), column-major

    def run():
        h = x
        for i, (wt, s, b, n) in enumerate(padded):
            a = torch.clamp(h.abs().amax(1, keepdim=True) / 127.0, min=1e-12)
            codes = torch.clamp(torch.round(h / a), -127, 127).to(torch.int8)
            h = torch._int_mm(codes, wt)[:, :n].float() * a * s + b
            if i < len(padded) - 1:
                h = torch.relu(h)
        return h
    return run


@phase("quant")
def quant_phase():
    """The int8 head ladder on the seeded PoseNet's heads and features."""
    from plr2_tpu_torch import DenseFusionPipeline
    from plr2_tpu_torch.ops import launch_counts, mlp_head, quant, reset_launch_counts
    pipe = DenseFusionPipeline(NUM_POINTS, NUM_OBJ, device=DEVICE, seed=0)
    x = head_features(pipe, BATCH)
    heads = {tag: head_layers(pipe, tag) for tag in HEAD_OUT}
    qheads = {tag: quant.quantize_weights(layers) for tag, layers in heads.items()}
    print(f"  features {tuple(x.shape)}; heads "
          f"{[tuple(w.shape) for w, _, _ in qheads['r']]} int8 (r), K = "
          f"{[NUM_OBJ * od for od in HEAD_OUT.values()]}")

    # the path: the three ladders with the op's defaults (seed 0, stochastic)
    reset_launch_counts()
    outs = {tag: quant.quantized_mlp_head(x, q) for tag, q in qheads.items()}
    torch.cuda.synchronize()
    seen = launch_counts()
    print(f"  launches in one int8 head forward: {seen}")
    if seen != counts(quantized_mlp_head=3):
        raise AssertionError(f"expected 3 quantized_mlp_head launches, got {seen}")
    for tag, out in outs.items():
        if out.shape != (x.shape[0], NUM_OBJ * HEAD_OUT[tag]) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"int8 head {tag}: shape {tuple(out.shape)} or "
                                 "non-finite values")

    # 1. kernel against its plain version, both rounding modes, exact
    max_err, results = 0.0, {}
    for stochastic in (False, True):
        for tag, q in qheads.items():
            got = quant.quantized_mlp_head(x, q, QUANT_SEED, stochastic)
            torch.cuda.synchronize()
            ref = quant.quantized_mlp_head_plain(x, q, QUANT_SEED, stochastic)
            n_diff = int((got != ref).sum())
            err = float((got - ref).abs().max())
            max_err = max(max_err, err)
            results[(tag, stochastic)] = got
            print(f"  quantized_mlp_head {tag} stochastic={stochastic} "
                  f"{tuple(x.shape)}->{got.shape[1]}: {n_diff} of {got.numel()} "
                  f"outputs differ from the plain version, max |d| {err:.3e} "
                  f"(exact: must be 0) {'ok' if n_diff == 0 else 'FAIL'}")
            if n_diff:
                raise AssertionError("quantized_mlp_head disagrees with its "
                                     "plain version")
    # 2. the same seed twice gives the same draws, another seed others
    for tag, q in qheads.items():
        again = quant.quantized_mlp_head(x, q, QUANT_SEED, True)
        other = quant.quantized_mlp_head(x, q, QUANT_SEED + 1, True)
        moved = int((other != again).sum())
        print(f"  stochastic {tag}: seed {QUANT_SEED} twice identical "
              f"{torch.equal(again, results[(tag, True)])}; seed {QUANT_SEED + 1} "
              f"moves {moved} of {other.numel()} outputs")
        if not torch.equal(again, results[(tag, True)]) or moved == 0:
            raise AssertionError("stochastic rounding is not deterministic per seed")
    # 3. accuracy against the f32 head kernel (tests/test_quant.py's bounds)
    for tag, layers in heads.items():
        ref = mlp_head.mlp_head(x, layers)
        denom = torch.maximum(ref.abs(), ref.abs().mean())
        for stochastic in (False, True):
            rel = (results[(tag, stochastic)] - ref).abs() / denom
            med, mean = float(rel.median()), float(rel.mean())
            ok = med < QUANT_ACC["median"] and mean < QUANT_ACC["mean"]
            print(f"  int8 vs f32 head kernel {tag} stochastic={stochastic}: "
                  f"median rel err {med:.4f} (< {QUANT_ACC['median']}), mean "
                  f"{mean:.4f} (< {QUANT_ACC['mean']}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("int8 head too far from the f32 head")
    # 4. other depths, widths and row counts: tests/test_quant.py's ladder
    # at 40 rows, the ragged ladders at 977
    gen = torch.Generator().manual_seed(8)
    for rows, widths in [(QUANT_SMALL_ROWS, QUANT_SMALL)] + QUANT_RAGGED:
        ladder = quant.quantize_weights(
            [(_rand((o, i), gen, i ** -0.5), _rand((o,), gen, 0.05))
             for i, o in zip(widths[:-1], widths[1:])])
        xs = _rand((rows, widths[0]), gen)
        for stochastic in (False, True):
            got = quant.quantized_mlp_head(xs, ladder, QUANT_SEED, stochastic)
            torch.cuda.synchronize()
            ref = quant.quantized_mlp_head_plain(xs, ladder, QUANT_SEED, stochastic)
            n_diff = int((got != ref).sum())
            print(f"  quantized_mlp_head {widths} at {rows} rows, "
                  f"stochastic={stochastic}: {n_diff} outputs differ (exact) "
                  f"{'ok' if n_diff == 0 else 'FAIL'}")
            if n_diff:
                raise AssertionError(f"quantized_mlp_head disagrees with its "
                                     f"plain version on {widths} at {rows} rows")
    # 5. batch 128: the seeded heads on 128,000 rows of features
    xb = head_features(pipe, BATCH_BIG)
    for stochastic in (False, True):
        for tag, q in qheads.items():
            got = quant.quantized_mlp_head(xb, q, QUANT_SEED, stochastic)
            torch.cuda.synchronize()
            ref = quant.quantized_mlp_head_plain(xb, q, QUANT_SEED, stochastic)
            n_diff = int((got != ref).sum())
            max_err = max(max_err, float((got - ref).abs().max()))
            print(f"  quantized_mlp_head {tag} stochastic={stochastic} "
                  f"{tuple(xb.shape)}->{got.shape[1]}: {n_diff} of {got.numel()} "
                  f"outputs differ (exact) {'ok' if n_diff == 0 else 'FAIL'}")
            if n_diff:
                raise AssertionError("quantized_mlp_head disagrees with its "
                                     "plain version at batch 128")
            del got, ref
    del xb
    torch.cuda.empty_cache()
    return pipe, heads, qheads, seen, max_err


@phase("quant timing")
def quant_timing_phase(pipe, heads, qheads, seen, max_err):
    """Per forward (three ladders): the int8 kernel, the f32 and bf16 head
    kernels on the same rows, the plain version, a torch._int_mm chain and
    the H100's bound, at batch 8 and 128."""
    from plr2_tpu_torch.ops import mlp_head, quant
    entry = None
    for batch in (BATCH, BATCH_BIG):
        x = head_features(pipe, batch)
        rows = x.shape[0]
        t = {"ms": 0.0, "nearest_ms": 0.0, "f32_ms": 0.0, "bf16_ms": 0.0,
             "plain_ms": 0.0, "library_ms": 0.0, "ops": 0, "bytes": 0}
        per_launch = []
        xb = x.bfloat16()
        for tag, q in qheads.items():
            k = time_ms(lambda: quant.quantized_mlp_head(x, q), 10)
            per_launch.append(k)
            t["ms"] += k
            t["nearest_ms"] += time_ms(
                lambda: quant.quantized_mlp_head(x, q, stochastic=False), 10)
            t["f32_ms"] += time_ms(lambda: mlp_head.mlp_head(x, heads[tag]), 5)
            hb = [(w.bfloat16(), b.bfloat16()) for w, b in heads[tag]]
            t["bf16_ms"] += time_ms(lambda: mlp_head.mlp_head(xb, hb), 5)
            t["library_ms"] += time_ms(int_mm_library(x, q), 10)
            if batch == BATCH:
                t["plain_ms"] += time_ms(
                    lambda: quant.quantized_mlp_head_plain(x, q), 3, warmup=1)
            widths = (x.shape[1], *(w.shape[0] for w, _, _ in q))
            t["ops"] += mlp_head.flops(rows, widths)  # int8 multiply-adds x 2
            t["bytes"] += 4 * rows * (widths[0] + widths[-1]) + sum(
                w.numel() + 4 * (s.numel() + b.numel()) for w, s, b in q)
        ops_ms = t["ops"] / PEAK_FLOPS["int8"] * 1e3
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        print(f"  int8 heads batch {batch} ({rows} rows): kernel "
              f"{' + '.join(f'{v:.3f}' for v in per_launch)} = {t['ms']:.3f} ms "
              f"per forward ({t['ops'] / t['ms'] / 1e9:.1f} TOP/s; stochastic "
              f"rounding, the op's default), {t['nearest_ms']:.3f} ms rounding "
              f"to nearest; f32 head "
              f"kernel {t['f32_ms']:.3f} ms, bf16 {t['bf16_ms']:.3f} ms; "
              f"torch._int_mm chain {t['library_ms']:.3f} ms; "
              + (f"plain {t['plain_ms']:.3f} ms; " if batch == BATCH else "")
              + f"bound {bound:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}"
              f": {t['bytes'] / 1e6:.1f} MB, {t['ops'] / 1e9:.1f} G int8 ops)")
        if batch == BATCH:
            entry = {
                "name": "quantized_mlp_head_int8", "route": "cuda",
                "source": QUANT_SOURCE[0], "replaces": QUANT_SOURCE[1],
                "launches": seen["quantized_mlp_head"],
                "launches_by_path": {"estimate_f32": 0, "estimate_bf16": 0,
                                     "train_stage1": 0, "train_refine": 0,
                                     "quant": seen["quantized_mlp_head"]},
                "max_abs_err": max_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": t["library_ms"], "nearest_ms": t["nearest_ms"],
                "f32_head_ms": t["f32_ms"], "bf16_head_ms": t["bf16_ms"]}
        else:
            entry.update({"ms_b128": t["ms"], "library_ms_b128": t["library_ms"],
                          "nearest_ms_b128": t["nearest_ms"],
                          "bound_ms_b128": bound, "f32_head_ms_b128": t["f32_ms"],
                          "bf16_head_ms_b128": t["bf16_ms"]})
        del x, xb
        torch.cuda.empty_cache()
    return entry


def main():
    t0 = time.perf_counter()
    import_port()
    smi = device_phase()
    build_s = build_phase()
    errs = kernels_phase()
    knn_errs = knn_phase()
    grad_phase()
    kern, launches = main_path_phase()
    tkern, batch, train_launches, train_result = train_phase()
    launches.update(train_launches)
    frames, entries, est_profile = timing_phase(kern, launches, errs)
    kern.cast(torch.float32)
    tf32 = tf32_phase(kern)
    del kern
    train_times, knn_entries = train_timing_phase(tkern, batch, train_result,
                                                  launches, knn_errs)
    entries += knn_entries
    del tkern, batch, train_result
    torch.cuda.empty_cache()
    entries.append(quant_timing_phase(*quant_phase()))
    print(f"summary: build {build_s:.2f} s, total {time.perf_counter() - t0:.2f} s, "
          f"frames/s {json.dumps({k: round(v, 1) for k, v in frames.items()})}, "
          f"train {json.dumps({k: round(v, 3) for k, v in train_times.items()})}, "
          f"tf32 {json.dumps({k: round(v, 6) for k, v in tf32.items()})}, "
          f"estimate profiles {json.dumps({d: {k: round(v, 3) for k, v in p.items()} for d, p in est_profile.items()})}")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
