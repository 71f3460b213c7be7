#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plr2_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its elapsed time; any failure raises and exits
non-zero, and there is no CPU fallback:

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles plr2_tpu_torch/csrc/*.cu with one nvcc call (into the
   git-ignored plr2_tpu_torch/_build/) and prints the wall time.
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in f32 and bf16, at the shapes the main path gives it (batch 8).
4. main path: DenseFusionPipeline.estimate at YCB width (21 objects, 1000
   points, 160 px crops, 2 refine iterations, batch 8, seeded random
   weights) in f32 and bf16; checks the kernel launch counts of the run,
   finite outputs and unit quaternions, and q/t against the same pipeline
   run through the plain versions on the card.
5. timing: estimate frames/s at batch 8 and 128, and per-kernel times at
   the main-path shapes beside the plain version, one PyTorch library
   call of the same function, and the bound of the H100.

The second-to-last line is a JSON object with one entry per kernel and
dtype; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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

# H100 SXM published dense peaks (NVIDIA data sheet, 700 W)
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
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

DEVICE = "cuda"

SOURCES = {"mlp_head": ("plr2_tpu_torch/csrc/mlp_head.cu",
                        "plr2_tpu/ops/pallas_fusion.py:55"),
           "upconv3x3_prelu": ("plr2_tpu_torch/csrc/upconv.cu",
                               "plr2_tpu/ops/pallas_upsample.py:255")}


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
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    return wall


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
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for name in STAGES:
            args = stage_inputs(name, dtype, gen)
            got = upconv.upconv3x3_prelu(*args)
            torch.cuda.synchronize()
            ref = upconv.upconv3x3_prelu_plain(*args)
            e = compare(f"upconv3x3_prelu {name} {dt_name} "
                        f"{tuple(args[0].shape)}", got, ref, TOL[dt_name])
            errs[("upconv3x3_prelu", dt_name)] = max(
                errs.get(("upconv3x3_prelu", dt_name), 0.0), e)
        for tag in HEAD_OUT:
            x, params = head_inputs(tag, dtype, gen)
            got = mlp_head.mlp_head(x, params)
            torch.cuda.synchronize()
            ref = mlp_head.mlp_head_plain(x, params)
            e = compare(f"mlp_head {tag} {dt_name} {tuple(x.shape)}->"
                        f"{params[-1][0].shape[0]}", got, ref, TOL[dt_name])
            errs[("mlp_head", dt_name)] = max(
                errs.get(("mlp_head", dt_name), 0.0), e)
    return errs


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
    norm_err = float((q.norm(dim=-1) - 1).abs().max())
    if norm_err > 1e-5:
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
        counts = launch_counts()
        print(f"  launches in one estimate ({dt_name}): {counts}")
        if counts != {"mlp_head": 3, "upconv3x3_prelu": 3}:
            raise AssertionError("expected 3 mlp_head + 3 upconv3x3_prelu "
                                 f"launches per PoseNet forward, got {counts}")
        launches[dt_name] = counts
        check_pose(dt_name, est)
        ref = plain.estimate(*inputs, refine_iterations=ITERS)
        if launch_counts() != counts:
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
        dq = float((est.quat - ref.quat)[same].abs().max()) if same.any() else 0.0
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


def kernel_ms_per_forward(dtype, batch, gen):
    """Time of the kernel launches one PoseNet forward makes at `batch`."""
    from plr2_tpu_torch.ops import mlp_head, upconv
    ms = {"mlp_head": 0.0, "upconv3x3_prelu": 0.0}
    for name in STAGES:
        args = stage_inputs(name, dtype, gen, batch)
        ms["upconv3x3_prelu"] += time_ms(lambda: upconv.upconv3x3_prelu(*args), 5)
    del args
    for tag in HEAD_OUT:
        x, params = head_inputs(tag, dtype, gen, batch)
        ms["mlp_head"] += time_ms(lambda: mlp_head.mlp_head(x, params), 5)
    return ms


@phase("timing")
def timing_phase(kern, launches, errs):
    from plr2_tpu_torch.ops import mlp_head, upconv
    frames = {}
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
            kms = kernel_ms_per_forward(dtype, batch, gen)
            print(f"    kernels of its PoseNet forward: mlp_head x3 "
                  f"{kms['mlp_head']:.3f} ms + upconv3x3_prelu x3 "
                  f"{kms['upconv3x3_prelu']:.3f} ms = "
                  f"{100 * sum(kms.values()) / ms:.1f}% of the estimate")
            torch.cuda.empty_cache()

    entries = []
    for dt_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        item = torch.empty((), dtype=dtype).element_size()
        tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "flops": 0, "bytes": 0} for k in SOURCES}
        for name, (h, w, cin, cout) in STAGES.items():
            args = stage_inputs(name, dtype, gen)
            t = tot["upconv3x3_prelu"]
            k = time_ms(lambda: upconv.upconv3x3_prelu(*args), 10)
            p = time_ms(lambda: upconv.upconv3x3_prelu_plain(*args), 5)
            lib = time_ms(lambda: upconv_library(*args), 10)
            b = args[0].shape[0]
            fl = upconv.flops(b, h, w, cin, cout)
            by = item * (b * h * w * cin + 9 * cin * cout + cout + 1
                         + b * 4 * h * w * cout)
            print(f"  upconv3x3_prelu {name} {dt_name}: kernel {k:.3f} ms "
                  f"({fl / k / 1e9:.1f} TFLOP/s), plain {p:.3f} ms, "
                  f"library {lib:.3f} ms")
            for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                           ("flops", fl), ("bytes", by)):
                t[key] += v
        for tag, od in HEAD_OUT.items():
            x, params = head_inputs(tag, dtype, gen)
            rows = x.shape[0]
            widths = HEAD_WIDTHS + (NUM_OBJ * od,)
            t = tot["mlp_head"]
            k = time_ms(lambda: mlp_head.mlp_head(x, params), 10)
            p = time_ms(lambda: mlp_head.mlp_head_plain(x, params), 5)

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
            print(f"  mlp_head {tag} {dt_name}: kernel {k:.3f} ms "
                  f"({fl / k / 1e9:.1f} TFLOP/s), plain {p:.3f} ms, "
                  f"library {lib:.3f} ms")
            for key, v in (("ms", k), ("plain_ms", p), ("library_ms", lib),
                           ("flops", fl), ("bytes", by)):
                t[key] += v
        for kname, t in tot.items():
            ops_ms = t["flops"] / PEAK_FLOPS[dt_name] * 1e3
            bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
            entries.append({
                "name": f"{kname}_{dt_name}", "route": "cuda",
                "source": SOURCES[kname][0], "replaces": SOURCES[kname][1],
                "launches": launches[dt_name][kname],
                "max_abs_err": errs[(kname, dt_name)],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": t["library_ms"]})
    return frames, entries


def main():
    t0 = time.perf_counter()
    import_port()
    smi = device_phase()
    build_s = build_phase()
    errs = kernels_phase()
    kern, launches = main_path_phase()
    frames, entries = timing_phase(kern, launches, errs)
    print(f"summary: build {build_s:.2f} s, total {time.perf_counter() - t0:.2f} s, "
          f"frames/s {json.dumps({k: round(v, 1) for k, v in frames.items()})}")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
