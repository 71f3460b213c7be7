"""The serve driver: one client in a closed loop sends full RGB-D frames to
the program's frame server (`plr2_tpu_torch.serving.FrameEstimator`) and
waits for each call's poses on the host before it sends the next.

Traffic parameters (`traffic/<mix>.json`): `entry` ("run": one frame a
call, or "run_frames": `frames_per_call` frames a call),
`objects_per_frame` (K slots a frame), `canvas`, `pool_frames` (distinct
frames made in set-up, cycled call after call; they stay in host memory
and are copied in by every call), `object_span_m` (the frames' scale:
`gen/frames.py`), `trace_seconds` (the traced slice's length).

End-to-end: `frames_per_s` (frames whose poses reached the host over the
window's wall time) and `latency_p95_ms` (over every call of the window:
from the call to its poses on the host). Every answer of the window is
judged against the reference once the window has closed
(`reference/frame.py`).
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from benchmark import counts
from benchmark.gen.frames import serve_pool
from benchmark.gen.weights import make_weights
from benchmark.reference import frame as ref
from benchmark.reference.precision import tf32_flags
from benchmark.run import Outcome


def build(r):
    """The program as a user serves it: the pipeline with the seed's
    weights, in the cell's dtype, and its frame server."""
    from plr2_tpu_torch.pipeline import DenseFusionPipeline
    from plr2_tpu_torch.serving import FrameEstimator

    cfg, tr = r.config, r.traffic
    pipe = DenseFusionPipeline(cfg["num_points"], cfg["num_objects"],
                               cfg["emb_dim"], device=r.device, seed=None)
    w = make_weights(cfg["num_objects"], cfg["emb_dim"], r.seed, r.device)
    pipe.posenet.load_state_dict(w["posenet"], strict=True)
    pipe.refiner.load_state_dict(w["refiner"], strict=True)
    del w
    if r.workload["dtype"] == "bfloat16":
        pipe.cast(torch.bfloat16)
    return FrameEstimator(pipe, canvas=tr["canvas"], img_h=cfg["img_h"],
                          img_w=cfg["img_w"],
                          refine_iterations=cfg["refine_iterations"],
                          min_mask_pixels=cfg["min_mask_pixels"])


def calls_of(pool, traffic):
    """The pool cut into calls: the arguments of each call, host arrays."""
    f = traffic["frames_per_call"]
    out = []
    for c in range(len(pool["seeds"]) // f):
        s = slice(c * f, (c + 1) * f)
        if traffic["entry"] == "run":
            i = c * f
            out.append((pool["colors"][i], pool["depths"][i],
                        pool["labels"][i], pool["obj_ids"][i],
                        pool["model_points"][i], pool["intr"],
                        int(pool["seeds"][i])))
        else:
            out.append((pool["colors"][s], pool["depths"][s],
                        pool["labels"][s], pool["obj_ids"][s],
                        pool["model_points"][s],
                        np.broadcast_to(pool["intr"], (f, 5)).copy(),
                        pool["seeds"][s]))
    return out


def serve(est, entry: str, args):
    """One call: the poses of its frames, on the host, as arrays
    (frames, K, ...)."""
    with torch.profiler.record_function("bench.call"):
        out = (est.run if entry == "run" else est.run_frames)(*args)
        with torch.profiler.record_function("bench.download"):
            host = [x.float().cpu().numpy() if x.is_floating_point()
                    else x.cpu().numpy() for x in out]
    if entry == "run":
        host = [x[None] for x in host]
    return host


def loop(est, entry, calls, seconds, answers, latencies):
    """Calls back to back for `seconds`; each call's answer is kept by
    pool index. Returns (calls made, wall seconds)."""
    n = 0
    t0 = time.perf_counter()
    while True:
        c = n % len(calls)
        ts = time.perf_counter()
        host = serve(est, entry, calls[c])
        te = time.perf_counter()
        latencies.append(te - ts)
        answers.setdefault(c, []).append(host)
        n += 1
        if te - t0 >= seconds:
            return n, te - t0


def distinct(answers):
    """The distinct answers of each pool call (a deterministic program
    gives one), with how many calls gave each."""
    out = {}
    for c, hs in answers.items():
        groups = []
        for h in hs:
            for g in groups:
                if all(np.array_equal(a, b) for a, b in zip(g[0], h)):
                    g[1] += 1
                    break
            else:
                groups.append([h, 1])
        out[c] = groups
    return out


def judge(r, pool, calls_answered, params):
    """The reference's numbers over every valid slot of every distinct
    answer."""
    cfg, tr, wl = r.config, r.traffic, r.workload
    f = tr["frames_per_call"]
    numbers = dict(flags=0, conf_gap=0.0)
    gaps, cands, deficits = [], [], []
    with tf32_flags("float32"):
        for c, groups in sorted(calls_answered.items()):
            slots = ref.prepare_frames(pool, range(c * f, (c + 1) * f),
                                       tr["canvas"], cfg["num_points"],
                                       cfg["min_mask_pixels"],
                                       cfg["num_objects"])
            hyps = ref.hypotheses(params, slots, cfg["num_objects"], r.device)
            for host, _ in groups:
                quat, trans, conf, valid, over = (
                    x.reshape(len(slots), -1) for x in host)
                answers = [dict(quat=quat[i], trans=trans[i],
                                confidence=conf[i, 0], valid=valid[i, 0],
                                oversized=over[i, 0])
                           for i in range(len(slots))]
                got = ref.judge(params, slots, hyps, answers,
                                cfg["num_objects"], cfg["refine_iterations"],
                                wl["candidate_window"])
                numbers["flags"] += got["flags"]
                numbers["conf_gap"] = max(numbers["conf_gap"],
                                          got["conf_gap"])
                gaps += got["pose_gaps"]
                cands += got["candidates"]
                deficits += got["deficits"]
    numbers["pose_gap"] = max(gaps, default=0.0)
    # the 90th percentile as a judged slot's own gap (no interpolation,
    # so a slot that reads inf reads inf here too)
    numbers["pose_gap_p90"] = (sorted(gaps)[math.ceil(0.9 * len(gaps)) - 1]
                               if gaps else 0.0)
    numbers["pose_gap_median"] = float(np.median(gaps)) if gaps else 0.0
    numbers["slots"] = len(gaps)
    numbers["candidates"] = max(cands, default=0)
    numbers["candidates_median"] = float(np.median(cands)) if cands else 0.0
    numbers["pick_deficit_median"] = (float(np.median(deficits))
                                      if deficits else 0.0)
    numbers["pick_deficit_p90"] = (sorted(deficits)[
        math.ceil(0.9 * len(deficits)) - 1] if deficits else 0.0)
    return numbers


def run(r) -> Outcome:
    cfg, tr, wl = r.config, r.traffic, r.workload
    marks = [("imports", time.perf_counter())]
    est = build(r)
    marks.append(("program", time.perf_counter()))
    pool = serve_pool(cfg, tr, r.seed)
    calls = calls_of(pool, tr)
    marks.append(("frames", time.perf_counter()))
    entry = tr["entry"]
    for args in calls:  # warm-up: the one graph, every input once
        serve(est, entry, args)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    marks.append(("warm-up", time.perf_counter()))
    print("info: set-up " + ", ".join(
        f"{name} {t - prev:.2f} s" for (name, t), (_, prev)
        in zip(marks, [("imports", r.t_start)] + marks[:-1])), file=sys.stderr)
    answers, latencies = {}, []
    trace = None
    t_first = time.perf_counter()
    if r.trace:
        from benchmark.trace import traced
        got = {}
        with traced(got):
            n, wall = loop(est, entry, calls, min(r.seconds,
                                                  tr["trace_seconds"]),
                           answers, latencies)
        trace = got["trace"]
        wall = trace.window_s
    else:
        n, wall = loop(est, entry, calls, r.seconds, answers, latencies)
    setup_s = t_first - r.t_start
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    f, k = tr["frames_per_call"], tr["objects_per_frame"]
    dtype = wl["dtype"]
    crops = n * f * k
    per_crop = counts.posenet_flops(tr["canvas"], cfg["num_points"],
                                    cfg["num_objects"]) \
        + cfg["refine_iterations"] * counts.refiner_flops(
            cfg["num_points"], cfg["num_objects"])
    kernel = counts.forward_kernel_work(f * k, tr["canvas"],
                                        cfg["num_points"],
                                        cfg["num_objects"], dtype)
    cnt = dict(dtype=dtype, window_s=wall, model_flops=crops * per_crop,
               kernel_bound_s={kk: n * v for kk, v in kernel.items()})
    del est
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
        print(f"info: held after the program was freed "
              f"{torch.cuda.memory_allocated(r.device)} bytes",
              file=sys.stderr)
    params = make_weights(cfg["num_objects"], cfg["emb_dim"], r.seed,
                          r.device)
    groups = distinct(answers)
    t_judge = time.perf_counter()
    numbers = judge(r, pool, groups, params)
    lim = wl["limits"]
    checks = {k2: (numbers[k2], v) for k2, v in lim.items()}
    print(f"info: judged {numbers['slots']} slots of "
          f"{sum(len(g) for g in groups.values())} distinct answers of {n} "
          f"calls in {time.perf_counter() - t_judge:.1f} s; candidate "
          f"hypotheses a slot: median {numbers['candidates_median']}, most "
          f"{numbers['candidates']}; pose gap: widest "
          f"{numbers['pose_gap']!r}, 90th percentile "
          f"{numbers['pose_gap_p90']!r}, median "
          f"{numbers['pose_gap_median']!r}; conf gap "
          f"{numbers['conf_gap']!r}; pick deficit: median "
          f"{numbers['pick_deficit_median']!r}, 90th percentile "
          f"{numbers['pick_deficit_p90']!r}", file=sys.stderr)
    e2e = dict(frames_per_s=n * f / wall,
               latency_p95_ms=1e3 * float(np.percentile(latencies, 95)),
               setup_s=setup_s)
    return Outcome(e2e, cnt, trace, checks, attempted=n, failed=0,
                   memory_peak_bytes=peak)


def control(r, prec_name: str):
    """The control: the reference computed in `prec_name` put in the
    program's place, its answers judged as the program's are, over every
    call of the pool."""
    from benchmark.reference.precision import precision

    cfg, tr = r.config, r.traffic
    pool = serve_pool(cfg, tr, r.seed)
    params = make_weights(cfg["num_objects"], cfg["emb_dim"], r.seed,
                          r.device)
    f = tr["frames_per_call"]
    groups = {}
    with tf32_flags(prec_name):
        for c in range(len(pool["seeds"]) // f):
            slots = ref.prepare_frames(pool, range(c * f, (c + 1) * f),
                                       tr["canvas"], cfg["num_points"],
                                       cfg["min_mask_pixels"],
                                       cfg["num_objects"])
            prec = precision(prec_name)
            hyps = ref.hypotheses(params, slots, cfg["num_objects"], r.device,
                                  prec)
            ans = ref.serve(params, slots, hyps, cfg["num_objects"],
                            cfg["refine_iterations"], prec)
            groups[c] = [[[np.stack([a[k] for a in ans]) for k in
                           ("quat", "trans", "confidence", "valid",
                            "oversized")], 1]]
    return judge(r, pool, groups, params)
