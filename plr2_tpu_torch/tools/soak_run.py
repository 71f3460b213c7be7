"""Soak-run orchestrator, the port of tools/soak_run.py: the training
CLI's unattended survival of preemption, end to end.

It launches `python -m plr2_tpu_torch.tools.train` on synthetic frames,
sends SIGTERM once the run has logged each requested kill epoch, requires
each such leg to exit 0 with the graceful-stop line (`interrupt
requested`), requires every relaunch to log `auto-resumed from last
checkpoint`, lets the last leg run to the --nepoch horizon (an epoch
COUNT from the resumed state, so the last absolute epoch is >= it), and
writes `<outf>/soak_summary.json`. Each leg's output is kept as
`<log_dir>/soak_leg<i>.log`.

  python -m plr2_tpu_torch.tools.soak_run                      # card
  python -m plr2_tpu_torch.tools.soak_run --mode fused --nepoch 4 \
      --kill_epochs 2 --synthetic_frames 16                    # short
  python -m plr2_tpu_torch.tools.soak_run --cpu --num_points 64 \
      --mesh_points 64 --synthetic_frames 4 --nepoch 6 --kill_epochs 2 \
      --mode persample --extra --batch_size 2                  # CPU

Unlike the JAX script it refuses a stale run and tells a fast exit apart:
- a `last` checkpoint already under `<outf>/<dataset>` would make leg 0
  auto-resume past its kill epoch, so the run stops before launching
  anything unless --resume is given;
- a leg that logged its kill epoch and exited before the SIGTERM reached
  it (the marker is read again from the capture after the process ends)
  fails as such, not as "never logged"; a leg past --leg_timeout is
  killed and reaped.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m plr2_tpu_torch.tools.soak_run",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="linemod")
    p.add_argument("--synthetic_frames", type=int, default=256)
    p.add_argument("--nepoch", type=int, default=40,
                   help="epoch-count horizon handed to the trainer; fit() "
                        "counts it from the restored state, so the final "
                        "absolute epoch is >= this")
    p.add_argument("--kill_epochs", default="3,9",
                   help="comma list: SIGTERM the run once it has logged "
                        "this epoch (one kill + resume cycle per entry)")
    p.add_argument("--num_points", type=int, default=500)
    p.add_argument("--mesh_points", type=int, default=256)
    p.add_argument("--outf", default="trained_models/soak_torch")
    p.add_argument("--log_dir", default="experiments/logs/soak_torch")
    p.add_argument("--mode", choices=["fused", "batched", "persample"],
                   default="fused")
    p.add_argument("--leg_timeout", type=int,
                   default=int(os.environ.get("PLR2_SOAK_LEG_TIMEOUT", "3600")))
    p.add_argument("--poll_s", type=float, default=2.0)
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the CUDA card)")
    p.add_argument("--resume", action="store_true",
                   help="allow a `last` checkpoint left under <outf>: leg 0 "
                        "then auto-resumes from it")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="remaining args passed through to the trainer")
    return p.parse_args(argv)


def train_cmd(a):
    cmd = [sys.executable, "-m", "plr2_tpu_torch.tools.train",
           "--dataset", a.dataset, "--synthetic",
           "--synthetic_frames", str(a.synthetic_frames),
           "--nepoch", str(a.nepoch),
           "--num_points", str(a.num_points),
           "--mesh_points", str(a.mesh_points),
           "--outf", a.outf, "--log_dir", a.log_dir,
           "--batched_test"]
    if a.mode == "fused":
        cmd.append("--fused")
    elif a.mode == "batched":
        cmd.append("--batched")
    if a.cpu:
        cmd.append("--cpu")
    return cmd + list(a.extra)


def run_leg(cmd, capture_path, kill_epoch, leg_timeout, poll_s):
    """One trainer leg: to its end (kill_epoch None), or SIGTERMed once its
    capture shows that epoch. Returns (captured text, seconds). Raises
    SystemExit on any breach of the robustness contract."""
    t0 = time.time()
    marker = (re.compile(rf"^epoch {kill_epoch}: ", re.M)
              if kill_epoch is not None else None)
    killed_at = None
    with open(capture_path, "w") as cap:
        proc = subprocess.Popen(cmd, stdout=cap, stderr=subprocess.STDOUT,
                                cwd=REPO)
        while proc.poll() is None:
            if time.time() - t0 > leg_timeout:
                proc.kill()
                proc.wait()
                raise SystemExit(f"soak leg timed out after {leg_timeout}s "
                                 f"({capture_path})")
            if marker is not None and killed_at is None:
                with open(capture_path) as f:
                    if marker.search(f.read()):
                        proc.send_signal(signal.SIGTERM)
                        killed_at = time.time()
            time.sleep(poll_s)
    with open(capture_path) as f:
        text = f.read()
    if proc.returncode != 0:
        raise SystemExit(f"soak leg exited {proc.returncode} "
                         f"({capture_path}):\n{text[-2000:]}")
    if kill_epoch is not None:
        if killed_at is None:
            if marker.search(text):
                raise SystemExit(f"leg logged epoch {kill_epoch} but exited "
                                 f"before the SIGTERM reached it: nothing was "
                                 f"killed; pick a kill epoch further from the "
                                 f"horizon or a shorter --poll_s ({capture_path})")
            raise SystemExit(f"leg finished before epoch {kill_epoch} was "
                             f"ever logged: nothing was killed ({capture_path})")
        if "interrupt requested" not in text:
            raise SystemExit("SIGTERM leg exited 0 but never logged the "
                             f"graceful stop ({capture_path})")
    return text, time.time() - t0


def main(argv=None):
    a = parse_args(argv)
    # the trainer runs from the repository's root: give it absolute paths
    a.outf, a.log_dir = os.path.abspath(a.outf), os.path.abspath(a.log_dir)
    last = os.path.join(a.outf, a.dataset, "last.pt")
    if os.path.exists(last) and not a.resume:
        raise SystemExit(f"{last} exists: leg 0 would auto-resume from it, "
                         f"past its kill epoch. Remove {os.path.dirname(last)} "
                         f"or pass --resume")
    os.makedirs(a.log_dir, exist_ok=True)
    kills = [int(k) for k in a.kill_epochs.split(",") if k.strip()]
    cmd = train_cmd(a)
    legs, wall0 = [], time.time()
    for i, k in enumerate(kills + [None]):
        cap = os.path.join(a.log_dir, f"soak_leg{i}.log")
        what = f"kill after epoch {k}" if k is not None else "run to horizon"
        print(f"[soak] leg {i}: {what}", flush=True)
        text, secs = run_leg(cmd, cap, k, a.leg_timeout, a.poll_s)
        resumed = re.search(r"auto-resumed from last checkpoint \(epoch (\d+)\)",
                            text)
        if i > 0 and not resumed:
            raise SystemExit(f"leg {i} did not auto-resume ({cap})")
        epochs = [int(m) for m in re.findall(r"^epoch (\d+): ", text, re.M)]
        last_line = ([ln for ln in text.splitlines()
                      if re.match(r"epoch \d+: ", ln)] or ["-"])[-1]
        legs.append({
            "leg": i, "kill_epoch": k, "seconds": round(secs, 1),
            "resumed_from": int(resumed.group(1)) if resumed else None,
            "epochs_logged": [epochs[0], epochs[-1]] if epochs else [],
            "last_epoch_line": last_line,
            "graceful_stop": "interrupt requested" in text,
        })
        print(f"[soak] leg {i} ok: {legs[-1]}", flush=True)
    final = legs[-1]
    if not final["epochs_logged"] or final["epochs_logged"][1] < a.nepoch:
        raise SystemExit(f"final leg stopped short of the {a.nepoch}-epoch "
                         f"horizon: {final}")
    summary = {
        "recipe": " ".join(cmd), "kill_epochs": kills,
        "nepoch": a.nepoch, "legs": legs,
        "total_wall_s": round(time.time() - wall0, 1),
    }
    os.makedirs(a.outf, exist_ok=True)
    out = os.path.join(a.outf, "soak_summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[soak] PASS: {len(kills)} kill / resume cycles, horizon epoch "
          f"{a.nepoch} reached; summary: {out}", flush=True)
    return summary


if __name__ == "__main__":
    main()
