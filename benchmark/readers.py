"""What the per-layer metric readers (`metrics/<name>.py`) share: each
reads the driver's counts and the traced slice, and returns None where it
finds nothing to read (no trace, or no device time of its kernels)."""

from __future__ import annotations

from benchmark.counts import PEAK_FLOPS


def device_idle(o):
    """% of the traced window with no operation on the device."""
    t = o.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(o):
    """% of the dtype's peak: the model FLOPs the window's work needs over
    the window's wall time."""
    t, c = o.trace, o.counts
    if t is None or c.get("model_flops", 0) <= 0:
        return None
    return 100.0 * c["model_flops"] / (c["window_s"] * PEAK_FLOPS[c["dtype"]])


def roofline(o, kernel: str, patterns):
    """% of its bound: the bound of the kernel's calls in the window
    (`counts.forward_kernel_work`, from the shapes and the calls made)
    over the device time of the kernels whose names hold `patterns`."""
    t = o.trace
    bound = o.counts.get("kernel_bound_s", {}).get(kernel, 0.0)
    if t is None or bound <= 0:
        return None
    time_s = t.kernel_time(patterns)
    if time_s <= 0:
        return None
    return 100.0 * bound / time_s
