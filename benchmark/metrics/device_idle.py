"""device_idle, the reader of `serve.device_idle`, `train.device_idle` and
`window.device_idle`: % of the traced slice in which no kernel, copy or
set ran on the device (torch.profiler's CUDA activity)."""

from benchmark.readers import device_idle


def read(o):
    return device_idle(o)
