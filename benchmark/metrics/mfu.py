"""mfu, the reader of `serve.mfu`, `train.mfu` and `window.mfu`: the model
FLOPs of the traced slice's work (`counts.py`) over its wall time, as a %
of the H100's dense peak for the cell's dtype."""

from benchmark.readers import mfu


def read(o):
    return mfu(o)
