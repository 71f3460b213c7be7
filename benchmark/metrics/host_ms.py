"""host_ms, the reader of `serve.host_ms`, `train.host_ms` and
`window.host_ms`: the host's own time in the program per call or step, in
ms: the root span (`plr2.serve.call` a call, `plr2.train.step` a step or
window) less its capture, replay, eager-program and copy spans
(`benchmark/spans.py`). What stays: turning inputs into device tensors,
the outputs' copy, Adam's launches and the Python between them."""

from benchmark.spans import self_ms_per_root


def read(o):
    return self_ms_per_root(o)
