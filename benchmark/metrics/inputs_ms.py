"""inputs_ms, the reader of `serve.inputs_ms`, `train.inputs_ms` and
`window.inputs_ms`: the self time of the program's input spans per call or
step, in ms. `plr2.serve.inputs`: host arrays to device tensors, the
pageable copy-in included (the serve loop reads each call's answer, so
the copy waits for nothing). `plr2.train.inputs`: the dropout masks drawn
on the host, the symmetric count and the ADD-S branch, less the
`plr2.train.copy` inside, whose pageable copies wait for the previous
step's work."""

from benchmark.spans import self_ms_per_root

NAMES = ("plr2.serve.inputs", "plr2.train.inputs")


def read(o):
    return self_ms_per_root(o, NAMES)
