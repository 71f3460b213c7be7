"""adam_ms, the reader of `train.adam_ms` and `window.adam_ms`: the summed
duration of the program's `plr2.train.adam` spans in the traced slice
(the eager optimizer step's launches, and the clearing of the gradients
where the step clears them), over the number of steps, in ms."""

from benchmark.spans import self_ms_per_root

NAMES = ("plr2.train.adam",)


def read(o):
    return self_ms_per_root(o, NAMES)
