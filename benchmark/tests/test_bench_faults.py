"""A run whose timed path is broken underneath comes out not correct, for
each fault its cell can have (`benchmark/faults.py`); the control (the
reference one precision step below the cell's) fails the cell's limits."""

import pytest
import torch

from benchmark import faults
from benchmark import run as R
from benchmark.tests import tiny


def _cases():
    out = []
    for cell in tiny.CELLS:
        tr = R.load_cell(cell)["traffic"]
        if tr["driver"] == "serve_frames":
            # two slots a frame to swap; and a tiny bf16 cell's 48
            # confidences all lie within its candidate window, so its
            # pick is seen only at the cell's size (on the card)
            out += [(cell, "serve", f) for f in faults.SERVE
                    if (f != "slot" or tr["objects_per_frame"] > 1)
                    and (f != "pick"
                         or R.load_cell(cell)["workload"]["dtype"]
                         == "float32")]
        else:
            out += [(cell, "train", f) for f in faults.TRAIN]
    return out


@pytest.mark.parametrize("cell,kind,fault", _cases())
def test_fault_is_not_correct(cell, kind, fault):
    spec = tiny.spec(cell)
    with faults.planted(kind, fault, spec["traffic"].get("window", 0)):
        line, _ = tiny.run(spec)
    assert not line["correct"], line["checks"]


def _control(cell, device):
    from benchmark.reference.precision import CONTROL_OF

    spec = tiny.spec(cell)
    driver = R.load_module(R.os.path.join(R.HERE, "traffic",
                                          spec["traffic"]["driver"] + ".py"),
                           "t_driver")
    r = R.Run(spec, 2 ** 31 + 7, 1.0, False, device, 0.0)
    got = driver.control(r, CONTROL_OF[spec["workload"]["dtype"]])
    limits = spec["workload"]["limits"]
    return {k: (got[k], limits[k]) for k in limits}


@pytest.mark.parametrize("cell", [c for c in tiny.CELLS if R.load_cell(c)
                                  ["workload"]["dtype"] == "bfloat16"])
def test_fp8_control_fails(cell):
    numbers = _control(cell, torch.device("cpu"))
    assert any(v > lim for v, lim in numbers.values()), numbers


@pytest.mark.chip
@pytest.mark.parametrize("cell", [c for c in tiny.CELLS if R.load_cell(c)
                                  ["workload"]["dtype"] == "float32"])
def test_tf32_control_fails(cell, card):
    numbers = _control(cell, card)
    assert any(v > lim for v, lim in numbers.values()), numbers
