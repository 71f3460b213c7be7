"""The networks' weights, made from the run's seed on the device in two
large draws (one normal, one for the running variances), in float32:
convolution and linear weights N(0, 1 / fan_in), biases N(0, 0.05^2),
BatchNorm scale 1 and shift 0 with running mean N(0, 0.3^2) and running
variance 0.3 + 0.5 |N(0, 1)|, PReLU slopes 0.25. The same seed on the
same device gives the same tensors, so the reference makes its own copy
after the program's run has been freed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import posenet_shapes, refiner_shapes


def _fill(shapes, flat: torch.Tensor, var: torch.Tensor) -> Dict:
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        x = flat[at:at + n].reshape(shape)
        v = var[at:at + n].reshape(shape)
        at += n
        if kind == "weight":
            x = x / math.sqrt(math.prod(shape[1:]))
        elif kind == "bias":
            x = x * 0.05
        elif kind == "bn_weight":
            x = torch.ones_like(x)
        elif kind == "bn_bias":
            x = torch.zeros_like(x)
        elif kind == "bn_mean":
            x = x * 0.3
        elif kind == "bn_var":
            x = v.abs() * 0.5 + 0.3
        elif kind == "bn_count":
            x = torch.zeros(shape, dtype=torch.int64, device=flat.device)
        elif kind == "prelu":
            x = torch.full_like(x, 0.25)
        out[name] = x.clone()
    return out


def make_weights(num_obj: int, emb: int, seed: int, device) -> Dict[str, Dict]:
    """{"posenet": state dict, "refiner": state dict} from `seed`."""
    shapes = {"posenet": posenet_shapes(num_obj, emb),
              "refiner": refiner_shapes(num_obj, emb)}
    total = sum(math.prod(s) for v in shapes.values() for _, s, _ in v)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    var = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for net, sh in shapes.items():
        n = sum(math.prod(s) for _, s, _ in sh)
        out[net] = _fill(sh, flat[at:at + n], var[at:at + n])
        at += n
    return out
