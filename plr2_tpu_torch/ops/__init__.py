"""Hand-written CUDA kernels of the port, each beside its plain version:
`ops.mlp_head` (pose-head ladder), `ops.upconv` (PSP decoder stage),
`ops.knn` (the ADD-S nearest-neighbour match: `nn_match`, `nn_argmin`,
`nn_match_mxu`), `ops.quant` (the int8 pose-head ladder,
`quantized_mlp_head`) and `ops.gather` (the choose gather's deterministic
backward, `gather_rows_backward`)."""

from plr2_tpu_torch.ops import gather, knn, mlp_head, quant, upconv

_KERNEL_MODULES = {"mlp_head": mlp_head, "upconv3x3_prelu": upconv,
                   "quantized_mlp_head": quant,
                   "gather_rows_backward": gather}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name, and
    `upconv3x3_prelu.split`: the f32 decoder launches split over a
    cluster (counted in `upconv3x3_prelu` too)."""
    counts = {name: mod.launches for name, mod in _KERNEL_MODULES.items()}
    counts["upconv3x3_prelu.split"] = upconv.split_launches
    counts.update(knn.launches)
    return counts


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
    upconv.split_launches = 0
    for name in knn.launches:
        knn.launches[name] = 0
