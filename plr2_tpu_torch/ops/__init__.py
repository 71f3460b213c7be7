"""Hand-written CUDA kernels of the port, each beside its plain version:
`ops.mlp_head` (pose-head ladder) and `ops.upconv` (PSP decoder stage)."""

from plr2_tpu_torch.ops import mlp_head, upconv

_KERNEL_MODULES = {"mlp_head": mlp_head, "upconv3x3_prelu": upconv}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
