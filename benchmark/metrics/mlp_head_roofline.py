"""mlp_head_roofline, the reader of `mlp_head_roofline.<serve|train|window>`:
the three PoseNet pose heads' bound (four-layer ladders over every point
of every crop in the traced slice, from their shapes) over the device
time of the kernels that implement them, as a %."""

from benchmark.readers import roofline

# kernel names whose device time counts: the bf16 wgmma and f32 SGEMM
# designs of csrc/mlp_head.cu
PATTERNS = ("mlp_head_wgmma_kernel", "head_sgemm_kernel")


def read(o):
    return roofline(o, "mlp_head", PATTERNS)
