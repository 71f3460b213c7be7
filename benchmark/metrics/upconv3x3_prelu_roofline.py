"""upconv3x3_prelu_roofline, the reader of
`upconv3x3_prelu_roofline.<serve|train|window>`: the PSP decoder stages'
bound (the three 2x-upsample + 3x3 conv + PReLU stages of every PoseNet
forward in the traced slice, from their shapes) over the device time of
the kernels that implement them, as a %."""

from benchmark.readers import roofline

# kernel names whose device time counts: the bf16 wgmma and f32 SGEMM
# designs of csrc/upconv.cu
PATTERNS = ("upconv_wgmma_kernel", "upconv_sgemm_kernel")


def read(o):
    return roofline(o, "upconv3x3_prelu", PATTERNS)
