"""The attention's share of its roofline in the training cells: the least
time of the work the traced steps' attention needs (4 * Dh operations a
pair and head forward, 10 * Dh backward, only pairs inside one video; each
byte read or written once; 989 TFLOP/s against 3.35 TB/s) over the device
time of the kernels named ``flash_*``."""

from gpubench.readers import attn_roofline


def read(ctx):
    return attn_roofline(ctx, "train")
