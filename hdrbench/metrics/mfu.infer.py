"""The forward's share of the card's float32 peak (3xTF32, 165 TFLOP/s):
the reference's FLOPs an image at the padded size x the images a second of
the untraced batches."""

from hdrbench.readers import mfu_pct


def read(out):
    return mfu_pct(out, "flops_per_image", "img_s_untraced")
