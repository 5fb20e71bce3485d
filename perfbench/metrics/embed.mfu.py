"""embed.mfu (%): the image tower's forward share of the card's bf16 peak:
the forward's analytic matrix-product FLOPs per image
(``perfbench/flops.py``) times the untraced stretch's images/s, over 989
TFLOP/s. Moves images_per_s."""

from perfbench.roofline import PEAK_FLOPS


def read(run):
    if run.get("kind") != "embed" or not run.get("trace"):
        return None
    return 100.0 * run["flops_per_item"] * run["rate"] / PEAK_FLOPS["bfloat16"]
