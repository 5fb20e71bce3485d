"""train.mfu (%): the whole training step's share of the card's bf16 peak:
the step's analytic matrix-product FLOPs per pair (``perfbench/flops.py``:
kept tokens only, 3x the forward, no recompute, the loss's logits) times
the untraced stretch's pairs/s, over 989 TFLOP/s. Moves pairs_per_s."""

from perfbench.roofline import PEAK_FLOPS


def read(run):
    if run.get("kind") != "train" or not run.get("trace"):
        return None
    return 100.0 * run["flops_per_item"] * run["rate"] / PEAK_FLOPS["bfloat16"]
