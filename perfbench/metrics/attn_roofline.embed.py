"""attn_roofline.embed (%): the fused attention forward's share of its
roofline in the embedding service: the traced window's launches times each
launch's bound at a chunk's shape (``perfbench/roofline.py``) over the
device time of the kernels this pattern names. Moves images_per_s. Reads
nothing where the trace holds none of them."""

import re

from perfbench import roofline

FORWARD = r"fused_attention_fwd"


def read(run):
    t, n = run.get("trace"), run.get("launches", {})
    if run.get("kind") != "embed" or not t:
        return None
    device_s = sum(e - s for name, s, e in t["kernels"]
                   if re.search(FORWARD, name))
    a = run["attention"]
    bound = n.get("fused_attention", 0) * roofline.bound_s(
        *roofline.attention_fwd(a["batch"], a["seq"], a["width"]))
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (device_s / 1e6)
