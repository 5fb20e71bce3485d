"""attn_roofline.train (%): the fused attention kernels' share of their
roofline in a training step: the sum over the traced window's launches of
each launch's bound (``perfbench/roofline.py``: forward and backward at the
image tower's shape) over the device time of the kernels these patterns
name. Moves pairs_per_s. Reads nothing where the trace holds none of these
kernels or the window launched none."""

import re

from perfbench import roofline

FORWARD = r"fused_attention_fwd"
BACKWARD = r"attention_bwd_|column_sum_kernel"


def read(run):
    t, n = run.get("trace"), run.get("launches", {})
    if run.get("kind") != "train" or not t:
        return None
    device_s = sum(e - s for name, s, e in t["kernels"]
                   if re.search(FORWARD, name) or re.search(BACKWARD, name))
    a = run["attention"]
    shape = (a["batch"], a["seq"], a["width"])
    bound = (n.get("fused_attention", 0)
             * roofline.bound_s(*roofline.attention_fwd(*shape))
             + n.get("fused_attention_bwd", 0)
             * roofline.bound_s(*roofline.attention_bwd(*shape)))
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (device_s / 1e6)
