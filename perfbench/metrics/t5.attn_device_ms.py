"""t5.attn_device_ms (ms): the device milliseconds per training step spent
in the mT5 text tower's attention cores (scores, position bias, pad mask,
softmax, weighted sum; forward, remat's recompute and backward): the part
of the traced window's busy time (the union of its kernel and copy
intervals, ``perfbench/trace.py``) that the device-timeline mirrors of the
program's ``t5.attention`` and ``t5.attention.bwd`` ranges cover, over the
traced window's steps. Moves pairs_per_s. Nothing to read where the run
holds no such range (no T5 tower, no device trace, or a program without
those spans)."""


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    t5, t = run.get("t5_attention"), run.get("trace")
    if run.get("kind") != "train" or not t5 or not t or not t5["ranges"]:
        return None
    busy = _union((s, e) for _, s, e in t["kernels"])
    covered = _overlap_us(_union(t5["ranges"]), busy)
    if covered <= 0:
        return None
    return covered / 1e3 / t5["steps"]
