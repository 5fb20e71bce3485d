"""embed.idle_share (%): the share of the measured (untraced) window in
which no kernel or copy ran on the device, in the embedding service's cells:
1 - (device busy seconds per item in the traced window: the union of the
kernel and copy intervals, ``perfbench/trace.py``) x (items per second of
the untraced window). The traced window's own idle share (the contract's
busy_s over window_s) reads high where the host sets the pace, since the
profiler slows the host and not the device. Moves images_per_s. Nothing to
read without a device trace."""


def read(run):
    t = run.get("trace")
    if run.get("kind") != "embed" or not t or not run.get("traced_items"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / run["traced_items"] * run["rate"])
