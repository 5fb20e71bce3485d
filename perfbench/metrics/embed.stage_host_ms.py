"""embed.stage_host_ms (ms): the host's milliseconds per chunk in the
embedding service's staging, the span ``serve.stage`` of
``clipa_tpu_torch/tracing.py`` (the copy into pinned memory, the copy in,
the launches, the enqueued copy out): the median of the measured window's
chunks, the newest untraced spans, as many as the window's requests times
the chunks of a request (its images over the bucket, rounded up); the
profiler slows the host, so traced chunks are left out. Read in the run's
own process. Moves images_per_s. Nothing to read off the card or where
the program records no such span."""

import math
import statistics


def read(run):
    if run.get("kind") != "embed" or not run.get("trace") \
            or not run.get("attempted"):
        return None
    try:
        from clipa_tpu_torch import tracing
    except ImportError:
        return None
    per_request = round(run["rate"] * run["window_s"] / run["attempted"])
    chunks = run["attempted"] * math.ceil(per_request
                                          / run["attention"]["batch"])
    stages = tracing.recent("serve.stage")[-chunks:]
    if not stages:
        return None
    return statistics.median(s.duration_ns for s in stages) / 1e6
