"""embed.pin_host_ms (ms): the host's milliseconds per chunk in the
embedding service's copy of a chunk into pinned memory, the span
``serve.pin`` of ``clipa_tpu_torch/tracing.py``: for each of the measured
window's chunks (the newest untraced ``serve.stage`` spans, as many as
the window's requests times the chunks of a request: its images over the
bucket, rounded up; the profiler slows the host, so traced chunks are
left out), the sum of the ``serve.pin`` spans that started inside it;
their median. Read in the run's own process. Moves images_per_s. Nothing
to read off the card or where the program records no such span."""

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
    pins = tracing.recent("serve.pin")
    per_chunk = [sum(p.duration_ns for p in pins
                     if s.start_ns <= p.start_ns < s.start_ns + s.duration_ns)
                 for s in tracing.recent("serve.stage")[-chunks:]]
    if not any(per_chunk):
        return None
    return statistics.median(per_chunk) / 1e6
