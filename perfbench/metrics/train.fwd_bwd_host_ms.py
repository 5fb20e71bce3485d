"""train.fwd_bwd_host_ms (ms): the host's milliseconds per training step
in the forward, the loss and the backward, the spans ``train.forward``,
``train.loss`` and ``train.backward`` of ``clipa_tpu_torch/tracing.py``:
for each of the measured window's steps (the newest untraced
``train.step`` spans, as many as the window ran; the profiler slows the
host, so traced steps are left out), the sum of those spans that started
inside it; their median. Where the device's queue is full the host waits
in these spans, so they read up to the device's time for the phase. Read
in the run's own process. Moves pairs_per_s. Nothing to read off the
card or where the program records no such span."""

import statistics

PHASES = ("train.forward", "train.loss", "train.backward")


def read(run):
    n = run.get("steps")
    if run.get("kind") != "train" or not run.get("trace") or not n:
        return None
    try:
        from clipa_tpu_torch import tracing
    except ImportError:
        return None
    parts = [p for name in PHASES for p in tracing.recent(name)]
    per_step = [sum(p.duration_ns for p in parts
                    if s.start_ns <= p.start_ns < s.start_ns + s.duration_ns)
                for s in tracing.recent("train.step")[-n:]]
    if not any(per_step):
        return None
    return statistics.median(per_step) / 1e6
