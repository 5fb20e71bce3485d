"""Named host spans of the port's hot paths, on the profiler's clock.

The port's own module (no counterpart under ``clipa_tpu/``). A span times
one phase of the host's work:

    with tracing.span("train.optim.update"):
        ...

Every span records its host duration (``time.perf_counter_ns``) into a
bounded store per name (the newest :data:`BOUND` samples), flagged with
whether a ``torch.profiler`` was recording at its start: the profiler
slows the host, so a reader of host times keeps the two apart
(:func:`recent`). It does no device work and no I/O.

While a profiler records, the span also opens a ``record_function``
range of its name, so the profiler's host lane shows it on the device
trace's clock and an idle gap of the device falls inside a named span.
Without a profiler no range is made. There is no exporter: the Chrome
trace of the profiler that is recording (``train/metrics.Profiler``, a
caller's ``torch.profiler.profile``) holds the spans.

The spans of the port: ``train.step`` (all of ``update()``),
``train.forward`` (the normalize and each microbatch's forward),
``train.loss``, ``train.backward`` (``torch.autograd.grad``),
``train.optim.update`` and ``train.optim.apply`` (``optim.Optimizer``: on
CUDA parameters ``train.optim.update`` holds the fused Adam kernel's host
side, its launch included, and ``train.optim.apply`` is opened but empty,
since the kernel adds the updates itself; on CPU parameters the eager
chain and the add), ``train.norms`` (the gated ``l2_*`` and block norms);
``t5.attention`` (``models/t5_text.py``: one block's attention core, the
scores, position bias, pad mask, softmax and weighted sum, in the forward
and again in remat's recompute) and ``t5.attention.bwd`` (that core's
backward, opened and closed from autograd's thread by two identity marks),
beside the tower's counter ``t5_text.attention_calls`` (cores by phase:
"forward", "recompute", "backward"), and the LayerNorm kernels' counter
``ops/layer_norm.layer_norm.launches`` (launches by phase: "forward", remat's
recomputes included, and "backward"); ``serve.stage``
(``EmbeddingService._dispatch``), ``serve.pin`` (the host copy into
pinned memory, inside ``serve.stage``) and ``serve.drain`` (the wait on a
chunk and its concatenation).
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

# samples kept per span name
BOUND = 1024

# whether a profiler records on this thread: the C++ flag, about 0.1 us
_recording = torch._C._autograd._profiler_enabled
_store: dict = {}       # span name -> deque of its newest Samples


class Sample(NamedTuple):
    start_ns: int       # time.perf_counter_ns at the span's start
    duration_ns: int
    profiled: bool      # a profiler was recording at the start


class span:
    """A context manager timing one named phase (module docstring)."""

    __slots__ = ("name", "_start", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _recording():
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        samples = _store.get(self.name)
        if samples is None:
            samples = _store.setdefault(
                self.name, collections.deque(maxlen=BOUND))
        samples.append(Sample(self._start, end - self._start,
                              self._range is not None))
        return False


def recent(name: str, profiled: bool = False) -> list:
    """The stored samples of span `name` whose flag is `profiled`, oldest
    first (at most :data:`BOUND` of either kind together)."""
    return [s for s in list(_store.get(name, ())) if s.profiled == profiled]


def clear() -> None:
    """Forgets every sample."""
    _store.clear()
