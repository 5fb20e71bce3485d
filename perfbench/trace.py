"""What a torch.profiler window says about the device.

``union_us`` and the window analysis are the program's own
(``clipa_tpu_torch/tools/profile_service.py``: ``union_us``, ``analyse``),
copied here so that the yardstick stays fixed: the busy time is the union
of the kernel and copy intervals inside a ``record_function`` window, the
idle share its complement. :func:`analyse` also returns each device event
with its interval (for the per-layer readers), the device time by family,
and the longest idle gaps named by what the host was doing then.
"""

from __future__ import annotations

import re

# Op families by kernel name, first match wins (profile_service.FAMILIES).
FAMILIES = (
    ("flash attention kernel", r"flash_attention_fwd"),
    ("flash attention bwd kernel", r"flash_attention_(dq|dkv|bwd)"),
    ("attention kernel", r"fused_attention_fwd"),
    ("attention bwd kernel", r"attention_bwd_|column_sum_kernel"),
    ("patch embed kernel", r"patch_embed_kernel"),
    ("gemm", r"gemm|nvjet|cutlass|xmma|cublas|s16816|s1688"),
    ("layernorm", r"layer_norm"),
    ("gelu", r"[Gg]elu"),
    ("dtype copy", r"copy_kernel|direct_copy"),
    ("add", r"[Aa]dd"),
    ("host<->device copy", r"Memcpy|Memset"),
)


def family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, w0: float, w1: float) -> list:
    """The (start, end) stretches of [w0, w1] that no interval covers."""
    out, end = [], w0
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if w1 > end:
        out.append((end, w1))
    return out


def _host_label(cpu_events, t: float) -> str:
    """The outermost and the innermost host range running at time t."""
    live = [e for e in cpu_events
            if e.time_range.start <= t <= e.time_range.end]
    if not live:
        return "no host op"
    outer = min(live, key=lambda e: e.time_range.start)
    inner = max(live, key=lambda e: e.time_range.start)
    return outer.name if inner is outer else f"{outer.name} > {inner.name}"


def analyse(prof, window: str, top: int = 10) -> dict:
    """The device's view of one record_function `window` of a finished
    torch.profiler run: busy and window seconds, device seconds by family,
    the device events with their intervals (µs), the `top` longest idle
    gaps labelled by the host ranges running at their midpoint. Raises when
    the trace holds no device event."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [e for e in events if e.name == window and e.device_type == cpu]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {window!r} span, found "
                           f"{len(spans)}")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    # kernels and copies only: record_function ranges mirrored onto the
    # device timeline are annotations, not device work
    device = [e for e in events
              if e.device_type == cuda and not e.is_user_annotation
              and e.name != window
              and e.time_range.end > w0 and e.time_range.start < w1]
    if not device:
        raise RuntimeError("the trace holds no device events: the profiler "
                           "did not see the card")
    kernels = [(e.name, max(e.time_range.start, w0), min(e.time_range.end,
                                                         w1))
               for e in device]
    intervals = [(s, t) for _, s, t in kernels]
    by_family = {}
    for name, s, t in kernels:
        fam = family(name)
        by_family[fam] = by_family.get(fam, 0.0) + (t - s) / 1e6
    host = [e for e in events if e.device_type == cpu and e.name != window
            and e.time_range.end > w0 and e.time_range.start < w1]
    idle = sorted(gaps(intervals, w0, w1), key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": union_us(intervals) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": kernels,
        "by_family_s": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
        "idle_gaps": [[_host_label(host, (a + b) / 2), (b - a) / 1e6]
                      for a, b in idle],
    }
