"""Summarize a torch.profiler Chrome trace: device time by op family.

    python -m clipa_tpu_torch.tools.trace_summary \
        profile_out/train_step_trace.json [--steps N] [--top 25]

Port of ``clipa_tpu/tools/trace_summary.py`` for the traces
``torch.profiler`` writes (``export_chrome_trace``; ``tools/profile_step.py
--out`` writes ``train_step_trace.json``). Reads the device events (kernels,
copies and memsets: categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``;
the annotations the profiler mirrors onto the device lanes are not device
work) and reports, per step:

  * device ms per op family and its share of the device time (families by
    kernel name: ``tools/profile_service.py``'s ``FAMILIES``), and the top
    kernels by name;
  * the busy share: the union of the device intervals over the window, the
    span of the step annotations when the trace has any (else from the
    first device event to the last);
  * the steps detected: host annotations named ``ProfilerStep#<n>``
    (``torch.profiler``'s own step marks, which ``profile_step.py`` writes
    around each step); ``--steps`` overrides the divisor.

The summary is one JSON object on stdout.
"""

from __future__ import annotations

import argparse
import collections
import json
import re

from clipa_tpu_torch.tools.profile_service import family, union_us

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_STEP = re.compile(r"^ProfilerStep#\d+$")


def summarize(trace_file: str, steps: int = 0, top: int = 25) -> dict:
    with open(trace_file) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [(e["ts"], e["ts"] + e["dur"]) for e in spans
             if e.get("cat") == "user_annotation" and _STEP.match(e["name"])]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        raise RuntimeError(f"{trace_file} holds no device events")
    if marks:
        w0, w1 = min(s for s, _ in marks), max(e for _, e in marks)
    else:
        w0 = min(e["ts"] for e in device)
        w1 = max(e["ts"] + e["dur"] for e in device)
    divisor = steps or len(marks) or 1
    by_family = collections.defaultdict(float)
    count = collections.Counter()
    by_kernel = collections.defaultdict(float)
    intervals = []
    for e in device:
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        intervals.append((s, t))
        fam = family(e["name"])
        by_family[fam] += t - s
        count[fam] += 1
        by_kernel[e["name"]] += t - s
    total = sum(by_family.values())
    return {
        "trace_file": trace_file,
        "steps_detected": len(marks),
        "steps_divisor": divisor,
        "window_ms": (w1 - w0) / 1e3,
        "device_ms_per_step": total / 1e3 / divisor,
        "busy_share": union_us(intervals) / (w1 - w0),
        "by_family_per_step": {
            k: {"ms": v / 1e3 / divisor, "share": v / total,
                "count": count[k]}
            for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {
            k: v / 1e3 / divisor for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:top]},
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace", help="a torch.profiler Chrome trace (.json)")
    p.add_argument("--steps", type=int, default=0,
                   help="override the detected step count (divisor)")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    out = summarize(args.trace, steps=args.steps, top=args.top)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
