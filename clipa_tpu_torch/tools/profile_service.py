"""Where the embedding service's device time goes, from a torch.profiler trace.

    python -m clipa_tpu_torch.tools.profile_service [--model NAME]
        [--chunks 2] [--out profile_out]

Builds an `EmbeddingService` on one CUDA device (seeded random weights,
bf16), warms it up, then traces `--chunks` full chunks of uint8 images and
of captions at the largest bucket, each in its own window. For each window
it reports:

  * the device busy share: the union of the kernel and copy intervals in
    the trace over the window's host span (host and device timestamps share
    the profiler's clock);
  * device ms per op family (attention kernels, GEMMs, LayerNorm, GELU,
    dtype copies, adds, host<->device copies, the rest), read from the
    kernels' full names;
  * the window's items/s on the host clock (the profiler slows the host, so
    this is below the service's untraced rate).

The summary is one JSON line on stdout; `key_averages()` tables and the
top kernels go to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch

# Op families by kernel name, first match wins.
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


def analyse(prof, window: str, items: int) -> dict:
    """Busy share and per-family device time of one record_function
    window in a finished torch.profiler run."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [e for e in events if e.name == window and e.device_type == cpu]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {window!r} span, found "
                           f"{len(spans)}")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    # Kernels and copies only: the profiler mirrors record_function ranges
    # onto the device timeline as annotations, which are not device work.
    device = [e for e in events
              if e.device_type == cuda and not e.is_user_annotation
              and e.name != window
              and e.time_range.end > w0 and e.time_range.start < w1]
    if not device:
        raise RuntimeError("the trace holds no device events: the profiler "
                           "did not see the card")
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
                 for e in device]
    by_family, by_kernel = {}, {}
    for e, (s, t) in zip(device, intervals):
        fam = family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + (t - s) / 1e3
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (t - s) / 1e3
    device_ms = sum(by_family.values())
    span_ms = (w1 - w0) / 1e3
    return {
        "window": window,
        "span_ms": span_ms,
        "device_busy_ms": union_us(intervals) / 1e3,
        "busy_share": union_us(intervals) / (w1 - w0),
        "items_per_s_traced": items / (span_ms / 1e3),
        "device_ms_by_family": {
            k: {"ms": v, "share": v / device_ms}
            for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": dict(sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1])[:12]),
    }


def main(argv=None) -> int:
    from clipa_tpu_torch.serving import EmbeddingService

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="ViT-H-14-CL32-GAP-BigVision")
    p.add_argument("--vocab", default="data/vocab.txt")
    p.add_argument("--chunks", type=int, default=2,
                   help="full chunks traced per window")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="profile_out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_service needs a CUDA device")

    svc = EmbeddingService(args.model, None, vocab_path=args.vocab,
                           device="cuda", seed=args.seed, num_workers=0)
    bucket = svc.buckets[-1]
    n = bucket * args.chunks
    rng = np.random.RandomState(args.seed)
    images = rng.randint(0, 256, (n, svc.image_size, svc.image_size, 3),
                         np.uint8)
    words = ["a photo of", "two dogs", "a red car on a street", "birds"]
    texts = [f"{words[i % 4]} {i} {words[(i * 7) % 4]}" for i in range(n)]
    svc.embed_images(images[:bucket])    # warm-up: allocator, cuBLAS plans
    svc.embed_texts(texts[:bucket])
    torch.cuda.synchronize()

    os.makedirs(args.out, exist_ok=True)
    summary = {"card": torch.cuda.get_device_name(0), "model": args.model,
               "bucket": bucket, "chunks": args.chunks, "windows": []}
    for window, call in (("images", lambda: svc.embed_images(images)),
                         ("texts", lambda: svc.embed_texts(texts))):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(window):
                call()     # returns host arrays: the device has drained
            wall = time.perf_counter() - t0
        res = analyse(prof, window, n)
        res["host_wall_s"] = wall
        summary["windows"].append(res)
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40,
                                          max_name_column_width=120)
        with open(os.path.join(args.out, f"{window}_key_averages.txt"),
                  "w") as f:
            f.write(table)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
