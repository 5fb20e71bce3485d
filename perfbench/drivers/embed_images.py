"""Driver ``embed_images``: ``serving.EmbeddingService.embed_images``.

A closed loop with one client: each request is ``request_images`` decoded
uint8 images, a contiguous block of a pool of ``pool_images`` made from
the seed (request r takes block r mod blocks), and the client sends the
next request when the embeddings of the last have come back to the host.
images/s = all images of the window's requests over its wall time.

Set-up builds the service on the open_clip name of the configuration's
``serve`` route, loads the benchmark's weights (made in the dtype served)
into the image tower, and sends ``warmup_requests`` requests. Traced, a
profiler window of ``trace_requests`` more follows the measured one.

Correctness: a sample of ``checked_images`` pool images is drawn from the
seed; every answer the window returned for one of them is held against the
float32 reference's embedding of that image (1 - cosine, the worst one).
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from perfbench import flops, weights
from perfbench import trace as trace_lib
from perfbench.reference import clip

WINDOW = "perfbench.window"


def _counters() -> dict:
    from clipa_tpu_torch.ops import block_attention
    return {"fused_attention": block_attention.fused_attention.launches}


def run(ctx) -> dict:
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.serving import EmbeddingService

    device = torch.device(ctx.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, tr = ctx.config, ctx.traffic
    route = {**cfg["routes"][tr["route"]], "image_size": tr["image_size"]}
    name = route["model_name"]
    if name.endswith(".json"):
        name = os.path.join(ctx.root, name)
    ctx.phase("process start to the driver (imports)")
    svc = EmbeddingService(name, None, image_size=tr["image_size"],
                           precision=cfg["dtype"], num_workers=0,
                           device=device)
    model = svc.clip.model
    specs = clip.param_specs(cfg, route, towers=("img",))
    weights.copy_into(
        {n: x for n, x in optim.named_parameters(model).items()
         if n.startswith("img/")},
        weights.make(specs, ctx.seed, device, getattr(torch, cfg["dtype"])))
    ctx.phase("build (the service and its init) and weights")
    if ctx.control:
        for m in model.img.modules():
            if hasattr(m, "quant"):
                m.quant = ctx.control

    size, per, n_pool = (tr["image_size"], tr["request_images"],
                         tr["pool_images"])
    pool = weights.images(n_pool, size, ctx.seed, device).cpu().numpy()
    blocks = n_pool // per

    def request(r):
        return pool[(r % blocks) * per:(r % blocks + 1) * per]
    ctx.phase("inputs")

    c0 = _counters()
    for r in range(tr["warmup_requests"]):
        svc.embed_images(request(r))
    ctx.phase("warm-up requests (kernel builds on a first run)")
    chunks = tr["warmup_requests"] * -(-per // tr["bucket"])
    per_chunk = (_counters()["fused_attention"] - c0["fused_attention"]) \
        / chunks
    expected = tr["launches_per_image_layer"]["fused_attention"] \
        * cfg["image"]["depth"]
    if cuda and per_chunk != expected:
        ctx.log(f"warning: {per_chunk} fused launches per chunk, the cell's "
                f"route gives {expected}")

    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    answers = []    # (block, embeddings)
    r = tr["warmup_requests"]
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while time.perf_counter() - t0 < ctx.seconds:
        answers.append((r % blocks, svc.embed_images(request(r))))
        r += 1
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    images_per_s = len(answers) * per / window_s

    analysis, traced = None, {}
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        c1 = _counters()
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                for _ in range(tr["trace_requests"]):
                    with record_function("perfbench.embed_images"):
                        svc.embed_images(request(r))
                    r += 1
                sync()
        traced = {"fused_attention":
                  _counters()["fused_attention"] - c1["fused_attention"]}
        if cuda:
            analysis = trace_lib.analyse(prof, WINDOW)
        del prof

    del svc, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    failed = sum(1 for _, z in answers if z.shape != (per, cfg["embed_dim"])
                 or not np.isfinite(z).all())
    picked = weights.sample(n_pool, tr["checked_images"], ctx.seed)
    ref_params = {n: x.float() for n, x in weights.make(
        specs, ctx.seed, device, getattr(torch, cfg["dtype"])).items()}
    ref = clip.image_embeddings(ref_params, torch.from_numpy(pool[picked]),
                                cfg, route, device=device).cpu().numpy()
    del ref_params
    worst, compared = 0.0, 0
    for block, z in answers:
        if z.shape != (per, cfg["embed_dim"]):
            continue
        rows = picked[(picked >= block * per) & (picked < (block + 1) * per)]
        if not len(rows):
            continue
        got = z[rows - block * per].astype(np.float64)
        want = ref[np.searchsorted(picked, rows)].astype(np.float64)
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                     * np.linalg.norm(want, axis=1))
        gap = 1.0 - cos
        gap[~np.isfinite(gap)] = np.inf     # a zero or broken answer
        worst = max(worst, float(gap.max()))
        compared += len(rows)
    ctx.log(f"{compared} answers compared for {len(picked)} pool images")
    failed += compared == 0
    checks = {"cos_gap": {"value": worst, "limit": ctx.limits["cos_gap"]}}
    return {
        "kind": "embed", "attempted": len(answers), "failed": failed,
        "end_to_end": {"images_per_s": images_per_s, "setup_s": setup_s},
        "rate": images_per_s, "window_s": window_s,
        "memory_peak_bytes": int(peak), "checks": checks,
        "flops_per_item": flops.image_forward(cfg, tr["image_size"]),
        "attention": {"batch": tr["bucket"],
                      "seq": (size // cfg["image"]["patch_size"]) ** 2 + 1,
                      "width": cfg["image"]["width"]},
        "launches": traced, "trace": analysis,
        "traced_items": tr["trace_requests"] * per if ctx.trace else 0,
    }
