"""Driver ``train_step_t5``: the port's training step with the mT5 text
tower, ``update(state, batch)``.

The ``train_step`` driver's protocol (its helpers, used as they are) on a
configuration whose text tower is ``models/t5_text.py``: set-up builds the
step as the port's trainer does (``train.step``: ``create_model``,
``init_train_state``, ``optim.make``, ``make_update_fn`` on the port config
the traffic names, ``clipa_pretrain.py``'s ``txt`` option), loads the
benchmark's weights (``reference/mt5_clip.param_specs``), places the
optimizer at ``start_count`` and stages each step's batch from a pinned
pool of ``pool_batches`` batches made from the seed.

The text is mT5 ids: each row's length drawn from a seeded log-normal
(``lengths``: median, sigma, clipped to [lo, token_len]), the ids before
the last drawn uniformly from [2, vocab), the end token 1 last, pads 0
after it.

The first ``checked_steps`` steps are the ones the reference follows (each
step's loss, each leaf's first gradient norm, each leaf's change), then
``extra_warmup_steps``, the window and, traced, a profiler window of
``trace_steps`` steps. Besides ``train_step``'s result it counts the T5
attention cores by phase (``t5_text.attention_calls``) and returns the
device intervals of the profiler's mirrored ``t5.attention`` and
``t5.attention.bwd`` ranges (``t5_attention``), which
``metrics/t5.attn_device_ms.py`` reads. Then the program's state is
freed and ``reference/mt5_clip.py`` runs the checked steps in float32.
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from perfbench import flops_mt5, weights
from perfbench import trace as trace_lib
from perfbench.drivers import train_step as base
from perfbench.reference import clip, mt5_clip

WINDOW = base.WINDOW
T5_RANGES = ("t5.attention", "t5.attention.bwd")


def _t5_calls() -> dict:
    from clipa_tpu_torch.models import t5_text
    return dict(t5_text.attention_calls)


def mt5_ids(n: int, tr: dict, cfg: dict, seed: int, device) -> torch.Tensor:
    """(n, token_len) int32 mT5 ids from the seed (module docstring)."""
    t, lengths = cfg["text"], tr["lengths"]
    length = tr["token_len"]
    g = weights.generator(seed, weights.LABELS, device)
    z = torch.randn(n, generator=g, device=device)
    real = torch.round(lengths["median"] * torch.exp(lengths["sigma"] * z))
    real = real.clamp(lengths["lo"], length).long()
    ids = torch.randint(2, t["vocab_size"], (n, length), generator=g,
                        device=device, dtype=torch.int32)
    pos = torch.arange(length, device=device)[None]
    ids = torch.where(pos == real[:, None] - 1,
                      torch.full_like(ids, t["eos_id"]), ids)
    return torch.where(pos >= real[:, None],
                       torch.full_like(ids, t["pad_id"]), ids)


def build(ctx, device):
    """The port's step at the traffic's port config: (model, state, tx,
    update), the optimizer at the traffic's ``start_count``."""
    import clipa_tpu_torch
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.train import step

    cfg, tr = ctx.config, ctx.traffic
    route = cfg["routes"][tr["route"]]
    spec = tr["port_config"].format(img=route["port_variant"],
                                    txt=route["text_variant"])
    config = load_config(os.path.join(
        os.path.dirname(clipa_tpu_torch.__file__), "configs", spec))
    if config.model.get("text_model") != "t5_text":
        raise ValueError(f"{spec} builds no t5_text tower")
    config.model.dtype = cfg["dtype"]
    config.model.image.remat_policy = tr["remat"]
    config.model.text.remat_policy = tr["remat"]
    if ctx.control:
        config.model.image.quant = ctx.control
        config.model.text.quant = ctx.control
    opt = tr["optimizer"]
    stated = {"lr": config.lr, "wd": config.wd,
              "total_steps": config.total_steps,
              "b1": config.optax.b1, "b2": config.optax.b2,
              "mu_dtype": config.optax.mu_dtype}
    for key, value in stated.items():
        if value != opt[key]:
            ctx.log(f"warning: the port config's {key} is {value!r}, the "
                    f"traffic's {opt[key]!r}")
    model = step.create_model(config, device=device)
    state = step.init_train_state(
        model, config, weights.generator(ctx.seed, 0, device), device)
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=tr["batch"]))
    tx.count = state["step"] = int(opt["start_count"])
    update = step.make_update_fn(model, tx, config, config.total_steps)
    return model, state, tx, update


def _mirrored(prof, window: str) -> list:
    """(start, end) µs of the device-timeline mirrors of the T5 ranges
    inside the profiler's `window`."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [e for e in events if e.name == window and e.device_type == cpu]
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    return [(max(e.time_range.start, w0), min(e.time_range.end, w1))
            for e in events if e.device_type == cuda and e.is_user_annotation
            and e.name in T5_RANGES
            and e.time_range.end > w0 and e.time_range.start < w1]


def run(ctx) -> dict:
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"
    cfg, tr = ctx.config, ctx.traffic
    route = base._route(ctx)
    specs = mt5_clip.param_specs(cfg, route)
    b, pool = tr["batch"], tr["pool_batches"]
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    ctx.phase("process start to the driver (imports)")
    model, state, tx, update = build(ctx, device)
    ctx.phase("build (the port's model, init and optimizer)")
    weights.copy_into(state["params"], weights.make(specs, ctx.seed, device))
    gc.collect()
    ctx.phase("weights")
    images = weights.images(pool * b, tr["image_size"], ctx.seed, device)
    labels = mt5_ids(pool * b, tr, cfg, ctx.seed, device)
    host_images = images.reshape(pool, b, *images.shape[1:]).cpu()
    host_labels = labels.reshape(pool, b, -1).cpu()
    pads = float((labels == cfg["text"]["pad_id"]).float().mean())
    del images, labels
    if cuda:
        host_images, host_labels = (host_images.pin_memory(),
                                    host_labels.pin_memory())
    ctx.log(f"text: {pads:.4f} of the id slots are pads")
    ctx.phase("inputs")

    def stage(k):
        i = k % pool
        return {"image": host_images[i].to(device, non_blocking=True),
                "labels": host_labels[i].to(device, non_blocking=True)}

    # the checked steps: the reference follows these
    c0, t0_calls = base._counters(), _t5_calls()
    losses, grad_norms = [], None
    checked = tr["checked_steps"]
    b2 = tr["optimizer"]["b2"]
    for k in range(checked):
        state, meas = update(state, stage(k))
        losses.append(meas["training_loss"].detach().clone())
        if k == 0:
            with torch.no_grad():
                grad_norms = {n: torch.sqrt(nu.float().sum() / (1 - b2))
                              for n, nu in tx.nu.items()}
    with torch.no_grad():
        start = weights.make(specs, ctx.seed, device)
        changes = {n: torch.linalg.norm(state["params"][n].float() - x)
                   for n, x in start.items()}
        del start
    ctx.phase("checked steps (kernel builds on a first run)")
    for k in range(checked, checked + tr["extra_warmup_steps"]):
        state, meas = update(state, stage(k))
    ctx.phase("warm-up steps")
    steps_run = checked + tr["extra_warmup_steps"]
    launches = base._delta(c0, base._counters())
    per_step = {key: n / steps_run for key, n in launches.items()}
    depth = cfg["image"]["depth"]
    expected = {key: m * depth for key, m in
                tr["launches_per_image_layer"].items()}
    if cuda and per_step != expected:
        ctx.log(f"warning: fused launches per step {per_step}, the cell's "
                f"route gives {expected}")
    t5_per_step = {key: n / steps_run for key, n in
                   base._delta(t0_calls, _t5_calls()).items()}
    t5_expected = {key: m * cfg["text"]["depth"] for key, m in
                   tr["t5_attention_calls_per_text_layer"].items()}
    ctx.log(f"t5 attention calls per step {t5_per_step}")
    if t5_per_step != t5_expected:
        ctx.log(f"warning: t5 attention calls per step {t5_per_step}, the "
                f"cell's route gives {t5_expected}")

    # the window
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    k = steps_run
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    n = 0
    while time.perf_counter() - t0 < ctx.seconds:
        state, meas = update(state, stage(k))
        k += 1
        n += 1
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    pairs_per_s = n * b / window_s

    analysis, traced, t5_ranges = None, {}, None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        c1 = base._counters()
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                for _ in range(tr["trace_steps"]):
                    with record_function("perfbench.stage"):
                        batch = stage(k)
                    with record_function("perfbench.update"):
                        state, meas = update(state, batch)
                    k += 1
                sync()
        traced = base._delta(c1, base._counters())
        if cuda:
            analysis = trace_lib.analyse(prof, WINDOW)
            t5_ranges = _mirrored(prof, WINDOW)
        del prof

    prog_losses = [float(x) for x in losses]
    prog_grads = {n: float(x) for n, x in grad_norms.items()}
    prog_changes = {n: float(x) for n, x in changes.items()}
    del model, state, tx, update, meas, losses, grad_norms, changes
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference: the checked steps in float32 from the same weights
    params = weights.make(specs, ctx.seed, device)
    batches = [(host_images[k].to(device), host_labels[k].to(device))
               for k in range(checked)]
    ref = mt5_clip.train_steps(params, batches, cfg, route, tr["optimizer"],
                               clip.decayed(specs), remat=True)
    del batches
    start = weights.make(specs, ctx.seed, device)
    ref_changes = {n: float(torch.linalg.norm(params[n] - start[n]))
                   for n in params}
    del params, start

    loss_gap = max(base._finite(abs(p - r) / abs(r)) for p, r in
                   zip(prog_losses, ref["losses"]))
    grad_gap, grad_leaf = base._gap(prog_grads, ref["grad_norms"],
                                    ref["grad_norms"])
    median_grad = float(np.median(list(ref["grad_norms"].values())))
    moving = [n for n, g in ref["grad_norms"].items()
              if g >= tr["still_leaf_share"] * median_grad]
    change_gap, change_leaf = base._gap(prog_changes, ref_changes, moving)
    ctx.log(f"losses {prog_losses} reference {ref['losses']}")
    ctx.log(f"worst gradient leaf {grad_leaf}: {prog_grads[grad_leaf]!r} "
            f"reference {ref['grad_norms'][grad_leaf]!r}")
    ctx.log(f"worst change leaf {change_leaf}: {prog_changes[change_leaf]!r}"
            f" reference {ref_changes[change_leaf]!r}; {len(moving)} of "
            f"{len(ref_changes)} leaves compared")
    lim = ctx.limits
    checks = {
        "loss_gap": {"value": loss_gap, "limit": lim["loss_gap"]},
        "grad_norm_gap": {"value": grad_gap, "limit": lim["grad_norm_gap"]},
        "change_gap": {"value": change_gap, "limit": lim["change_gap"]},
    }
    bad = [x for x in prog_losses if not math.isfinite(x)]
    image_tokens = (tr["image_size"] // cfg["image"]["patch_size"]) ** 2
    return {
        "kind": "train", "attempted": n, "failed": len(bad),
        "end_to_end": {"pairs_per_s": pairs_per_s, "setup_s": setup_s},
        "rate": pairs_per_s, "window_s": window_s, "steps": n,
        "memory_peak_bytes": int(peak), "checks": checks,
        "flops_per_item": flops_mt5.train_step_per_pair(
            cfg, tr["image_size"], tr["token_len"], b),
        "attention": {"batch": b, "seq": image_tokens + 1,
                      "width": cfg["image"]["width"]},
        "launches": traced, "trace": analysis,
        "traced_items": tr["trace_steps"] * b if ctx.trace else 0,
        "t5_attention": (None if t5_ranges is None else
                         {"ranges": t5_ranges,
                          "steps": tr["trace_steps"]}),
    }
