"""Driver ``train_step``: the port's training step, ``update(state, batch)``.

Set-up builds the step as the port's trainer does (``train.step``:
``create_model``, ``init_train_state``, ``optim.make``, ``make_update_fn``
on the port config the traffic names), loads the benchmark's weights into
it, and places the optimizer at ``start_count`` of its schedule (past the
warmup, where a run spends its steps: at count 0 the lr is 0 and no step
would move a weight). A pool of ``pool_batches`` distinct batches is made
from the seed and kept in pinned host memory; every step stages its batch
host -> device without blocking, as the trainer does.

The first ``checked_steps`` steps of that same object are the ones the
reference follows: each step's loss, each leaf's first gradient norm (from
Adam's second moment after one step: sqrt(sum(nu) / (1 - b2))) and each
leaf's change after the checked steps. Then ``extra_warmup_steps`` more,
then the window: steps until ``seconds`` have passed, then a synchronize.
pairs/s = all pairs of the window's steps over its wall time. Traced, a
profiler window of ``trace_steps`` more steps follows.

Then the program's state is freed and the float32 reference runs the
checked steps from the same weights on the same batches; under
unmask-tuning it keeps the same image tokens, drawn again by the
masking rule from the port config's seed and the step
(``reference.clip.kept_tokens``).
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from perfbench import flops, weights
from perfbench import trace as trace_lib
from perfbench.reference import clip

WINDOW = "perfbench.window"


def _route(ctx) -> dict:
    tr = ctx.traffic
    return {**ctx.config["routes"][tr["route"]],
            "image_size": tr["image_size"], "token_len": tr["token_len"]}


def _counters() -> dict:
    from clipa_tpu_torch.ops import block_attention
    return {"fused_attention": block_attention.fused_attention.launches,
            "fused_attention_bwd":
                block_attention.fused_attention_bwd.launches}


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def _finite(x: float) -> float:
    """x, or infinity where it is NaN: a broken number fails every limit."""
    return x if math.isfinite(x) else math.inf


def _gap(prog: dict, ref: dict, names) -> tuple:
    """The worst leaf's |prog - ref| over max(ref, the median leaf's ref),
    and that leaf's name."""
    names = list(names)
    median = float(np.median([ref[n] for n in names]))
    gaps = {n: _finite(abs(prog[n] - ref[n]) / max(ref[n], median))
            for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def build(ctx, device):
    """The port's step at the traffic's port config: (model, state, tx,
    update), the optimizer placed at the traffic's ``start_count``."""
    import clipa_tpu_torch
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.train import step

    cfg, tr = ctx.config, ctx.traffic
    route = cfg["routes"][tr["route"]]
    spec = tr["port_config"].format(img=route["port_variant"])
    config = load_config(os.path.join(
        os.path.dirname(clipa_tpu_torch.__file__), "configs", spec))
    config.model.dtype = cfg["dtype"]
    config.model.image.remat_policy = tr["remat"]
    if ctx.control:
        config.model.image.quant = ctx.control
        config.model.text.quant = ctx.control
    opt = tr["optimizer"]
    stated = {"lr": config.lr, "wd": config.wd,
              "total_steps": config.total_steps,
              "b1": config.optax.b1, "b2": config.optax.b2,
              "mu_dtype": config.optax.mu_dtype,
              "mask_ratio": config.get("mask_ratio", 0.0)}
    for key, value in stated.items():
        want = tr["mask_ratio"] if key == "mask_ratio" else opt[key]
        if value != want:
            ctx.log(f"warning: the port config's {key} is {value!r}, the "
                    f"traffic's {want!r}")
    model = step.create_model(config, device=device)
    state = step.init_train_state(
        model, config, weights.generator(ctx.seed, 0, device), device)
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=tr["batch"]))
    tx.count = state["step"] = int(opt["start_count"])
    update = step.make_update_fn(model, tx, config, config.total_steps)
    return model, state, tx, update


def run(ctx) -> dict:
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"
    cfg, tr = ctx.config, ctx.traffic
    route = _route(ctx)
    specs = clip.param_specs(cfg, route)
    b, pool = tr["batch"], tr["pool_batches"]
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    ctx.phase("process start to the driver (imports)")
    model, state, tx, update = build(ctx, device)
    ctx.phase("build (the port's model, init and optimizer)")
    weights.copy_into(state["params"], weights.make(specs, ctx.seed, device))
    gc.collect()
    ctx.phase("weights")
    images = weights.images(pool * b, tr["image_size"], ctx.seed, device)
    labels = weights.labels(pool * b, tr["token_len"],
                            cfg["text"]["vocab_size"], ctx.seed, device)
    host_images = images.reshape(pool, b, *images.shape[1:]).cpu()
    host_labels = labels.reshape(pool, b, -1).cpu()
    del images, labels
    if cuda:
        host_images, host_labels = (host_images.pin_memory(),
                                    host_labels.pin_memory())

    ctx.phase("inputs")

    def stage(k):
        i = k % pool
        return {"image": host_images[i].to(device, non_blocking=True),
                "labels": host_labels[i].to(device, non_blocking=True)}

    # the checked steps: the reference follows these
    c0 = _counters()
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
    launches = _delta(c0, _counters())
    steps_run = checked + tr["extra_warmup_steps"]
    per_step = {key: n / steps_run for key, n in launches.items()}
    depth = cfg["image"]["depth"]
    expected = {key: m * depth for key, m in
                tr["launches_per_image_layer"].items()}
    if cuda and per_step != expected:
        ctx.log(f"warning: fused launches per step {per_step}, the cell's "
                f"route gives {expected}")

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

    analysis, traced = None, {}
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        c1 = _counters()
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                for _ in range(tr["trace_steps"]):
                    with record_function("perfbench.stage"):
                        batch = stage(k)
                    with record_function("perfbench.update"):
                        state, meas = update(state, batch)
                    k += 1
                sync()
        traced = _delta(c1, _counters())
        if cuda:
            analysis = trace_lib.analyse(prof, WINDOW)
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
    patches = (tr["image_size"] // cfg["image"]["patch_size"]) ** 2
    start_count = int(tr["optimizer"]["start_count"])
    batches = [(host_images[k].to(device), host_labels[k].to(device),
                clip.kept_tokens(tr["mask_seed"], start_count + k, b,
                                 patches, tr["mask_ratio"], device)
                if tr["mask_ratio"] else None)
               for k in range(checked)]
    ref = clip.train_steps(params, batches, cfg, route, tr["optimizer"],
                           clip.decayed(specs), remat=True)
    del batches
    start = weights.make(specs, ctx.seed, device)
    ref_changes = {n: float(torch.linalg.norm(params[n] - start[n]))
                   for n in params}
    del params, start

    loss_gap = max(_finite(abs(p - r) / abs(r)) for p, r in
                   zip(prog_losses, ref["losses"]))
    grad_gap, grad_leaf = _gap(prog_grads, ref["grad_norms"],
                               ref["grad_norms"])
    median_grad = float(np.median(list(ref["grad_norms"].values())))
    moving = [n for n, g in ref["grad_norms"].items()
              if g >= tr["still_leaf_share"] * median_grad]
    change_gap, change_leaf = _gap(prog_changes, ref_changes, moving)
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
    kept = int(image_tokens * (1 - tr["mask_ratio"])) + 1
    return {
        "kind": "train", "attempted": n, "failed": len(bad),
        "end_to_end": {"pairs_per_s": pairs_per_s, "setup_s": setup_s},
        "rate": pairs_per_s, "window_s": window_s, "steps": n,
        "memory_peak_bytes": int(peak), "checks": checks,
        "flops_per_item": flops.train_step_per_pair(
            cfg, tr["image_size"], tr["token_len"], b, tr["mask_ratio"]),
        "attention": {"batch": b, "seq": kept,
                      "width": cfg["image"]["width"]},
        "launches": traced, "trace": analysis,
        "traced_items": tr["trace_steps"] * b if ctx.trace else 0,
    }
