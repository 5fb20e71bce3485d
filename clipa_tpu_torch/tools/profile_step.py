"""Where a training step's device time goes, from a torch.profiler trace.

    python -m clipa_tpu_torch.tools.profile_step \
        [--config clipa_tpu_torch/configs/clipa_pretrain.py:img=L/16,res=112,token_len=8,batchsize=384] \
        [--img-attn-impl pallas] [--steps 2] [--out profile_out]

Builds the config's two-tower model on one CUDA device with seeded random
weights (the image tower's attention path set by `--img-attn-impl` when
given, e.g. ``pallas`` for the flash kernels of the unmask-tuning config
``clipa_tpu_torch/configs/clipa_finetune.py:img=L/16,res=224,token_len=32,
mask_ratio=0.3,batchsize=128``), its optimizer and
``train.step.make_update_fn``, warms up two
steps on a fixed synthetic uint8 batch (as ``chip_smoke.py`` makes it), then
traces `--steps` synchronous steps in one window and reports, with the
analysis of ``tools/profile_service.py``: the device busy share (the union
of kernel and copy intervals over the window's host span), device ms per op
family (forward and backward attention kernels, GEMMs, LayerNorm, GELU,
dtype copies, adds, the rest) and pairs/s on the host clock inside the
trace (the profiler slows the host). The summary is one JSON line on
stdout; the ``key_averages()`` tables (by device time and by host time)
and the Chrome trace (``train_step_trace.json``, each step marked
``ProfilerStep#<n>``; ``tools/trace_summary.py`` reads it) go to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from clipa_tpu_torch.tools.profile_service import analyse

DEFAULT_CONFIG = ("clipa_tpu_torch/configs/clipa_pretrain.py:"
                  "img=L/16,res=112,token_len=8,batchsize=384")


def main(argv=None) -> int:
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.train import step

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--img-attn-impl", default=None,
                   help="the image tower's attn_impl (default: the config's)")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="profile_out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    config = load_config(args.config)
    if args.img_attn_impl:
        config.model.image.attn_impl = args.img_attn_impl
    batch_size = config.input.batch_size
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(args.seed),
        "cuda")
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=batch_size))
    update = step.make_update_fn(model, tx, config, config.total_steps)
    rng = np.random.RandomState(args.seed)
    res, tokens = config.init_shapes[0][1], config.init_shapes[1][1]
    batch = {
        "image": torch.from_numpy(rng.randint(
            0, 255, (batch_size, res, res, 3), dtype=np.uint8)).cuda(),
        "labels": torch.from_numpy(rng.randint(
            0, 32000, (batch_size, tokens)).astype(np.int32)).cuda(),
    }
    for _ in range(2):    # warm-up: allocator, cuBLAS plans, kernel builds
        state, _ = update(state, batch)
    torch.cuda.synchronize()

    window = "train_step"
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(window):
            for i in range(args.steps):
                with torch.profiler.record_function(f"ProfilerStep#{i}"):
                    state, meas = update(state, batch)
            float(meas["training_loss"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = {"card": torch.cuda.get_device_name(0), "config": args.config,
               "img_attn_impl": config.model.image.get("attn_impl", "auto"),
               "steps": args.steps,
               **analyse(prof, window, batch_size * args.steps)}
    summary["host_wall_s"] = wall
    summary["pairs_per_s_traced"] = summary.pop("items_per_s_traced")
    os.makedirs(args.out, exist_ok=True)
    for name, key in (("train_step_key_averages.txt", "self_cuda_time_total"),
                      ("train_step_host_ops.txt", "self_cpu_time_total")):
        with open(os.path.join(args.out, name), "w") as f:
            f.write(prof.key_averages().table(sort_by=key, row_limit=50,
                                              max_name_column_width=120))
    prof.export_chrome_trace(os.path.join(args.out, "train_step_trace.json"))
    with open(os.path.join(args.out, "train_step_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
