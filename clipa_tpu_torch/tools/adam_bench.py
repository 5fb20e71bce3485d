"""Times the optimizer's fused Adam kernel against its eager chain.

    python -m clipa_tpu_torch.tools.adam_bench \
        [--config clipa_pretrain.py:img=H/14] [--config ...] [--iters 20]

For each port config (a file of ``clipa_tpu_torch/configs`` with its
argument string): the model's parameter set (shapes from the model built
on the meta device) as fp32 tensors on the card with seeded random values
and gradients, and the config's optimizer (``optim.make``) placed past its
warmup. Then:

  check             one step of the kernel (``Optimizer.update``) and one
                    of the chain (``chain_update``, then ``apply_updates``)
                    from the same state: parameters and moments bit for bit
  kernel_ms         the kernel's device time per step (torch.profiler,
                    ``fused_adam_kernel``; None where three profiler
                    sessions lose records), and by CUDA events around
                    `iters` steps (``events_ms``); ``launches_per_step``
                    from the wrapper's counter
  bound_ms          the bytes the step must move (each parameter, gradient
                    and moment read once, each parameter and moment written
                    once) over 3.35 TB/s, the H100 SXM's published rate;
                    ``bound_share`` = bound_ms / kernel_ms
  chain_device_ms   the eager chain's device time per step: the sum of its
                    kernels' device time (some twenty per leaf)
  host_ms           the host's time in ``update()`` + ``apply()`` for the
                    kernel (median of `iters`, no synchronisation inside)
                    and for the chain

One JSON line per config, then one with all of them and the card's name
and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12
KERNEL = "fused_adam_kernel"


def _card() -> dict:
    out = {"device": torch.cuda.get_device_name(0)}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["power_limit"] = f"unread: {e}"
    return out


def _build(spec: str, seed: int):
    """(optimizer over seeded fp32 parameters on the card, gradients)."""
    import clipa_tpu_torch
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.train import step

    config = load_config(os.path.join(
        os.path.dirname(clipa_tpu_torch.__file__), "configs", spec))
    shapes = {n: p.shape for n, p in optim.named_parameters(
        step.create_model(config, "meta")).items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {n: torch.randn(s, device="cuda", generator=gen) * 0.02
              for n, s in shapes.items()}
    grads = {n: torch.randn(s, device="cuda", generator=gen) * 1e-3
             for n, s in shapes.items()}
    tx, _ = optim.make(config, params, sched_kw=dict(
        total_steps=config.total_steps, batch_size=config.input.batch_size))
    tx.count = config.total_steps // 2     # past warmup: the lr is not 0
    return tx, grads


def _bytes(tx) -> int:
    """The step's least traffic: p read and written, g (p's dtype here)
    read, mu and nu read and written, for every unfrozen leaf."""
    return sum(p.numel() * (3 * p.element_size()
                            + 2 * tx.mu[n].element_size()
                            + 2 * tx.nu[n].element_size())
               for n, p in tx.params.items() if n not in tx.frozen)


def _device_ms(fn, name=None, steps=3) -> tuple:
    """(device time per call of fn, kernels seen per call): the kernels
    whose name holds `name`, or every kernel, under torch.profiler, after
    a warm-up step whose records are dropped. A session's records can come
    back in part or not at all in a long process, so a session counts only
    where each kernel name's count is a whole number of calls' worth; after
    three that are not, (None, None): not measured."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(steps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        spans = {}
        for e in prof.events():
            if e.device_type == cuda and not e.is_user_annotation \
                    and (name is None or name in e.name):
                spans.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if spans and all(len(d) % steps == 0 for d in spans.values()):
            return (sum(map(sum, spans.values())) / 1e3 / steps,
                    sum(map(len, spans.values())) / steps)
    return None, None


def _host_ms(fn, iters: int) -> float:
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _bits(t):
    ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.view(ints)


def measure(spec: str, iters: int = 20, seed: int = 0) -> dict:
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.ops import fused_adam
    tx, grads = _build(spec, seed)
    tx.return_updates = False
    out = {"config": spec, "leaves": len(tx.params),
           "params": sum(p.numel() for p in tx.params.values()),
           "bytes": _bytes(tx)}
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3

    # one step of each from the same state, bit for bit
    start = ({n: p.clone() for n, p in tx.params.items()},
             {n: m.clone() for n, m in tx.mu.items()},
             {n: m.clone() for n, m in tx.nu.items()}, tx.count)
    tx.apply(tx.update(grads))
    got = ({n: p.clone() for n, p in tx.params.items()},
           {n: m.clone() for n, m in tx.mu.items()},
           {n: m.clone() for n, m in tx.nu.items()})
    with torch.no_grad():
        for live, saved in zip((tx.params, tx.mu, tx.nu), start):
            for n, t in live.items():
                t.copy_(saved[n])
    tx.count = start[3]
    optim.apply_updates(tx.params, tx.chain_update(grads))
    torch.cuda.synchronize()
    out["check"] = all(
        torch.equal(_bits(mine[n]), _bits(live[n]))
        for mine, live in zip(got, (tx.params, tx.mu, tx.nu)) for n in live)
    del start, got

    def kernel():
        tx.apply(tx.update(grads))

    def chain():
        optim.apply_updates(tx.params, tx.chain_update(grads))

    out["kernel_ms"], out["kernel_launches"] = _device_ms(kernel, KERNEL)
    before = fused_adam.fused_adam_step.launches
    kernel()
    torch.cuda.synchronize()
    out["launches_per_step"] = fused_adam.fused_adam_step.launches - before
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    begin.record()
    for _ in range(iters):
        kernel()
    end.record()
    torch.cuda.synchronize()
    out["events_ms"] = begin.elapsed_time(end) / iters
    out["bound_share"] = (out["bound_ms"] / out["kernel_ms"]
                          if out["kernel_ms"] else None)
    out["kernel_host_ms"] = _host_ms(kernel, iters)
    out["chain_device_ms"], out["chain_kernels"] = _device_ms(chain)
    out["chain_host_ms"] = _host_ms(chain, max(3, iters // 4))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", action="append",
                        help="a port config and its argument string "
                             "(repeatable; default: the H/14 and L/16 "
                             "pre-training configs)")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("adam_bench needs a CUDA card")
    specs = args.config or ["clipa_pretrain.py:img=H/14",
                            "clipa_pretrain.py:img=L/16"]
    results = []
    for spec in specs:
        results.append(measure(spec, args.iters, args.seed))
        print(json.dumps(results[-1]), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({**_card(), "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
