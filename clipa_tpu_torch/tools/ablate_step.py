"""Ablation timing of the CLIPA train step: where the step time goes.

    python -m clipa_tpu_torch.tools.ablate_step [--batch 512] [--res 112]
        [--tokens 8] [--variant L/16] [--attn auto] [--iters 8]
        [--device cuda]

Port of ``clipa_tpu/tools/ablate_step.py``. Builds the two-tower model the
reference builds (``variant`` image tower with ``tok`` pooling and sincos2d
posemb, the matching text tower, bf16 compute over fp32 parameters, seeded
random weights) on one device and times a ladder of step variants on one
fixed uint8 batch, host clock around synchronized calls:

  fwd_ms          forward loss only (no autograd graph)
  grad_ms         loss and gradients, no optimizer
  sgd_ms          gradients + a plain SGD update in place
  adam_ms         the real update: clip 1.0, Adam (b2 0.95, bf16 first
                  moment), decoupled weight decay 0.2, lr 1e-8
  grad_noattn_ms  grad_ms with every attention core replaced by identity
                  (returns v): what attention costs
  grad_titext_ms  grad_ms with a Ti text tower
  hbm_triad_gbps  a * 1.0001 + 3.0 over 1 GiB of fp32 in one kernel: the
                  device memory rate (read once, written once)

The same JSON keys as the reference, printed one line per finished rung
and once more at the end. :func:`main` also returns the kernel launches of
each rung and the calls of the stand-in attention core (``bypassed``), so a
caller can show that ``grad_noattn`` replaced every attention core and
launched no kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

OUT_DIMS = {"Ti": 192, "S": 384, "B": 512, "L": 768, "H": 1024, "G": 1280}
TRIAD_MB = 1024   # fp32 megabytes of the triad's input


def _counters():
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.ops import flash_attention as fa
    return {"fused_fwd": ba.fused_attention,
            "fused_bwd": ba.fused_attention_bwd,
            "flash_fwd": fa.flash_attention,
            "flash_bwd": fa.flash_attention_bwd}


@contextlib.contextmanager
def no_attention():
    """Every attention core returns v (the reference's ``grad_noattn``
    monkeypatch); use with ``attn_impl="einsum"`` so that the core is the
    one replaced. Each call of the stand-in adds one to
    ``no_attention.calls``."""
    from clipa_tpu_torch.ops import attention
    orig = attention.dot_product_attention

    def identity(q, k, v, mask=None, impl="auto"):
        no_attention.calls += 1
        return v
    attention.dot_product_attention = identity
    try:
        yield
    finally:
        attention.dot_product_attention = orig


no_attention.calls = 0


def build(args, device, attn_impl: str, text_variant=None):
    """The reference's ablation model on `device`, seeded parameters."""
    from clipa_tpu_torch.models import layers, two_towers
    tv = args.variant.split("/")[0]
    out_dim = OUT_DIMS.get(tv, 768)
    with device:
        model = two_towers.Model(
            image={"variant": args.variant, "pool_type": "tok",
                   "posemb": "sincos2d", "attn_impl": attn_impl,
                   "image_size": (args.res, args.res)},
            text={"variant": text_variant or tv, "pool_type": "last",
                  "vocab_size": 32000, "context_length": args.tokens},
            out_dim=(out_dim, out_dim), temperature_init=1 / 0.07,
            dtype=torch.bfloat16)
    layers.init_parameters(model,
                           torch.Generator(device=device).manual_seed(0))
    return model.train()


def loss_fn(model, images, labels):
    from clipa_tpu_torch import losses
    from clipa_tpu_torch.ops import preprocess
    zimg, ztxt, out = model(preprocess.normalize_uint8(images), labels)
    return losses.bidirectional_contrastive_loss(zimg, ztxt, out["t"],
                                                 reduction=True)[0]


def _grad_fn(model, images, labels):
    params = [p for p in model.parameters() if p.requires_grad]

    def grad():   # allow_unused: without attention q and k get no gradient
        return torch.autograd.grad(loss_fn(model, images, labels), params,
                                   allow_unused=True)
    return params, grad


def _time(fn, device, iters: int) -> float:
    """Seconds per call of fn(): two warm-up calls, then `iters` calls
    between synchronizations."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(2):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    """Runs the ladder; returns (results, {rung: kernel launches})."""
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.config import ConfigDict

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--res", type=int, default=112)
    p.add_argument("--tokens", type=int, default=8)
    p.add_argument("--variant", default="L/16")
    p.add_argument("--attn", default="auto")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ablate_step needs a CUDA device (or --device cpu)")

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(
        0, 255, (args.batch, args.res, args.res, 3), dtype=np.uint8)).to(
            device)
    labels = torch.from_numpy(rng.randint(
        0, 32000, (args.batch, args.tokens)).astype(np.int32)).to(device)
    counters = _counters()
    results, launches = {}, {}

    def rung(key, fn):
        for c in counters.values():
            c.launches = 0
        no_attention.calls = 0
        results[key] = round(_time(fn, device, args.iters) * 1e3, 2)
        launches[key] = {n: c.launches for n, c in counters.items()}
        launches[key]["bypassed"] = no_attention.calls
        print(json.dumps(results), flush=True)

    model = build(args, device, args.attn)

    def fwd():
        with torch.no_grad():
            return loss_fn(model, images, labels)
    rung("fwd_ms", fwd)
    params, grad = _grad_fn(model, images, labels)
    rung("grad_ms", grad)

    def sgd():
        grads = grad()
        with torch.no_grad():
            for x, g in zip(params, grads):
                if g is not None:
                    x.sub_(g, alpha=1e-8)
    rung("sgd_ms", sgd)

    config = ConfigDict(
        lr=1e-8, wd=0.2, wd_mults=[(".*", 1.0)], grad_clip_norm=1.0,
        schedule=[(".*", dict(decay_type="const"))],
        optax=dict(b1=0.9, b2=0.95, mu_dtype="bfloat16"))
    named = optim.named_parameters(model)
    names = list(named)
    tx = optim.Optimizer(config, named, dict(total_steps=1 << 30))

    def adam():
        grads = torch.autograd.grad(loss_fn(model, images, labels),
                                    [named[n] for n in names])
        tx.apply(tx.update(dict(zip(names, grads))))
    rung("adam_ms", adam)
    del model, params, grad, named, tx

    # attention ablation: the einsum path with its core replaced by identity
    with no_attention():
        model = build(args, device, "einsum")
        _, grad = _grad_fn(model, images, labels)
        rung("grad_noattn_ms", grad)
    del model, grad

    # text tower ablation: a Ti text tower
    model = build(args, device, args.attn, text_variant="Ti")
    _, grad = _grad_fn(model, images, labels)
    rung("grad_titext_ms", grad)
    del model, grad

    # device memory rate: a big elementwise triad, one kernel (3 + 1.0001 a;
    # `a * 1.0001 + 3.0` would run two and move twice the bytes counted)
    big = torch.ones(TRIAD_MB * 2 ** 18, dtype=torch.float32,
                     device=device)
    three = torch.tensor(3.0, device=device)
    t = _time(lambda: torch.add(three, big, alpha=1.0001), device,
              args.iters)
    results["hbm_triad_gbps"] = round(2 * big.numel() * 4 / t / 1e9, 1)
    del big
    print(json.dumps(results, indent=2))
    return results, launches


if __name__ == "__main__":
    main()
