"""Times the kernels of one checkout at the shapes of ``chip_smoke.py``:
the fused forward (K1/K3/K5) at its phase-2 ``FUSED_SHAPES``, the fused
backward (K2/K4/K6) at its phase-3 ``BWD_SHAPES``, the flash kernels (K7
forward, K8 backward) at its phase-6 ``FLASH_SHAPES``, and on request the
uint8 patch embed (K9) at its phase-9 ``PATCH_CASES`` and the deferred
backward (K10's) at ``tools/attn_sweep.py``'s shape, clip and exact.

    python clipa_tpu_torch/tools/flash_bench.py [--root DIR] [--plans]
        [--kernels fused,flash,patch,deferred] [--serve]

Runs this checkout's ``chip_smoke._kernel_case``, ``_bwd_case``,
``_flash_case``, ``_patch_embed`` (``patch``: every gate of phase 9, then
kernel, plain and ``F.conv2d`` times and the host's and each kernel's
share of a call) and ``_sweep`` (``deferred``: phase 10, the sweep's
variants against their plain versions and a second call, the deferred
backward against the normalized one, each timed by events and by device
time) on the ``clipa_tpu_torch`` package under `--root`
(default: this checkout): the kernels against their plain versions, the
outputs twice bit for bit, kernel, plain and SDPA times by CUDA events and
by device time, and the bounds. So two commits are measured by the same
code in turns on one card: unpack the other one with ``git archive`` into
a directory that .gitignore lists and run this file, by path, once with
each root. The last line is one JSON object: the card and the cases.

`--plans` adds to each case, under ``plan_device_ms``, the device time of
the fused forward under every plan of ``block_attention.fwd_candidates``
(each split and ring, in the case's mode), of the fused backward under
every plan of ``block_attention.bwd_candidates`` (the whole-head scheme
where it is offered, every plan of the long scheme), and of the flash
forward under every split of ``fwd_candidates`` and, where ``launch_plan``
fuses the backward, of the split backward (``bwd_split_plan``): the
measurements behind the plans' choices (for a root whose package has
them).

`--serve` first measures the service as ``chip_smoke.py`` phase 4 does:
images/s (1024 uint8 224 px images, 4 full chunks) and texts/s (2048
captions) at bucket 256 on ViT-H-14-CL32-GAP-BigVision (seeded random
weights, bf16), host clock around synchronous calls, best of two. Needs a
CUDA card.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the kernel sets that --kernels names
KERNELS = ("fused", "flash", "patch", "deferred")


def _chip_smoke():
    """This checkout's chip_smoke.py (it imports the package only inside
    its functions, so they use the one under --root)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _plan_device_ms(cs, fa, b, lq, lk, h, hd, q_scale, gen, iters):
    """Device ms of each forward split that _fwd_plan weighs, keyed
    "fwd <warps>x<blocks>", and of the split backward where the plan fuses
    it, on seeded bf16 operands."""
    import torch

    def mk(l, scale=1.0):
        return (torch.randn(b, l, h, hd, device="cuda", generator=gen)
                * scale).to(torch.bfloat16)

    q, k, v, do = mk(lq, q_scale), mk(lk), mk(lk), mk(lq)
    out, lse = fa._launch(q, k, v)
    probes = {f"fwd {p.warps}x{p.blocks}": (lambda p=p: fa._launch(q, k, v,
                                                                 plan=p))
              for p in fa.fwd_candidates(lq, lk, hd)}
    if len(fa.launch_plan(lq, lk, hd).bwd) == 1:
        split = fa.bwd_split_plan(lq, lk, hd)
        probes["bwd split"] = lambda: fa._launch_bwd(q, k, v, out, lse, do,
                                                     plan=split)
    return {name: cs._device_ms(fn, iters) for name, fn in probes.items()}


def _fused_plan_device_ms(cs, ba, b, l, d, h, bias, exact, gen, iters):
    """Device ms of the fused forward under each plan that fwd_plan weighs,
    keyed "<warps>x<blocks> stages <n>", on seeded bf16 operands."""
    import torch

    def mk(*shape):
        return torch.randn(*shape, device="cuda",
                           generator=gen).to(torch.bfloat16)

    q, k, v = mk(b * l, d), mk(b * l, d), mk(b * l, d)
    biases = (mk(d), mk(d), mk(d)) if bias else None
    return {f"{p.warps}x{p.blocks} stages {p.stages}": cs._device_ms(
        lambda p=p: ba._launch(q, k, v, h, l, biases, exact, plan=p), iters)
        for p in ba.fwd_candidates(l, d // h)}


def _fused_bwd_plan_device_ms(cs, ba, b, l, d, h, bias, exact, gen, iters):
    """Device ms of the fused backward under each plan of bwd_candidates,
    keyed by the plan's repr, on seeded bf16 operands."""
    import torch

    def mk(*shape):
        return torch.randn(*shape, device="cuda",
                           generator=gen).to(torch.bfloat16)

    q, k, v, do = mk(b * l, d), mk(b * l, d), mk(b * l, d), mk(b * l, d)
    biases = (mk(d), mk(d), mk(d)) if bias else None
    return {repr(p): cs._device_ms(
        lambda p=p: ba._launch_bwd(q, k, v, do, h, l, biases, exact, plan=p),
        iters) for p in ba.bwd_candidates(l, d // h)}


def _serve_rates(cs, root) -> dict:
    """images/s and texts/s at bucket 256 of the service under `root`."""
    import numpy as np
    from clipa_tpu_torch.serving import EmbeddingService
    svc = EmbeddingService(cs.MODEL, None,
                           vocab_path=os.path.join(HERE, "data", "vocab.txt"),
                           device="cuda", precision="bfloat16", seed=cs.SEED,
                           num_workers=0)
    rng = np.random.RandomState(cs.SEED)
    images = rng.randint(0, 256, (1024, 224, 224, 3), np.uint8)
    captions = [f"a photo of {n} {w}" for n, w in zip(
        range(40), ["cats", "dogs", "a red car on a street", "birds"] * 10)]
    texts = (captions * 52)[:2048]
    svc.embed_images(images[:256])   # warm-up: allocator, cuBLAS plans
    svc.embed_texts(texts[:256])
    return {"images_per_s": cs._rate(lambda: svc.embed_images(images),
                                     len(images)),
            "texts_per_s": cs._rate(lambda: svc.embed_texts(texts),
                                    len(texts))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--plans", action="store_true",
                        help="also time every plan of the fused forward and "
                        "backward and every split of the flash forward that "
                        "the plans weigh, and the split flash backward where "
                        "it fuses")
    parser.add_argument("--kernels", default="fused,flash",
                        help="comma-separated: fused (phase 2's and 3's "
                        "shapes), flash (phase 6's), patch (phase 9's), "
                        "deferred (the sweep's shape, clip and exact)")
    parser.add_argument("--serve", action="store_true",
                        help="first measure images/s and texts/s at bucket "
                        "256")
    args = parser.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not kernels or kernels - set(KERNELS):
        parser.error(f"--kernels {args.kernels!r}: a comma-separated subset "
                     f"of {','.join(KERNELS)}")
    import torch
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.ops import flash_attention as fa
    if not os.path.abspath(fa.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {fa.__file__}, not the package under "
                           f"{root}: run this file by path")
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"root": root, "card": cs._card()}
    if args.serve:
        out["serve"] = _serve_rates(cs, root)
        print(f"{out['card']}: {root}: images/s at bucket 256 "
              f"{out['serve']['images_per_s']:.2f}, texts/s "
              f"{out['serve']['texts_per_s']:.2f}", flush=True)
    cases = []
    for name, b, l, d, h, bias, exact in (
            cs.FUSED_SHAPES if "fused" in kernels else ()):
        case = {"name": name, **cs._kernel_case(b, l, d, h, bias, exact, 1.0,
                                                gen=gen, device=True)}
        if args.plans:
            case["plan"] = ba.fwd_plan(l, d // h)
            case["plan_device_ms"] = _fused_plan_device_ms(
                cs, ba, b, l, d, h, bias, exact, gen, iters=20)
        cases.append(case)
    for name, b, l, d, h, bias, exact in (
            cs.BWD_SHAPES if "fused" in kernels else ()):
        case = {"name": f"bwd {name}", **cs._bwd_case(
            b, l, d, h, bias, exact, 1.0, gen=gen, iters=20, device=True)}
        if args.plans and hasattr(ba, "bwd_candidates"):
            case["plan"] = ba.bwd_plan(l, d // h)
            case["plan_device_ms"] = _fused_bwd_plan_device_ms(
                cs, ba, b, l, d, h, bias, exact, gen, iters=20)
        cases.append(case)
    for b, lq, lk, h, hd, q_scale in (
            cs.FLASH_SHAPES if "flash" in kernels else ()):
        case = cs._flash_case(b, lq, lk, h, hd, q_scale, gen=gen)
        if args.plans:
            plan = fa.launch_plan(lq, lk, hd)
            case["plan"] = {"fwd": plan.fwd, "bwd": plan.bwd}
            case["plan_device_ms"] = _plan_device_ms(
                cs, fa, b, lq, lk, h, hd, q_scale, gen, iters=20)
        cases.append(case)
    if "patch" in kernels:
        cases.append({"name": "patch embed", **cs._patch_embed(gen)})
    if "deferred" in kernels:
        cases.append({"name": "attn sweep", **cs._sweep()})
    print(json.dumps({**out, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
