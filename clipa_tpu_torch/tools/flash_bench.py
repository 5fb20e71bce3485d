"""Times the flash attention kernels (K7 forward, K8 backward) of one
checkout at the phase-6 shapes of ``chip_smoke.py``.

    python clipa_tpu_torch/tools/flash_bench.py [--root DIR] [--plans]

Runs this checkout's ``chip_smoke._flash_case`` at each of its
``FLASH_SHAPES`` on the ``clipa_tpu_torch`` package under `--root`
(default: this checkout): the kernels against their plain versions, the
backward twice bit for bit, kernel and SDPA times by CUDA events and by
device time, and the bounds. So two commits are measured by the same code
in turns on one card: unpack the other one with ``git archive`` into a
directory that .gitignore lists and run this file, by path, once with each
root. The last line is one JSON object: the card and the cases.

`--plans` adds to each case, under ``plan_device_ms``, the device time of
the forward under every split of ``fwd_candidates`` and, where
``launch_plan`` fuses the backward, of the split backward
(``bwd_split_plan``): the measurements behind the plan's choices (for a
root whose package has them). Needs a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--plans", action="store_true",
                        help="also time every forward split that the plan "
                        "weighs, and the split backward where it fuses")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from clipa_tpu_torch.ops import flash_attention as fa
    if not os.path.abspath(fa.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {fa.__file__}, not the package under "
                           f"{root}: run this file by path")
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cases = []
    for b, lq, lk, h, hd, q_scale in cs.FLASH_SHAPES:
        case = cs._flash_case(b, lq, lk, h, hd, q_scale, gen=gen)
        if args.plans:
            plan = fa.launch_plan(lq, lk, hd)
            case["plan"] = {"fwd": plan.fwd, "bwd": plan.bwd}
            case["plan_device_ms"] = _plan_device_ms(
                cs, fa, b, lq, lk, h, hd, q_scale, gen, iters=20)
        cases.append(case)
    print(json.dumps({"root": root, "card": cs._card(), "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
