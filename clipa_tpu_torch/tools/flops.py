"""FLOPs / parameter counting CLI (the reference's training/profile.py).

    python -m clipa_tpu_torch.tools.flops --model ViT-H-14-CL32-GAP-BigVision
    python -m clipa_tpu_torch.tools.flops --variant L/16 --res 112 --tokens 8

Port of ``clipa_tpu/tools/flops.py``. The model is built on the ``meta``
device (no memory, no weights) and its forward runs there under
``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products (2 per multiply-add) of the program that runs. XLA's cost analysis
in the reference also counts elementwise work, a few percent of a ViT's
total; torch keeps no count of bytes accessed, so that field is None.
Attention is counted on its einsum path (the fused kernel's plain version
and the kernels cannot run on ``meta``): the same products.
"""

from __future__ import annotations

import argparse

import torch


def analyze(model, image_shape, text_shape) -> dict:
    """{"params_m", "fwd_gflops", "bytes_accessed_mb"} of `model`'s forward
    on (B, H, W, 3) images and (B, L) tokens. `model` is moved to ``meta``
    (build it there: ``with torch.device("meta"): ...``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from clipa_tpu_torch.models import layers

    model = model.to("meta")
    for m in model.modules():
        if isinstance(m, layers.MultiHeadAttention):
            m.attn_impl = "einsum"
    n_params = sum(p.numel() for p in model.parameters())
    image = torch.zeros(image_shape, device="meta")
    text = torch.zeros(text_shape, dtype=torch.int32, device="meta")
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(image, text)
    return {
        "params_m": float(n_params) / 1e6,
        "fwd_gflops": counter.get_total_flops() / 1e9,
        "bytes_accessed_mb": None,
    }


def main(argv=None) -> dict:
    from clipa_tpu_torch.models import two_towers

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", help="open_clip config name")
    p.add_argument("--variant", default="B/16", help="ViT variant")
    p.add_argument("--res", type=int, default=224)
    p.add_argument("--tokens", type=int, default=32)
    p.add_argument("--batch", type=int, default=1)
    args = p.parse_args(argv)

    if args.model:
        from clipa_tpu_torch.compat import openclip
        cfg = openclip.get_model_config(args.model)
        res = args.res or cfg["vision_cfg"]["image_size"]
        tokens = cfg["text_cfg"]["context_length"]
        kw = openclip._to_two_towers_cfg(cfg, image_size=res)
    else:
        tv = args.variant.split("/")[0]
        res, tokens = args.res, args.tokens
        kw = dict(image={"variant": args.variant, "pool_type": "gap",
                         "posemb": "sincos2d", "image_size": (res, res)},
                  text={"variant": tv, "pool_type": "last",
                        "vocab_size": 32000, "context_length": tokens},
                  out_dim=512, temperature_init=1 / 0.07)
    with torch.device("meta"):
        model = two_towers.Model(**kw)
    stats = analyze(model, (args.batch, res, res, 3), (args.batch, tokens))
    print(f"params: {stats['params_m']:.1f}M")
    print(f"forward GFLOPs (batch {args.batch}): {stats['fwd_gflops']:.2f}")
    print("bytes accessed: not counted by torch")
    return stats


if __name__ == "__main__":
    main()
