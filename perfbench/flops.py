"""Analytic matrix-product FLOPs of CLIPA's towers, 2 per multiply-add.

Counted from the configuration's shapes alone: every product of the
forward over the tokens the step keeps (the patch embedding over the kept
patches only), the attention's two L x L products, the heads, and the
loss's B x B logits. A training step is 3x its forward; remat's recompute
is never counted. Elementwise work (LayerNorm, GELU, softmax) is left out,
as a model-FLOPs utilization leaves it out.
"""

from __future__ import annotations


def encoder(tokens: int, width: int, depth: int, mlp: int) -> float:
    """One sequence through `depth` pre-LN blocks: q, k, v and out
    projections (8 L D^2), the MLP (4 L D M), the scores and the weighted
    sum (4 L^2 D)."""
    per_block = (8 * tokens * width ** 2 + 4 * tokens * width * mlp
                 + 4 * tokens ** 2 * width)
    return float(depth * per_block)


def image_forward(cfg: dict, image_size: int, mask_ratio: float = 0.0
                  ) -> float:
    """One image: the kept patches' embedding, the encoder over the kept
    patches and cls, the head."""
    v = cfg["image"]
    p, w = v["patch_size"], v["width"]
    patches = (image_size // p) ** 2
    kept = int(patches * (1 - mask_ratio))
    return (2.0 * kept * p * p * 3 * w
            + encoder(kept + 1, w, v["depth"], v["mlp_dim"])
            + 2.0 * w * cfg["embed_dim"])


def text_forward(cfg: dict, token_len: int) -> float:
    """One caption: the encoder and the head (the lookup is no product)."""
    t = cfg["text"]
    return (encoder(token_len, t["width"], t["depth"], t["mlp_dim"])
            + 2.0 * t["width"] * cfg["embed_dim"])


def loss_per_pair(cfg: dict, batch: int) -> float:
    """The B x B logits' share of one pair: 2 B E."""
    return 2.0 * batch * cfg["embed_dim"]


def train_step_per_pair(cfg: dict, image_size: int, token_len: int,
                        batch: int, mask_ratio: float = 0.0) -> float:
    """A training step's FLOPs per image-text pair: 3x the forward."""
    return 3.0 * (image_forward(cfg, image_size, mask_ratio)
                  + text_forward(cfg, token_len)
                  + loss_per_pair(cfg, batch))
