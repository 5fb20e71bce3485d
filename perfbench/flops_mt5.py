"""Analytic matrix-product FLOPs of the mT5 two-towers step, 2 per
multiply-add, beside ``flops.py`` (which it uses for the image tower and
the loss, unchanged).

The T5 blocks are counted over every slot of the ids, pads included (the
program computes them): per block the q, k, v and o projections
(8 L D I, I = heads x head_dim), the gated feed-forward's three matrices
(6 L D F), the scores and the weighted sum (4 L^2 I); then the ``mlp``
projection (2 (D P + P E)). The lookup of the ids, the position bias and
the RMSNorms are no products. A training step is 3x the forward; remat's
recompute is never counted.
"""

from __future__ import annotations

from perfbench import flops


def t5_text_forward(cfg: dict, token_len: int) -> float:
    """One caption of `token_len` ids through the mT5 tower."""
    t = cfg["text"]
    w, inner, m = t["width"], t["num_heads"] * t["head_dim"], t["mlp_dim"]
    per_block = (8 * token_len * w * inner + 6 * token_len * w * m
                 + 4 * token_len ** 2 * inner)
    hid = t["proj_hidden"]
    return float(t["depth"] * per_block
                 + 2.0 * (w * hid + hid * cfg["embed_dim"]))


def train_step_per_pair(cfg: dict, image_size: int, token_len: int,
                        batch: int) -> float:
    """A training step's FLOPs per image-text pair: 3x the forward."""
    return 3.0 * (flops.image_forward(cfg, image_size)
                  + t5_text_forward(cfg, token_len)
                  + flops.loss_per_pair(cfg, batch))
