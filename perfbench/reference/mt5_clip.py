"""The plain reference of open_clip's mt5-xl-ViT-H-14 on CLIPA's H/14 image
tower, in float32: the towers, the loss and the training steps.

The benchmark's copy of the repository's ``tests/plain_mt5_clip.py`` (the
CPU tests hold the two to each other): the text tower is written from the
equations here; the image tower, the InfoNCE, Adam and the TF32 switch are
``reference/clip.py``'s, used as they are. It imports nothing of the
program. Parameters are a {name: tensor} dict under the program's flat
names, each matrix in the (out, in) layout of a linear layer.

Text (the mT5 encoder, T5 v1.1, with open_clip's mean pool and ``mlp``
projection):
  keep = ids != pad; x = Embed[ids];
  bias[h, i, j] = table[bucket(j - i), h], one table for every block;
  per block:
    y = RMS(x) * g0, RMS(x) = x / sqrt(mean(x^2) + eps);
    s = q k^T + bias (unscaled, no projection biases); pad keys at
    finfo(float32).min; x += (softmax(s) v) W_o;
    y = RMS(x) * g1; x += (gelu_tanh(y W_i0) * (y W_i1)) W_o;
  x = RMS(x) * g_final; pooled = sum(x * keep) / max(sum(keep), 1);
  z = gelu(pooled W_fc) W_head (exact GELU, no biases), L2-normalized.
bucket: T5's bidirectional relative_position_bucket (32 buckets, max
distance 128) with the ``+ 1e-6`` inside the log that the JAX package adds
and the program keeps (HF has none; it moves no bucket at these lengths).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from perfbench.reference import clip


def param_specs(cfg: dict, route: dict) -> list:
    """[(name, shape, kind, fan_in)] of the image tower (``clip``'s), ``t``
    and the mT5 text tower. Scales follow T5's own initializer (HF's
    ``T5PreTrainedModel._init_weights``): q by (width * head_dim)^-1/2, k,
    v and the feed-forward's inputs by width^-1/2, o and wo by their fan-in,
    the ids' table N(0, 1); the position-bias table N(0, 1), a trained
    table's order of size, so that its gradient is seen."""
    t = cfg["text"]
    w, inner = t["width"], t["num_heads"] * t["head_dim"]
    m, hid = t["mlp_dim"], t["proj_hidden"]
    specs = clip.param_specs(cfg, route, towers=("img",))
    specs += [("t", (1,), "t", None),
              ("txt/relative_attention_bias",
               (t["rel_buckets"], t["num_heads"]), "embed", 1),
              ("txt/word_embeddings/embedding", (t["vocab_size"], w),
               "embed", 1)]
    for i in range(t["depth"]):
        b = f"txt/block_{i}"
        specs += [(f"{b}_ln0/scale", (w,), "scale", None),
                  (f"{b}_attn/q/kernel", (inner, w), "qkv",
                   w * t["head_dim"]),
                  (f"{b}_attn/k/kernel", (inner, w), "qkv", w),
                  (f"{b}_attn/v/kernel", (inner, w), "qkv", w),
                  (f"{b}_attn/o/kernel", (w, inner), "out", inner),
                  (f"{b}_ln1/scale", (w,), "scale", None),
                  (f"{b}_wi0/kernel", (m, w), "fc", w),
                  (f"{b}_wi1/kernel", (m, w), "fc", w),
                  (f"{b}_wo/kernel", (w, m), "proj", m)]
    specs += [("txt/final_norm/scale", (w,), "scale", None),
              ("txt/proj_fc/kernel", (hid, w), "head", w),
              ("txt/head/kernel", (cfg["embed_dim"], hid), "head", hid)]
    return specs


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional bucket of each relative position (the module
    docstring), the log in float32."""
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    far = exact + (torch.log(n.float() / exact + 1e-6)
                   / math.log(max_distance / exact)
                   * (half - exact)).long()
    far = torch.clamp(far, max=half - 1)
    return out + torch.where(n < exact, n, far)


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _block(x, p, i, bias, keep, t):
    """One mT5 block over (n, l, width) float32."""
    heads, hd, eps = t["num_heads"], t["head_dim"], t["ln_eps"]
    n, l, _ = x.shape
    b = f"txt/block_{i}"
    y = _rms(x, p[f"{b}_ln0/scale"], eps)
    q, k, v = (F.linear(y, p[f"{b}_attn/{s}/kernel"])
               .reshape(n, l, heads, hd).transpose(1, 2)
               for s in ("q", "k", "v"))
    s = q @ k.transpose(-1, -2) + bias
    s = s.masked_fill(~keep[:, None, None, :], torch.finfo(torch.float32).min)
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(n, l, -1)
    x = x + F.linear(o, p[f"{b}_attn/o/kernel"])
    y = _rms(x, p[f"{b}_ln1/scale"], eps)
    y = (F.gelu(F.linear(y, p[f"{b}_wi0/kernel"]), approximate="tanh")
         * F.linear(y, p[f"{b}_wi1/kernel"]))
    return x + F.linear(y, p[f"{b}_wo/kernel"])


def embed_texts(p: dict, ids: torch.Tensor, cfg: dict,
                remat: bool = False) -> torch.Tensor:
    """(n, l) mT5 ids (pads at ``pad_id``) -> (n, embed_dim) L2-normalized
    float32; `remat` recomputes each block in the backward."""
    t = cfg["text"]
    ids = ids.long()
    keep = ids != t["pad_id"]
    x = p["txt/word_embeddings/embedding"][ids]
    pos = torch.arange(ids.shape[1], device=ids.device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                       t["rel_buckets"],
                                       t["rel_max_distance"])
    bias = p["txt/relative_attention_bias"][buckets].permute(2, 0, 1)[None]
    for i in range(t["depth"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint.checkpoint(_block, x, p, i, bias, keep, t,
                                      use_reentrant=False)
        else:
            x = _block(x, p, i, bias, keep, t)
    x = _rms(x, p["txt/final_norm/scale"], t["ln_eps"])
    m = keep[..., None].float()
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    z = F.linear(F.gelu(F.linear(pooled, p["txt/proj_fc/kernel"])),
                 p["txt/head/kernel"])
    return z / (torch.linalg.norm(z, dim=1, keepdim=True) + 1e-8)


def train_loss(p: dict, images_u8, ids, cfg: dict, route: dict,
               remat: bool = True) -> torch.Tensor:
    """The step's InfoNCE over the whole batch."""
    zimg = clip.embed_images(p, images_u8, cfg, route, remat)
    ztxt = embed_texts(p, ids, cfg, remat)
    return clip.contrastive_loss(zimg, ztxt, p["t"])


def train_steps(params: dict, batches, cfg: dict, route: dict, opt: dict,
                decay: set, remat: bool = True) -> dict:
    """``len(batches)`` steps of the float32 reference from `params`
    (updated in place), with ``clip.Adam``; a batch is (images, ids).
    Returns {"losses": [...], "grad_norms": {name: norm of step 1's
    gradient}}."""
    adam = clip.Adam(params, opt, decay)
    losses, grad_norms = [], None
    names = list(params)
    with clip.fp32_products():
        for images, ids in batches:
            leaves = [params[n].requires_grad_() for n in names]
            loss = train_loss(params, images, ids, cfg, route, remat)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            for x in leaves:
                x.requires_grad_(False)
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = {n: float(torch.linalg.norm(g.float()))
                              for n, g in grads.items()}
            adam.step(params, grads)
            del grads, loss
    return {"losses": losses, "grad_norms": grad_norms}
