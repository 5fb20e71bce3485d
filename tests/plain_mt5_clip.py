"""Plain reference of open_clip's mt5-*-ViT-* on CLIPA's image tower.

The two towers' forward, the InfoNCE loss and its gradients in float32
plain ``torch``, TF32 off, written from the equations; it imports nothing
of ``clipa_tpu_torch`` and nothing of JAX. Parameters are a {name: tensor}
dict under the port's flat names (``optim.named_parameters``), each matrix
in the (out, in) layout of a linear layer, the patch kernel (p, p, 3,
width).

Image (CLIPA's pre-LN ViT, big_vision):
  x = patches(normalized image) @ K_patch; [cls; x] + posemb (sincos2d or
  learned); per block x += Attn(LN0(x)); x += MLP(LN1(x)), Attn with q/k/v/out
  biases and scores q k^T / sqrt(hd), MLP Dense_1(gelu_tanh(Dense_0(.)));
  gap: LN_enc(mean of the patch tokens); z = head(.).

Text (the mT5 encoder, T5 v1.1 / mT5, and open_clip's HF text tower):
  keep = ids != pad; x = Embed[ids];
  bias[h, i, j] = table[bucket(j - i), h], the one table of every block;
  per block:
    y = RMS(x) * g0, RMS(x) = x / sqrt(mean(x^2) + eps);
    s = q k^T + bias (unscaled, no projection biases); s[.., j] = finfo.min
    where key j is a pad; x += (softmax(s) v) W_o;
    y = RMS(x) * g1; x += (gelu_tanh(y W_i0) * (y W_i1)) W_o;
  x = RMS(x) * g_final; pooled = sum(x * keep) / max(sum(keep), 1)
  (open_clip's mean_pooler, the count floored at 1);
  z = gelu(pooled W_fc) W_head (the ``mlp`` projection, exact GELU, no
  biases).

bucket (T5's bidirectional relative_position_bucket, 32 buckets, max
distance 128): the sign takes half the buckets; |r| < 8 is its own bucket;
else 8 + int(log(|r| / 8 + 1e-6) / log(128 / 8) * 8), at most 15.
Departure from HF: the ``+ 1e-6`` inside the log, which the JAX package
adds and the port keeps (ROADMAP); HF has none. In float32 it moves no
bucket at any distance from 8 to 1999 (checked when this was written).

Both embeddings are L2-normalized with a 1e-8 floor on the norm; the loss
is the mean bidirectional InfoNCE of logits zi zt^T exp(t).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet statistics on the uint8 scale (CLIPA's "vgg_value_range")
MEAN_255 = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD_255 = (0.229 * 255, 0.224 * 255, 0.225 * 255)


@contextlib.contextmanager
def fp32_products():
    """float32 matrix products with TF32 off (restored on exit)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def posemb_sincos_2d(h: int, w: int, width: int,
                     temperature: float = 10_000.) -> torch.Tensor:
    """(1 + h*w, width): [sin x | cos x | sin y | cos y], a zero cls row."""
    y, x = np.mgrid[:h, :w]
    omega = 1.0 / temperature ** (np.arange(width // 4) / (width // 4 - 1))
    y = y.reshape(-1)[:, None] * omega[None]
    x = x.reshape(-1)[:, None] * omega[None]
    pe = np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], 1)
    pe = np.concatenate([np.zeros((1, width)), pe], 0)
    return torch.as_tensor(pe, dtype=torch.float32)


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}/scale"],
                        p[f"{name}/bias"], eps)


def _vit_block(x, p, prefix, heads, eps):
    n, l, w = x.shape
    hd = w // heads
    a = f"{prefix}/MultiHeadDotProductAttention_0"
    y = _ln(x, p, f"{prefix}/LayerNorm_0", eps)
    q, k, v = (F.linear(y, p[f"{a}/{s}/kernel"], p[f"{a}/{s}/bias"])
               .reshape(n, l, heads, hd).transpose(1, 2)
               for s in ("query", "key", "value"))
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(n, l, w)
    x = x + F.linear(o, p[f"{a}/out/kernel"], p[f"{a}/out/bias"])
    m = f"{prefix}/MlpBlock_0"
    y = _ln(x, p, f"{prefix}/LayerNorm_1", eps)
    y = F.gelu(F.linear(y, p[f"{m}/Dense_0/kernel"], p[f"{m}/Dense_0/bias"]),
               approximate="tanh")
    return x + F.linear(y, p[f"{m}/Dense_1/kernel"], p[f"{m}/Dense_1/bias"])


def _l2(z):
    return z / (torch.linalg.norm(z, dim=1, keepdim=True) + 1e-8)


def embed_images(p: dict, images_u8: torch.Tensor, image: dict
                 ) -> torch.Tensor:
    """(n, H, W, 3) uint8 -> (n, E) L2-normalized. `image`: patch_size,
    width, depth, num_heads, posemb ("sincos2d" or "learn"), ln_eps."""
    pp, w = image["patch_size"], image["width"]
    mean = torch.tensor(MEAN_255, device=images_u8.device)
    std = torch.tensor(STD_255, device=images_u8.device)
    x = (images_u8.float() - mean) / std
    n, hh, ww, c = x.shape
    h, g = hh // pp, ww // pp
    x = x.reshape(n, h, pp, g, pp, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h * g, pp * pp * c)
    x = x @ p["img/embedding/kernel"].reshape(pp * pp * c, w)
    x = torch.cat([p["img/cls"].expand(n, 1, w), x], 1)
    if image["posemb"] == "learn":
        x = x + p["img/pos_embedding"]
    else:
        x = x + posemb_sincos_2d(h, g, w).to(x.device)
    for i in range(image["depth"]):
        x = _vit_block(x, p, f"img/Transformer/encoderblock_{i}",
                       image["num_heads"], image["ln_eps"])
    x = _ln(x[:, 1:].mean(1), p, "img/encoder_norm", image["ln_eps"])
    return _l2(F.linear(x, p["img/head/kernel"]))


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional bucket of each relative position (module
    docstring; the log in float32)."""
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


def _t5_block(x, p, i, bias, keep, text):
    heads, hd, eps = text["num_heads"], text["head_dim"], text["ln_eps"]
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


def embed_texts(p: dict, ids: torch.Tensor, text: dict) -> torch.Tensor:
    """(n, l) mT5 ids -> (n, E) L2-normalized. `text`: depth, num_heads,
    head_dim, ln_eps, pad_id, rel_buckets, rel_max_distance."""
    ids = ids.long()
    keep = ids != text["pad_id"]
    x = p["txt/word_embeddings/embedding"][ids]
    pos = torch.arange(ids.shape[1], device=ids.device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                       text["rel_buckets"],
                                       text["rel_max_distance"])
    bias = p["txt/relative_attention_bias"][buckets].permute(2, 0, 1)[None]
    for i in range(text["depth"]):
        x = _t5_block(x, p, i, bias, keep, text)
    x = _rms(x, p["txt/final_norm/scale"], text["ln_eps"])
    m = keep[..., None].float()
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    z = F.linear(F.gelu(F.linear(pooled, p["txt/proj_fc/kernel"])),
                 p["txt/head/kernel"])
    return _l2(z)


def contrastive_loss(zimg, ztxt, t):
    """The mean bidirectional InfoNCE (labels on the diagonal)."""
    logits = zimg @ ztxt.T * torch.exp(t)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def loss_and_grads(p: dict, images_u8, ids, image: dict, text: dict):
    """(loss, {name: gradient}) of the batch, float32 with TF32 off."""
    names = list(p)
    leaves = [p[n].detach().float().requires_grad_() for n in names]
    q = dict(zip(names, leaves))
    with fp32_products():
        loss = contrastive_loss(embed_images(q, images_u8, image),
                                embed_texts(q, ids, text), q["t"])
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))
