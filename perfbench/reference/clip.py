"""The plain reference: CLIPA's two towers, loss and optimizer in float32.

Written from the configurations' equations (``perfbench/configs/*.json``)
in plain PyTorch, with no kernel, no cache and no batching trick. It
imports nothing of the program and takes none of its weights: the
benchmark makes the weights from the seed (``perfbench/weights.py``) and
hands the same tensors to both sides.

Parameters are a {name: tensor} dict keyed by the CLIPA checkpoint's flat
names, each matrix in the (out, in) layout of a linear layer; the patch
kernel is (p, p, 3, width). :func:`param_specs` lists them for a
configuration.

Equations (pre-LN ViT and text transformer, CLIPA/big_vision):
  image: x = patches(normalize(u8)) @ K_patch; [cls; x] + posemb;
         per block x += Attn(LN0(x)); x += MLP(LN1(x));
         gap: LN_enc(mean of the patch tokens); z = head(.)
  text:  x = Embed[ids] + posemb[:l]; the same blocks; LN_enc; last token;
         z = head(.)
  Attn:  softmax(q k^T / sqrt(hd)) v per head, q/k/v/out with biases
  MLP:   Dense_1(gelu_tanh(Dense_0(x)))
  both embeddings L2-normalized with a 1e-8 floor on the norm;
  loss:  the bidirectional InfoNCE, logits = zi zt^T exp(t).
Every product runs in float32 with TF32 off (:func:`fp32_products`).

The port clips attention scores at +-70 inside its kernels; with these
weights the scores are O(1), so the clip never binds and the reference
keeps the published softmax.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint

# ImageNet statistics on the uint8 scale (CLIPA's "vgg_value_range")
MEAN_255 = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD_255 = (0.229 * 255, 0.224 * 255, 0.225 * 255)

BLOCK_LEAVES = (
    ("LayerNorm_0/scale", "scale"), ("LayerNorm_0/bias", "bias"),
    ("MultiHeadDotProductAttention_0/query/kernel", "qkv"),
    ("MultiHeadDotProductAttention_0/query/bias", "bias"),
    ("MultiHeadDotProductAttention_0/key/kernel", "qkv"),
    ("MultiHeadDotProductAttention_0/key/bias", "bias"),
    ("MultiHeadDotProductAttention_0/value/kernel", "qkv"),
    ("MultiHeadDotProductAttention_0/value/bias", "bias"),
    ("MultiHeadDotProductAttention_0/out/kernel", "out"),
    ("MultiHeadDotProductAttention_0/out/bias", "bias"),
    ("LayerNorm_1/scale", "scale"), ("LayerNorm_1/bias", "bias"),
    ("MlpBlock_0/Dense_0/kernel", "fc"), ("MlpBlock_0/Dense_0/bias", "bias"),
    ("MlpBlock_0/Dense_1/kernel", "proj"), ("MlpBlock_0/Dense_1/bias", "bias"),
)


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


def _block_specs(prefix: str, width: int, mlp: int) -> list:
    shapes = {"scale": (width,), "qkv": (width, width), "out": (width, width),
              "fc": (mlp, width), "proj": (width, mlp)}
    out = []
    for leaf, kind in BLOCK_LEAVES:
        if kind == "bias":
            n = mlp if leaf.endswith("Dense_0/bias") else width
            shape = (n,)
        else:
            shape = shapes[kind]
        fan_in = shape[1] if len(shape) == 2 else None
        out.append((f"{prefix}/{leaf}", shape, kind, fan_in))
    return out


def param_specs(cfg: dict, route: dict, towers=("img", "txt")) -> list:
    """[(name, shape, kind, fan_in)] of every parameter of the two towers
    that `cfg` (a configuration file) and `route` (its ``routes`` entry)
    describe. kind: scale, bias, qkv, out, fc, proj, patch, head, cls,
    posemb, embed, t."""
    specs = []
    if "txt" in towers:
        t = cfg["text"]
        w = t["width"]
        specs.append(("t", (1,), "t", None))
        if t["posemb"] == "learn":
            specs.append(("txt/pos_embedding", (1, route["token_len"], w),
                          "posemb", None))
        specs.append(("txt/Embed_0/embedding", (t["vocab_size"], w), "embed",
                      None))
        for i in range(t["depth"]):
            specs += _block_specs(f"txt/Transformer/encoderblock_{i}", w,
                                  t["mlp_dim"])
        specs += [("txt/encoder_norm/scale", (w,), "scale", None),
                  ("txt/encoder_norm/bias", (w,), "bias", None),
                  ("txt/head/kernel", (cfg["embed_dim"], w), "head", w)]
    if "img" in towers:
        v = cfg["image"]
        w, p = v["width"], v["patch_size"]
        grid = route["image_size"] // p
        specs.append(("img/cls", (1, 1, w), "cls", None))
        if route["image_posemb"] == "learn":
            specs.append(("img/pos_embedding", (1, grid * grid + 1, w),
                          "posemb", None))
        specs.append(("img/embedding/kernel", (p, p, 3, w), "patch",
                      p * p * 3))
        for i in range(v["depth"]):
            specs += _block_specs(f"img/Transformer/encoderblock_{i}", w,
                                  v["mlp_dim"])
        specs += [("img/encoder_norm/scale", (w,), "scale", None),
                  ("img/encoder_norm/bias", (w,), "bias", None),
                  ("img/head/kernel", (cfg["embed_dim"], w), "head", w)]
    return specs


def decayed(specs: list) -> set:
    """Names that take weight decay: every kernel (the projections, the MLP,
    the patch stem and the heads), as CLIPA's ``.*/kernel$`` rule says."""
    return {n for n, _, _, _ in specs if n.endswith("/kernel")}


def posemb_sincos_2d(h: int, w: int, width: int,
                     temperature: float = 10_000.) -> torch.Tensor:
    """(1 + h*w, width) fixed 2-D sin-cos table, [sin x | cos x | sin y |
    cos y], a zero row for the cls token (MoCo v3 / big_vision)."""
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


def _block(x, p, prefix, heads, eps):
    """One pre-LN block over (n, l, width) float32."""
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


def _blocks(x, p, tower, depth, heads, eps, remat):
    for i in range(depth):
        prefix = f"{tower}/Transformer/encoderblock_{i}"
        if remat and torch.is_grad_enabled():
            x = checkpoint.checkpoint(_block, x, p, prefix, heads, eps,
                                      use_reentrant=False)
        else:
            x = _block(x, p, prefix, heads, eps)
    return x


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN_255, device=images_u8.device)
    std = torch.tensor(STD_255, device=images_u8.device)
    return (images_u8.float() - mean) / std


def _l2(z):
    return z / (torch.linalg.norm(z, dim=1, keepdim=True) + 1e-8)


def kept_tokens(seed: int, step: int, n: int, patches: int,
                mask_ratio: float, device) -> torch.Tensor:
    """(n, kept) indices of the patch tokens that unmask-tuning keeps at
    `step`, by CLIPA's rule as the port draws it: iid uniform noise per
    patch token from a torch.Generator on `device` seeded by
    ``SeedSequence([seed, step])``, the ``int(patches * (1 - mask_ratio))``
    tokens of least noise kept (a stable sort)."""
    state = np.random.SeedSequence([int(seed), int(step)])
    g = torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]))
    noise = torch.rand((n, patches), generator=g, device=device)
    kept = int(patches * (1 - mask_ratio))
    return torch.argsort(noise, dim=1, stable=True)[:, :kept]


def embed_images(p: dict, images_u8: torch.Tensor, cfg: dict, route: dict,
                 remat: bool = False,
                 keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, H, W, 3) uint8 -> (n, embed_dim) L2-normalized float32. `keep`:
    the (n, kept) patch tokens unmask-tuning keeps after the position
    table is added (cls always stays)."""
    v = cfg["image"]
    pp, w = v["patch_size"], v["width"]
    x = normalize(images_u8)
    n, hh, ww, c = x.shape
    h, g = hh // pp, ww // pp
    x = x.reshape(n, h, pp, g, pp, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h * g, pp * pp * c)
    x = x @ p["img/embedding/kernel"].reshape(pp * pp * c, w)
    x = torch.cat([p["img/cls"].expand(n, 1, w), x], 1)
    if route["image_posemb"] == "learn":
        x = x + p["img/pos_embedding"]
    else:
        x = x + posemb_sincos_2d(h, g, w).to(x.device)
    if keep is not None:
        kept = torch.gather(x[:, 1:], 1, keep[:, :, None].expand(-1, -1, w))
        x = torch.cat([x[:, :1], kept], 1)
    x = _blocks(x, p, "img", v["depth"], v["num_heads"], route["image_ln_eps"],
                remat)
    x = _ln(x[:, 1:].mean(1), p, "img/encoder_norm", route["image_ln_eps"])
    return _l2(F.linear(x, p["img/head/kernel"]))


def embed_texts(p: dict, ids: torch.Tensor, cfg: dict, route: dict,
                remat: bool = False) -> torch.Tensor:
    """(n, l) token ids -> (n, embed_dim) L2-normalized float32."""
    t = cfg["text"]
    x = F.embedding(ids.long(), p["txt/Embed_0/embedding"])
    x = x + p["txt/pos_embedding"][:, :x.shape[1]]
    x = _blocks(x, p, "txt", t["depth"], t["num_heads"], t["ln_eps"], remat)
    x = _ln(x, p, "txt/encoder_norm", t["ln_eps"])[:, -1]
    return _l2(F.linear(x, p["txt/head/kernel"]))


def contrastive_loss(zimg: torch.Tensor, ztxt: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """The mean bidirectional InfoNCE of a batch (labels on the diagonal)."""
    logits = zimg @ ztxt.T * torch.exp(t)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def train_loss(p: dict, images_u8, ids, cfg: dict, route: dict,
               remat: bool = True, keep=None) -> torch.Tensor:
    """The step's loss over the whole batch; `remat` recomputes each block
    in the backward, so a full-size batch fits in float32."""
    zimg = embed_images(p, images_u8, cfg, route, remat, keep)
    ztxt = embed_texts(p, ids, cfg, route, remat)
    return contrastive_loss(zimg, ztxt, p["t"])


class Adam:
    """optax's ``scale_by_adam`` chain as CLIPA configures it: Adam
    direction (first moment stored in `mu_dtype`; ``b1 * mu`` formed in that
    dtype, the update from the unrounded float32 moment), + wd * param on
    the decayed names, x lr x schedule(count), subtracted. The schedule is a
    linear warmup times a cosine decay over ``total_steps``."""

    def __init__(self, params: dict, opt: dict, decay: set):
        self.opt = opt
        self.decay = decay
        self.count = int(opt["start_count"])
        self.mu_dtype = getattr(torch, opt["mu_dtype"])
        self.mu = {n: torch.zeros_like(x, dtype=self.mu_dtype)
                   for n, x in params.items()}
        self.nu = {n: torch.zeros_like(x) for n, x in params.items()}

    def schedule(self, count: int) -> float:
        warm, total = self.opt["warmup_steps"], self.opt["total_steps"]
        gain = min(1.0, count / warm) if warm else 1.0
        frac = min(max((count - warm) / float(total - warm), 0.0), 1.0)
        return float(np.float32(0.5 * (1.0 + math.cos(math.pi * frac))
                                * gain))

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        b1, b2, eps = self.opt["b1"], self.opt["b2"], self.opt["eps"]
        c = self.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(c))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(c))
        lr = self.opt["lr"] * self.schedule(self.count)
        for n, x in params.items():
            g = grads[n].float()
            mu = g * (1 - b1) + self.mu[n] * torch.tensor(
                b1, dtype=self.mu_dtype)
            nu = (g * g) * (1 - b2) + self.nu[n] * b2
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if n in self.decay:
                u = u + x * self.opt["wd"]
            x.sub_(u * lr)
            self.mu[n] = mu.to(self.mu_dtype)
            self.nu[n] = nu
        self.count = c


def train_steps(params: dict, batches, cfg: dict, route: dict, opt: dict,
                decay: set, remat: bool = True) -> dict:
    """Runs ``len(batches)`` steps of the float32 reference from `params`
    (updated in place); a batch is (images, ids, kept tokens or None).
    Returns {"losses": [...], "grad_norms": {name: norm of step 1's
    gradient}}."""
    adam = Adam(params, opt, decay)
    losses, grad_norms = [], None
    names = list(params)
    with fp32_products():
        for images, ids, keep in batches:
            leaves = [params[n].requires_grad_() for n in names]
            loss = train_loss(params, images, ids, cfg, route, remat, keep)
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


def image_embeddings(params: dict, images_u8: torch.Tensor, cfg: dict,
                     route: dict, rows: int = 64,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Embeddings of host or device uint8 images in blocks of `rows`."""
    out = []
    with torch.no_grad(), fp32_products():
        for i in range(0, images_u8.shape[0], rows):
            x = images_u8[i:i + rows].to(device or images_u8.device)
            out.append(embed_images(params, x, cfg, route))
    return torch.cat(out)
