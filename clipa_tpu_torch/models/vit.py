"""ViT image tower.

Port of ``clipa_tpu/models/vit.py``: conv patch stem, cls token, learned or
sincos2d position embeddings, CLIPA's random token masking for
unmask-tuning (:func:`random_masking`, ``mask_ratio > 0``), optional
``ln_pre``, pre-LN encoder over a flat residual stream (``remat_policy``
"minimal" as in models/layers.py), pools ``gap`` / ``gap_all`` / ``tok`` /
``0``, the no-bias projection head, and position-embedding resampling for
checkpoints of another resolution (:func:`resample_posemb`, :func:`load`).
Input is NHWC, as in the JAX tower. Parameters are fp32; `dtype` is the
compute dtype (None: the image's), to which the stem, cls, posemb and every
layer cast at use. Gradients flow in ``train()`` mode as in ``eval()`` mode
(no dropout is ported at a rate above 0).

Not ported yet: ``map`` pooling and the ``linear`` patch stem.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import common, layers


def posemb_sincos_2d(h: int, w: int, width: int, temperature: float = 10_000.,
                     cls_token: bool = False) -> torch.Tensor:
    """Fixed 2D sin-cos position embedding, (1, [1 +] h*w, width) fp32:
    layout [sin x | cos x | sin y | cos y], a zero row for the cls token."""
    if width % 4:
        raise ValueError("sincos2d needs width % 4 == 0")
    y, x = np.mgrid[:h, :w]
    omega = np.arange(width // 4) / (width // 4 - 1)
    omega = 1.0 / (temperature ** omega)
    y = np.einsum("m,d->md", y.flatten(), omega)
    x = np.einsum("m,d->md", x.flatten(), omega)
    pe = np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1)
    if cls_token:
        pe = np.concatenate([np.zeros((1, width)), pe], axis=0)
    return torch.as_tensor(pe, dtype=torch.float32)[None]


def random_masking(x: torch.Tensor, mask_ratio: float,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None):
    """Keeps a random (1 - mask_ratio) subset of the tokens of each sample.

    CLIPA-v2's image-token reduction for unmask-tuning: iid uniform noise
    per token (`noise`, (n, l), or drawn from `generator`, which must live
    on x's device), keep the ``int(l * (1 - mask_ratio))`` tokens of least
    noise (a stable argsort, as ``jnp.argsort``). Returns (kept tokens
    (n, len_keep, d), the fp32 mask (n, l) in the original order with 1 =
    removed, and the restore indices (n, l)).
    """
    n, l, d = x.shape
    len_keep = int(l * (1 - mask_ratio))
    if noise is None:
        noise = torch.rand(n, l, generator=generator, device=x.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    kept = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, d))
    mask = torch.ones(n, l, device=x.device)
    mask[:, :len_keep] = 0
    return kept, torch.gather(mask, 1, ids_restore), ids_restore


class PatchEmbed(nn.Module):
    """The conv stem (``nn.Conv`` with stride = kernel = patch, VALID) as a
    patchify reshape and one matmul against the (p, p, 3, W) HWIO kernel:
    exact, and the same product the JAX stem computes outside any kernel."""

    def __init__(self, patch_size: Sequence[int], width: int):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.kernel = nn.Parameter(torch.empty(*self.patch_size, 3, width))

    def init_own_parameters(self, generator):
        layers.lecun_normal()(self.kernel, tuple(self.kernel.shape),
                              generator)

    def forward(self, image: torch.Tensor, dtype: torch.dtype):
        """(n, H, W, 3) -> ((n, h*w, W) tokens in `dtype`, h, w)."""
        n, hh, ww, c = image.shape
        ph, pw = self.patch_size
        h, w = hh // ph, ww // pw
        x = image[:, :h * ph, :w * pw].to(dtype)
        x = x.reshape(n, h, ph, w, pw, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, h * w, ph * pw * c)
        kernel = self.kernel.reshape(-1, self.kernel.shape[-1]).to(dtype)
        return x @ kernel, h, w


class _Model(nn.Module):
    """ViT encoder producing a pooled embedding (and optional head logits).

    `image_size` fixes the learned position-embedding grid (flax infers it
    from the init input).
    """

    def __init__(self, num_classes: Optional[int] = None, *,
                 image_size: Any = 224, patch_size: Sequence[int] = (16, 16),
                 width: int = 768, depth: int = 12,
                 mlp_dim: Optional[int] = None, num_heads: int = 12,
                 posemb: str = "learn", dropout: float = 0.0,
                 drop_path: float = 0.0, pool_type: str = "gap",
                 patch_embed: str = "conv",
                 attn_impl: str = "auto", ln_pre: bool = False,
                 gelu_approx: Any = True, ln_eps: float = 1e-6,
                 ls_init: Optional[float] = None, dtype: Any = None,
                 remat_policy: Optional[str] = "none"):
        super().__init__()
        if patch_embed != "conv":
            raise NotImplementedError(f"patch_embed={patch_embed!r} is not "
                                      "ported yet (only 'conv')")
        if pool_type not in ("gap", "gap_all", "tok", "0"):
            raise NotImplementedError(f"pool_type={pool_type!r} is not "
                                      "ported yet")
        if posemb not in ("learn", "sincos2d"):
            raise ValueError(f"Unknown posemb {posemb!r}")
        size = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        self.grid = (size[0] // patch_size[0], size[1] // patch_size[1])
        n_pos = self.grid[0] * self.grid[1] + 1
        self.width = width
        self.pool_type = pool_type
        self.dtype = u.resolve_dtype(dtype)

        self.embedding = PatchEmbed(patch_size, width)
        self.cls = nn.Parameter(torch.empty(1, 1, width))
        if posemb == "learn":
            self.pos_embedding = nn.Parameter(torch.empty(1, n_pos, width))
        else:
            self.register_buffer("pos_embedding", posemb_sincos_2d(
                *self.grid, width, cls_token=True), persistent=False)
        self.dropout = layers.Dropout(dropout)
        self.ln_pre = layers.LayerNorm(width, eps=ln_eps) if ln_pre else None
        self.Transformer = layers.Encoder(
            depth, width, num_heads, mlp_dim=mlp_dim, dropout=dropout,
            drop_path=drop_path, attn_impl=attn_impl,
            gelu_approx=gelu_approx, ln_eps=ln_eps, ls_init=ls_init,
            remat_policy=remat_policy)
        self.encoder_norm = (layers.LayerNorm(width, eps=ln_eps)
                             if pool_type != "0" else None)
        self.head = None
        if num_classes:
            self.head = layers.QuantDense(
                width, num_classes, kernel_init=layers.normal(width ** -0.5),
                use_bias=False)

    def init_own_parameters(self, generator):
        self.cls.zero_()
        if isinstance(self.pos_embedding, nn.Parameter):
            layers.normal(self.width ** -0.5)(self.pos_embedding, (),
                                              generator)

    def forward(self, image: torch.Tensor, mask_ratio: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """image: (n, H, W, 3) normalized floats. With `mask_ratio` > 0 the
        patch tokens are masked by :func:`random_masking` with noise from
        `generator` (on the image's device), after the position embedding;
        cls stays in front. Returns the fp32 (n, C) embedding and a dict of
        intermediates (``mask`` among them when masking)."""
        out = {}
        x, h, w = self.embedding(image, self.dtype or image.dtype)
        if (h, w) != self.grid:
            raise ValueError(f"image gives a {h}x{w} patch grid, the model "
                             f"was built for {self.grid[0]}x{self.grid[1]}")
        n = x.shape[0]
        x = torch.cat([self.cls.to(x.dtype).expand(n, -1, -1), x], dim=1)
        x = self.dropout(x + self.pos_embedding.to(x.dtype))
        if mask_ratio > 0:
            kept, out["mask"], _ = random_masking(x[:, 1:], mask_ratio,
                                                  generator)
            x = torch.cat([x[:, :1], kept], dim=1)
        if self.ln_pre is not None:
            x = self.ln_pre(x)

        x = self.Transformer(x)
        out["encoded"] = x

        if self.pool_type == "gap":
            x = self.encoder_norm(x[:, 1:].mean(dim=1))
        elif self.pool_type == "gap_all":
            x = self.encoder_norm(x.mean(dim=1))
        elif self.pool_type == "tok":
            x = self.encoder_norm(x)[:, 0]
        else:  # "0"
            x = x[:, 0]
        out["head_input"] = x

        if self.head is not None:
            x = self.head(x)
            out["logits"] = x
        # Embeddings leave the tower in fp32, as in the JAX tower.
        return x.float(), out


def Model(num_classes=None, *, variant=None, **kw):  # noqa: N802
    """Builds a ViT from a variant string (e.g. "L/16") plus overrides."""
    return _Model(num_classes, **{**decode_variant(variant), **kw})


def decode_variant(variant: Optional[str]) -> dict:
    """"B/16" -> dims dict. Table 2 of arxiv.org/abs/2106.04560."""
    if variant is None:
        return {}
    v, _, patch = variant.partition("/")
    cfg = {
        "width": {"Ti": 192, "S": 384, "M": 512, "B": 768, "L": 1024,
                  "H": 1280, "g": 1408, "G": 1664, "e": 1792}[v],
        "depth": {"Ti": 12, "S": 12, "M": 12, "B": 12, "L": 24,
                  "H": 32, "g": 40, "G": 48, "e": 56}[v],
        "mlp_dim": {"Ti": 768, "S": 1536, "M": 2048, "B": 3072, "L": 4096,
                    "H": 5120, "g": 6144, "G": 8192, "e": 15360}[v],
        "num_heads": {"Ti": 3, "S": 6, "M": 8, "B": 12, "L": 16,
                      "H": 16, "g": 16, "G": 16, "e": 16}[v],
    }
    if patch:
        cfg["patch_size"] = (int(patch), int(patch))
    return cfg


def resample_posemb(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Bilinearly resizes a (1, N, C) posemb grid of N = g*g tokens to
    `new`'s token count (``jax.image.resize`` semantics)."""
    if old.shape == new.shape:
        return old
    gs_old = int(np.sqrt(old.shape[1]))
    gs_new = int(np.sqrt(new.shape[1]))
    grid = common.resize_bilinear(old.reshape(gs_old, gs_old, -1),
                                  (gs_new, gs_new))
    return grid.reshape(1, gs_new * gs_new, -1).to(old.dtype)


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads tower params from an npz checkpoint, merging with `init_params`
    (a tree of the tower's tensors) under `dont_load`."""
    del model_cfg
    from clipa_tpu_torch.train import checkpoint
    restored = checkpoint.load_params(init_file)
    restored = common.merge_params(restored, init_params, dont_load)
    if init_params and "pos_embedding" in init_params \
            and "pos_embedding" in restored:
        restored["pos_embedding"] = resample_posemb(
            old=restored["pos_embedding"], new=init_params["pos_embedding"])
    if "pos_embedding" in dont_load and init_params:
        _, l, c = init_params["pos_embedding"].shape
        g = int(round((l - 1) ** 0.5))
        restored["pos_embedding"] = posemb_sincos_2d(g, g, c, cls_token=True)
    return restored
