"""Swin Transformer image tower (timm's ``swin_*`` trunk under open_clip).

Port of ``clipa_tpu/models/swin.py``: a biased 4 x 4 conv stem and
``patch_norm``; four stages of window-attention blocks (:class:`SwinBlock`:
LN, cyclically shifted window attention with a learned relative-position
bias table, residual; LN, MLP with the erf GELU, residual), 2 x 2 patch
merging between stages (:class:`PatchMerging`, which concatenates the
neighbours as (0,0), (0,1), (1,0), (1,1): the JAX tower's order, not
timm's; the open_clip maps permute the ``reduction`` rows); the final
``norm``, the token mean and the head. Every LayerNorm takes flax's
epsilon, 1e-6.

As in the JAX tower the window scores are formed in the compute dtype,
the bias table and the shift mask (-1e9 between pre-shift regions) are
cast to it and added there, and the softmax runs in fp32; the attention
is this einsum. `image_size` fixes the grid, which each stage's window
must divide; a window covering a whole stage's grid is not shifted.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import common, layers
from clipa_tpu_torch.models.vit import PatchEmbed


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, w*w, C)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _window_reverse(x: torch.Tensor, w: int, h: int,
                    wd: int) -> torch.Tensor:
    """(B * nH * nW, w*w, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    x = x.reshape(-1, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, wd, c)


def _relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) indices into the (2w-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


def _shift_attn_mask(h: int, wd: int, w: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask of shifted-window attention: 0 within a
    pre-shift region, -1e9 across (the 3 x 3 region partition)."""
    img = np.zeros((h, wd), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // w, w, wd // w, w).transpose(0, 2, 1, 3)
    win = win.reshape(-1, w * w)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff == 0, 0.0, -1e9).astype(np.float32)


class WindowAttention(nn.Module):
    """Per-window multi-head attention with a learned relative-position
    bias table (std 0.02)."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        init = layers.normal(0.02)
        self.qkv = layers.QuantDense(dim, 3 * dim, kernel_init=init)
        self.rel_pos_table = nn.Parameter(torch.empty((2 * window - 1) ** 2,
                                                      num_heads))
        self.proj = layers.QuantDense(dim, dim, kernel_init=init)
        self.register_buffer("rel_index", torch.as_tensor(
            _relative_position_index(window).reshape(-1), dtype=torch.long),
            persistent=False)

    def init_own_parameters(self, generator):
        layers.normal(0.02)(self.rel_pos_table, (), generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bw, n, dim = x.shape
        hd = dim // self.num_heads
        qkv = self.qkv(x).reshape(bw, n, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = self.rel_pos_table[self.rel_index].reshape(n, n, -1)
        attn = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, self.num_heads, n, n)
            attn = attn + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(bw, self.num_heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        y = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.proj(y.transpose(1, 2).reshape(bw, n, dim))


class SwinBlock(nn.Module):
    """LN, (shifted) window attention, residual; LN, MLP, residual; each
    residual through DropPath. `grid` (h, w) is the stage's token grid."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 grid: Sequence[int], mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.window, self.shift = window, shift
        init = layers.normal(0.02)
        self.norm1 = layers.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = layers.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = layers.QuantDense(dim, int(dim * mlp_ratio),
                                         kernel_init=init)
        self.mlp_fc2 = layers.QuantDense(int(dim * mlp_ratio), dim,
                                         kernel_init=init)
        self.drop_path = layers.DropPath(drop_path)
        self.register_buffer("attn_mask", torch.as_tensor(_shift_attn_mask(
            *grid, window, shift)) if shift else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, wd, _ = x.shape
        y = self.norm1(x)
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
        y = self.attn(_window_partition(y, self.window), self.attn_mask)
        y = _window_reverse(y, self.window, h, wd)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + self.drop_path(y)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.drop_path(y)


class PatchMerging(nn.Module):
    """2 x 2 neighbourhood concat ((0,0), (0,1), (1,0), (1,1); 4C), LN,
    then ``reduction`` to 2C (no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layers.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = layers.QuantDense(4 * dim, 2 * dim, use_bias=False,
                                           kernel_init=layers.normal(0.02))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class _Model(nn.Module):
    """Swin producing a pooled embedding (and optional head logits)."""

    def __init__(self, num_classes: Optional[int] = None, *,
                 image_size: Any = 224, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 7,
                 patch_size: int = 4, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, head_bias: bool = False,
                 dtype: Any = None, attn_impl: str = "auto"):
        super().__init__()
        del attn_impl   # the biased einsum is the only path
        size = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        self.grid = (size[0] // patch_size, size[1] // patch_size)
        self.dtype = u.resolve_dtype(dtype)
        self.patch_embed = PatchEmbed((patch_size, patch_size), embed_dim,
                                      use_bias=True,
                                      kernel_init=layers.normal(0.02))
        self.patch_norm = layers.LayerNorm(embed_dim, eps=1e-6)
        rates = np.linspace(0, drop_path, sum(depths))
        self._order = []
        dim, (h, w), cur = embed_dim, self.grid, 0
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            if h % window or w % window:
                raise ValueError(
                    f"swin stage {i}: token grid {h}x{w} is not divisible by "
                    f"window {window}; image_size must satisfy "
                    f"size/{patch_size}/2^stage % {window} == 0 at every "
                    f"stage (224 works for window 7; 256 does not)")
            for j in range(depth):
                # a window covering the whole grid is never shifted
                shift = (window // 2 if j % 2 and min(h, w) > window
                         else 0)
                name = f"layers{i}_blocks{j}"
                self.add_module(name, SwinBlock(
                    dim, heads, window, shift, (h, w), mlp_ratio,
                    float(rates[cur + j])))
                self._order.append(name)
            cur += depth
            if i < len(depths) - 1:
                name = f"layers{i}_downsample"
                self.add_module(name, PatchMerging(dim))
                self._order.append(name)
                dim, h, w = 2 * dim, h // 2, w // 2
        self.norm = layers.LayerNorm(dim, eps=1e-6)
        self.head = None
        if num_classes:
            self.head = layers.QuantDense(
                dim, num_classes, use_bias=head_bias,
                kernel_init=layers.normal(dim ** -0.5))

    def forward(self, image: torch.Tensor, mask_ratio: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """image: (n, H, W, 3). `mask_ratio` and `generator` are ignored
        (token masking is the plain ViT's). Returns the fp32 (n, C)
        embedding and a dict of intermediates."""
        del mask_ratio, generator
        out = {}
        x, h, w = self.patch_embed(image, self.dtype or image.dtype)
        if (h, w) != self.grid:
            raise ValueError(f"image gives a {h}x{w} patch grid, the model "
                             f"was built for {self.grid[0]}x{self.grid[1]}")
        x = self.patch_norm(x.reshape(x.shape[0], h, w, -1))
        for name in self._order:
            x = getattr(self, name)(x)
        x = self.norm(x).mean(dim=(1, 2))
        out["head_input"] = x
        if self.head is not None:
            x = self.head(x)
            out["logits"] = x
        return x.float(), out


def Model(num_classes=None, *, variant=None, **kw):  # noqa: N802
    return _Model(num_classes, **{**decode_variant(variant), **kw})


def decode_variant(variant: Optional[str]) -> dict:
    if variant is None:
        return {}
    return {
        "T": dict(embed_dim=96, depths=(2, 2, 6, 2),
                  num_heads=(3, 6, 12, 24)),
        "S": dict(embed_dim=96, depths=(2, 2, 18, 2),
                  num_heads=(3, 6, 12, 24)),
        "B": dict(embed_dim=128, depths=(2, 2, 18, 2),
                  num_heads=(4, 8, 16, 32)),
        "L": dict(embed_dim=192, depths=(2, 2, 18, 2),
                  num_heads=(6, 12, 24, 48)),
    }[variant.split("/")[0]]


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads the tower from an npz checkpoint, merged with `init_params`
    (the tower's tree of tensors) under `dont_load`."""
    del model_cfg
    from clipa_tpu_torch.train import checkpoint
    return common.merge_params(checkpoint.load_params(init_file),
                               init_params, dont_load)
