"""ViT with a continuous relative-position bias (timm's ``vit_relpos_*``
trunk).

Port of ``clipa_tpu/models/vit_relpos.py``: a biased 16 x 16 conv stem
(std 0.02), no absolute position embedding, a class token (std 0.02),
pre-LN blocks (:class:`RelPosBlock`) whose attention adds a per-block bias
from a small MLP over log-scaled relative grid coordinates
(:class:`RelPosMlpBias`: fc1, ReLU, fc2; the class token's row and column
zero), qkv without bias, then ``norm``, the class token, and the head
(``head_bias`` as open_clip's ``timm_proj_bias``). Every LayerNorm takes
flax's epsilon, 1e-6.

Coordinate modes (``coords_mode``): ``cr``, timm RelPosMlp's
``sign(d) * ln(1 + |d|)``, and ``swinv2``, Swin-v2's log-spaced table.
As in the JAX tower, the bias MLP computes in fp32 and the scores in the
compute dtype, to which the bias is cast before the fp32 softmax; the
attention is this einsum (the bias rules out the fused kernels). Not
ported, as the JAX tower lacks them: timm's dropout inside the bias MLP
in training, and a record of ``coords_mode`` in the open_clip maps.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import common, layers
from clipa_tpu_torch.models.vit import PatchEmbed


def _rel_coords_log(h: int, w: int, mode: str = "cr") -> np.ndarray:
    """((2h-1)*(2w-1), 2) log-scaled relative coordinates. "cr": sign(d) *
    ln(1 + |d|); "swinv2": sign * log2(1 + |x|) / log2(8) of x scaled by
    8 / (max(h, w) - 1)."""
    dy = np.arange(-(h - 1), h, dtype=np.float32)
    dx = np.arange(-(w - 1), w, dtype=np.float32)
    grid = np.stack(np.meshgrid(dy, dx, indexing="ij"), axis=-1)
    grid = grid.reshape(-1, 2)
    if mode == "cr":
        return np.sign(grid) * np.log1p(np.abs(grid))
    if mode != "swinv2":
        raise ValueError(f"Unknown coords_mode {mode!r}")
    scaled = grid * (8.0 / np.maximum(h - 1, w - 1))
    return np.sign(scaled) * np.log2(1.0 + np.abs(scaled)) / np.log2(8.0)


def _rel_index(h: int, w: int) -> np.ndarray:
    """(h*w, h*w) indices into the (2h-1)*(2w-1) relative-coordinate
    table."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + np.array([h - 1, w - 1])
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int32)


class RelPosMlpBias(nn.Module):
    """The MLP over the grid's log relative coordinates -> the fp32
    (heads, 1+N, 1+N) additive bias, zero in the class token's row and
    column. Its parameters stay fp32 when the tower's are stored in the
    compute dtype (the JAX MLP computes in fp32 whatever the dtype)."""

    keep_fp32 = True

    def __init__(self, grid: Tuple[int, int], num_heads: int,
                 hidden_dim: int = 512, coords_mode: str = "cr"):
        super().__init__()
        self.fc1 = layers.QuantDense(2, hidden_dim,
                                     kernel_init=layers.normal(0.02))
        self.fc2 = layers.QuantDense(hidden_dim, num_heads,
                                     kernel_init=layers.normal(0.02))
        self.num_heads = num_heads
        self.register_buffer("coords", torch.as_tensor(
            _rel_coords_log(*grid, coords_mode)), persistent=False)
        self.register_buffer("index", torch.as_tensor(
            _rel_index(*grid).reshape(-1), dtype=torch.long),
            persistent=False)

    def forward(self) -> torch.Tensor:
        y = self.fc2(F.relu(self.fc1(self.coords.float())))   # (T, heads)
        n = int(round(self.index.numel() ** 0.5))
        bias = y[self.index].reshape(n, n, self.num_heads).permute(2, 0, 1)
        return F.pad(bias, (1, 0, 1, 0))


class RelPosBlock(nn.Module):
    """Pre-LN block: attention with the relative-position bias, then the
    MLP (erf GELU), each residual through DropPath."""

    def __init__(self, width: int, num_heads: int, grid: Tuple[int, int],
                 mlp_ratio: float = 4.0, rel_pos_dim: int = 512,
                 coords_mode: str = "cr", drop_path: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        init = layers.normal(0.02)
        self.norm1 = layers.LayerNorm(width, eps=1e-6)
        self.qkv = layers.QuantDense(width, 3 * width, kernel_init=init,
                                     use_bias=False)
        self.rel_pos = RelPosMlpBias(grid, num_heads, rel_pos_dim,
                                     coords_mode)
        self.proj = layers.QuantDense(width, width, kernel_init=init)
        self.norm2 = layers.LayerNorm(width, eps=1e-6)
        self.mlp_fc1 = layers.QuantDense(width, int(width * mlp_ratio),
                                         kernel_init=init)
        self.mlp_fc2 = layers.QuantDense(int(width * mlp_ratio), width,
                                         kernel_init=init)
        self.drop_path = layers.DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, width = x.shape
        hd = width // self.num_heads
        qkv = self.qkv(self.norm1(x)).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5
        attn = attn + self.rel_pos()[None].to(attn.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        y = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        y = self.proj(y.transpose(1, 2).reshape(b, n, width))
        x = x + self.drop_path(y)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.drop_path(y)


class _Model(nn.Module):
    """relpos-ViT producing a pooled embedding (and optional head logits).
    `image_size` fixes the grid of the bias tables (flax's is the init
    input's)."""

    def __init__(self, num_classes: Optional[int] = None, *,
                 image_size: Any = 224, width: int = 512, depth: int = 12,
                 num_heads: int = 8, mlp_ratio: float = 4.0,
                 patch_size: int = 16, rel_pos_dim: int = 512,
                 coords_mode: str = "cr", drop_path: float = 0.0,
                 head_bias: bool = False, dtype: Any = None,
                 attn_impl: str = "auto"):
        super().__init__()
        del attn_impl   # the biased einsum is the only path
        size = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        self.grid = (size[0] // patch_size, size[1] // patch_size)
        self.dtype = u.resolve_dtype(dtype)
        self.depth = depth
        self.patch_embed = PatchEmbed((patch_size, patch_size), width,
                                      use_bias=True,
                                      kernel_init=layers.normal(0.02))
        self.cls = nn.Parameter(torch.empty(1, 1, width))
        rates = np.linspace(0, drop_path, depth)
        for i in range(depth):
            self.add_module(f"blocks{i}", RelPosBlock(
                width, num_heads, self.grid, mlp_ratio, rel_pos_dim,
                coords_mode, float(rates[i])))
        self.norm = layers.LayerNorm(width, eps=1e-6)
        self.head = None
        if num_classes:
            self.head = layers.QuantDense(
                width, num_classes, use_bias=head_bias,
                kernel_init=layers.normal(width ** -0.5))

    def init_own_parameters(self, generator):
        layers.normal(0.02)(self.cls, (), generator)

    def forward(self, image: torch.Tensor, mask_ratio: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """image: (n, H, W, 3). `mask_ratio` and `generator` are ignored
        (the JAX tower's grid is dense). Returns the fp32 (n, C) embedding
        and a dict of intermediates."""
        del mask_ratio, generator
        out = {}
        x, h, w = self.patch_embed(image, self.dtype or image.dtype)
        if (h, w) != self.grid:
            raise ValueError(f"image gives a {h}x{w} patch grid, the model "
                             f"was built for {self.grid[0]}x{self.grid[1]}")
        x = torch.cat([self.cls.to(x.dtype).expand(x.shape[0], -1, -1), x],
                      dim=1)
        for i in range(self.depth):
            x = getattr(self, f"blocks{i}")(x)
        x = self.norm(x)[:, 0]
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
        "S": dict(width=384, depth=12, num_heads=6),
        "M": dict(width=512, depth=12, num_heads=8),
        "B": dict(width=768, depth=12, num_heads=12),
    }[variant.split("/")[0]]


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads the tower from an npz checkpoint, merged with `init_params`
    (the tower's tree of tensors) under `dont_load`."""
    del model_cfg
    from clipa_tpu_torch.train import checkpoint
    return common.merge_params(checkpoint.load_params(init_file),
                               init_params, dont_load)
