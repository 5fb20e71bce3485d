"""ModifiedResNet image tower (OpenAI CLIP's anti-aliased ResNet).

Port of ``clipa_tpu/models/resnet.py``: a 3-conv stem (``conv1`` 3 x 3
stride 2 with padding 1, ``conv2``, ``conv3``, each with a BatchNorm and a
ReLU) and a 2 x 2 average pool; four stages of :class:`Bottleneck` blocks
(1 x 1, 3 x 3, then, where the block is strided, a 2 x 2 VALID average pool
before the 1 x 1 expansion to 4x; the identity through an average pool, a
1 x 1 conv and a BatchNorm where the shape changes); the first block of
stages 2-4 strided; then :class:`AttentionPool2d`, a single-query
attention over the mean token and the H x W grid with a learned
(HW + 1, C) position table, 64-wide heads by default (``width * 32 //
head_width``). Module names are the JAX tower's (``conv1..3``,
``bn1..3``, ``layer{i}_{j}/{conv,bn}{1,2,3}``, ``downsample_conv``,
``downsample_bn``, ``attnpool/{q,k,v,c}_proj``, ``pos_embedding``).

Activations stay NHWC; the convs run on the channels-last NCHW view
(``layers.Conv``, flax's lecun-normal init, no bias). The BatchNorms are
``layers.BatchNorm``: flax's rule, their running statistics fp32 buffers
(the JAX package's ``batch_stats`` collection), updated by a training-mode
forward. The pool projects only the query of token 0, scales it by
hd^-0.5 before the product and takes the softmax in fp32, as the JAX pool
does. `image_size` fixes the pool's grid (224 px: 7 x 7).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import common, layers


def _conv(in_features: int, features: int, kernel: int,
          stride: int = 1) -> layers.Conv:
    return layers.Conv(in_features, features, kernel, stride=stride,
                       padding=kernel // 2, use_bias=False)


def _bn(features: int) -> layers.BatchNorm:
    return layers.BatchNorm(features)


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """flax ``nn.avg_pool`` (stride x stride window and stride, VALID) on
    NHWC."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), stride, stride)
    return y.permute(0, 2, 3, 1)


def pool_grid(image_size: int) -> int:
    """The side of the grid the attention pool sees at `image_size`: the
    stem's stride-2 conv (padding 1), its pool and three strided stages."""
    side = (image_size - 1) // 2 + 1
    for _ in range(4):
        side //= 2
    return side


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (avg pool if strided) -> 1x1 (4x), the identity through
    an avg pool and a 1x1 conv where the shape changes."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = _bn(out)
        self.downsample_conv = self.downsample_bn = None
        if stride > 1 or inplanes != out:
            self.downsample_conv = _conv(inplanes, out, 1)
            self.downsample_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            if self.stride > 1:
                identity = _avg_pool(x, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Single-query multi-head attention pool: the query is token 0 (the
    mean of the grid), keys and values all HW + 1 tokens; ``c_proj`` of
    the attended value."""

    def __init__(self, tokens: int, width: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.pos_embedding = nn.Parameter(torch.empty(tokens + 1, width))
        init = layers.normal(width ** -0.5)
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, layers.QuantDense(width, width,
                                                    kernel_init=init))
        self.c_proj = layers.QuantDense(width, output_dim, kernel_init=init)

    def init_own_parameters(self, generator):
        layers.normal(self.pos_embedding.shape[1] ** -0.5)(
            self.pos_embedding, (), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h * w + 1 != self.pos_embedding.shape[0]:
            raise ValueError(
                f"image gives a {h}x{w} grid at the attention pool, the "
                f"model was built for {self.pos_embedding.shape[0] - 1} "
                "positions")
        x = x.reshape(b, h * w, c)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.pos_embedding.to(x.dtype)
        hd = c // self.num_heads
        q = self.q_proj(x[:, :1]).reshape(b, 1, self.num_heads, hd)
        k = self.k_proj(x).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(x).reshape(b, -1, self.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        pooled = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, c)
        return self.c_proj(pooled)


class _Model(nn.Module):
    """ModifiedResNet trunk and attention pool -> (embedding, out dict)."""

    def __init__(self, num_classes: Optional[int] = None, *,
                 layers: Sequence[int] = (3, 4, 6, 3),  # noqa: F811
                 width: int = 64, num_heads: Optional[int] = None,
                 image_size: Any = 224, dtype: Any = None,
                 attn_impl: str = "auto"):
        super().__init__()
        del attn_impl   # the pool's einsum is the only path
        size = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        self.dtype = u.resolve_dtype(dtype)
        w = width
        self.conv1 = _conv(3, w // 2, 3, stride=2)
        self.bn1 = _bn(w // 2)
        self.conv2 = _conv(w // 2, w // 2, 3)
        self.bn2 = _bn(w // 2)
        self.conv3 = _conv(w // 2, w, 3)
        self.bn3 = _bn(w)
        self._order = []
        inplanes = w
        for i, (blocks, planes) in enumerate(
                zip(layers, (w, w * 2, w * 4, w * 8))):
            for j in range(blocks):
                name = f"layer{i + 1}_{j}"
                self.add_module(name, Bottleneck(
                    inplanes, planes, 2 if (j == 0 and i > 0) else 1))
                self._order.append(name)
                inplanes = planes * Bottleneck.expansion
        embed_dim = w * 32
        self.attnpool = AttentionPool2d(
            pool_grid(size[0]) * pool_grid(size[1]), embed_dim, num_heads or embed_dim // 64,
            num_classes or embed_dim)

    def forward(self, image: torch.Tensor, mask_ratio: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """image: (n, H, W, 3). `mask_ratio` and `generator` are ignored
        (token masking is the plain ViT's). Returns the fp32 (n, C)
        embedding and a dict of intermediates."""
        del mask_ratio, generator
        out = {}
        x = image.to(self.dtype or image.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = _avg_pool(x, 2)
        for name in self._order:
            x = getattr(self, name)(x)
        out["pre_pool"] = x
        x = self.attnpool(x)
        out["head_input"] = x
        return x.float(), out


def Model(num_classes=None, *, variant=None, **kw):  # noqa: N802
    return _Model(num_classes, **{**decode_variant(variant), **kw})


def decode_variant(variant: Optional[str]) -> dict:
    """RN variant table (open_clip's RN*.json)."""
    if variant is None:
        return {}
    return {
        "50": dict(layers=(3, 4, 6, 3), width=64),
        "101": dict(layers=(3, 4, 23, 3), width=64),
        "50x4": dict(layers=(4, 6, 10, 6), width=80),
        "50x16": dict(layers=(6, 8, 18, 8), width=96),
        "50x64": dict(layers=(3, 15, 36, 10), width=128),
    }[variant.removeprefix("RN")]


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads the tower's parameters from an npz checkpoint, merged with
    `init_params` (the tower's tree of tensors) under `dont_load`."""
    del model_cfg
    from clipa_tpu_torch.train import checkpoint
    return common.merge_params(checkpoint.load_params(init_file),
                               init_params, dont_load)
