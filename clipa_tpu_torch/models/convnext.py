"""ConvNeXt image tower (timm's ``convnext_*`` trunk under open_clip).

Port of ``clipa_tpu/models/convnext.py``: a 4 x 4 stride-4 conv stem
(``embedding``) and its LayerNorm (``downsample_layers01``); four stages of
:class:`ConvNeXtBlock` (7 x 7 depthwise conv, LayerNorm, pointwise 4x
expansion, GELU, projection, optional LayerScale ``gamma``, DropPath,
residual) with a LayerNorm and a 2 x 2 stride-2 conv between stages
(``downsample_layers{i}0`` / ``{i}1``); the spatial mean, ``norm`` and the
head (a Dense, or with `head_mlp` open_clip's Mlp head: ``head_mlp_fc``,
the erf GELU, ``head``). Blocks are ``encoderblock_j`` in stage 0 and
``stages{i}{j}`` after it, the JAX tower's names.

As in the JAX tower: activations stay NHWC, so each LayerNorm runs over the
last dim (flax's epsilon, 1e-6), and each conv runs on the channels-last
NCHW view (``layers.Conv``); the convs take XLA's "SAME" padding, which on
a size the stride does not divide pads the odd pixel after; the blocks'
GELU is flax's default, the tanh form (timm's ConvNeXt uses erf), the mlp
head's the erf form; DropPath rates are ``np.linspace(0, drop_path,
sum(depths))`` over the blocks. ``dropout`` (open_clip's ``timm_drop``) and
``remat_policy`` are accepted and, as in the JAX tower, never read.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import common, layers


class ConvNeXtBlock(nn.Module):

    def __init__(self, dim: int, layer_scale_init_value: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        init = layers.normal(0.02)
        self.dwconv = layers.Conv(dim, dim, 7, groups=dim, kernel_init=init)
        self.norm = layers.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = layers.QuantDense(dim, 4 * dim, kernel_init=init)
        self.pwconv2 = layers.QuantDense(4 * dim, dim, kernel_init=init)
        self.ls_init = layer_scale_init_value
        self.gamma = (nn.Parameter(torch.empty(dim))
                      if layer_scale_init_value > 0 else None)
        self.drop_path = layers.DropPath(drop_path)

    def init_own_parameters(self, generator):
        if self.gamma is not None:
            self.gamma.fill_(self.ls_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv1(self.norm(self.dwconv(x)))
        y = self.pwconv2(F.gelu(y, approximate="tanh"))
        if self.gamma is not None:
            y = self.gamma.to(y.dtype) * y
        return x + self.drop_path(y)


class _Model(nn.Module):
    """ConvNeXt producing a pooled embedding (and optional head logits)."""

    def __init__(self, num_classes: Optional[int] = None, *,
                 dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (3, 3, 9, 3),
                 layer_scale_init_value: float = 0.0, dropout: float = 0.0,
                 drop_path: float = 0.0, head_zeroinit: bool = False,
                 head_mlp: bool = False, remat_policy: str = "none",
                 dtype: Any = None, image_size: Any = None,
                 attn_impl: str = "auto"):
        super().__init__()
        # as in the JAX tower, dropout and remat_policy are never read; the
        # convs take any image size, and there is no attention
        del dropout, remat_policy, image_size, attn_impl
        dims, depths = tuple(dims), tuple(depths)
        self.dtype = u.resolve_dtype(dtype)
        init = layers.normal(0.02)
        rates = np.linspace(0, drop_path, sum(depths))
        self.embedding = layers.Conv(3, dims[0], 4, stride=4,
                                     kernel_init=init, hwio=True)
        self.downsample_layers01 = layers.LayerNorm(dims[0], eps=1e-6)
        self._order = ["embedding", "downsample_layers01"]
        cur = 0
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            if i > 0:
                self.add_module(f"downsample_layers{i}0",
                                layers.LayerNorm(dims[i - 1], eps=1e-6))
                self.add_module(f"downsample_layers{i}1", layers.Conv(
                    dims[i - 1], dim, 2, stride=2, kernel_init=init))
                self._order += [f"downsample_layers{i}0",
                                f"downsample_layers{i}1"]
            for j in range(depth):
                name = f"encoderblock_{j}" if i == 0 else f"stages{i}{j}"
                self.add_module(name, ConvNeXtBlock(
                    dim, layer_scale_init_value, float(rates[cur + j])))
                self._order.append(name)
            cur += depth
        self.norm = layers.LayerNorm(dims[-1], eps=1e-6)
        self.head = self.head_mlp_fc = None
        if num_classes:
            head_init = (layers.zeros() if head_zeroinit
                         else layers.normal(dims[-1] ** -0.5))
            width = dims[-1]
            if head_mlp:
                self.head_mlp_fc = layers.QuantDense(
                    width, 2 * num_classes, kernel_init=head_init)
                width = 2 * num_classes
            self.head = layers.QuantDense(width, num_classes,
                                          kernel_init=head_init)

    def forward(self, image: torch.Tensor, mask_ratio: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """image: (n, H, W, 3). `mask_ratio` and `generator` are ignored
        (token masking is the plain ViT's). Returns the fp32 (n, C)
        embedding and a dict of intermediates."""
        del mask_ratio, generator
        out = {}
        x = image.to(self.dtype or image.dtype)
        for name in self._order:
            x = getattr(self, name)(x)
        x = self.norm(x.mean(dim=(1, 2)))
        out["head_input"] = x
        if self.head is not None:
            if self.head_mlp_fc is not None:
                x = F.gelu(self.head_mlp_fc(x), approximate="none")
            x = self.head(x)
            out["logits"] = x
        return x.float(), out


def Model(num_classes=None, *, variant=None, **kw):  # noqa: N802
    return _Model(num_classes, **{**decode_variant(variant), **kw})


def decode_variant(variant: Optional[str]) -> dict:
    if variant is None:
        return {}
    v = variant.split("/")[0]
    return {
        "dims": {"T": (96, 192, 384, 768), "S": (96, 192, 384, 768),
                 "B": (128, 256, 512, 1024), "L": (192, 384, 768, 1536),
                 "XL": (256, 512, 1024, 2048)}[v],
        "depths": {"T": (3, 3, 9, 3), "S": (3, 3, 27, 3),
                   "B": (3, 3, 27, 3), "L": (3, 3, 27, 3),
                   "XL": (3, 3, 27, 3)}[v],
    }


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads the tower from an npz checkpoint, merged with `init_params`
    (the tower's tree of tensors) under `dont_load`."""
    del model_cfg
    from clipa_tpu_torch.train import checkpoint
    return common.merge_params(checkpoint.load_params(init_file),
                               init_params, dont_load)
