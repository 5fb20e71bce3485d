"""Two-tower CLIP model: image encoder + text encoder + learned temperature.

Port of ``clipa_tpu/models/two_towers.py``: towers named ``img``/``txt``,
embeddings L2-normalized with a 1e-8 floor, scalar log-temperature ``t``
initialized to log(temperature_init). Either input may be None. `dtype` is
both towers' compute dtype over fp32 parameters (a config's "bfloat16"), so
``Model(**config.model)`` builds the model the JAX trainer builds; the
towers' position tables are sized by `image_size` / `context_length` in the
tower dicts (``train.step.create_model`` takes them from
``config.init_shapes``, as flax sizes them from the init inputs).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple, Union

import torch
from torch import nn

from clipa_tpu_torch.models import get_model_module, layers


class Model(nn.Module):

    def __init__(self, image: Optional[dict] = None,
                 text: Optional[dict] = None, image_model: str = "vit",
                 text_model: str = "text_transformer",
                 out_dim: Union[int, Tuple[Optional[int], int]] = 512,
                 temperature_init: float = 1.0, dtype: Any = None):
        super().__init__()
        out_dims = (out_dim, out_dim) if isinstance(out_dim, int) else out_dim
        self.img = (get_model_module(image_model).Model(
            **{"num_classes": out_dims[0], "dtype": dtype, **image})
            if image is not None else None)
        self.txt = (get_model_module(text_model).Model(
            **{"num_classes": out_dims[1], "dtype": dtype, **text})
            if text is not None else None)
        self.temperature_init = temperature_init
        self.t = nn.Parameter(torch.empty(1))

    def init_own_parameters(self, generator):
        self.t.fill_(math.log(self.temperature_init))

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Stores the towers' weights in `dtype` (LayerNorms and `t` stay
        fp32): serving's layout, where the casts to the compute dtype at use
        are no-ops. Training keeps the fp32 masters."""
        for tower in (self.img, self.txt):
            if tower is not None:
                layers.cast_params(tower, dtype)

    def forward(self, image: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None,
                mask_ratio: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """Returns (zimg, ztxt, out) with L2-normalized (B, C) embeddings.
        `mask_ratio` > 0 masks image tokens (unmask-tuning) with noise from
        `generator`, on the image's device."""
        out: dict[str, Any] = {}
        zimg = ztxt = None
        if text is not None:
            ztxt, out_txt = self.txt(text)
            out["txt/norm"] = torch.linalg.norm(ztxt, dim=1, keepdim=True)
            out["txt/normalized"] = ztxt = ztxt / (out["txt/norm"] + 1e-8)
            out.update({f"txt/{k}": v for k, v in out_txt.items()})
        if image is not None:
            zimg, out_img = self.img(image, mask_ratio=mask_ratio,
                                     generator=generator)
            out["img/norm"] = torch.linalg.norm(zimg, dim=1, keepdim=True)
            out["img/normalized"] = zimg = zimg / (out["img/norm"] + 1e-8)
            out.update({f"img/{k}": v for k, v in out_img.items()})
        out["t"] = torch.exp(self.t)
        out["t/parameter"] = self.t
        return zimg, ztxt, out
