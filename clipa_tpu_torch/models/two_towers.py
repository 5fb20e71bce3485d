"""Two-tower CLIP model: image encoder + text encoder + learned temperature.

Port of ``clipa_tpu/models/two_towers.py``: towers named ``img``/``txt``,
embeddings L2-normalized with a 1e-8 floor, scalar log-temperature ``t``
initialized to log(temperature_init), and, where ``bias_init`` is set, the
sigmoid loss's learned bias ``b`` (shape (1,), initialized to bias_init;
``out["b"]``). Either input may be None. `dtype` is
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
                 temperature_init: float = 1.0,
                 bias_init: Optional[float] = None, dtype: Any = None):
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
        self.bias_init = bias_init
        self.b = (nn.Parameter(torch.empty(1)) if bias_init is not None
                  else None)

    def init_own_parameters(self, generator):
        self.t.fill_(math.log(self.temperature_init))
        if self.b is not None:
            self.b.fill_(self.bias_init)

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
        if self.b is not None:
            out["b"] = self.b
        return zimg, ztxt, out


def load(init_params, init_files, model_cfg, img_load_kw=None,
         txt_load_kw=None):
    """Loads both towers (the trainer's ``config.model_init``): `init_files`
    is a dict with img/txt/t keys (or image/text/temperature), or one path,
    a two_towers checkpoint whose subtrees are read with the
    ``file.npz:key`` syntax. `init_params`: the model's tree of tensors
    (nested); each tower merges through its module's ``load`` with
    `img_load_kw` / `txt_load_kw` (``dont_load``). Returns the tree."""
    from clipa_tpu_torch.train import checkpoint

    if isinstance(init_files, str):
        init_files = {k: f"{init_files}:{k}" for k in ("img", "txt", "t")}
    else:
        init_files = {**init_files}

    restored = {**init_params}
    img_init = init_files.pop("image", init_files.pop("img", None))
    if img_init:
        restored["img"] = get_model_module(model_cfg.image_model).load(
            init_params["img"], img_init, model_cfg.get("image"),
            **(img_load_kw or {}))
    txt_init = init_files.pop("text", init_files.pop("txt", None))
    if txt_init:
        restored["txt"] = get_model_module(model_cfg.text_model).load(
            init_params["txt"], txt_init, model_cfg.get("text"),
            **(txt_load_kw or {}))
    t_init = init_files.pop("temperature", init_files.pop("t", None))
    if t_init:
        restored["t"] = checkpoint.load_params(t_init)
    if init_files:
        raise ValueError(f"Unused keys in model_init: {list(init_files)}")
    return restored
