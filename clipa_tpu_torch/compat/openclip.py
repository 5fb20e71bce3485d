"""open_clip-style factory for the ported CLIPA models.

Port of the JAX-free parts of ``clipa_tpu/compat/openclip.py``: model
configs by name or ``.json`` path (``model_configs/`` beside this module
holds the ViT + text-transformer JSON files of
``clipa_tpu/compat/model_configs/``), their translation to two-tower kwargs
for the ViT/text towers, ``create_model``,
``CLIPModel.encode_image/encode_text`` and the WordPiece branch of
``get_tokenizer``.

Not ported yet: timm, ResNet, HF-text and CoCa configs, the BPE tokenizers,
torch open_clip state-dict conversion and the pretrained-tag registry.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "model_configs")


def list_models() -> list[str]:
    return sorted(f[:-5] for f in os.listdir(_CONFIG_DIR)
                  if f.endswith(".json"))


@functools.lru_cache(maxsize=None)
def get_model_config(name: str) -> dict:
    if name.endswith(".json") and os.path.exists(name):
        # a user-local config file, addressed by path
        with open(name) as f:
            return json.load(f)
    path = os.path.join(_CONFIG_DIR, name + ".json")
    if not os.path.exists(path):
        raise KeyError(f"Unknown model {name!r}; known: {list_models()}")
    with open(path) as f:
        return json.load(f)


def _to_two_towers_cfg(cfg: dict, *, image_size: Optional[int] = None,
                       pos_embed: Optional[str] = None) -> dict:
    """open_clip JSON fields -> clipa_tpu_torch.models.two_towers kwargs
    (the ViT/text branch of the JAX translation)."""
    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    if ("timm_model_name" in v or "hf_model_name" in t
            or isinstance(v["layers"], (list, tuple))
            or "multimodal_cfg" in cfg):
        raise NotImplementedError("only ViT + text-transformer configs are "
                                  "ported to clipa_tpu_torch")
    quick = bool(cfg.get("quick_gelu"))
    vision_pool_style = v.get("pool_style", "open_clip")
    if vision_pool_style == "big_vision_gap":
        img_pool = "gap"           # mean over patch tokens, then ln_post
    elif vision_pool_style == "big_vision_tok":
        img_pool = "tok"
    elif v.get("global_average_pool"):
        img_pool = "gap_all"       # open_clip gap: mean incl. cls token
    else:
        img_pool = "tok"           # open_clip cls pooling == tok numerically
    width = v["width"]
    image = dict(
        variant=None,
        image_size=image_size or v["image_size"],
        width=width,
        depth=v["layers"],
        num_heads=width // v.get("head_width", 64),
        mlp_dim=int(round(width * v.get("mlp_ratio", 4.0))),
        patch_size=(v["patch_size"], v["patch_size"]),
        pool_type=img_pool,
        posemb={"sin_cos_2d": "sincos2d"}.get(pos_embed, pos_embed)
        or "learn",
        ln_pre=bool(v.get("ln_pre", True)),
        gelu_approx="quick" if quick else
        (v.get("gelu_approximate", "none") == "tanh"),
        ln_eps=1e-5,  # torch nn.LayerNorm default: the compat surface
        ls_init=v.get("ls_init_value"),
    )
    return dict(image=image, text=_text_tower_cfg(t, quick),
                out_dim=(cfg["embed_dim"], cfg["embed_dim"]),
                temperature_init=1 / 0.07)


def _text_tower_cfg(t: dict, quick: bool) -> dict:
    text_pool = {"big_vision_last": "last", "big_vision_tok": "tok",
                 "open_clip": "eot"}[t.get("pool_style", "open_clip")]
    return dict(
        variant=None,
        context_length=t.get("context_length", 77),
        width=t["width"],
        depth=t["layers"],
        num_heads=t["heads"],
        mlp_dim=int(round(t["width"] * t.get("mlp_ratio", 4.0))),
        pool_type=text_pool,
        vocab_size=t["vocab_size"],
        causal_mask=bool(t.get("attention_mask", True)),
        gelu_approx="quick" if quick else
        (t.get("gelu_approximate", "none") == "tanh"),
        ln_eps=1e-5,  # torch nn.LayerNorm default: the compat surface
    )


class CLIPModel:
    """A two-tower model on its device plus the config it was built from."""

    def __init__(self, model, config: dict, image_size: int,
                 context_length: int, device: torch.device):
        self.model = model
        self.config = config
        self.image_size = image_size
        self.context_length = context_length
        self.device = device

    @torch.inference_mode()
    def encode_image(self, image) -> torch.Tensor:
        """Normalized float images, (N, H, W, 3) or (N, 3, H, W) (or one
        image without N) -> (N, C) unit-norm fp32 embeddings."""
        image = torch.as_tensor(image, device=self.device)
        if image.dim() == 3:
            image = image[None]
        if image.shape[1] == 3 and image.shape[-1] != 3:
            image = image.permute(0, 2, 3, 1)  # accept NCHW
        zimg, _, _ = self.model(image, None)
        return zimg

    @torch.inference_mode()
    def encode_text(self, text) -> torch.Tensor:
        """(N, context_length) token ids -> (N, C) unit-norm embeddings."""
        zimg, ztxt, _ = self.model(None, torch.as_tensor(text,
                                                         device=self.device))
        return ztxt

    @property
    def logit_scale(self) -> torch.Tensor:
        return torch.exp(self.model.t.detach())

    def __call__(self, image=None, text=None):
        zimg = self.encode_image(image) if image is not None else None
        ztxt = self.encode_text(text) if text is not None else None
        return zimg, ztxt, self.logit_scale


def create_model(model_name: str, pretrained: Optional[str] = None, *,
                 precision: str = "float32",
                 force_image_size: Optional[int] = None,
                 pos_embed: Optional[str] = None, device="cuda",
                 seed: int = 0, attn_impl: str = "auto") -> CLIPModel:
    """Builds a CLIPA model by open_clip name (or config path) on `device`
    (the card unless the caller names the CPU; raises without a card).

    `pretrained` is a flat npz in the JAX package's format (``file.npz`` or
    ``file.npz:subtree``), loaded through ``convert.load_jax_params``.
    Without it, weights are drawn on the device from a ``torch.Generator``
    seeded with `seed`, with the flax initializers' distributions.
    `attn_impl` is the towers' attention dispatch
    (``ops.attention.multi_head_attention``).
    """
    from clipa_tpu_torch import convert, utils
    from clipa_tpu_torch.models import layers, two_towers
    from clipa_tpu_torch.train import checkpoint as ckpt

    dtype = {"float32": None, "bf16": torch.bfloat16,
             "bfloat16": torch.bfloat16}[precision]
    device = utils.resolve_device(device, "create_model")
    cfg = get_model_config(model_name)
    image_size = force_image_size or cfg["vision_cfg"]["image_size"]
    tt_cfg = _to_two_towers_cfg(cfg, image_size=image_size,
                                pos_embed=pos_embed)
    tt_cfg["image"]["attn_impl"] = attn_impl
    tt_cfg["text"]["attn_impl"] = attn_impl
    with device:
        model = two_towers.Model(**tt_cfg, dtype=dtype)
    if pretrained:
        convert.load_jax_params(model, ckpt.load_params(pretrained))
    else:
        generator = torch.Generator(device=device).manual_seed(seed)
        layers.init_parameters(model, generator)
    if dtype is not None:
        model.set_compute_dtype(dtype)
    model.eval().requires_grad_(False)
    ctx = cfg["text_cfg"].get("context_length", 77)
    return CLIPModel(model, cfg, image_size, ctx, device)


def get_tokenizer(model_name: str, *, vocab_path: Optional[str] = None,
                  context_length: Optional[int] = None) -> Callable:
    """Returns texts -> (B, context_length) int32 token array.

    BERT-tokenizer configs (all CLIPA-v2 BigVision models) tokenize with
    the port's WordPiece stack (:mod:`clipa_tpu_torch.tokenizer`).
    """
    from clipa_tpu_torch import tokenizer

    cfg = get_model_config(model_name)["text_cfg"]
    ctx = context_length or cfg.get("context_length", 77)
    vocab_path = vocab_path or os.environ.get("CLIPA_VOCAB_PATH")
    if "hf_tokenizer_name" in cfg or (not cfg.get("bert_tokenizer")
                                      and cfg.get("vocab_size") == 49408):
        raise NotImplementedError("only the WordPiece (BERT) tokenizer is "
                                  "ported to clipa_tpu_torch")
    if cfg.get("text_mask") == "syntax":
        raise NotImplementedError("syntax-priority sampling is not ported "
                                  "to clipa_tpu_torch yet")
    if not vocab_path:
        raise ValueError("vocab_path (or CLIPA_VOCAB_PATH) is required")

    tok = tokenizer.get_wordpiece(vocab_path)

    def tokenize(texts):
        if isinstance(texts, (str, bytes)):
            texts = [texts]
        return np.stack([tokenizer.bert_tokenize(
            t.decode("utf-8", "replace") if isinstance(t, bytes) else t,
            tok, ctx) for t in texts])

    tokenize.context_length = ctx
    return tokenize
