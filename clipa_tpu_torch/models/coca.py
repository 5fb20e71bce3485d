"""CoCa: contrastive captioner (two towers and a caption decoder).

Port of ``clipa_tpu/models/coca.py``: a ViT image tower (``pool_type="0"``)
whose token sequence is pooled either by the attentional pooler
(``img_pool``, then ``img_encoder_norm``: token 0 is the contrastive
embedding, the rest feed the decoder) or as open_clip pools
(``img_encoder_norm`` of the class token; the raw patch tokens feed the
decoder), the bias-free ``img_head``; the ``embed_cls`` text tower
(models/text.py), whose un-normed token outputs feed the caption decoder
(models/multimodal.py); and the learned temperature ``t``.

``text_model`` may instead be an HF trunk (``hf_text`` or ``t5_text``:
coca_roberta-ViT-B-32): its pooled projection is the contrastive
embedding and the decoder cross-reads its unprojected ``encoded``
sequence.

``forward(image, text)`` returns ``(zimg, ztxt, out)`` as the two-tower
model does, with ``out["logits"]`` (fp32 next-token logits over the text
positions) and ``out["labels"]``: under ``embed_cls`` (training, serving)
the tower reads ``text[:, :-1]`` -- the HF trunks too, which append no cls
of their own -- and the labels are the last ``len(tokens)`` ids of the
untruncated text, i.e. ``text[:, 1:]``; generation passes
``embed_cls=False`` to decode over the whole prefix. The trainer, the
evaluators and serving take it through the two-tower interface
(``config.model_name = "coca"``, ``config.loss = "coca"``).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple, Union

import torch
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import (get_model_module, layers, multimodal,
                                    text as text_lib, vit)

# The text towers under the decoder, and the output of each it reads.
_TEXT_TOKENS = {"text_transformer": "tokens", "hf_text": "encoded",
                "t5_text": "encoded"}


class AttentionalPooler(nn.Module):
    """`n_queries` learned queries attend over the image tokens: q from
    ``ln_q(query)`` (no batch dimension), k and v projected from
    ``ln_k(context)`` (context width to `d_model`), fp32 softmax,
    ``out_proj``. flax ``nn.Dense`` defaults for the projections."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8,
                 n_queries: int = 256, ln_eps: float = 1e-5,
                 dtype: Any = None):
        super().__init__()
        self.dtype = u.resolve_dtype(dtype)
        self.n_head = n_head
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.ln_k = layers.LayerNorm(context_dim, eps=ln_eps)
        self.ln_q = layers.LayerNorm(d_model, eps=ln_eps)
        for name, d_in in (("q_proj", d_model), ("k_proj", context_dim),
                           ("v_proj", context_dim), ("out_proj", d_model)):
            self.add_module(name, layers.QuantDense(
                d_in, d_model, kernel_init=layers.lecun_normal()))

    def init_own_parameters(self, generator):
        layers.normal(1.0)(self.query, (), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        b = x.shape[0]
        nq, d = self.query.shape
        hd = d // self.n_head
        x = self.ln_k(x.to(dtype))
        q = self.q_proj(self.ln_q(self.query.to(dtype)))
        q = q.reshape(1, nq, self.n_head, hd).expand(b, -1, -1, -1)
        k = self.k_proj(x).reshape(b, -1, self.n_head, hd)
        v = self.v_proj(x).reshape(b, -1, self.n_head, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        attn = torch.softmax(logits.float(), dim=-1).to(dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, nq, d)
        return self.out_proj(y)


class Model(nn.Module):

    def __init__(self, image: Optional[dict] = None,
                 text: Optional[dict] = None,
                 multimodal_cfg: Optional[dict] = None,
                 image_model: str = "vit",
                 text_model: str = "text_transformer",
                 out_dim: Union[int, Tuple[int, int]] = 512,
                 temperature_init: float = 1 / 0.07,
                 attentional_pool: bool = False, n_queries: int = 256,
                 attn_pooler_heads: int = 8, pad_id: int = 0,
                 ln_eps: float = 1e-5, dtype: Any = None):
        super().__init__()
        if image_model != "vit":
            raise NotImplementedError(f"the CoCa image tower {image_model!r} "
                                      "is not ported (only 'vit')")
        if text_model not in _TEXT_TOKENS:
            raise NotImplementedError(
                f"the CoCa text tower {text_model!r} is not ported (ported: "
                f"{sorted(_TEXT_TOKENS)})")
        out_dims = (out_dim, out_dim) if isinstance(out_dim, int) else out_dim
        self.tokens_key = _TEXT_TOKENS[text_model]
        if text_model == "text_transformer":
            self.txt = text_lib.Model(**{"num_classes": out_dims[1],
                                         "dtype": dtype, "embed_cls": True,
                                         "pad_id": pad_id, **(text or {})})
            text_width = self.txt.Embed_0.embedding_dim
        else:
            self.txt = get_model_module(text_model).Model(
                **{"num_classes": out_dims[1], "dtype": dtype,
                   **(text or {})})
            text_width = self.txt.word_embeddings.embedding_dim
        self.img = vit.Model(**{"num_classes": None, "pool_type": "0",
                                "dtype": dtype, **(image or {})})
        pooled = self.img.width
        self.img_pool = None
        if attentional_pool:
            self.img_pool = AttentionalPooler(
                out_dims[0], self.img.width, n_head=attn_pooler_heads,
                n_queries=n_queries, ln_eps=ln_eps, dtype=dtype)
            pooled = out_dims[0]
        self.img_encoder_norm = layers.LayerNorm(pooled, eps=ln_eps)
        self.img_head = layers.QuantDense(
            pooled, out_dims[0], kernel_init=layers.normal(pooled ** -0.5),
            use_bias=False)
        mm = dict(multimodal_cfg or {})
        self.decoder = multimodal.Decoder(
            vocab_size=mm.pop("vocab_size", (text or {}).get("vocab_size",
                                                             49408)),
            width=mm.pop("width", text_width), dtype=dtype, ln_eps=ln_eps,
            **mm)
        self.temperature_init = temperature_init
        self.t = nn.Parameter(torch.empty(1))

    def init_own_parameters(self, generator):
        self.t.fill_(math.log(self.temperature_init))

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Stores every weight in `dtype` but the LayerNorms' and `t`:
        serving's layout (see two_towers.Model.set_compute_dtype)."""
        for child in self.children():
            layers.cast_params(child, dtype)

    def encode_image(self, image: torch.Tensor, mask_ratio: float = 0.0,
                     generator: Optional[torch.Generator] = None):
        """(n, H, W, 3) images -> (unit-norm fp32 (n, C) embeddings, their
        norms, the (n, N, width) tokens the decoder reads)."""
        _, out_img = self.img(image, mask_ratio=mask_ratio,
                              generator=generator)
        encoded = out_img["encoded"]
        if self.img_pool is not None:
            x = self.img_encoder_norm(self.img_pool(encoded))
            pooled, tokens = x[:, 0], x[:, 1:]
        else:
            pooled = self.img_encoder_norm(encoded[:, 0])
            tokens = encoded[:, 1:]
        zimg = self.img_head(pooled).float()
        norm = torch.linalg.norm(zimg, dim=1, keepdim=True)
        return zimg / (norm + 1e-8), norm, tokens

    def forward(self, image: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None,
                mask_ratio: float = 0.0,
                generator: Optional[torch.Generator] = None,
                embed_cls: bool = True):
        """Returns (zimg, ztxt, out); out carries the caption ``logits``
        and ``labels`` when both inputs are given."""
        out: dict[str, Any] = {}
        zimg = ztxt = text_tokens = image_tokens = None
        if text is not None:
            ztxt, out_txt = self.txt(text[:, :-1] if embed_cls else text)
            text_tokens = out_txt[self.tokens_key]
            out["txt/norm"] = torch.linalg.norm(ztxt, dim=1, keepdim=True)
            out["txt/normalized"] = ztxt = ztxt / (out["txt/norm"] + 1e-8)
            out["labels"] = text[:, -text_tokens.shape[1]:]
            out.update({f"txt/{k}": v for k, v in out_txt.items()})
        if image is not None:
            zimg, out["img/norm"], image_tokens = self.encode_image(
                image, mask_ratio, generator)
            out["img/normalized"] = zimg
        if text_tokens is not None and image_tokens is not None:
            out["logits"] = self.decoder(text_tokens, image_tokens)
        out["t"] = torch.exp(self.t)
        out["t/parameter"] = self.t
        return zimg, ztxt, out


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads a CoCa npz checkpoint, merging with `init_params` (the model's
    tree of tensors) under `dont_load`."""
    del model_cfg
    from clipa_tpu_torch.models import common
    from clipa_tpu_torch.train import checkpoint
    return common.merge_params(checkpoint.load_params(init_file),
                               init_params, dont_load)
