"""Text transformer tower.

Port of ``clipa_tpu/models/text.py``: token embedding (std 0.02), learned
(std 0.01) or fixed sincos1d position embeddings sliced to the input
length, encoder blocks with the CLIP-paper init scales, optional causal
mask (the masked einsum attention path), final ``encoder_norm``, pools
``last`` / ``tok`` / ``gap`` / ``eot``, and the no-bias head. Parameters are
fp32; `dtype` is the compute dtype (None: fp32, as in flax), to which the
embedded tokens, posemb and every layer cast at use. ``remat_policy`` and
Dropout / DropPath are the encoder's (models/layers.py).

``embed_cls`` is the CoCa text tower (open_clip's TextTransformer with
``embed_cls``): a learned ``cls_emb`` is appended after the tokens, the
position table holds ``context_length + 1`` rows, attention is causal and
the cls row sees ``[1, text != pad_id]`` over the keys (the reference's
build_cls_mask, key j gated on ``text[j - 1]``); the pooled output is
``encoder_norm`` of the cls position and ``out["tokens"]`` the un-normed
token outputs in fp32, which the caption decoder norms itself.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import layers


def posemb_sincos_1d(max_len: int, width: int, min_scale: float = 1.0,
                     max_scale: float = 10_000.0) -> torch.Tensor:
    """Fixed 1D sin-cos posemb, (1, max_len, width) fp32: [sin | cos]
    halves (MoCo-v3 construction). Row i depends on i alone, so a longer
    table sliced to l rows is the table of l rows."""
    pe = np.zeros((max_len, width), dtype=np.float32)
    position = np.arange(max_len)[:, None]
    half = width // 2
    scale_factor = -np.log(max_scale / min_scale) / (half - 1)
    div_term = min_scale * np.exp(np.arange(half) * scale_factor)
    pe[:, :half] = np.sin(position * div_term)
    pe[:, half:2 * half] = np.cos(position * div_term)
    return torch.as_tensor(pe)[None]


class _Model(nn.Module):
    """Text encoder producing a pooled embedding (and optional head logits).

    `context_length` sizes the position table (flax sizes it from the init
    input, which is the context length), plus one row under `embed_cls`.
    """

    def __init__(self, num_classes: Optional[int] = None, *,
                 context_length: int = 77, width: int = 512, depth: int = 12,
                 mlp_dim: Optional[int] = None, num_heads: int = 8,
                 dropout: float = 0.0, drop_path: float = 0.0,
                 pool_type: str = "last", vocab_size: int = 32000,
                 attn_impl: str = "auto", causal_mask: bool = False,
                 gelu_approx: Any = True, ln_eps: float = 1e-6,
                 dtype: Any = None, remat_policy: Optional[str] = "none",
                 posemb: str = "learn", embed_cls: bool = False,
                 pad_id: int = 0):
        super().__init__()
        self.dtype = u.resolve_dtype(dtype) or torch.float32
        if pool_type not in ("last", "tok", "gap", "eot"):
            raise ValueError(f"Unknown pool_type {pool_type!r}")
        self.pool_type = pool_type
        self.causal_mask = causal_mask
        self.embed_cls = embed_cls
        self.pad_id = pad_id
        self.num_pos = context_length + (1 if embed_cls else 0)
        self.Embed_0 = nn.Embedding(vocab_size, width)
        self.cls_emb = (nn.Parameter(torch.empty(1, 1, width))
                        if embed_cls else None)
        if posemb == "learn":
            self.pos_embedding = nn.Parameter(torch.empty(1, self.num_pos,
                                                          width))
        elif posemb == "sincos1d":
            self.register_buffer("pos_embedding", posemb_sincos_1d(
                self.num_pos, width), persistent=False)
        else:
            raise ValueError(f"Unknown posemb {posemb!r}")
        self.dropout = layers.Dropout(dropout)
        # CLIP-paper residual-scaled initializers, constant across blocks.
        std_attn = width ** -0.5
        std_proj = (width ** -0.5) * ((2 * depth) ** -0.5)
        block_inits = dict(
            attn_qkv_init=layers.normal(std_attn),
            attn_out_init=layers.normal(std_proj),
            mlp_fc_init=layers.normal((2 * width) ** -0.5),
            mlp_proj_init=layers.normal(std_proj),
        )
        self.Transformer = layers.Encoder(
            depth, width, num_heads, mlp_dim=mlp_dim, dropout=dropout,
            drop_path=drop_path, block_inits=block_inits,
            attn_impl=attn_impl, gelu_approx=gelu_approx, ln_eps=ln_eps,
            remat_policy=remat_policy)
        self.encoder_norm = layers.LayerNorm(width, eps=ln_eps)
        self.head = None
        if num_classes:
            self.head = layers.QuantDense(
                width, num_classes, kernel_init=layers.normal(width ** -0.5),
                use_bias=False)

    def init_own_parameters(self, generator):
        layers.normal(0.02)(self.Embed_0.weight, (), generator)
        if self.embed_cls:
            layers.normal(0.01)(self.cls_emb, (), generator)
        if isinstance(self.pos_embedding, nn.Parameter):
            layers.normal(0.01)(self.pos_embedding, (), generator)

    def forward(self, text: torch.Tensor):
        """text: (n, l) int token ids. Returns the fp32 (n, C) embedding and
        a dict of intermediates."""
        out = {}
        # take then cast: the same values as flax's cast-then-take
        x = self.Embed_0(text).to(self.dtype)
        n = x.shape[0]
        if self.embed_cls:
            x = torch.cat([x, self.cls_emb.to(x.dtype).expand(n, -1, -1)],
                          dim=1)
        l = x.shape[1]
        if l > self.num_pos:
            raise ValueError(f"input length {l} exceeds positional capacity "
                             f"{self.num_pos}")
        x = self.dropout(x + self.pos_embedding[:, :l].to(x.dtype))

        mask = None
        if self.causal_mask or self.embed_cls:
            mask = torch.tril(torch.ones(l, l, dtype=torch.bool,
                                         device=x.device))[None, None]
        if self.embed_cls:
            cls_row = torch.cat([torch.ones(n, 1, dtype=torch.bool,
                                            device=x.device),
                                 text != self.pad_id], dim=1)
            mask = mask.expand(n, 1, l, l).clone()
            mask[:, 0, -1, :] = cls_row
        x = self.Transformer(x, mask)

        if self.embed_cls:
            out["tokens"] = x[:, :-1].float()
            x = self.encoder_norm(x[:, -1])
            out["head_input"] = x
            if self.head is not None:
                x = self.head(x)
                out["logits"] = x
            return x.float(), out

        x = self.encoder_norm(x)

        if self.pool_type == "last":
            x = x[:, -1, :]
        elif self.pool_type == "tok":
            x = x[:, 0]
        elif self.pool_type == "gap":
            x = x[:, 1:].mean(dim=1)
        else:  # "eot": the highest token id marks the end of a BPE sequence
            x = x[torch.arange(n, device=x.device), text.argmax(dim=-1)]
        out["head_input"] = x

        if self.head is not None:
            x = self.head(x)
            out["logits"] = x
        return x.float(), out


def Model(num_classes=None, *, variant=None, **kw):  # noqa: N802
    """Builds a text tower from a variant string plus overrides."""
    return _Model(num_classes, **{**decode_variant(variant), **kw})


def decode_variant(variant: Optional[str]) -> dict:
    """Text-tower size table (note B = width 512 / 8 heads, unlike image B)."""
    if variant is None:
        return {}
    v = variant.split("/")[0]
    return {
        "width": {"Ti": 192, "S": 384, "M": 512, "B": 512, "L": 768,
                  "H": 1024, "g": 1408, "G": 1664, "e": 1792}[v],
        "depth": {"Ti": 12, "S": 12, "M": 12, "B": 12, "L": 12,
                  "H": 24, "g": 40, "G": 48, "e": 56}[v],
        "mlp_dim": {"Ti": 768, "S": 1536, "M": 2048, "B": 2048, "L": 3072,
                    "H": 4096, "g": 6144, "G": 8192, "e": 15360}[v],
        "num_heads": {"Ti": 3, "S": 6, "M": 8, "B": 8, "L": 12,
                      "H": 16, "g": 16, "G": 16, "e": 16}[v],
    }


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads tower params from an npz checkpoint, merging with `init_params`
    (a tree of the tower's tensors) under `dont_load`."""
    del model_cfg
    from clipa_tpu_torch.models import common
    from clipa_tpu_torch.train import checkpoint
    return common.merge_params(checkpoint.load_params(init_file),
                               init_params, dont_load)
