"""CoCa multimodal text decoder (the captioning head).

Port of ``clipa_tpu/models/multimodal.py``: per layer, a causal
self-attention block over the text tokens (``encoderblock_i``) and a
residual cross-attention block with its own MLP (``crossblock_i``) whose
keys and values are the image tokens, LayerNormed by the block's ``ln_kv``;
then ``encoder_norm`` and a bias-free projection to the vocabulary, whose
logits leave in fp32. Both block kinds take the CLIP-paper residual-scaled
inits and attend on the einsum path (the JAX decoder's ``attn_impl="xla"``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import layers


def _inits(width: int, depth: int) -> dict:
    """The decoder's residual-scaled inits (MultimodalTransformer's
    init_parameters) for both block kinds."""
    std_attn = width ** -0.5
    std_proj = (width ** -0.5) * ((2 * depth) ** -0.5)
    return dict(attn_qkv_init=layers.normal(std_attn),
                attn_out_init=layers.normal(std_proj),
                mlp_fc_init=layers.normal((2 * width) ** -0.5),
                mlp_proj_init=layers.normal(std_proj))


class CrossAttnBlock(nn.Module):
    """Pre-LN residual cross-attention block with its own MLP: q from
    ``LayerNorm_0(x)``, k and v from ``ln_kv(context)``; then
    ``LayerNorm_1`` and the MLP. Dropout after each branch."""

    def __init__(self, width: int, num_heads: int,
                 mlp_dim: Optional[int] = None, dropout: float = 0.0,
                 attn_qkv_init: layers.Init = layers.xavier_uniform(),
                 attn_out_init: layers.Init = layers.xavier_uniform(),
                 mlp_fc_init: layers.Init = layers.xavier_uniform(),
                 mlp_proj_init: layers.Init = layers.xavier_uniform(),
                 gelu_approx: Any = False, ln_eps: float = 1e-5):
        super().__init__()
        self.ln_kv = layers.LayerNorm(width, eps=ln_eps)
        self.LayerNorm_0 = layers.LayerNorm(width, eps=ln_eps)
        self.MultiHeadDotProductAttention_0 = layers.MultiHeadAttention(
            width, num_heads, qkv_kernel_init=attn_qkv_init,
            out_kernel_init=attn_out_init, attn_impl="einsum")
        self.LayerNorm_1 = layers.LayerNorm(width, eps=ln_eps)
        self.MlpBlock_0 = layers.MlpBlock(width, mlp_dim, dropout,
                                          fc_init=mlp_fc_init,
                                          proj_init=mlp_proj_init,
                                          gelu_approx=gelu_approx)
        self.dropout = layers.Dropout(dropout)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        kv = self.ln_kv(context.to(x.dtype))
        y = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), kv)
        x = x + self.dropout(y)
        y = self.MlpBlock_0(self.LayerNorm_1(x))
        return x + self.dropout(y)


class Decoder(nn.Module):
    """(causal self-attention block, cross-attention block) x depth, then
    ``encoder_norm`` and ``head``. forward(text_embs (B, L, width),
    image_embs (B, N, width)) -> fp32 (B, L, vocab) logits aligned with the
    text positions. `dtype` is the compute dtype (None: the text's)."""

    def __init__(self, vocab_size: int, width: int = 512, depth: int = 12,
                 num_heads: int = 8, mlp_dim: Optional[int] = None,
                 dropout: float = 0.0, dtype: Any = None,
                 gelu_approx: Any = False, ln_eps: float = 1e-5):
        super().__init__()
        self.dtype = u.resolve_dtype(dtype)
        self.depth = depth
        inits = _inits(width, depth)
        for i in range(depth):
            self.add_module(f"encoderblock_{i}", layers.EncoderBlock(
                width, num_heads, mlp_dim=mlp_dim, dropout=dropout,
                attn_impl="einsum", gelu_approx=gelu_approx, ln_eps=ln_eps,
                **inits))
            self.add_module(f"crossblock_{i}", CrossAttnBlock(
                width, num_heads, mlp_dim=mlp_dim, dropout=dropout,
                gelu_approx=gelu_approx, ln_eps=ln_eps, **inits))
        self.encoder_norm = layers.LayerNorm(width, eps=ln_eps)
        self.head = layers.QuantDense(width, vocab_size,
                                      kernel_init=layers.normal(width ** -0.5),
                                      use_bias=False)

    def forward(self, text_embs: torch.Tensor,
                image_embs: torch.Tensor) -> torch.Tensor:
        x = text_embs.to(self.dtype or text_embs.dtype)
        l = x.shape[1]
        causal = torch.tril(torch.ones(l, l, dtype=torch.bool,
                                       device=x.device))[None, None]
        for i in range(self.depth):
            x = getattr(self, f"encoderblock_{i}")(x, mask=causal)
            x = getattr(self, f"crossblock_{i}")(x, image_embs)
        return self.head(self.encoder_norm(x)).float()
