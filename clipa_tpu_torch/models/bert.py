"""BERT text tower (LiT-style text initialization).

Port of ``clipa_tpu/models/bert.py``: word, position and one type embedding
(std 0.02), ``embeddings_norm``, post-LN blocks (:class:`BertBlock`:
attention, add, ``LayerNorm_0``; MLP with the erf GELU, add,
``LayerNorm_1``; flax's LayerNorm epsilon, 1e-6, in every norm), then the
``tok`` pool (a tanh ``pooler`` of position 0) or ``gap``, and the no-bias
head. Parameters are fp32; `dtype` is the compute dtype (None: fp32).

The attention is unmasked, as in the JAX tower, so it takes the fused
kernels from 33 tokens on (``ops.attention``'s dispatch, the q/k/v biases
inside the kernel), the einsum path below.

:func:`convert_hf_state_dict` maps a HuggingFace ``BertModel`` state dict
onto the tower (strictly; the token-type row 0 only); :func:`load` reads
an npz, a ``.pt``/``.bin`` or ``.safetensors`` HF file, or ``hf:<name>``
through ``transformers`` (both libraries imported only there).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import layers


class BertBlock(nn.Module):
    """Post-LN transformer block (BERT's order). `mask`: optional boolean
    (B, 1|H, L, L) keys to attend."""

    def __init__(self, width: int, num_heads: int, mlp_dim: int,
                 dropout: float = 0.0, gelu_approx: Any = False,
                 attn_impl: str = "auto"):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = layers.MultiHeadAttention(
            width, num_heads, qkv_kernel_init=layers.normal(0.02),
            out_kernel_init=layers.normal(0.02), attn_impl=attn_impl)
        self.LayerNorm_0 = layers.LayerNorm(width, eps=1e-6)
        self.MlpBlock_0 = layers.MlpBlock(
            width, mlp_dim, dropout, fc_init=layers.normal(0.02),
            proj_init=layers.normal(0.02), gelu_approx=gelu_approx)
        self.LayerNorm_1 = layers.LayerNorm(width, eps=1e-6)
        self.dropout = layers.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.MultiHeadDotProductAttention_0(x, x, mask=mask)
        x = self.LayerNorm_0(x + self.dropout(y))
        y = self.MlpBlock_0(x)
        return self.LayerNorm_1(x + self.dropout(y))


class _Model(nn.Module):
    """BERT encoder with a pooled embedding (and optional head logits).
    `context_length` (the trainer's) is unused: the position table holds
    `max_len` rows."""

    def __init__(self, num_classes: Optional[int] = None, *,
                 width: int = 768, depth: int = 12,
                 mlp_dim: Optional[int] = None, num_heads: int = 12,
                 vocab_size: int = 30522, max_len: int = 512,
                 dropout: float = 0.0, pool_type: str = "tok",
                 head_zeroinit: bool = False, dtype: Any = None,
                 attn_impl: str = "auto",
                 context_length: Optional[int] = None):
        super().__init__()
        del context_length
        if pool_type not in ("tok", "gap"):
            raise ValueError(f"Unknown pool_type {pool_type!r}")
        self.dtype = u.resolve_dtype(dtype) or torch.float32
        self.pool_type = pool_type
        self.word_embeddings = nn.Embedding(vocab_size, width)
        self.position_embeddings = nn.Parameter(torch.empty(1, max_len,
                                                            width))
        self.type_embeddings = nn.Parameter(torch.empty(1, 1, width))
        self.embeddings_norm = layers.LayerNorm(width, eps=1e-6)
        self.dropout = layers.Dropout(dropout)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"encoderblock_{i}", BertBlock(
                width, num_heads, mlp_dim or 4 * width, dropout,
                attn_impl=attn_impl))
        self.pooler = (layers.QuantDense(width, width,
                                         kernel_init=layers.normal(0.02))
                       if pool_type == "tok" else None)
        self.head = None
        if num_classes:
            self.head = layers.QuantDense(
                width, num_classes, use_bias=False,
                kernel_init=(layers.zeros() if head_zeroinit
                             else layers.normal(width ** -0.5)))

    def init_own_parameters(self, generator):
        for p in (self.word_embeddings.weight, self.position_embeddings,
                  self.type_embeddings):
            layers.normal(0.02)(p, (), generator)

    def forward(self, text: torch.Tensor):
        """text: (n, l) int ids. Returns the fp32 (n, C) embedding and a dict
        of intermediates (``encoded``: the (n, l, width) sequence)."""
        out = {}
        x = self.word_embeddings(text).to(self.dtype)
        x = x + self.position_embeddings[:, :x.shape[1]].to(self.dtype)
        x = x + self.type_embeddings.to(self.dtype)   # single-segment input
        x = self.dropout(self.embeddings_norm(x))
        for i in range(self.depth):
            x = getattr(self, f"encoderblock_{i}")(x)
        out["encoded"] = x
        if self.pooler is not None:
            pooled = torch.tanh(self.pooler(x[:, 0]))
        else:
            pooled = x.mean(dim=1)
        out["head_input"] = pooled
        if self.head is not None:
            pooled = self.head(pooled)
            out["logits"] = pooled
        return pooled.float(), out


def Model(num_classes=None, *, variant=None, **kw):  # noqa: N802
    return _Model(num_classes, **{**decode_variant(variant), **kw})


def decode_variant(variant: Optional[str]) -> dict:
    if variant is None:
        return {}
    return {
        "base": {"width": 768, "depth": 12, "mlp_dim": 3072, "num_heads": 12},
        "large": {"width": 1024, "depth": 24, "mlp_dim": 4096,
                  "num_heads": 16},
    }[variant]


def convert_hf_state_dict(sd: dict, depth: int, num_heads: int) -> dict:
    """A HuggingFace ``BertModel`` state dict (numpy arrays or tensors) ->
    this tower's parameter tree in the JAX layout (numpy), as the JAX
    package maps it: the MLM head (``cls.*``) dropped, the token-type row 0
    only. Raises KeyError on a missing key and ValueError on a key left
    unconsumed."""
    sd = {k: np.asarray(v) for k, v in sd.items() if not k.startswith("cls.")}
    consumed = set()

    def take(name):
        consumed.add(name)
        return sd[name]

    width = take("embeddings.word_embeddings.weight").shape[1]
    hd = width // num_heads
    p = {
        "word_embeddings": {
            "embedding": take("embeddings.word_embeddings.weight")},
        "position_embeddings":
            take("embeddings.position_embeddings.weight")[None],
        "type_embeddings":
            take("embeddings.token_type_embeddings.weight")[:1][None],
        "embeddings_norm": {"scale": take("embeddings.LayerNorm.weight"),
                            "bias": take("embeddings.LayerNorm.bias")},
        "pooler": {"kernel": take("pooler.dense.weight").T,
                   "bias": take("pooler.dense.bias")},
    }
    for i in range(depth):
        hf = f"encoder.layer.{i}."
        attn = {}
        for ours in ("query", "key", "value"):
            w = take(hf + f"attention.self.{ours}.weight")
            attn[ours] = {"kernel": w.T.reshape(width, num_heads, hd),
                          "bias": take(hf + f"attention.self.{ours}.bias")
                          .reshape(num_heads, hd)}
        attn["out"] = {
            "kernel": take(hf + "attention.output.dense.weight").T.reshape(
                num_heads, hd, width),
            "bias": take(hf + "attention.output.dense.bias")}
        p[f"encoderblock_{i}"] = {
            "MultiHeadDotProductAttention_0": attn,
            "LayerNorm_0": {
                "scale": take(hf + "attention.output.LayerNorm.weight"),
                "bias": take(hf + "attention.output.LayerNorm.bias")},
            "MlpBlock_0": {
                "Dense_0": {"kernel": take(hf + "intermediate.dense.weight").T,
                            "bias": take(hf + "intermediate.dense.bias")},
                "Dense_1": {"kernel": take(hf + "output.dense.weight").T,
                            "bias": take(hf + "output.dense.bias")}},
            "LayerNorm_1": {"scale": take(hf + "output.LayerNorm.weight"),
                            "bias": take(hf + "output.LayerNorm.bias")},
        }
    leftover = set(sd) - consumed
    if leftover:
        raise ValueError(f"Unconsumed HF BERT keys: {sorted(leftover)[:8]}"
                         f"{'...' if len(leftover) > 8 else ''}")
    return p


def _tensors(tree):
    """A nested tree of numpy arrays as CPU tensors."""
    return {k: _tensors(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads the tower from an npz checkpoint, a HuggingFace file
    (``.pt``/``.bin`` by ``torch.load``, ``.safetensors``) or ``hf:<name>``
    (``transformers``' cache), merged with `init_params` (the tower's tree
    of tensors) under `dont_load`. The head count is `model_cfg`'s
    ``num_heads`` (12 without one)."""
    from clipa_tpu_torch.models import common
    from clipa_tpu_torch.train import checkpoint

    init_file = str(init_file)
    depth = len([k for k in init_params if k.startswith("encoderblock_")])
    heads = (model_cfg or {}).get("num_heads", 12)
    if init_file.startswith("hf:"):
        from transformers import BertModel
        hf = BertModel.from_pretrained(init_file[3:])
        restored = _tensors(convert_hf_state_dict(
            {k: v.detach().numpy() for k, v in hf.state_dict().items()},
            depth, heads))
    elif init_file.endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = {k.removeprefix("bert."): v.numpy()
              for k, v in load_file(init_file).items()}
        restored = _tensors(convert_hf_state_dict(sd, depth, heads))
    elif init_file.endswith((".pt", ".bin")):
        sd = torch.load(init_file, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        sd = {k.removeprefix("bert."): v.numpy() for k, v in sd.items()}
        restored = _tensors(convert_hf_state_dict(sd, depth, heads))
    else:
        restored = checkpoint.load_params(init_file)
    return common.merge_params(restored, init_params, dont_load)
