"""RoBERTa-family text tower (open_clip's HF text encoder over roberta and
xlm-roberta trunks).

Port of ``clipa_tpu/models/hf_text.py``: RoBERTa's embeddings (position ids
``cumsum(mask) * mask + pad_id`` over a ``max_len`` table, one type
embedding, ``embeddings_norm`` at ``ln_eps``), the pad-masked post-LN
:class:`~clipa_tpu_torch.models.bert.BertBlock` s (their norms at flax's
1e-6, as in the JAX tower), the masked mean pool over non-pad positions,
and open_clip's projection: ``mlp`` (``proj_fc`` to ``(width + out) // 2``,
the erf GELU, ``head``, no biases) or ``linear`` (``head`` alone).

The masks keep attention on the einsum path. The mean pool divides by the
count of non-pad ids with no floor, as the JAX tower does: a row of pads
alone pools to NaN.

:func:`convert_hf_roberta` maps a ``transformers`` Roberta / XLMRoberta
state dict onto the tower, strictly.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import layers
from clipa_tpu_torch.models.bert import BertBlock

# The architectures of the zoo's hf_model_name values (the model cards'
# configs; the JAX package's table).
HF_ARCHS = {
    "roberta-base": dict(width=768, depth=12, num_heads=12, mlp_dim=3072,
                         vocab_size=50265, max_len=514, pad_id=1),
    "xlm-roberta-base": dict(width=768, depth=12, num_heads=12,
                             mlp_dim=3072, vocab_size=250002, max_len=514,
                             pad_id=1),
    "xlm-roberta-large": dict(width=1024, depth=24, num_heads=16,
                              mlp_dim=4096, vocab_size=250002, max_len=514,
                              pad_id=1),
}


class _Model(nn.Module):
    """`context_length` (the trainer's) is unused: positions are counted
    over the non-pad ids."""

    def __init__(self, num_classes: Optional[int] = None, *,
                 width: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: Optional[int] = None, vocab_size: int = 50265,
                 max_len: int = 514, pad_id: int = 1, dropout: float = 0.0,
                 proj: Optional[str] = "mlp", ln_eps: float = 1e-5,
                 dtype: Any = None, attn_impl: str = "auto",
                 context_length: Optional[int] = None):
        super().__init__()
        del context_length
        self.dtype = u.resolve_dtype(dtype) or torch.float32
        self.pad_id = pad_id
        self.num_classes = num_classes
        self.word_embeddings = nn.Embedding(vocab_size, width)
        self.position_embeddings = nn.Parameter(torch.empty(max_len, width))
        self.type_embeddings = nn.Parameter(torch.empty(1, 1, width))
        self.embeddings_norm = layers.LayerNorm(width, eps=ln_eps)
        self.dropout = layers.Dropout(dropout)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"encoderblock_{i}", BertBlock(
                width, num_heads, mlp_dim or 4 * width, dropout,
                attn_impl=attn_impl))
        self.proj_fc = self.head = None
        if num_classes and proj == "mlp":
            hidden = (width + num_classes) // 2
            self.proj_fc = layers.QuantDense(
                width, hidden, kernel_init=layers.normal(0.02),
                use_bias=False)
            self.head = layers.QuantDense(
                hidden, num_classes, kernel_init=layers.normal(0.02),
                use_bias=False)
        elif num_classes and proj == "linear":
            self.head = layers.QuantDense(
                width, num_classes, kernel_init=layers.normal(0.02),
                use_bias=False)

    def init_own_parameters(self, generator):
        for p in (self.word_embeddings.weight, self.position_embeddings,
                  self.type_embeddings):
            layers.normal(0.02)(p, (), generator)

    def forward(self, text: torch.Tensor):
        """text: (n, l) int ids, `pad_id` for padding. Returns the fp32
        (n, C) embedding and a dict of intermediates (``encoded``: the
        (n, l, width) sequence the CoCa decoder reads)."""
        out = {}
        keep = text != self.pad_id
        x = self.word_embeddings(text).to(self.dtype)
        pos_ids = torch.cumsum(keep, dim=1) * keep + self.pad_id
        x = x + self.position_embeddings[pos_ids].to(self.dtype)
        x = x + self.type_embeddings.to(self.dtype)   # single-segment input
        x = self.dropout(self.embeddings_norm(x))
        mask = keep[:, None, None, :]   # keys, for every query
        for i in range(self.depth):
            x = getattr(self, f"encoderblock_{i}")(x, mask)
        out["encoded"] = x

        m = keep[..., None].to(x.dtype)
        pooled = (x * m).sum(dim=1) / m.sum(dim=1)
        out["head_input"] = pooled
        if self.proj_fc is not None:
            pooled = F.gelu(self.proj_fc(pooled))
        if self.head is not None:
            pooled = self.head(pooled)
        if self.num_classes:
            out["logits"] = pooled
        return pooled.float(), out


def Model(num_classes=None, *, variant=None, **kw):  # noqa: N802
    return _Model(num_classes, **{**(HF_ARCHS.get(variant) or {}), **kw})


def convert_hf_roberta(sd: dict, depth: int, num_heads: int) -> dict:
    """A ``transformers`` Roberta / XLMRoberta state dict (numpy arrays or
    tensors; a ``roberta.`` prefix is dropped) -> this tower's parameter
    tree in the JAX layout (numpy), as the JAX package maps it: the
    token-type row 0 only; ``position_ids`` and the pooler are not used.
    Raises ValueError on any other tensor left unconsumed."""
    sd = {k.removeprefix("roberta."): np.asarray(v) for k, v in sd.items()}
    consumed = set()

    def take(name):
        consumed.add(name)
        return sd[name]

    flat = {
        "word_embeddings/embedding": take("embeddings.word_embeddings.weight"),
        "position_embeddings": take("embeddings.position_embeddings.weight"),
        "type_embeddings": take("embeddings.token_type_embeddings.weight")
        [:1].reshape(1, 1, -1),
        "embeddings_norm/scale": take("embeddings.LayerNorm.weight"),
        "embeddings_norm/bias": take("embeddings.LayerNorm.bias"),
    }
    width = flat["word_embeddings/embedding"].shape[1]
    hd = width // num_heads
    for i in range(depth):
        b, o = f"encoder.layer.{i}", f"encoderblock_{i}"
        attn = f"{o}/MultiHeadDotProductAttention_0"
        for name in ("query", "key", "value"):
            flat[f"{attn}/{name}/kernel"] = take(
                f"{b}.attention.self.{name}.weight").T.reshape(
                    width, num_heads, hd)
            flat[f"{attn}/{name}/bias"] = take(
                f"{b}.attention.self.{name}.bias").reshape(num_heads, hd)
        flat[f"{attn}/out/kernel"] = take(
            f"{b}.attention.output.dense.weight").T.reshape(num_heads, hd,
                                                            width)
        flat[f"{attn}/out/bias"] = take(f"{b}.attention.output.dense.bias")
        for ours, theirs in (("LayerNorm_0", "attention.output.LayerNorm"),
                             ("LayerNorm_1", "output.LayerNorm")):
            flat[f"{o}/{ours}/scale"] = take(f"{b}.{theirs}.weight")
            flat[f"{o}/{ours}/bias"] = take(f"{b}.{theirs}.bias")
        for ours, theirs in (("Dense_0", "intermediate.dense"),
                             ("Dense_1", "output.dense")):
            flat[f"{o}/MlpBlock_0/{ours}/kernel"] = take(
                f"{b}.{theirs}.weight").T
            flat[f"{o}/MlpBlock_0/{ours}/bias"] = take(f"{b}.{theirs}.bias")

    ignorable = ("embeddings.position_ids", "pooler.dense.weight",
                 "pooler.dense.bias")
    leftover = [k for k in sd if k not in consumed
                and not k.endswith(ignorable)]
    if leftover:
        raise ValueError(
            f"convert_hf_roberta left {len(leftover)} tensors unconsumed: "
            f"{leftover[:8]}")
    return u.recover_tree(list(flat), list(flat.values()))


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads the tower from an npz checkpoint, merged with `init_params`
    (the tower's tree of tensors) under `dont_load`. (A HuggingFace state
    dict goes through :func:`convert_hf_roberta` first.)"""
    del model_cfg
    from clipa_tpu_torch.models import common
    from clipa_tpu_torch.train import checkpoint
    return common.merge_params(checkpoint.load_params(init_file),
                               init_params, dont_load)
