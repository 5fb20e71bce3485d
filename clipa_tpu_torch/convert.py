"""JAX flat parameter names <-> PyTorch ``state_dict`` of clipa_tpu_torch.

The port's modules keep the flax module names (``Transformer``,
``encoderblock_0``, ``MultiHeadDotProductAttention_0``, ``MlpBlock_0``,
``LayerNorm_0``, ``encoder_norm``, ``head``, ...), so a JAX name maps to a
``state_dict`` key by replacing "/" with "." and renaming the leaf. The
table (``...`` is any prefix, e.g. ``img/Transformer/encoderblock_3``):

=========================================================  ==================  =================================
JAX name (shape)                                           torch leaf          transform
=========================================================  ==================  =================================
``.../MultiHeadDotProductAttention_i/{query,key,value}/``  ``.weight``         ``reshape(d, H*hd).T``
``kernel`` (d, H, hd)
``.../MultiHeadDotProductAttention_i/{query,key,value}/``  ``.bias``           ``reshape(H*hd)``
``bias`` (H, hd)
``.../MultiHeadDotProductAttention_i/out/kernel``          ``.weight``         ``reshape(H*hd, d).T``
(H, hd, d)
``.../MultiHeadDotProductAttention_i/out/bias`` (d,)       ``.bias``           as is
``.../<Dense>/kernel`` (in, out)                           ``.weight``         ``.T`` (Linear layout)
``.../<Dense>/bias`` (out,)                                ``.bias``           as is
``.../<LayerNorm>/scale``                                  ``.weight``         as is
``.../<LayerNorm>/bias``                                   ``.bias``           as is
``.../<Conv>/kernel`` (kh, kw, in/groups, out)             ``.weight``         ``permute(3, 2, 0, 1)`` (OIHW)
``.../<Conv>/bias`` (out,)                                 ``.bias``           as is
``.../<BatchNorm>/scale``                                  ``.weight``         as is
``.../<BatchNorm>/bias``                                   ``.bias``           as is
``img/{embedding,patch_embed}/{kernel,bias}``              same name           as is (HWIO, NHWC stem; linear stem)
(p, p, 3, W) or (P, W)
``txt/{Embed_0,word_embeddings}/embedding`` (vocab, W)     ``.weight``         as is
``.../<as is>``, ``t``, ``b``                              same name           as is
=========================================================  ==================  =================================

``<Dense>`` is ``Dense_i``, ``head`` or CoCa's ``img_head``,
``{q,k,v,out}_proj``, BERT's ``pooler``, the HF towers' ``proj_fc``, T5's
``q``, ``k``, ``v``, ``o`` and ``block_i_{wi0,wi1,wo}``, Swin's and
relpos's ``qkv``, ``proj``, ``mlp_fc1``, ``mlp_fc2``, ``fc1``, ``fc2`` (the
bias MLP), ``reduction`` and ``head_mlp_fc``; ``<LayerNorm>`` is
``LayerNorm_i``, ``encoder_norm``, ``ln_pre``, CoCa's ``ln_kv``, ``ln_q``,
``ln_k``, ``img_encoder_norm``, the HF towers' ``embeddings_norm``, Swin's
and relpos's ``patch_norm``, ``norm``, ``norm1``, ``norm2``, and T5's RMS
norms ``block_i_ln{0,1}``, ``final_norm`` (a scale, no bias); ``<as is>``
is ``cls``, ``pos_embedding``, ``ls1``, ``ls2``, CoCa's ``cls_emb`` and
pooler ``query``, the MAP head's ``probe``, the HF towers'
``position_embeddings`` and ``type_embeddings``, T5's
``relative_attention_bias``, Swin's ``rel_pos_table`` and ConvNeXt's
LayerScale ``gamma``; ``<Conv>`` is ConvNeXt's ``dwconv`` (a depthwise
(7, 7, 1, C) kernel) and ``downsample_layers{i}1`` (i >= 1; the stem,
``embedding``, shares the ViT stem's JAX name and keeps its HWIO row) and
the ModifiedResNet's ``conv1..3`` and ``downsample_conv``; ``<BatchNorm>``
is the ModifiedResNet's ``bn1..3`` and ``downsample_bn``. ConvNeXt's
LayerNorms are ``downsample_layers01`` (the stem's), ``downsample_layers{i}0``
and ``norm``; its ``pwconv1``, ``pwconv2`` and the pool's ``c_proj`` are
``<Dense>``.

The JAX package's second collection, ``batch_stats`` (the BatchNorms'
running ``img/.../<BatchNorm>/{mean,var}``), maps to the BatchNorm
buffers of the same names (``.mean``, ``.var``) as they are: the loaders
take the JAX variables, ``{"params": ..., "batch_stats": ...}``, as well
as a bare params tree, and :func:`to_jax_variables` gives them back.

A name that matches no row raises: a weight silently dropped gives wrong
numbers. Keys the model expects but the checkpoint lacks (a BatchNorm's
statistics among them) are caught by :func:`load_jax_params`, which loads
strictly.

The inverse, :func:`to_jax_names` and :func:`to_jax_params`, reads the same
table from right to left (``...`` is any prefix with "." for "/"):

==========================================================  ==================  ===========================================
torch key                                                   JAX leaf            transform (to_jax_params)
==========================================================  ==================  ===========================================
``...MultiHeadDotProductAttention_i.{query,key,value}.``    ``/kernel``         ``.T.reshape(d, H, hd)``
``weight`` (H*hd, d)
``...MultiHeadDotProductAttention_i.{query,key,value}.``    ``/bias``           ``reshape(H, hd)``
``bias`` (H*hd,)
``...MultiHeadDotProductAttention_i.out.weight`` (d, H*hd)  ``/kernel``         ``.T.reshape(H, hd, d)``
``...MultiHeadDotProductAttention_i.out.bias`` (d,)         ``/bias``           as is
``...<Dense>.weight`` (out, in)                             ``/kernel``         ``.T``
``...<Dense>.bias`` (out,)                                  ``/bias``           as is
``...<LayerNorm>.weight``                                   ``/scale``          as is
``...<LayerNorm>.bias``                                     ``/bias``           as is
``...<Conv>.weight`` (out, in/groups, kh, kw)               ``/kernel``         ``permute(2, 3, 1, 0)`` (HWIO)
``...<Conv>.bias`` (out,)                                   ``/bias``           as is
``...<BatchNorm>.weight``                                   ``/scale``          as is
``...<BatchNorm>.bias``                                     ``/bias``           as is
``img.{embedding,patch_embed}.{kernel,bias}``               same name           as is
``txt.{Embed_0,word_embeddings}.weight`` (vocab, W)         ``/embedding``      as is
``...<as is>``, ``t``, ``b``                                same name           as is
==========================================================  ==================  ===========================================

The optimizer's regexes (``optim.py``) and the parity tests run on the JAX
names, so ``.*/kernel$`` selects the same tensors in both packages.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from clipa_tpu_torch import utils as u

Array = Union[np.ndarray, torch.Tensor]

_MHA = r"(?:.*/)?MultiHeadDotProductAttention_\d+"
# flax Dense layers (Linear layout in torch), LayerNorms (and T5's RMS
# norms, a scale only), and parameters kept as they are (CoCa's pooler,
# decoder and cls embedding, the HF towers' position and type tables, the
# relative position tables of T5 and Swin included)
_DENSE = (r"(?:Dense_\d+|head|img_head|q_proj|k_proj|v_proj|out_proj"
          r"|pooler|proj_fc|q|k|v|o|block_\d+_w(?:i0|i1|o)"
          r"|qkv|proj|mlp_fc1|mlp_fc2|fc1|fc2|reduction|head_mlp_fc"
          r"|pwconv1|pwconv2|c_proj)")
_NORM = (r"(?:LayerNorm_\d+|encoder_norm|ln_pre|ln_kv|ln_q|ln_k"
         r"|img_encoder_norm|embeddings_norm|block_\d+_ln[01]|final_norm"
         r"|patch_norm|norm|norm1|norm2|downsample_layers(?:01|\d0))")
_AS_IS = (r"(?:cls|pos_embedding|ls1|ls2|cls_emb|query|probe"
          r"|position_embeddings|type_embeddings|relative_attention_bias"
          r"|rel_pos_table|gamma)")
# convolutions in the OIHW layout (the stem `embedding` keeps its HWIO row)
# and BatchNorms (the conv towers)
_CONV = r"(?:dwconv|downsample_layers[1-9]1|conv[123]|downsample_conv)"
_BN = r"(?:bn[123]|downsample_bn)"
_STATS = re.compile(rf"(?:.*/)?{_BN}/(?:mean|var)")
_RULES: list[tuple[re.Pattern, str, Callable[[torch.Tensor], torch.Tensor]]] = [
    (re.compile(rf"({_MHA}/(?:query|key|value))/kernel"), r"\1/weight",
     lambda a: a.reshape(a.shape[0], -1).T),
    (re.compile(rf"({_MHA}/(?:query|key|value))/bias"), r"\1/bias",
     lambda a: a.reshape(-1)),
    (re.compile(rf"({_MHA}/out)/kernel"), r"\1/weight",
     lambda a: a.reshape(-1, a.shape[-1]).T),
    (re.compile(rf"({_MHA}/out)/bias"), r"\1/bias", lambda a: a),
    (re.compile(rf"((?:.*/)?{_DENSE})/kernel"), r"\1/weight",
     lambda a: a.T),
    (re.compile(rf"((?:.*/)?{_DENSE})/bias"), r"\1/bias", lambda a: a),
    (re.compile(rf"((?:.*/)?{_NORM})/scale"), r"\1/weight", lambda a: a),
    (re.compile(rf"((?:.*/)?{_NORM})/bias"), r"\1/bias", lambda a: a),
    (re.compile(rf"((?:.*/)?{_CONV})/kernel"), r"\1/weight",
     lambda a: a.permute(3, 2, 0, 1)),
    (re.compile(rf"((?:.*/)?{_CONV})/bias"), r"\1/bias", lambda a: a),
    (re.compile(rf"((?:.*/)?{_BN})/scale"), r"\1/weight", lambda a: a),
    (re.compile(rf"((?:.*/)?{_BN})/bias"), r"\1/bias", lambda a: a),
    (re.compile(r"((?:.*/)?(?:embedding|patch_embed))/(kernel|bias)"),
     r"\1/\2", lambda a: a),
    (re.compile(r"((?:.*/)?(?:Embed_\d+|word_embeddings))/embedding"),
     r"\1/weight", lambda a: a),
    (re.compile(rf"((?:.*/)?{_AS_IS}|t|b)"), r"\1", lambda a: a),
]


def _to_tensor(value: Array) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    # torch cannot share a read-only numpy buffer (jax.device_get's): copy it
    return torch.as_tensor(value if value.flags.writeable else
                           np.array(value))


def from_jax_params(flat: dict[str, Array],
                    batch_stats: Optional[dict[str, Array]] = None
                    ) -> dict[str, torch.Tensor]:
    """Maps {JAX flat name: array} (and the flat ``batch_stats``
    collection, {name: array}) to a clipa_tpu_torch ``state_dict``.

    Arrays may be numpy (an npz) or CPU tensors (``train.checkpoint``);
    dtypes are kept. Raises ValueError on a name no rule covers.
    """
    sd: dict[str, torch.Tensor] = {}
    unknown = []
    for name, value in flat.items():
        for pattern, target, transform in _RULES:
            if pattern.fullmatch(name):
                key = pattern.sub(target, name).replace("/", ".")
                sd[key] = transform(_to_tensor(value)).contiguous()
                break
        else:
            unknown.append(name)
    for name, value in (batch_stats or {}).items():
        if _STATS.fullmatch(name):
            sd[name.replace("/", ".")] = _to_tensor(value).contiguous()
        else:
            unknown.append(f"batch_stats/{name}")
    if unknown:
        raise ValueError(f"JAX parameters with no torch counterpart: "
                         f"{sorted(unknown)}")
    return sd


def load_jax_params(module: nn.Module, tree: Any) -> None:
    """Loads a JAX params tree (nested dict, as ``load_params`` returns, or
    a flat {name: array} dict), or the JAX variables ``{"params": tree,
    "batch_stats": tree}``, into `module`. Every key must match both ways,
    the BatchNorms' statistics included; shapes must agree. Values are
    copied into the module's existing parameters and buffers, converting
    dtype and device; a mismatch raises RuntimeError listing the keys."""
    stats = None
    if isinstance(tree, dict) and "params" in tree:
        extra = set(tree) - {"params", "batch_stats"}
        if extra:
            raise ValueError(f"unknown variable collections {sorted(extra)}")
        stats = dict(u.tree_flatten_with_names(tree.get("batch_stats") or {}))
        tree = tree["params"]
    sd = from_jax_params(dict(u.tree_flatten_with_names(tree)), stats)
    module.load_state_dict(sd, strict=True)  # raises on missing/unexpected


# torch key (with "/" for ".") -> JAX name, and the (d, H, hd)-style reshape
# of to_jax_params ("in": q/k/v projections, "out": the output projection).
_INVERSE: list[tuple[re.Pattern, str, str]] = [
    (re.compile(rf"({_MHA}/(?:query|key|value))/weight"), r"\1/kernel", "in"),
    (re.compile(rf"({_MHA}/(?:query|key|value))/bias"), r"\1/bias",
     "in_bias"),
    (re.compile(rf"({_MHA}/out)/weight"), r"\1/kernel", "out"),
    (re.compile(rf"({_MHA}/out)/bias"), r"\1/bias", "same"),
    (re.compile(rf"((?:.*/)?{_DENSE})/weight"), r"\1/kernel", "t"),
    (re.compile(rf"((?:.*/)?{_DENSE})/bias"), r"\1/bias", "same"),
    (re.compile(rf"((?:.*/)?{_NORM})/weight"), r"\1/scale", "same"),
    (re.compile(rf"((?:.*/)?{_NORM})/bias"), r"\1/bias", "same"),
    (re.compile(rf"((?:.*/)?{_CONV})/weight"), r"\1/kernel", "hwio"),
    (re.compile(rf"((?:.*/)?{_CONV})/bias"), r"\1/bias", "same"),
    (re.compile(rf"((?:.*/)?{_BN})/weight"), r"\1/scale", "same"),
    (re.compile(rf"((?:.*/)?{_BN})/bias"), r"\1/bias", "same"),
    (re.compile(r"((?:.*/)?(?:embedding|patch_embed))/(kernel|bias)"),
     r"\1/\2", "same"),
    (re.compile(r"((?:.*/)?(?:Embed_\d+|word_embeddings))/weight"),
     r"\1/embedding", "same"),
    (re.compile(rf"((?:.*/)?{_AS_IS}|t|b)"), r"\1", "same"),
]


def _inverse_rule(key: str) -> tuple[str, str]:
    name = key.replace(".", "/")
    for pattern, target, kind in _INVERSE:
        if pattern.fullmatch(name):
            return pattern.sub(target, name), kind
    raise ValueError(f"torch parameter {key!r} has no JAX counterpart")


def to_jax_names(module: nn.Module) -> dict[str, str]:
    """{torch parameter key: JAX flat name} for every parameter of
    `module` (buffers, such as the fixed sincos posemb and the BatchNorms'
    statistics, are not parameters: :func:`to_jax_batch_stats` names the
    latter). Raises ValueError on a key no rule covers."""
    return {key: _inverse_rule(key)[0]
            for key, _ in module.named_parameters()}


def to_jax_params(module: nn.Module,
                  values: Optional[dict[str, torch.Tensor]] = None
                  ) -> dict[str, torch.Tensor]:
    """{JAX flat name: tensor in the JAX layout} of `module`'s parameters
    (detached, on their device, dtypes kept): the inverse of
    :func:`from_jax_params`. With `values` ({torch key: tensor of the
    parameter's shape}, e.g. the gradients), those are mapped instead."""
    modules = dict(module.named_modules())
    if values is None:
        values = dict(module.named_parameters())
    out = {}
    for key, p in values.items():
        name, kind = _inverse_rule(key)
        a = p.detach()
        if kind in ("in", "out"):    # _flax_shape: (d, H, hd) / (H, hd, d)
            a = a.T.reshape(modules[key.rsplit(".", 1)[0]]._flax_shape)
        elif kind == "in_bias":
            a = a.reshape(modules[key.rsplit(".", 1)[0]]._flax_shape[1:])
        elif kind == "t":
            a = a.T
        elif kind == "hwio":
            a = a.permute(2, 3, 1, 0)
        out[name] = a.contiguous()
    return out


def to_jax_batch_stats(module: nn.Module) -> dict[str, torch.Tensor]:
    """{JAX flat name: tensor} of `module`'s BatchNorm statistics (its
    persistent buffers; detached, on their device, fp32): the JAX
    package's ``batch_stats`` collection, empty for a tower without it."""
    params = dict(module.named_parameters())
    out = {}
    for key, value in module.state_dict(keep_vars=True).items():
        if key in params:
            continue
        name = key.replace(".", "/")
        if not _STATS.fullmatch(name):
            raise ValueError(f"torch buffer {key!r} has no JAX counterpart")
        out[name] = value.detach()
    return out


def to_jax_variables(module: nn.Module) -> dict[str, dict]:
    """The JAX variables of `module`: ``{"params": to_jax_params(module)}``
    and, for a tower with BatchNorms, ``"batch_stats"`` (flat dicts)."""
    variables = {"params": to_jax_params(module)}
    stats = to_jax_batch_stats(module)
    if stats:
        variables["batch_stats"] = stats
    return variables
