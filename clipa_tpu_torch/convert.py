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
``.../{Dense_i,head}/kernel`` (in, out)                    ``.weight``         ``.T`` (Linear layout)
``.../{Dense_i,head}/bias`` (out,)                         ``.bias``           as is
``.../{LayerNorm_i,encoder_norm,ln_pre}/scale``            ``.weight``         as is
``.../{LayerNorm_i,encoder_norm,ln_pre}/bias``             ``.bias``           as is
``img/embedding/kernel`` (p, p, 3, W)                      ``.kernel``         as is (HWIO, NHWC stem)
``txt/Embed_0/embedding`` (vocab, W)                       ``.weight``         as is
``.../{cls,pos_embedding,ls1,ls2}``, ``t``                 same name           as is
=========================================================  ==================  =================================

A name that matches no row raises: a weight silently dropped gives wrong
numbers. Keys the model expects but the checkpoint lacks are caught by
:func:`load_jax_params`, which loads strictly.

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
``...{Dense_i,head}.weight`` (out, in)                      ``/kernel``         ``.T``
``...{Dense_i,head}.bias`` (out,)                           ``/bias``           as is
``...{LayerNorm_i,encoder_norm,ln_pre}.weight``             ``/scale``          as is
``...{LayerNorm_i,encoder_norm,ln_pre}.bias``               ``/bias``           as is
``img.embedding.kernel`` (p, p, 3, W)                       ``/kernel``         as is
``txt.Embed_0.weight`` (vocab, W)                           ``/embedding``      as is
``...{cls,pos_embedding,ls1,ls2}``, ``t``                   same name           as is
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
_RULES: list[tuple[re.Pattern, str, Callable[[torch.Tensor], torch.Tensor]]] = [
    (re.compile(rf"({_MHA}/(?:query|key|value))/kernel"), r"\1/weight",
     lambda a: a.reshape(a.shape[0], -1).T),
    (re.compile(rf"({_MHA}/(?:query|key|value))/bias"), r"\1/bias",
     lambda a: a.reshape(-1)),
    (re.compile(rf"({_MHA}/out)/kernel"), r"\1/weight",
     lambda a: a.reshape(-1, a.shape[-1]).T),
    (re.compile(rf"({_MHA}/out)/bias"), r"\1/bias", lambda a: a),
    (re.compile(r"((?:.*/)?(?:Dense_\d+|head))/kernel"), r"\1/weight",
     lambda a: a.T),
    (re.compile(r"((?:.*/)?(?:Dense_\d+|head))/bias"), r"\1/bias",
     lambda a: a),
    (re.compile(r"((?:.*/)?(?:LayerNorm_\d+|encoder_norm|ln_pre))/scale"),
     r"\1/weight", lambda a: a),
    (re.compile(r"((?:.*/)?(?:LayerNorm_\d+|encoder_norm|ln_pre))/bias"),
     r"\1/bias", lambda a: a),
    (re.compile(r"((?:.*/)?embedding)/kernel"), r"\1/kernel", lambda a: a),
    (re.compile(r"((?:.*/)?Embed_\d+)/embedding"), r"\1/weight",
     lambda a: a),
    (re.compile(r"((?:.*/)?(?:cls|pos_embedding|ls1|ls2)|t)"), r"\1",
     lambda a: a),
]


def _to_tensor(value: Array) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    # torch cannot share a read-only numpy buffer (jax.device_get's): copy it
    return torch.as_tensor(value if value.flags.writeable else
                           np.array(value))


def from_jax_params(flat: dict[str, Array]) -> dict[str, torch.Tensor]:
    """Maps {JAX flat name: array} to a clipa_tpu_torch ``state_dict``.

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
    if unknown:
        raise ValueError(f"JAX parameters with no torch counterpart: "
                         f"{sorted(unknown)}")
    return sd


def load_jax_params(module: nn.Module, tree: Any) -> None:
    """Loads a JAX params tree (nested dict, as ``load_params`` returns, or
    a flat {name: array} dict) into `module`. Every key must match both
    ways; shapes must agree. Values are copied into the module's existing
    parameters, converting dtype and device; a mismatch raises
    RuntimeError listing the keys."""
    sd = from_jax_params(dict(u.tree_flatten_with_names(tree)))
    module.load_state_dict(sd, strict=True)  # raises on missing/unexpected


# torch key (with "/" for ".") -> JAX name, and the (d, H, hd)-style reshape
# of to_jax_params ("in": q/k/v projections, "out": the output projection).
_INVERSE: list[tuple[re.Pattern, str, str]] = [
    (re.compile(rf"({_MHA}/(?:query|key|value))/weight"), r"\1/kernel", "in"),
    (re.compile(rf"({_MHA}/(?:query|key|value))/bias"), r"\1/bias",
     "in_bias"),
    (re.compile(rf"({_MHA}/out)/weight"), r"\1/kernel", "out"),
    (re.compile(rf"({_MHA}/out)/bias"), r"\1/bias", "same"),
    (re.compile(r"((?:.*/)?(?:Dense_\d+|head))/weight"), r"\1/kernel", "t"),
    (re.compile(r"((?:.*/)?(?:Dense_\d+|head))/bias"), r"\1/bias", "same"),
    (re.compile(r"((?:.*/)?(?:LayerNorm_\d+|encoder_norm|ln_pre))/weight"),
     r"\1/scale", "same"),
    (re.compile(r"((?:.*/)?(?:LayerNorm_\d+|encoder_norm|ln_pre))/bias"),
     r"\1/bias", "same"),
    (re.compile(r"((?:.*/)?embedding)/kernel"), r"\1/kernel", "same"),
    (re.compile(r"((?:.*/)?Embed_\d+)/weight"), r"\1/embedding", "same"),
    (re.compile(r"((?:.*/)?(?:cls|pos_embedding|ls1|ls2)|t)"), r"\1",
     "same"),
]


def _inverse_rule(key: str) -> tuple[str, str]:
    name = key.replace(".", "/")
    for pattern, target, kind in _INVERSE:
        if pattern.fullmatch(name):
            return pattern.sub(target, name), kind
    raise ValueError(f"torch parameter {key!r} has no JAX counterpart")


def to_jax_names(module: nn.Module) -> dict[str, str]:
    """{torch parameter key: JAX flat name} for every parameter of
    `module` (buffers, such as the fixed sincos posemb, are not
    parameters). Raises ValueError on a key no rule covers."""
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
        out[name] = a.contiguous()
    return out
