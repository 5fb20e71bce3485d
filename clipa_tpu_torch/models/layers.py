"""Shared transformer building blocks.

Port of ``clipa_tpu/models/layers.py``. Module attribute names follow the
flax module names (``MultiHeadDotProductAttention_0``, ``MlpBlock_0``,
``Dense_0``, ``LayerNorm_0``, ``encoderblock_{i}``), so a ``state_dict`` key
is the JAX flat name with "." for "/" (the leaf renames are in
``clipa_tpu_torch/convert.py``).

Dtypes follow the JAX towers' mixed precision: parameters are fp32 masters
and every layer casts its weights and biases at use to the dtype of its
input, which the towers set to their compute dtype (the residual stream
stays in it, as in flax, where each module casts to ``dtype``). LayerNorm
computes its statistics and affine in fp32 with fp32 parameters. Serving
may store the weights in the compute dtype instead (:func:`cast_params`),
where the cast at use is a no-op and the numbers are the same.

Initializers reproduce the flax initializers' distributions (fans counted
on the flax parameter shapes), not their random bits: parameters are drawn
from an explicit ``torch.Generator`` by :func:`init_parameters`.

Remat: ``remat_policy="minimal"`` is the JAX package's
``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: each encoder
block runs under non-reentrant ``torch.utils.checkpoint`` with a selective
policy that keeps the outputs of the 2D products (the projections over the
flat stream: ``aten.mm`` / ``aten.addmm``) and recomputes everything else in
the backward, attention included (its custom Function is not a dot, as the
``pallas_call`` is not under the JAX policy). It changes no number.

Not ported: ``quant`` (int8 matmuls), ``stream="ref3d"`` and the other remat
policies. Dropout and DropPath are identities at rate 0 and in eval mode,
and refuse to train at a rate above 0.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from clipa_tpu_torch.ops.attention import multi_head_attention

# init(tensor, flax_shape, generator): fills `tensor` in place.
Init = Callable[[torch.Tensor, tuple, Optional[torch.Generator]], None]


def _fans(shape: tuple) -> tuple[int, int]:
    """flax variance_scaling fans: in_axis=-2, out_axis=-1, the other axes
    form the receptive field."""
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_uniform() -> Init:
    def init(w, shape, generator):
        fan_in, fan_out = _fans(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w.uniform_(-limit, limit, generator=generator)
    return init


def lecun_normal() -> Init:
    """flax's default conv kernel init: truncated normal, variance 1/fan_in."""
    def init(w, shape, generator):
        fan_in, _ = _fans(shape)
        # 0.8796... = std of a unit normal truncated to [-2, 2]
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
    return init


def normal(stddev: float) -> Init:
    def init(w, shape, generator):
        w.normal_(0.0, stddev, generator=generator)
    return init


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initializes every parameter of `module`, in module order, from
    `generator` (which must live on the parameters' device)."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "init_own_parameters"):
                m.init_own_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()


def cast_params(module: nn.Module, dtype: torch.dtype) -> None:
    """Stores every parameter in `dtype`, except LayerNorm's (fp32): the
    serving layout, whose casts at use are then no-ops."""
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)


def check_remat(policy: Optional[str]) -> None:
    """The remat policies the port takes: "none" and "minimal"."""
    if policy not in (None, "none", "minimal"):
        raise NotImplementedError(
            f"remat_policy={policy!r} is not ported (only 'none' and "
            "'minimal')")


def _save_2d_products(ctx, op, *args, **kwargs):
    """The "minimal" policy: keep what checkpoint_dots_with_no_batch_dims
    keeps, the outputs of products without batch dims."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


_minimal_remat = functools.partial(
    checkpoint.create_selective_checkpoint_contexts, _save_2d_products)


def _cast(x: Optional[torch.Tensor], dtype: torch.dtype):
    return None if x is None else x.to(dtype)


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm semantics: statistics and affine in fp32 (float64 for
    a float64 input, with float64 parameters); the output takes the input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(stats), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth. Identity at rate 0 and in eval mode; training at a
    rate above 0 is not ported."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0:
            raise NotImplementedError("DropPath in training mode is not "
                                      "ported yet")
        return x


class Dropout(DropPath):
    """Dropout. Identity at rate 0 and in eval mode; training at a rate
    above 0 is not ported."""


class _ProjIn(nn.Module):
    """Input projection to packed (..., heads * head_dim).

    Returns ``(y, bias)`` with the bias not added (None without bias),
    both in x's dtype: the attention core adds it, inside the kernel on the
    fused path.
    """

    def __init__(self, d_in: int, num_heads: int, head_dim: int,
                 kernel_init: Init, use_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_heads * head_dim, d_in))
        self.bias = (nn.Parameter(torch.empty(num_heads * head_dim))
                     if use_bias else None)
        self._flax_shape = (d_in, num_heads, head_dim)
        self._kernel_init = kernel_init

    def init_own_parameters(self, generator):
        self._kernel_init(self.weight, self._flax_shape, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor):
        return (F.linear(x, self.weight.to(x.dtype)),
                _cast(self.bias, x.dtype))


class _ProjOut(nn.Module):
    """Output projection from packed (..., heads * head_dim) to d_model."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 kernel_init: Init, use_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_model, num_heads * head_dim))
        self.bias = nn.Parameter(torch.empty(d_model)) if use_bias else None
        self._flax_shape = (num_heads, head_dim, d_model)
        self._kernel_init = kernel_init

    def init_own_parameters(self, generator):
        self._kernel_init(self.weight, self._flax_shape, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class QuantDense(nn.Module):
    """flax ``nn.Dense`` counterpart (the JAX layer's int8 option is not
    ported). Weight in Linear layout (features, in_features)."""

    def __init__(self, in_features: int, features: int,
                 kernel_init: Init = xavier_uniform(), use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self._kernel_init = kernel_init

    def init_own_parameters(self, generator):
        self._kernel_init(self.weight, tuple(self.weight.shape[::-1]),
                          generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with QKV/out projections over packed operands;
    the (Q, K, V) -> O core is ``ops.attention.multi_head_attention``."""

    def __init__(self, width: int, num_heads: int,
                 qkv_kernel_init: Init = xavier_uniform(),
                 out_kernel_init: Init = xavier_uniform(),
                 use_bias: bool = True, attn_impl: str = "auto"):
        super().__init__()
        if width % num_heads:
            raise ValueError(f"width {width} not divisible by heads "
                             f"{num_heads}")
        head_dim = width // num_heads
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.use_bias = use_bias
        for name in ("query", "key", "value"):
            self.add_module(name, _ProjIn(width, num_heads, head_dim,
                                          qkv_kernel_init, use_bias))
        self.out = _ProjOut(width, num_heads, head_dim, out_kernel_init,
                            use_bias)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                seq_len: Optional[int] = None) -> torch.Tensor:
        q, bq = self.query(inputs_q)
        k, bk = self.key(inputs_kv)
        v, bv = self.value(inputs_kv)
        y = multi_head_attention(
            q, k, v, self.num_heads, mask=mask, impl=self.attn_impl,
            seq_len=seq_len,
            qkv_biases=(bq, bk, bv) if self.use_bias else None)
        return self.out(y)


def _gelu(x: torch.Tensor, approx: Any) -> torch.Tensor:
    if approx == "quick":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="tanh" if approx else "none")


class MlpBlock(nn.Module):
    """Dense -> gelu -> Dense. gelu_approx: True = tanh (BigVision/CLIPA-v2),
    False = erf (open_clip), "quick" = x * sigmoid(1.702 x)."""

    def __init__(self, width: int, mlp_dim: Optional[int] = None,
                 dropout: float = 0.0, fc_init: Init = xavier_uniform(),
                 proj_init: Init = xavier_uniform(), gelu_approx: Any = True):
        super().__init__()
        hidden = mlp_dim or 4 * width
        self.Dense_0 = QuantDense(width, hidden, kernel_init=fc_init)
        self.dropout = Dropout(dropout)
        self.Dense_1 = QuantDense(hidden, width, kernel_init=proj_init)
        self.gelu_approx = gelu_approx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _gelu(self.Dense_0(x), self.gelu_approx)
        return self.Dense_1(self.dropout(x))


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block (MHSA + MLP), residual throughout,
    with optional LayerScale gains ``ls1``/``ls2``."""

    def __init__(self, width: int, num_heads: int,
                 mlp_dim: Optional[int] = None, dropout: float = 0.0,
                 drop_path: float = 0.0,
                 attn_qkv_init: Init = xavier_uniform(),
                 attn_out_init: Init = xavier_uniform(),
                 mlp_fc_init: Init = xavier_uniform(),
                 mlp_proj_init: Init = xavier_uniform(),
                 attn_impl: str = "auto", gelu_approx: Any = True,
                 ln_eps: float = 1e-6, ls_init: Optional[float] = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(width, eps=ln_eps)
        self.MultiHeadDotProductAttention_0 = MultiHeadAttention(
            width, num_heads, qkv_kernel_init=attn_qkv_init,
            out_kernel_init=attn_out_init, attn_impl=attn_impl)
        self.LayerNorm_1 = LayerNorm(width, eps=ln_eps)
        self.MlpBlock_0 = MlpBlock(width, mlp_dim, dropout,
                                   fc_init=mlp_fc_init,
                                   proj_init=mlp_proj_init,
                                   gelu_approx=gelu_approx)
        self.dropout = Dropout(dropout)
        self.drop_path = DropPath(drop_path)
        self.ls_init = ls_init
        if ls_init is not None:
            self.ls1 = nn.Parameter(torch.empty(width))
            self.ls2 = nn.Parameter(torch.empty(width))

    def init_own_parameters(self, generator):
        if self.ls_init is not None:
            self.ls1.fill_(self.ls_init)
            self.ls2.fill_(self.ls_init)

    def _layer_scale(self, gamma: Optional[torch.Tensor],
                     y: torch.Tensor) -> torch.Tensor:
        return y if gamma is None else y * gamma.to(y.dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seq_len: Optional[int] = None) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        y = self.MultiHeadDotProductAttention_0(y, y, mask=mask,
                                                seq_len=seq_len)
        y = self._layer_scale(getattr(self, "ls1", None), y)
        x = x + self.drop_path(self.dropout(y))
        y = self.MlpBlock_0(self.LayerNorm_1(x))
        y = self._layer_scale(getattr(self, "ls2", None), y)
        return x + self.drop_path(self.dropout(y))


class Encoder(nn.Module):
    """Stack of encoder blocks named ``encoderblock_{i}``.

    Unmasked input runs the residual stream flat, (B*L, D), as the JAX
    encoder does: every block op is token-wise except attention, which
    takes `seq_len`. `block_inits` are initializer overrides for every
    block (the text tower's CLIP-paper scales). `remat_policy` "minimal"
    recomputes each block in the backward, keeping its 2D products (module
    docstring); it may be switched on a built encoder.
    """

    def __init__(self, depth: int, width: int, num_heads: int,
                 mlp_dim: Optional[int] = None, dropout: float = 0.0,
                 drop_path: float = 0.0, block_inits: Optional[dict] = None,
                 attn_impl: str = "auto", gelu_approx: Any = True,
                 ln_eps: float = 1e-6, ls_init: Optional[float] = None,
                 remat_policy: Optional[str] = "none"):
        super().__init__()
        check_remat(remat_policy)
        self.depth = depth
        self.remat_policy = remat_policy
        dpr = np.linspace(0.0, drop_path, depth)
        for i in range(depth):
            self.add_module(f"encoderblock_{i}", EncoderBlock(
                width, num_heads, mlp_dim=mlp_dim, dropout=dropout,
                drop_path=float(dpr[i]), attn_impl=attn_impl,
                gelu_approx=gelu_approx, ln_eps=ln_eps, ls_init=ls_init,
                **(block_inits or {})))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = x.shape
        seq = None
        if mask is None and x.dim() == 3:
            n, seq, d = shape
            x = x.reshape(n * seq, d)
        remat = self.remat_policy == "minimal" and torch.is_grad_enabled()
        for i in range(self.depth):
            block = getattr(self, f"encoderblock_{i}")
            if remat:
                x = checkpoint.checkpoint(block, x, mask, seq,
                                          use_reentrant=False,
                                          context_fn=_minimal_remat)
            else:
                x = block(x, mask=mask, seq_len=seq)
        return x.reshape(shape)
