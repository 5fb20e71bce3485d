"""Shared building blocks: the transformer layers, and the conv towers'
:class:`Conv` and :class:`BatchNorm`.

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
``pallas_call`` is not under the JAX policy). Any other name but "none"
(``"full"``, bench.py's ``"actcp"``) is ``nn.remat`` with no policy there:
each block is recomputed whole. Neither changes a number.

Dropout and DropPath are identities at rate 0 and in eval mode. In training
mode they draw their keep masks (``uniform < 1 - rate``, as
``jax.random.bernoulli``) from the generators the caller hands over for the
forward with :func:`random_streams` (the training step seeds them per step);
remat's recompute replays the generators from their state at the block's
entry, so it draws the same masks.

``quant`` (``"int8"`` or ``"int8_full"``) runs the projections and the MLP
through ``ops/quantization.py``'s int8 products, each quantizing its fp32
master (the parameters keep their names and shapes). ``stream="ref3d"``
keeps the reference's (B, L, D) residual stream where the encoder would
otherwise run it flat: attention then takes 3-D operands, which selects the
per-sample kernels where the flat stream selects the 2-D ones.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from clipa_tpu_torch.ops import layer_norm as layer_norm_op
from clipa_tpu_torch.ops.attention import multi_head_attention
from clipa_tpu_torch.ops.quantization import MODES as QUANT_MODES
from clipa_tpu_torch.ops.quantization import quant_dot

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


def zeros() -> Init:
    def init(w, shape, generator):
        w.zero_()
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
    """Stores every parameter in `dtype`, except those the JAX towers use in
    fp32 whatever the compute dtype: LayerNorm's, those of a module that
    sets ``keep_fp32`` (T5's RMS norm, the relpos bias MLP) and a module's
    own parameters named in its ``fp32_params`` (T5's bias table). The
    serving layout, whose casts at use are then no-ops."""
    keep = set()
    for m in module.modules():
        if isinstance(m, nn.LayerNorm) or getattr(m, "keep_fp32", False):
            keep.update(id(p) for p in m.parameters())
        keep.update(id(getattr(m, n)) for n in getattr(m, "fp32_params", ()))
    for p in module.parameters():
        if id(p) not in keep:
            p.data = p.data.to(dtype)


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
    dtype. A bf16 CUDA input with fp32 parameters of a width the kernels
    take goes through ``ops/layer_norm.py``'s kernels (the same arithmetic
    in one pass each way); every other input through the cast, fp32
    ``layer_norm``, cast chain."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if layer_norm_op.takes(x, self.weight, self.bias):
            return layer_norm_op.run(x, self.weight, self.bias, self.eps)
        stats = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(stats), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


_STREAMS = threading.local()


@contextlib.contextmanager
def random_streams(dropout: Optional[torch.Generator] = None,
                   drop_path: Optional[torch.Generator] = None,
                   shard: Optional[tuple] = None):
    """The generators training-mode Dropout and DropPath draw from while the
    block runs (on the tensors' device). `shard` = (index, count) says the
    forward runs on batch shard `index` of `count` equal shards of a global
    batch (``parallel/mesh.py``'s rule): every draw of :func:`uniform`, the
    masks and the masking noise, is then made for the global batch and
    this shard's rows taken, so the draws do not depend on the process
    count. The setting is the calling thread's."""
    previous = (getattr(_STREAMS, "gens", {}), getattr(_STREAMS, "shard",
                                                       None))
    _STREAMS.gens = {"dropout": dropout, "drop_path": drop_path}
    _STREAMS.shard = shard
    try:
        yield
    finally:
        _STREAMS.gens, _STREAMS.shard = previous


def uniform(shape: tuple, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """``torch.rand(shape)`` from `generator`; under a batch shard of
    :func:`random_streams`, this shard's rows of the draw for the global
    batch (dim 0 is the batch, or the flat batch x tokens)."""
    shape = tuple(shape)
    index, count = getattr(_STREAMS, "shard", None) or (0, 1)
    if count == 1:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((count * shape[0],) + shape[1:], generator=generator,
                      device=device)
    return full[index * shape[0]:(index + 1) * shape[0]]


def keep_mask(stream: str, keep: float, shape: tuple,
              device) -> torch.Tensor:
    """A boolean mask of `shape`, True with probability `keep`, drawn from
    the `stream` ("dropout" or "drop_path") generator of
    :func:`random_streams`."""
    gen = getattr(_STREAMS, "gens", {}).get(stream)
    if gen is None:
        raise RuntimeError(
            f"{stream} at a rate above 0 in training mode draws from a "
            "generator: run the forward under layers.random_streams(...)")
    return uniform(shape, gen, device) < keep


def _stream_states() -> dict:
    return {"gens": {name: (g.device, g.get_state())
                     for name, g in getattr(_STREAMS, "gens", {}).items()
                     if g is not None},
            "shard": getattr(_STREAMS, "shard", None)}


def _replayed(states: dict) -> dict:
    """Fresh generators at the given states: remat's recompute draws from
    these, so the masks repeat and the live generators are not touched."""
    return {"shard": states["shard"],
            **{name: torch.Generator(device=device).set_state(state)
               for name, (device, state) in states["gens"].items()}}


def _drop(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class DropPath(nn.Module):
    """Stochastic depth: drops the whole residual branch per sample. On
    the flat (B*L, D) stream (`seq_len` set) the per-sample mask repeats
    over each sample's rows."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                seq_len: Optional[int] = None) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        keep = 1.0 - self.rate
        if x.dim() == 2 and seq_len:
            mask = keep_mask("drop_path", keep, (x.shape[0] // seq_len, 1),
                             x.device).repeat_interleave(seq_len, dim=0)
        else:
            mask = keep_mask("drop_path", keep,
                             (x.shape[0],) + (1,) * (x.dim() - 1), x.device)
        return _drop(x, mask, keep)


class Dropout(nn.Module):
    """Elementwise dropout (flax ``nn.Dropout``)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        return _drop(x, keep_mask("dropout", keep, tuple(x.shape), x.device),
                     keep)


class _ProjIn(nn.Module):
    """Input projection to packed (..., heads * head_dim).

    Returns ``(y, bias)`` with the bias not added (None without bias),
    both in x's dtype: the attention core adds it, inside the kernel on the
    fused path.
    """

    def __init__(self, d_in: int, num_heads: int, head_dim: int,
                 kernel_init: Init, use_bias: bool,
                 quant: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_heads * head_dim, d_in))
        self.bias = (nn.Parameter(torch.empty(num_heads * head_dim))
                     if use_bias else None)
        self._flax_shape = (d_in, num_heads, head_dim)
        self._kernel_init = kernel_init
        self.quant = quant

    def init_own_parameters(self, generator):
        self._kernel_init(self.weight, self._flax_shape, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor):
        return _linear(x, self.weight, None, self.quant), \
            _cast(self.bias, x.dtype)


class _ProjOut(nn.Module):
    """Output projection from packed (..., heads * head_dim) to d_model."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 kernel_init: Init, use_bias: bool,
                 quant: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_model, num_heads * head_dim))
        self.bias = nn.Parameter(torch.empty(d_model)) if use_bias else None
        self._flax_shape = (num_heads, head_dim, d_model)
        self._kernel_init = kernel_init
        self.quant = quant

    def init_own_parameters(self, generator):
        self._kernel_init(self.weight, self._flax_shape, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self.weight, self.bias, self.quant)


def _linear(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor], quant: Optional[str]):
    """x @ weight.T (+ bias) in x's dtype; under `quant` the int8 product
    of ``quant_dot`` with the fp32 master (``weight.T`` is the JAX kernel
    layout), the bias added after it, as in the JAX layers."""
    if quant in (None, "none", "bf16"):
        return F.linear(x, weight.to(x.dtype), _cast(bias, x.dtype))
    y = quant_dot(x, weight.T, quant=quant)
    return y if bias is None else y + bias.to(x.dtype)


class QuantDense(nn.Module):
    """flax ``nn.Dense`` counterpart with the JAX layer's optional int8
    forward (`quant`). Weight in Linear layout (features, in_features)."""

    def __init__(self, in_features: int, features: int,
                 kernel_init: Init = xavier_uniform(), use_bias: bool = True,
                 quant: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self._kernel_init = kernel_init
        self.quant = quant

    def init_own_parameters(self, generator):
        self._kernel_init(self.weight, tuple(self.weight.shape[::-1]),
                          generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self.weight, self.bias, self.quant)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with QKV/out projections over packed operands;
    the (Q, K, V) -> O core is ``ops.attention.multi_head_attention``."""

    def __init__(self, width: int, num_heads: int,
                 qkv_kernel_init: Init = xavier_uniform(),
                 out_kernel_init: Init = xavier_uniform(),
                 use_bias: bool = True, attn_impl: str = "auto",
                 quant: Optional[str] = None):
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
                                          qkv_kernel_init, use_bias, quant))
        self.out = _ProjOut(width, num_heads, head_dim, out_kernel_init,
                            use_bias, quant)

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
                 proj_init: Init = xavier_uniform(), gelu_approx: Any = True,
                 quant: Optional[str] = None):
        super().__init__()
        hidden = mlp_dim or 4 * width
        self.Dense_0 = QuantDense(width, hidden, kernel_init=fc_init,
                                  quant=quant)
        self.dropout = Dropout(dropout)
        self.Dense_1 = QuantDense(hidden, width, kernel_init=proj_init,
                                  quant=quant)
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
                 ln_eps: float = 1e-6, ls_init: Optional[float] = None,
                 quant: Optional[str] = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(width, eps=ln_eps)
        self.MultiHeadDotProductAttention_0 = MultiHeadAttention(
            width, num_heads, qkv_kernel_init=attn_qkv_init,
            out_kernel_init=attn_out_init, attn_impl=attn_impl, quant=quant)
        self.LayerNorm_1 = LayerNorm(width, eps=ln_eps)
        self.MlpBlock_0 = MlpBlock(width, mlp_dim, dropout,
                                   fc_init=mlp_fc_init,
                                   proj_init=mlp_proj_init,
                                   gelu_approx=gelu_approx, quant=quant)
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
        x = x + self.drop_path(self.dropout(y), seq_len)
        y = self.MlpBlock_0(self.LayerNorm_1(x))
        y = self._layer_scale(getattr(self, "ls2", None), y)
        return x + self.drop_path(self.dropout(y), seq_len)


class Encoder(nn.Module):
    """Stack of encoder blocks named ``encoderblock_{i}``.

    Unmasked input runs the residual stream flat, (B*L, D), as the JAX
    encoder does: every block op is token-wise except attention, which
    takes `seq_len`. `block_inits` are initializer overrides for every
    block (the text tower's CLIP-paper scales). `remat_policy` "minimal"
    recomputes each block in the backward, keeping its 2D products, and
    any other name but "none" recomputes the whole block (module
    docstring); it may be switched on a built encoder. `quant` is every
    block's int8 mode; `stream` "ref3d" keeps an unmasked input's stream
    (B, L, D) (module docstring).
    """

    def __init__(self, depth: int, width: int, num_heads: int,
                 mlp_dim: Optional[int] = None, dropout: float = 0.0,
                 drop_path: float = 0.0, block_inits: Optional[dict] = None,
                 attn_impl: str = "auto", gelu_approx: Any = True,
                 ln_eps: float = 1e-6, ls_init: Optional[float] = None,
                 remat_policy: Optional[str] = "none",
                 quant: Optional[str] = None, stream: str = "flat"):
        super().__init__()
        if stream not in ("flat", "ref3d"):
            raise ValueError(f"Unknown stream {stream!r}")
        if quant not in QUANT_MODES:
            raise ValueError(f"Unknown quant mode {quant!r}")
        self.depth = depth
        self.remat_policy = remat_policy
        self.stream = stream
        dpr = np.linspace(0.0, drop_path, depth)
        for i in range(depth):
            self.add_module(f"encoderblock_{i}", EncoderBlock(
                width, num_heads, mlp_dim=mlp_dim, dropout=dropout,
                drop_path=float(dpr[i]), attn_impl=attn_impl,
                gelu_approx=gelu_approx, ln_eps=ln_eps, ls_init=ls_init,
                quant=quant, **(block_inits or {})))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = x.shape
        seq = None
        if mask is None and x.dim() == 3 and self.stream == "flat":
            n, seq, d = shape
            x = x.reshape(n * seq, d)
        remat = (self.remat_policy not in (None, "none")
                 and torch.is_grad_enabled())
        for i in range(self.depth):
            block = getattr(self, f"encoderblock_{i}")
            if remat:
                x = _rematted(block, x, mask, seq,
                              _minimal_remat if self.remat_policy == "minimal"
                              else checkpoint.noop_context_fn)
            else:
                x = block(x, mask=mask, seq_len=seq)
        return x.reshape(shape)


def _rematted(block: nn.Module, x: torch.Tensor, mask, seq,
              context_fn) -> torch.Tensor:
    """`block` under non-reentrant checkpoint: the forward draws from the
    live random streams, the recompute from their replay (the same
    masks)."""
    states = _stream_states()
    forward_done = False

    def run(x, mask):
        nonlocal forward_done
        if not forward_done:
            forward_done = True
            return block(x, mask=mask, seq_len=seq)
        with random_streams(**_replayed(states)):
            return block(x, mask=mask, seq_len=seq)

    return checkpoint.checkpoint(run, x, mask, use_reentrant=False,
                                 context_fn=context_fn)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis (``lax.padtype_to_pads``):
    ceil(size / stride) outputs, the total padding split with the odd pixel
    after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` over NHWC activations. The (kh, kw, in / groups,
    out) kernel is held as the OIHW ``weight`` (as ``kernel`` in HWIO where
    `hwio` is set: the ConvNeXt stem, whose JAX name is the ViT stem's) and
    applied by ``F.conv2d`` to the input's NCHW view, channels-last in
    memory, so no copy is made. `padding`: "SAME" (XLA's), "VALID" or the
    pixels on every side. Weights and bias are cast to the input's dtype at
    use."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: Any = "SAME", groups: int = 1,
                 use_bias: bool = True, kernel_init: Init = lecun_normal(),
                 hwio: bool = False):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride, self.groups = k, stride, groups
        self.padding, self.hwio = padding, hwio
        self._flax_shape = (k, k, in_features // groups, features)
        if hwio:
            self.kernel = nn.Parameter(torch.empty(self._flax_shape))
        else:
            self.weight = nn.Parameter(torch.empty(
                features, in_features // groups, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self._kernel_init = kernel_init

    def init_own_parameters(self, generator):
        self._kernel_init(self.kernel if self.hwio else self.weight,
                          self._flax_shape, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.permute(3, 2, 0, 1) if self.hwio else self.weight
        y = x.permute(0, 3, 1, 2)
        pad = 0 if self.padding == "VALID" else self.padding
        if self.padding == "SAME":
            (top, bottom), (left, right) = (
                same_pads(n, self.kernel_size, self.stride)
                for n in y.shape[2:])
            if top == bottom and left == right:
                pad = (top, left)
            else:
                y, pad = F.pad(y, (left, right, top, bottom)), 0
        y = F.conv2d(y, w.to(x.dtype), _cast(self.bias, x.dtype),
                     self.stride, pad, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NHWC activations, with the JAX towers'
    settings (eps 1e-5, momentum 0.9): parameters ``weight`` / ``bias``
    (flax's scale / bias) and the running statistics as fp32 buffers
    ``mean`` / ``var`` (flax's ``batch_stats`` collection).

    Training mode normalizes by the batch's statistics over (N, H, W),
    formed in fp32 (float64 for a float64 input) as flax forms them: the mean and the biased variance
    E[x^2] - E[x]^2, clipped at 0. The running averages take that same
    variance (``F.batch_norm`` would take the unbiased one): ``m * running
    + (1 - m) * batch``. Eval mode reads the running statistics. Either way
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` runs in that dtype
    and takes the input's. The parameters and statistics stay fp32 when
    the tower's weights are stored in the compute dtype (``keep_fp32``),
    and the statistics also through ``module.to(dtype)``."""

    keep_fp32 = True

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def init_own_parameters(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def _apply(self, fn, recurse=True):
        stats = (self.mean, self.var)
        super()._apply(fn, recurse)
        self.mean, self.var = (s.to(device=b.device) for s, b in
                               zip(stats, (self.mean, self.var)))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = x32.mean(dim=(0, 1, 2))
            var = (x32.square().mean(dim=(0, 1, 2))
                   - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight.to(x32.dtype)
        return ((x32 - mean) * mul + self.bias.to(x32.dtype)).to(x.dtype)
