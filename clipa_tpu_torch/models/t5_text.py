"""mT5 encoder text tower (open_clip's HF text encoder over mt5 trunks).

Port of ``clipa_tpu/models/t5_text.py``: a T5 encoder -- :class:`RMSNorm`
(no mean, no bias, in fp32), one relative-position bias table (block 0's,
shared by every block; :func:`relative_position_bucket`), unscaled q . k
attention without projection biases (:class:`T5SelfAttention`, pad keys
at ``finfo(float32).min``), the gated-GELU feed-forward (the tanh GELU of
``wi0`` times ``wi1``, then ``wo``), ``final_norm`` -- with the masked mean
pool (its count floored at 1) and open_clip's ``mlp`` or ``linear``
projection.

The attention is the tower's own einsum (the bias rules out the fused
kernels, as in the JAX tower): :func:`attention_core`, the scores, bias,
pad mask, softmax and weighted sum of one block. It runs in the span
``t5.attention`` (``tracing.py``), in the forward and in remat's
recompute, and its backward in ``t5.attention.bwd``, opened and closed by
two identity marks on the core's output and inputs (autograd reaches the
first before the core's backward and the second after it, so the
arithmetic is autograd's own). :data:`attention_calls` counts the cores
run by phase. The bucketing is the JAX package's, in fp32: ``+ 1e-6``
inside the log, truncation to int32.

``remat_policy`` names the policies of ``layers.Encoder``: "minimal"
recomputes each block (RMSNorm, attention, RMSNorm, gated feed-forward) in
the backward and keeps the outputs of its 2D products; any other name but
"none" recomputes the whole block. Neither changes a number. ``quant``
runs the blocks' products through the int8 path of ``layers.QuantDense``.

:func:`convert_hf_mt5` maps a ``transformers`` MT5EncoderModel (or an
MT5Model's encoder) state dict onto the tower, strictly.
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

from clipa_tpu_torch import tracing
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import layers

# The mt5 configs of the zoo (the model cards'; the JAX package's table).
T5_ARCHS = {
    "mt5-base": dict(width=768, mlp_dim=2048, depth=12, num_heads=12,
                     head_dim=64, vocab_size=250112),
    "mt5-xl": dict(width=2048, mlp_dim=5120, depth=24, num_heads=32,
                   head_dim=64, vocab_size=250112),
}


class RMSNorm(nn.Module):
    """T5's layer norm: ``x / sqrt(mean(x^2) + eps) * scale`` in fp32, the
    output in `dtype` (None: the input's). The scale stays fp32 when the
    tower's weights are stored in the compute dtype."""

    keep_fp32 = True

    def __init__(self, width: int, eps: float = 1e-6, dtype: Any = None):
        super().__init__()
        self.eps = eps
        self.dtype = u.resolve_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(width))

    def init_own_parameters(self, generator):
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float()
        y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(self.dtype or x.dtype)


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional bucket of each relative position, as the JAX
    package computes it: the log in fp32 with ``1e-6`` added inside,
    truncated to int32."""
    num_buckets //= 2
    ret = (rel_pos > 0).to(torch.int32) * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), large)


def _dense(d_in: int, d_out: int, init=None,
           quant: Optional[str] = None) -> layers.QuantDense:
    """flax ``nn.Dense(use_bias=False)`` (lecun-normal kernel by default)."""
    return layers.QuantDense(d_in, d_out, use_bias=False,
                             kernel_init=init or layers.lecun_normal(),
                             quant=quant)


# Attention cores run, by phase (a plain counter: callers reset it or take
# differences): "forward" (the forward, with or without gradients),
# "recompute" (remat's replay in the backward), "backward".
attention_calls = {"forward": 0, "recompute": 0, "backward": 0}
_replay = threading.local()


@contextlib.contextmanager
def _replaying():
    """Marks the calling thread's cores as remat's recompute."""
    previous = getattr(_replay, "on", False)
    _replay.on = True
    try:
        yield
    finally:
        _replay.on = previous


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos_bias: torch.Tensor, key_mask: Optional[torch.Tensor],
                   dtype: torch.dtype) -> torch.Tensor:
    """(b, l, h, d) q, k, v -> (b, l, h, d): unscaled fp32 scores plus the
    (1, h, l, l) bias, pad keys at ``finfo(float32).min``, fp32 softmax
    cast to `dtype`, times v."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + pos_bias
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, None, :],
                                    torch.finfo(torch.float32).min)
    attn = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


class _Mark(torch.autograd.Function):
    """The identity on its tensors; its backward calls `action` first."""

    @staticmethod
    def forward(ctx, action: Callable, *xs):
        ctx.action = action
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.action()
        return (None, *grads)


class _BackwardSpan:
    """The span ``t5.attention.bwd`` of one core's backward: :meth:`open`
    runs in the backward of the mark on the core's output, :meth:`close` in
    that of the mark on its inputs."""

    __slots__ = ("span",)

    def __init__(self):
        self.span = None

    def open(self) -> None:
        attention_calls["backward"] += 1
        self.span = tracing.span("t5.attention.bwd")
        self.span.__enter__()

    def close(self) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None


class T5SelfAttention(nn.Module):
    """T5 self-attention: q . k unscaled (T5 folds the scale into its init),
    plus the position bias, pad keys at ``finfo(float32).min``, fp32
    softmax; no projection biases. The core is :func:`attention_core`, in
    the spans of the module docstring."""

    def __init__(self, width: int, num_heads: int, head_dim: int,
                 quant: Optional[str] = None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.q, self.k, self.v = (_dense(width, inner, quant=quant)
                                  for _ in range(3))
        self.o = _dense(inner, width, quant=quant)

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, _ = x.shape
        q, k, v = (p(x).reshape(b, l, self.num_heads, self.head_dim)
                   for p in (self.q, self.k, self.v))
        marked = torch.is_grad_enabled()
        if marked:
            bwd = _BackwardSpan()
            q, k, v = _Mark.apply(bwd.close, q, k, v)
        attention_calls["recompute" if getattr(_replay, "on", False)
                        else "forward"] += 1
        with tracing.span("t5.attention"):
            y = attention_core(q, k, v, pos_bias, key_mask, x.dtype)
        if marked:
            (y,) = _Mark.apply(bwd.open, y)
        return self.o(y.reshape(b, l, -1))


def _rematted(block: Callable, x: torch.Tensor, pos_bias: torch.Tensor,
              keep: torch.Tensor, context_fn) -> torch.Tensor:
    """`block` under non-reentrant checkpoint (``layers._rematted``): the
    forward draws from the live random streams, the recompute from their
    replay, with its cores counted as "recompute"."""
    states = layers._stream_states()
    forward_done = False

    def run(x, pos_bias):
        nonlocal forward_done
        if not forward_done:
            forward_done = True
            return block(x, pos_bias, keep)
        with layers.random_streams(**layers._replayed(states)), \
                _replaying():
            return block(x, pos_bias, keep)

    return checkpoint.checkpoint(run, x, pos_bias, use_reentrant=False,
                                 context_fn=context_fn)


class _Model(nn.Module):
    """`context_length` (the trainer's) is unused: the bias covers any
    length. `remat_policy` and `quant`: the module docstring."""

    fp32_params = ("relative_attention_bias",)

    def __init__(self, num_classes: Optional[int] = None, *,
                 width: int = 768, depth: int = 12, num_heads: int = 12,
                 head_dim: int = 64, mlp_dim: int = 2048,
                 vocab_size: int = 250112, pad_id: int = 0,
                 rel_buckets: int = 32, rel_max_distance: int = 128,
                 dropout: float = 0.0, proj: Optional[str] = "mlp",
                 ln_eps: float = 1e-6, dtype: Any = None,
                 attn_impl: str = "auto",
                 context_length: Optional[int] = None,
                 remat_policy: Optional[str] = "none",
                 quant: Optional[str] = None):
        super().__init__()
        del attn_impl, context_length
        self.dtype = u.resolve_dtype(dtype) or torch.float32
        self.pad_id = pad_id
        self.depth = depth
        self.remat_policy = remat_policy
        self.rel_buckets, self.rel_max_distance = rel_buckets, rel_max_distance
        self.num_classes = num_classes
        self.word_embeddings = nn.Embedding(vocab_size, width)
        self.relative_attention_bias = nn.Parameter(torch.empty(rel_buckets,
                                                                num_heads))
        self.dropout = layers.Dropout(dropout)
        for i in range(depth):
            self.add_module(f"block_{i}_ln0",
                            RMSNorm(width, ln_eps, self.dtype))
            self.add_module(f"block_{i}_attn", T5SelfAttention(
                width, num_heads, head_dim, quant))
            self.add_module(f"block_{i}_ln1",
                            RMSNorm(width, ln_eps, self.dtype))
            self.add_module(f"block_{i}_wi0",
                            _dense(width, mlp_dim, quant=quant))
            self.add_module(f"block_{i}_wi1",
                            _dense(width, mlp_dim, quant=quant))
            self.add_module(f"block_{i}_wo",
                            _dense(mlp_dim, width, quant=quant))
        self.final_norm = RMSNorm(width, ln_eps, self.dtype)
        self.proj_fc = self.head = None
        if num_classes:
            d = width
            if proj == "mlp":
                d = (width + num_classes) // 2
                self.proj_fc = _dense(width, d, layers.normal(0.02))
            self.head = _dense(d, num_classes, layers.normal(0.02))

    def init_own_parameters(self, generator):
        layers.normal(1.0)(self.word_embeddings.weight, (), generator)
        layers.normal(1.0)(self.relative_attention_bias, (), generator)

    def position_bias(self, length: int, device) -> torch.Tensor:
        """The fp32 (1, H, L, L) bias of every block at `length` ids."""
        pos = torch.arange(length, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.rel_buckets,
                                           self.rel_max_distance)
        bias = self.relative_attention_bias.float()[buckets]   # (L, L, H)
        return bias.permute(2, 0, 1)[None]

    def block(self, i: int, x: torch.Tensor, pos_bias: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
        """Block `i` over the (n, l, width) stream."""
        ln0, attn, ln1, wi0, wi1, wo = (
            getattr(self, f"block_{i}_{name}")
            for name in ("ln0", "attn", "ln1", "wi0", "wi1", "wo"))
        x = x + self.dropout(attn(ln0(x), pos_bias, keep))
        y = ln1(x)
        y = F.gelu(wi0(y), approximate="tanh") * wi1(y)
        return x + self.dropout(wo(y))

    def forward(self, text: torch.Tensor):
        """text: (n, l) int ids, `pad_id` for padding. Returns the fp32
        (n, C) embedding and a dict of intermediates (``encoded``: the
        final-normed (n, l, width) sequence)."""
        out = {}
        keep = text != self.pad_id
        x = self.word_embeddings(text).to(self.dtype)
        pos_bias = self.position_bias(text.shape[1], text.device)
        remat = (self.remat_policy not in (None, "none")
                 and torch.is_grad_enabled())
        context_fn = (layers._minimal_remat if self.remat_policy == "minimal"
                      else checkpoint.noop_context_fn)
        for i in range(self.depth):
            if remat:
                x = _rematted(functools.partial(self.block, i), x, pos_bias,
                              keep, context_fn)
            else:
                x = self.block(i, x, pos_bias, keep)
        x = self.final_norm(x)
        out["encoded"] = x

        m = keep[..., None].to(x.dtype)
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        out["head_input"] = pooled
        if self.proj_fc is not None:
            pooled = F.gelu(self.proj_fc(pooled))
        if self.head is not None:
            pooled = self.head(pooled)
            out["logits"] = pooled
        return pooled.float(), out


def Model(num_classes=None, *, variant=None, **kw):  # noqa: N802
    return _Model(num_classes, **{**(T5_ARCHS.get(variant) or {}), **kw})


def convert_hf_mt5(sd: dict, depth: int) -> dict:
    """A ``transformers`` MT5EncoderModel (or MT5Model ``.encoder``) state
    dict (numpy arrays or tensors; an ``encoder.`` prefix is dropped) ->
    this tower's parameter tree in the JAX layout (numpy), as the JAX
    package maps it: ``shared`` and its tied ``embed_tokens`` as one table,
    block 0's bias table. Raises ValueError on a tensor left unconsumed."""
    sd = {k.removeprefix("encoder."): np.asarray(v) for k, v in sd.items()}
    consumed = set()

    def take(name):
        consumed.add(name)
        return sd[name]

    flat = {}
    if "shared.weight" in sd:
        flat["word_embeddings/embedding"] = take("shared.weight")
        consumed.add("embed_tokens.weight")   # the tied copy
    else:
        flat["word_embeddings/embedding"] = take("embed_tokens.weight")
    flat["relative_attention_bias"] = take(
        "block.0.layer.0.SelfAttention.relative_attention_bias.weight")
    flat["final_norm/scale"] = take("final_layer_norm.weight")
    for i in range(depth):
        b = f"block.{i}"
        flat[f"block_{i}_ln0/scale"] = take(f"{b}.layer.0.layer_norm.weight")
        for p in ("q", "k", "v", "o"):
            flat[f"block_{i}_attn/{p}/kernel"] = take(
                f"{b}.layer.0.SelfAttention.{p}.weight").T
        flat[f"block_{i}_ln1/scale"] = take(f"{b}.layer.1.layer_norm.weight")
        for ours, theirs in (("wi0", "wi_0"), ("wi1", "wi_1"), ("wo", "wo")):
            flat[f"block_{i}_{ours}/kernel"] = take(
                f"{b}.layer.1.DenseReluDense.{theirs}.weight").T
    leftover = [k for k in sd if k not in consumed]
    if leftover:
        raise ValueError(
            f"convert_hf_mt5 left {len(leftover)} tensors unconsumed: "
            f"{leftover[:8]}")
    return u.recover_tree(list(flat), list(flat.values()))


def load(init_params, init_file, model_cfg=None, dont_load=()):
    """Loads the tower from an npz checkpoint, merged with `init_params`
    (the tower's tree of tensors) under `dont_load`. (A HuggingFace state
    dict goes through :func:`convert_hf_mt5` first.)"""
    del model_cfg
    from clipa_tpu_torch.models import common
    from clipa_tpu_torch.train import checkpoint
    return common.merge_params(checkpoint.load_params(init_file),
                               init_params, dont_load)
