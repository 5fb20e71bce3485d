"""Attention cores.

Port of ``clipa_tpu/ops/attention.py``. :func:`multi_head_attention` takes
packed (B, L, D) or flat (B*L, D) operands, as the JAX version does;
:func:`dot_product_attention` split (B, L, H, hd) ones.

Dispatch (``impl="auto"``) is keyed on the shapes and the mask, as in the
JAX package; the device decides only what a kernel path runs:
  * ``pallas`` -- the tiled flash attention (ops/flash_attention.py), where
                  the JAX package takes it: unmasked, L >= 1024, head dim <=
                  128, and the JAX fused kernel's forward VMEM plan fails
                  (:func:`_fused_plan_fits`, e.g. ViT-G/14 at 448 px,
                  L = 1025) or the attention is cross;
  * ``fused``  -- unmasked self-attention with L >= 33 and a head dim the
                  kernel takes: the fused CUDA kernels (forward and
                  backward) for a CUDA tensor, their plain versions for a
                  CPU tensor (ops/block_attention.py). Covers every CLIPA
                  image tower (50/138/257/577 tokens);
  * ``einsum`` -- einsum + fp32 softmax with ``finfo.min`` masking, autograd
                  gradients: masked attention and short sequences, including
                  the 8- and 32-token text towers (the JAX version's ``xla``
                  path).
Explicit choices: ``pallas`` (the towers' ``attn_impl="pallas"``: the flash
kernels at any length, exact softmax with no clip), ``fused_exact`` (the
fused path with the row-max softmax), and the plain references the kernels
are held against, on any device: ``plain`` (the fused path's plain
versions) and ``pallas_plain`` (the flash path's).
"""

from __future__ import annotations

from typing import Optional

import torch

from clipa_tpu_torch.ops import block_attention, flash_attention

# Below this the JAX package keeps attention on the einsum path (measured on
# the TPU there): the text towers (<= 32 tokens) stay off the fused kernel.
_FUSED_MIN_SEQ = 33
# From this length on the JAX package's auto route may take the flash kernel.
_FLASH_MIN_SEQ = 1024
# The JAX fused forward's VMEM budget (clipa_tpu/ops/block_attention.py).
_VMEM_BUDGET_FWD = 13 * 1024 * 1024

_IMPLS = ("auto", "fused", "fused_exact", "plain", "einsum", "pallas",
          "pallas_plain")


def _fused_plan_fits(batch: int, seq: int, d_model: int,
                     num_heads: int) -> bool:
    """Whether the JAX fused kernel's forward has a VMEM plan at this shape:
    a copy of ``clipa_tpu.ops.block_attention._plan(..., bwd=False) is not
    None`` in plain Python. A routing predicate only (which function the
    JAX package computes here: clip or exact), not a plan for the card."""
    hd = d_model // num_heads
    head_chunks = [num_heads]
    c = num_heads // 2
    while c >= 1 and num_heads % c == 0 and (c * hd) % 128 == 0:
        head_chunks.append(c)
        c //= 2
    for bq in (512, 256, 128, 64, 32):
        bq = min(bq, seq)
        for hc in head_chunks:
            dh = hc * hd
            for g in (16, 8, 4, 2, 1):
                if batch % g:
                    continue
                kv = 2 * g * seq * dh * 2 * 2
                tiles = 3 * g * bq * dh * 2 * 2
                scores = 3 * g * bq * seq * 4
                if kv + tiles + scores < _VMEM_BUDGET_FWD:
                    return True
    return False


def _auto(batch: int, seq: int, d_model: int, num_heads: int, mask,
          self_attention: bool) -> str:
    """The path ``impl="auto"`` takes: where the JAX package's auto route
    (on its TPU) takes its fused kernel, the flash kernel or XLA."""
    hd = d_model // num_heads
    jax_fused = (self_attention and seq >= _FUSED_MIN_SEQ and mask is None
                 and hd * num_heads == d_model and hd % 8 == 0
                 and _fused_plan_fits(batch, seq, d_model, num_heads))
    if (not jax_fused and mask is None and seq >= _FLASH_MIN_SEQ
            and hd <= flash_attention.MAX_HEAD_DIM):
        return "pallas"
    if (self_attention and seq >= _FUSED_MIN_SEQ
            and block_attention.eligible(d_model, num_heads, mask)):
        return "fused"
    return "einsum"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, mask: Optional[torch.Tensor] = None,
                         impl: str = "auto", seq_len: Optional[int] = None,
                         qkv_biases=None) -> torch.Tensor:
    """Multi-head attention over packed (B, L, D) or flat (B*L, D) operands.

    Args:
      q, k, v: (B, L, D) tensors, D = num_heads * head_dim, or flat (B*L, D)
        tensors with `seq_len` set (row i belongs to sample i // seq_len).
      num_heads: head count.
      mask: optional boolean (B, 1|H, Lq, Lk); True = attend. Masked
        attention always takes the einsum path.
      impl: one of ``_IMPLS`` (see the module docstring).
      seq_len: sequence length; required iff the operands are 2D.
      qkv_biases: optional ((D,), (D,), (D,)) projection biases not yet
        added to q/k/v. The fused path adds them inside the kernel; every
        other path adds them here, in the operand dtype.

    Returns:
      tensor of q's shape and dtype.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    shape = q.shape
    if q.dim() == 2:
        if seq_len is None:
            raise ValueError("2D operands require seq_len")
    else:
        seq_len = q.shape[1]
        q, k, v = (x.reshape(-1, x.shape[-1]) for x in (q, k, v))
    d = q.shape[-1]
    biases = None
    if qkv_biases is not None:
        biases = tuple(b.to(q.dtype) for b in qkv_biases)

    if impl == "auto":
        impl = _auto(q.shape[0] // seq_len, seq_len, d, num_heads, mask,
                     q.shape == k.shape)

    if impl in ("fused", "fused_exact", "plain"):
        # An explicit fused choice must not drop a mask; the wrapper raises
        # on a shape the kernel would refuse.
        if mask is not None:
            raise ValueError(f"impl={impl!r} does not support masks; use "
                             "impl='einsum' (or 'auto') for masked attention")
        out = block_attention.fused_attention(
            q, k, v, num_heads, seq_len, biases,
            exact=impl == "fused_exact", plain=impl == "plain")
        return out.reshape(shape)

    if biases is not None:
        q, k, v = q + biases[0], k + biases[1], v + biases[2]
    hd = d // num_heads
    q4 = q.reshape(-1, seq_len, num_heads, hd)
    k4 = k.reshape(q4.shape[0], -1, num_heads, hd)
    v4 = v.reshape(q4.shape[0], -1, num_heads, hd)
    return dot_product_attention(q4, k4, v4, mask, impl).reshape(shape)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over (B, L, H, hd) operands.

    Args:
      q, k, v: (B, Lq, H, hd), (B, Lk, H, hd), (B, Lk, H, hd).
      mask: optional boolean (B, 1|H, Lq, Lk); True = attend.
      impl: "auto" (the flash kernel for unmasked attention with Lq >= 1024
        and hd <= 128, as in the JAX version, else einsum) | "einsum" |
        "pallas" (the flash kernels) | "pallas_plain" (their plain
        versions, on any device).

    Returns:
      (B, Lq, H, hd) tensor in q's dtype.
    """
    if impl == "auto":
        impl = ("pallas" if mask is None and q.shape[1] >= _FLASH_MIN_SEQ
                and q.shape[-1] <= flash_attention.MAX_HEAD_DIM
                else "einsum")
    if impl in ("pallas", "pallas_plain"):
        return flash_attention.flash_attention(
            q, k, v, mask=mask, plain=impl == "pallas_plain")
    if impl != "einsum":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _einsum_attention(q, k, v, mask)


def _einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, L, H, hd) attention: fp32 logits and softmax, output in q's dtype
    (the JAX version's ``_xla_attention``)."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(dtype).float(),
                       v.float())
    return out.to(dtype)
