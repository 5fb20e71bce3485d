"""Attention cores.

Port of ``clipa_tpu/ops/attention.py``. :func:`multi_head_attention` takes
packed (B, L, D) or flat (B*L, D) operands, as the JAX version does.

Dispatch (``impl="auto"``) is keyed on the sequence length and the mask; the
device decides only what the fused path runs:
  * ``fused``  -- unmasked self-attention with L >= 33 and a head dim the
                  kernel takes: the CUDA kernels (forward and backward) for
                  a CUDA tensor, their plain versions for a CPU tensor
                  (ops/block_attention.py). Covers every CLIPA image tower
                  (50/257/577 tokens).
  * ``einsum`` -- einsum + fp32 softmax with ``finfo.min`` masking, autograd
                  gradients: masked attention and short sequences, including
                  the 8- and 32-token text towers (the JAX version's ``xla``
                  path).
Explicit choices: ``fused_exact`` (the fused path with the row-max softmax)
and ``plain`` (the fused path's plain PyTorch versions, forward and
backward, on any device: the reference the kernels are held against).
``pallas``, the tiled flash kernel the JAX version takes from 1024 tokens
on, is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from clipa_tpu_torch.ops import block_attention

# Below this the JAX package keeps attention on the einsum path (measured on
# the TPU there): the text towers (<= 32 tokens) stay off the fused kernel.
_FUSED_MIN_SEQ = 33


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
      impl: "auto" | "fused" | "fused_exact" | "plain" | "einsum".
      seq_len: sequence length; required iff the operands are 2D.
      qkv_biases: optional ((D,), (D,), (D,)) projection biases not yet
        added to q/k/v. The fused path adds them inside the kernel; every
        other path adds them here, in the operand dtype.

    Returns:
      tensor of q's shape and dtype.
    """
    if impl == "pallas":
        raise NotImplementedError(
            "impl='pallas' (tiled flash attention, clipa_tpu/ops/"
            "flash_attention.py) is not ported yet; see ROADMAP.md queue B")
    if impl not in ("auto", "fused", "fused_exact", "plain", "einsum"):
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
        fused = (q.shape == k.shape and seq_len >= _FUSED_MIN_SEQ
                 and block_attention.eligible(d, num_heads, mask))
        impl = "fused" if fused else "einsum"

    if impl != "einsum":
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
    return _einsum_attention(q4, k4, v4, mask).reshape(shape)


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
