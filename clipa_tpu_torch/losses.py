"""Losses.

Port of ``clipa_tpu/losses.py``: :func:`bidirectional_contrastive_loss`, the
global-batch InfoNCE of CLIP/CLIPA pre-training, on one device. The logits
are fp32 at full fp32 precision in both directions of autograd: the JAX loss
asks for ``Precision.HIGHEST``, so TF32 stays off for this product whatever
the process-wide setting is.

Not ported yet: the sigmoid, local, CoCa and distillation losses and the
chunked/ring InfoNCE (``ops/infonce.py``, ``ops/ring_infonce.py``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def _full_fp32_matmul():
    """fp32 matrix products without TF32 on a card (no-op on the CPU)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _Fp32MatmulT(torch.autograd.Function):
    """a @ b.T in fp32 with TF32 off, in the forward and in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _full_fp32_matmul():
            return a @ b.T

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _full_fp32_matmul():
            return g @ b, g.T @ a


def bidirectional_contrastive_loss(zimg: torch.Tensor, ztxt: torch.Tensor,
                                   t: torch.Tensor,
                                   mask: Optional[torch.Tensor] = None,
                                   reduction: bool = False):
    """Bidirectional InfoNCE over a batch.

    Args:
      zimg, ztxt: (B, C) L2-normalized embeddings.
      t: scalar (or (1,)) temperature, already exp'd.
      mask: optional (B,) boolean validity mask; masked rows/cols are
        excluded.
      reduction: mean-reduce to a scalar (over valid rows with a mask).

    Returns:
      (loss, {"ncorrect": ...}); per-row values without `reduction`.
    """
    logits = _Fp32MatmulT.apply(zimg.float(), ztxt.float()) * t
    if mask is not None:
        mask = mask.bool()
        exclude = ~mask
        exclude = exclude[:, None] | exclude[None, :]
        logits = logits.masked_fill(exclude, float("-inf"))

    l1 = -torch.diagonal(torch.log_softmax(logits, dim=1))  # img -> txt
    l2 = -torch.diagonal(torch.log_softmax(logits, dim=0))  # txt -> img
    loss = 0.5 * (l1 + l2)
    if mask is not None:
        loss = torch.where(mask, loss, 0.0)

    ncorrect = (logits.argmax(dim=1) == torch.arange(
        logits.shape[0], device=logits.device)).float()
    if reduction and mask is not None:
        m = mask.float()

        def redux(x):
            return (x * m).sum() / (m.sum() + 1e-8)
    elif reduction:
        def redux(x):
            return x.mean()
    else:
        def redux(x):
            return x
    return redux(loss), {"ncorrect": redux(ncorrect)}
