"""Chunked global InfoNCE with an online logsumexp.

Port of ``clipa_tpu/ops/infonce.py``. The bidirectional InfoNCE of
``losses.bidirectional_contrastive_loss`` materialises the B x B logits;
this loss never holds more than (B x chunk) of them. The forward walks the
text embeddings chunk by chunk, keeping a running (max, sum of exp) per row
(the flash-attention trick applied to the loss) and each chunk's column
logsumexp, which is complete within the chunk; the backward
(:class:`ChunkedContrastiveFn`, the JAX custom VJP) walks the chunks again
and rebuilds the softmax weights from the saved row and column
logsumexps. Loss and gradients equal the full loss's in fp32 arithmetic.

The JAX op is XLA (a ``lax.scan``), not a Pallas kernel: the port's are
PyTorch ops, each chunk one (B, C) x (C, chunk) fp32 product with TF32
off (the JAX op asks for ``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch

from clipa_tpu_torch.losses import full_fp32_matmul


def chunked_contrastive_loss(zimg: torch.Tensor, ztxt: torch.Tensor,
                             t: torch.Tensor, chunk_size: int = 4096):
    """Mean bidirectional InfoNCE in O(B * chunk) memory.

    Args:
      zimg, ztxt: (B, C) L2-normalized embeddings.
      t: temperature (already exp'd), scalar or (1,).
      chunk_size: the column chunk; where it does not divide B, the largest
        divisor of B below it (:func:`_largest_divisor`), refused where that
        is under a quarter of min(chunk_size, B).

    Returns:
      (scalar loss, {"ncorrect": fraction of rows whose argmax is the
      diagonal}).
    """
    b = zimg.shape[0]
    if b % chunk_size:
        requested = chunk_size
        chunk_size = _largest_divisor(b, chunk_size)
        # a pathological batch (e.g. prime) forces a tiny chunk: exact, but
        # up to ~100x slower; refuse rather than silently degrade
        if chunk_size * 4 < min(requested, b):
            raise ValueError(
                f"chunked_contrastive_loss: batch {b} has no divisor near "
                f"the requested chunk_size {requested}; the largest is "
                f"{chunk_size}, which would scan {b // chunk_size} chunks "
                "(pathological slowdown). Pick a batch size with a divisor "
                "close to loss_chunk_size.")
    t = t.float().reshape(())
    loss, ncorrect = ChunkedContrastiveFn.apply(zimg.float(), ztxt.float(),
                                                t, chunk_size)
    return loss, {"ncorrect": ncorrect}


def _largest_divisor(n: int, upper: int) -> int:
    for c in range(min(upper, n), 0, -1):
        if n % c == 0:
            return c
    return n


class ChunkedContrastiveFn(torch.autograd.Function):
    """``apply(zimg, ztxt, t, chunk_size) -> (loss, ncorrect)``: fp32
    (B, C) embeddings, a 0-d temperature; `chunk_size` divides B. The
    backward recomputes each chunk's logits."""

    @staticmethod
    def forward(ctx, zimg, ztxt, t, chunk_size):
        b = zimg.shape[0]
        rows = torch.arange(b, device=zimg.device)
        m_row = torch.full((b,), float("-inf"), device=zimg.device)
        s_row = torch.zeros(b, device=zimg.device)
        amax_val = torch.full((b,), float("-inf"), device=zimg.device)
        amax_idx = torch.zeros(b, dtype=torch.long, device=zimg.device)
        lse_col = []
        with full_fp32_matmul():
            for start in range(0, b, chunk_size):
                logits = (zimg @ ztxt[start:start + chunk_size].T) * t
                # online row logsumexp
                c_val, c_idx = logits.max(dim=1)
                m_new = torch.maximum(m_row, c_val)
                s_row = s_row * torch.exp(m_row - m_new) + torch.exp(
                    logits - m_new[:, None]).sum(dim=1)
                m_row = m_new
                # online row argmax: the first maximum wins
                take = c_val > amax_val
                amax_val = torch.where(take, c_val, amax_val)
                amax_idx = torch.where(take, c_idx + start, amax_idx)
                # a column's logsumexp is complete within its chunk
                lse_col.append(torch.logsumexp(logits, dim=0))
        lse_row = m_row + torch.log(s_row)
        lse_col = torch.cat(lse_col)
        diag = (zimg * ztxt).sum(dim=-1) * t
        loss = (0.5 * (lse_row + lse_col) - diag).mean()
        ncorrect = (amax_idx == rows).float().mean()
        ctx.save_for_backward(zimg, ztxt, t, lse_row, lse_col)
        ctx.chunk_size = chunk_size
        ctx.mark_non_differentiable(ncorrect)
        return loss, ncorrect

    @staticmethod
    def backward(ctx, g, _):
        zimg, ztxt, t, lse_row, lse_col = ctx.saved_tensors
        chunk_size = ctx.chunk_size
        b = zimg.shape[0]
        acc_z = torch.zeros_like(zimg)
        acc_t = torch.zeros((), device=zimg.device)
        g_w = []
        with full_fp32_matmul():
            for start in range(0, b, chunk_size):
                ztxt_c = ztxt[start:start + chunk_size]
                logits = (zimg @ ztxt_c.T) * t
                p_row = torch.exp(logits - lse_row[:, None])  # over columns
                p_col = torch.exp(
                    logits - lse_col[start:start + chunk_size][None, :])
                w = 0.5 * (p_row + p_col)                     # (B, chunk)
                acc_z = acc_z + w @ ztxt_c
                g_w.append(w.T @ zimg)
                acc_t = acc_t + (w * logits).sum() / t
        scale = g * t / b
        g_zimg = scale * (acc_z - ztxt)
        g_ztxt = scale * (torch.cat(g_w) - zimg)
        diag_c = (zimg * ztxt).sum(dim=-1)   # cosine similarities (no t)
        g_t = (g / b) * (acc_t - diag_c.sum())
        return g_zimg, g_ztxt, g_t, None
