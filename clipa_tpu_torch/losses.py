"""Losses.

Port of ``clipa_tpu/losses.py``: :func:`bidirectional_contrastive_loss`, the
global-batch InfoNCE of CLIP/CLIPA pre-training, and
:func:`sigmoid_contrastive_loss`, SigLIP's pairwise loss, on one device.
The logits are fp32 at full fp32 precision in both directions of autograd:
the JAX losses ask for ``Precision.HIGHEST``, so TF32 stays off for this
product whatever the process-wide setting is. The chunked InfoNCE is
``ops/infonce.py``. The classification losses
(:func:`sigmoid_xent`, :func:`softmax_xent`, :func:`bce_logits`,
:func:`weighted_softmax_xent`) are the ones the classification evaluator
resolves by name; each returns the per-row loss under ``reduction=False``.

:func:`distill_contrastive_loss` adds soft-label distillation from a
frozen teacher's logits; :func:`coca_loss` is CoCa's, the InfoNCE plus the
caption's next-token cross-entropy.

The local forms (:func:`local_contrastive_loss`,
:func:`local_sigmoid_contrastive_loss`,
:func:`local_distill_contrastive_loss`) compute one process's rows of the
global losses against the gathered global batch (label offset ``rank *
b``): the training step on several processes averages them over the
processes. The ring losses are ``ops/ring_infonce.py``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def full_fp32_matmul():
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
        with full_fp32_matmul():
            return a @ b.T

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with full_fp32_matmul():
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


def distill_contrastive_loss(zimg: torch.Tensor, ztxt: torch.Tensor,
                             t: torch.Tensor, t_zimg: torch.Tensor,
                             t_ztxt: torch.Tensor, t_t: torch.Tensor):
    """InfoNCE plus soft-label distillation from a teacher two-tower (the
    JAX package's ``distill_contrastive_loss``, the reference's
    DistillClipLoss with the trainer summing both terms).

    The teacher's B x B logits, at its own temperature `t_t`, give soft
    targets for the student's logits in both directions (soft
    cross-entropy); the contrastive term keeps weight 1. The teacher's
    inputs are detached: no gradient reaches them.

    Returns (total, {"contrastive_loss", "distill_loss", "ncorrect"}).
    """
    t_zimg, t_ztxt, t_t = t_zimg.detach(), t_ztxt.detach(), t_t.detach()
    logits_img = _Fp32MatmulT.apply(zimg.float(), ztxt.float()) * t
    logits_txt = logits_img.T
    with full_fp32_matmul():
        d_logits_img = (t_zimg.float() @ t_ztxt.float().T) * t_t
    d_logits_txt = d_logits_img.T

    contrastive = 0.5 * (
        -torch.diagonal(torch.log_softmax(logits_img, dim=1))
        - torch.diagonal(torch.log_softmax(logits_txt, dim=1))).mean()

    def soft_ce(teacher_logits, student_logits):
        p = torch.softmax(teacher_logits, dim=1)
        return (-(p * torch.log_softmax(student_logits, dim=1)).sum(
            dim=1)).mean()

    distill = 0.5 * (soft_ce(d_logits_img, logits_img)
                     + soft_ce(d_logits_txt, logits_txt))
    labels = torch.arange(logits_img.shape[0], device=logits_img.device)
    ncorrect = (logits_img.argmax(dim=1) == labels).float().mean()
    return contrastive + distill, {"contrastive_loss": contrastive,
                                   "distill_loss": distill,
                                   "ncorrect": ncorrect}


def sigmoid_contrastive_loss(zimg: torch.Tensor, ztxt: torch.Tensor,
                             t: torch.Tensor, bias=0.0,
                             reduction: bool = True):
    """SigLIP-style pairwise sigmoid loss (arxiv.org/abs/2303.15343).

    Every (i, j) pair is an independent binary problem, positives on the
    diagonal: the per-row loss is sum_j softplus(-sign_ij * (t * zimg_i .
    ztxt_j + bias)). `bias`: the two towers' learned ``b`` (or a number).
    Returns (mean over rows, or the per-row losses without `reduction`,
    {}).
    """
    logits = _Fp32MatmulT.apply(zimg.float(), ztxt.float()) * t + bias
    b = logits.shape[0]
    signs = 2 * torch.eye(b, device=logits.device) - 1.0  # +1 diag, -1 off
    nll = torch.nn.functional.softplus(-signs * logits)
    per_row = nll.sum(dim=1)
    return (per_row.mean() if reduction else per_row), {}


def _rows_logits(local: torch.Tensor, global_: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    return _Fp32MatmulT.apply(local.float(), global_.float()) * t


def _picked(log_p: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.gather(log_p, 1, labels[:, None])[:, 0]


def local_contrastive_loss(local_img: torch.Tensor, local_txt: torch.Tensor,
                           global_img: torch.Tensor,
                           global_txt: torch.Tensor, t: torch.Tensor,
                           rank: int, reduction: bool = True):
    """One process's rows of :func:`bidirectional_contrastive_loss` (the
    JAX package's ``local_contrastive_loss``): its (b, C) rows against the
    gathered (B, C) columns, the positives at ``rank * b + i``. The mean
    over the processes of the reduced value is the global loss.

    Returns (loss, {"ncorrect": ...}); per row without `reduction`.
    """
    b = local_img.shape[0]
    labels = rank * b + torch.arange(b, device=local_img.device)
    logits_img = _rows_logits(local_img, global_txt, t)
    logits_txt = _rows_logits(local_txt, global_img, t)
    l1 = -_picked(torch.log_softmax(logits_img, dim=1), labels)
    l2 = -_picked(torch.log_softmax(logits_txt, dim=1), labels)
    loss = 0.5 * (l1 + l2)
    ncorrect = (logits_img.argmax(dim=1) == labels).float()
    if reduction:
        return loss.mean(), {"ncorrect": ncorrect.mean()}
    return loss, {"ncorrect": ncorrect}


def local_sigmoid_contrastive_loss(local_img: torch.Tensor,
                                   global_txt: torch.Tensor,
                                   t: torch.Tensor, rank: int, bias=0.0,
                                   reduction: bool = True):
    """One process's rows of :func:`sigmoid_contrastive_loss`: its image
    rows against every text row, the positives at ``rank * b + i``."""
    b = local_img.shape[0]
    logits = _rows_logits(local_img, global_txt, t) + bias
    signs = -torch.ones_like(logits)
    rows = torch.arange(b, device=logits.device)
    signs[rows, rank * b + rows] = 1.0
    per_row = torch.nn.functional.softplus(-signs * logits).sum(dim=1)
    return (per_row.mean() if reduction else per_row), {}


def local_distill_contrastive_loss(zimg, ztxt, global_img, global_txt, t,
                                   t_zimg, t_ztxt, t_global_img,
                                   t_global_txt, t_t, rank: int):
    """One process's rows of :func:`distill_contrastive_loss`: the student's
    and the teacher's rows against the gathered columns (the teacher's
    detached)."""
    b = zimg.shape[0]
    labels = rank * b + torch.arange(b, device=zimg.device)
    logits_img = _rows_logits(zimg, global_txt, t)
    logits_txt = _rows_logits(ztxt, global_img, t)
    with torch.no_grad(), full_fp32_matmul():
        d_img = (t_zimg.float() @ t_global_txt.float().T) * t_t
        d_txt = (t_ztxt.float() @ t_global_img.float().T) * t_t
    contrastive = 0.5 * (
        -_picked(torch.log_softmax(logits_img, dim=1), labels)
        - _picked(torch.log_softmax(logits_txt, dim=1), labels)).mean()

    def soft_ce(teacher_logits, student_logits):
        p = torch.softmax(teacher_logits, dim=1)
        return (-(p * torch.log_softmax(student_logits, dim=1)).sum(
            dim=1)).mean()

    distill = 0.5 * (soft_ce(d_img, logits_img) + soft_ce(d_txt, logits_txt))
    ncorrect = (logits_img.argmax(dim=1) == labels).float().mean()
    return contrastive + distill, {"contrastive_loss": contrastive,
                                   "distill_loss": distill,
                                   "ncorrect": ncorrect}


def caption_nll(logits: torch.Tensor, labels: torch.Tensor,
                pad_id: int = 0):
    """CoCa's caption term before its mean: (the sum over the positions
    whose label is not `pad_id` of the next-token cross-entropy, the count
    of those positions), fp32. A label past the vocabulary gives NaN."""
    log_p = torch.log_softmax(logits.float(), dim=-1)
    vocab = log_p.shape[-1]
    labels = labels.long()
    nll = -torch.gather(log_p, -1, labels.clamp(max=vocab - 1)[..., None])
    nll = torch.where(labels < vocab, nll[..., 0], float("nan"))
    keep = (labels != pad_id).float()
    return (nll * keep).sum(), keep.sum()


def coca_loss(zimg: torch.Tensor, ztxt: torch.Tensor, t: torch.Tensor,
              logits: torch.Tensor, labels: torch.Tensor, *,
              clip_loss_weight: float = 1.0,
              caption_loss_weight: float = 2.0, pad_id: int = 0):
    """CoCa's objective: ``clip_loss_weight`` x the InfoNCE plus
    ``caption_loss_weight`` x the next-token cross-entropy of `logits`
    (B, L, V) against `labels` (B, L), averaged over the positions whose
    label is not `pad_id` (at least one), in fp32: torch's
    ``CrossEntropyLoss(ignore_index=pad_id)``. A label past the vocabulary
    gives NaN, as the JAX loss's gather does (coca_roberta's RoBERTa ids
    run past its decoder's 49 408). The extras carry both weighted
    terms."""
    clip_l, extras = bidirectional_contrastive_loss(zimg, ztxt, t,
                                                    reduction=True)
    total, count = caption_nll(logits, labels, pad_id)
    caption_l = total / count.clamp(min=1.0)
    loss = clip_loss_weight * clip_l + caption_loss_weight * caption_l
    return loss, {**extras, "contrastive_loss": clip_loss_weight * clip_l,
                  "caption_loss": caption_loss_weight * caption_l}


def sigmoid_xent(*, logits, labels, reduction: bool = True):
    """Stable elementwise sigmoid cross-entropy, summed over the last axis."""
    log_p = torch.nn.functional.logsigmoid(logits)
    log_not_p = torch.nn.functional.logsigmoid(-logits)
    nll = -torch.sum(labels * log_p + (1.0 - labels) * log_not_p, dim=-1)
    return nll.mean() if reduction else nll


def softmax_xent(*, logits, labels, reduction: bool = True, kl: bool = False,
                 axis: int = -1):
    """Cross-entropy of soft (one/multi-hot) `labels`; with `kl`, the KL
    divergence (the labels' entropy added back)."""
    log_p = torch.log_softmax(logits, dim=axis)
    nll = -torch.sum(labels * log_p, dim=axis)
    if kl:
        nll = nll + torch.sum(labels * torch.log(labels.clamp(min=1e-8)),
                              dim=axis)
    return nll.mean() if reduction else nll


def bce_logits(*, logits, labels, weight=None, reduction: bool = True):
    """Stable binary cross-entropy with logits, elementwise."""
    max_val = logits.clamp(min=0)
    loss = logits - logits * labels + max_val + \
        torch.log(torch.exp(-max_val) + torch.exp(-logits - max_val))
    if weight is not None:
        loss = loss * weight
    return loss.mean() if reduction else loss


def weighted_softmax_xent(*, logits, labels, reduction: bool = True,
                          weights=None, label_smoothing: float = 0.0,
                          normalize: bool = True):
    """Token-level cross-entropy over (B, L, V) logits / (B, L) int labels."""
    if logits.dim() != labels.dim() + 1:
        raise ValueError(f"Bad shapes: {tuple(logits.shape)} vs "
                         f"{tuple(labels.shape)}")
    vocab = logits.shape[-1]
    confidence = 1.0 - label_smoothing
    low = label_smoothing / (vocab - 1)
    onehot = torch.nn.functional.one_hot(labels.long(), vocab).to(
        logits.dtype)
    soft = onehot * confidence + (1.0 - onehot) * low
    loss = -torch.sum(soft * torch.log_softmax(logits, dim=-1), dim=-1)
    norm = labels.shape[1]
    if weights is not None:
        loss = loss * weights
        norm = weights.sum(dim=1)
    loss = loss.sum(dim=1)
    if normalize:
        loss = loss / norm
    return loss.mean() if reduction else loss
