"""The logits processors of caption generation, as plain torch functions.

``CoCaModel.generate`` in the JAX package takes four processors from
``transformers`` (MinLength, RepetitionPenalty, TopK, TopP); these are
their semantics for 2D (batch, vocab) scores, so the port needs no
``transformers``. Each takes the (batch, length) int64 prefix and the
scores and returns new scores.
"""

from __future__ import annotations

import torch


def min_length(prefix: torch.Tensor, scores: torch.Tensor, *,
               min_length: int, eos_token_id: int) -> torch.Tensor:
    """eos is impossible (-inf) while the prefix is shorter than
    `min_length`."""
    if prefix.shape[-1] >= min_length:
        return scores.clone()
    eos = torch.arange(scores.shape[-1], device=scores.device) == eos_token_id
    return torch.where(eos, -torch.inf, scores)


def repetition_penalty(prefix: torch.Tensor, scores: torch.Tensor, *,
                       penalty: float) -> torch.Tensor:
    """The score of every token in the prefix is divided by `penalty` where
    positive, multiplied where negative."""
    score = torch.gather(scores, 1, prefix)
    score = torch.where(score < 0, score * penalty, score / penalty)
    return scores.scatter(1, prefix, score)


def top_k(prefix: torch.Tensor, scores: torch.Tensor, *,
          top_k: int) -> torch.Tensor:
    """Every score below the `top_k`-th largest of its row becomes -inf."""
    del prefix
    k = min(max(top_k, 1), scores.shape[-1])
    kth = torch.topk(scores, k)[0][..., -1, None]
    return scores.masked_fill(scores < kth, -torch.inf)


def top_p(prefix: torch.Tensor, scores: torch.Tensor, *,
          top_p: float) -> torch.Tensor:
    """Nucleus filtering: the tokens outside the smallest set whose
    probability reaches `top_p` become -inf (the most likely one stays)."""
    del prefix
    sorted_logits, sorted_indices = torch.sort(scores, descending=False)
    cumulative = sorted_logits.softmax(dim=-1).cumsum(dim=-1)
    remove = cumulative <= (1 - top_p)
    remove[..., -1:] = False
    remove = remove.scatter(1, sorted_indices, remove)
    return scores.masked_fill(remove, -torch.inf)
