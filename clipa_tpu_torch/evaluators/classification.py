"""Supervised classification evaluator: loss and prec@1 on labeled data.

Port of ``clipa_tpu/evaluators/classification.py``: labels arrive one- or
multi-hot under `label_key`; examples whose label row is all zero are
excluded (the mask is multiplied by the row's max); top-1 correctness is
the label value at the argmax logit (so a multi-hot row counts any hot
class as correct); the per-example loss is `loss_name` from
:mod:`clipa_tpu_torch.losses` (softmax_xent | sigmoid_xent | bce_logits |
weighted_softmax_xent) with ``reduction=False``.

The predict fn's output is resolved as the JAX package resolves it: a bare
tensor is the logits, a tuple/list contributes its first element and a
mapping its ``"logits"``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from clipa_tpu_torch import losses as losses_lib
from clipa_tpu_torch import registry
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.data import core as data_core
from clipa_tpu_torch.evaluators import common


def _resolve_logits(out):
    if isinstance(out, (tuple, list)):
        out = out[0]
    if hasattr(out, "get") and not hasattr(out, "ndim"):
        out = out["logits"]
    return out


class Evaluator:
    def __init__(self, predict_fn: Callable, device="cuda", *,
                 batch_size: int = 256, data: Optional[dict] = None,
                 source=None, pp: str = "", loss_name: str = "softmax_xent",
                 label_key: str = "labels", num_workers: int = 8):
        self.predict_fn = predict_fn
        self.device = u.resolve_device(device, "classification.Evaluator")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.label_key = label_key
        self.source = source or data_core.get_source(**dict(data or {}))
        self.pp_fn = registry.get_preprocess_fn(pp)
        self.loss = getattr(losses_lib, loss_name)

    @torch.inference_mode()
    def _eval_batch(self, params, batch, labels, mask):
        logits = _resolve_logits(self.predict_fn(params, **batch))
        # ignore the entries whose label row is all zeros
        mask = mask * torch.max(labels, dim=1).values
        losses = self.loss(logits=logits, labels=labels, reduction=False)
        top1_idx = torch.argmax(logits, dim=1)
        top1_correct = torch.take_along_dim(labels, top1_idx[:, None],
                                            dim=1)[:, 0]
        return (torch.sum(top1_correct * mask), torch.sum(losses * mask),
                torch.sum(mask))

    def run(self, params):
        ncorrect = loss_sum = count = 0.0
        for batch in common.device_batches(
                self.source, lambda s: self.pp_fn(dict(s)), self.batch_size,
                self.device, num_workers=self.num_workers):
            labels = batch.pop(self.label_key)
            mask = batch.pop("_mask").float()
            nc, l, n = self._eval_batch(params, batch, labels, mask)
            ncorrect += float(nc)
            loss_sum += float(l)
            count += float(n)
        return [("prec@1", ncorrect / max(count, 1)),
                ("loss", loss_sum / max(count, 1))]
