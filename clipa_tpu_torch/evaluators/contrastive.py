"""Contrastive evaluator: validation loss and in-batch retrieval accuracy.

Port of ``clipa_tpu/evaluators/contrastive.py``: streams a held-out
image-text split once and computes the bidirectional InfoNCE loss
(``losses.bidirectional_contrastive_loss`` with the padding masked out, per
row) and the fraction of examples whose best match within the evaluation
batch is the true pair. Masked (padding) examples are excluded.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from clipa_tpu_torch import losses as losses_lib
from clipa_tpu_torch import registry
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.data import core as data_core
from clipa_tpu_torch.evaluators import common


class Evaluator:
    def __init__(self, predict_fn: Callable, device="cuda", *,
                 batch_size: int = 256, data: Optional[dict] = None,
                 source=None, pp: str = "", use_global_batch: bool = True,
                 num_workers: int = 8):
        del use_global_batch  # one process: the batch is the global batch
        self.predict_fn = predict_fn
        self.device = u.resolve_device(device, "contrastive.Evaluator")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.source = source or data_core.get_source(**dict(data or {}))
        self.pp_fn = registry.get_preprocess_fn(pp)

    def _eval_batch(self, params, image, labels, mask):
        zimg, ztxt, out = self.predict_fn(params, image, labels)
        with torch.inference_mode():
            loss, extras = losses_lib.bidirectional_contrastive_loss(
                zimg, ztxt, out["t"], mask=mask, reduction=False)
            return (torch.sum(loss * mask),
                    torch.sum(extras["ncorrect"] * mask), torch.sum(mask))

    def run(self, params):
        def pp(sample):
            out = self.pp_fn(dict(sample))
            return {"image": out["image"], "labels": out["labels"]}

        loss_sum = ncorrect = count = 0.0
        for batch in common.device_batches(self.source, pp, self.batch_size,
                                           self.device,
                                           num_workers=self.num_workers):
            l, nc, n = self._eval_batch(params, batch["image"],
                                        batch["labels"],
                                        batch["_mask"].float())
            loss_sum += float(l)
            ncorrect += float(nc)
            count += float(n)
        return [("loss", loss_sum / max(count, 1)),
                ("ncorrect", ncorrect / max(count, 1))]
