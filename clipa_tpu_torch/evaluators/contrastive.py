"""Contrastive evaluator: validation loss and in-batch retrieval accuracy.

Port of ``clipa_tpu/evaluators/contrastive.py``: streams a held-out
image-text split once and computes the bidirectional InfoNCE loss
(``losses.bidirectional_contrastive_loss`` with the padding masked out, per
row) and the fraction of examples whose best match within the evaluation
batch is the true pair. Masked (padding) examples are excluded. On several
processes the evaluation batch is the global one (every process's rows,
gathered) under `use_global_batch` (the default, as the JAX evaluator's
global arrays), else each process's own; the sums are over every
process's examples.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from clipa_tpu_torch import losses as losses_lib
from clipa_tpu_torch import registry
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.data import core as data_core
from clipa_tpu_torch.evaluators import common
from clipa_tpu_torch.parallel import collectives


class Evaluator:
    def __init__(self, predict_fn: Callable, device="cuda", *,
                 batch_size: int = 256, data: Optional[dict] = None,
                 source=None, pp: str = "", use_global_batch: bool = True,
                 num_workers: int = 8):
        self.use_global_batch = use_global_batch
        self.predict_fn = predict_fn
        self.device = u.resolve_device(device, "contrastive.Evaluator")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.source = source or data_core.get_source(**dict(data or {}))
        self.pp_fn = registry.get_preprocess_fn(pp)

    def _eval_batch(self, params, image, labels, mask, gathered=False):
        zimg, ztxt, out = self.predict_fn(params, image, labels)
        if gathered:   # every process computes the global batch's sums
            zimg, ztxt, mask = (collectives.gather_rows_nograd(x)
                                for x in (zimg, ztxt, mask))
        with torch.inference_mode():
            loss, extras = losses_lib.bidirectional_contrastive_loss(
                zimg, ztxt, out["t"], mask=mask, reduction=False)
            return (torch.sum(loss * mask),
                    torch.sum(extras["ncorrect"] * mask), torch.sum(mask))

    def run(self, params):
        def pp(sample):
            out = self.pp_fn(dict(sample))
            return {"image": out["image"], "labels": out["labels"]}

        gathered = self.use_global_batch and collectives.world_size() > 1
        sums = [0.0, 0.0, 0.0]
        for batch in common.device_batches(self.source, pp, self.batch_size,
                                           self.device,
                                           num_workers=self.num_workers):
            batch_sums = self._eval_batch(params, batch["image"],
                                          batch["labels"],
                                          batch["_mask"].float(), gathered)
            sums = [a + float(b) for a, b in zip(sums, batch_sums)]
        if not gathered:
            sums = collectives.all_reduce_sum(sums).tolist()
        loss_sum, ncorrect, count = sums
        return [("loss", loss_sum / max(count, 1)),
                ("ncorrect", ncorrect / max(count, 1))]
