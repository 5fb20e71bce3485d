"""Mean-of-per-example-metrics evaluator.

Port of ``clipa_tpu/evaluators/mean.py``: ``predict_fn(params, batch)``
returns a mapping from metric name to a per-example tensor shaped like the
batch mask; this evaluator sums each metric over the unmasked examples and
reports sum / n_unmasked, the sums taken over every process's examples.
Usable directly (hand it a function computing
e.g. per-example losses) or as a base for thin subclass evaluators.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from clipa_tpu_torch import registry
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.data import core as data_core
from clipa_tpu_torch.evaluators import common
from clipa_tpu_torch.parallel import collectives


class Evaluator:
    def __init__(self, predict_fn: Callable, device="cuda", *,
                 batch_size: int = 256, data: Optional[dict] = None,
                 source=None, pp: str = "", num_workers: int = 8):
        self.predict_fn = predict_fn
        self.device = u.resolve_device(device, "mean.Evaluator")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.source = source or data_core.get_source(**dict(data or {}))
        self.pp_fn = registry.get_preprocess_fn(pp)

    @torch.inference_mode()
    def _eval_batch(self, params, batch, mask):
        metrics = self.predict_fn(params, batch)
        if not isinstance(metrics, Mapping):
            raise TypeError("mean.Evaluator's predict_fn must return a "
                            f"dict, got {type(metrics).__name__}")
        for k, y in metrics.items():
            if y.shape != mask.shape:
                raise ValueError(
                    f"per-example metric {k!r} must have the batch shape "
                    f"{tuple(mask.shape)}, got {tuple(y.shape)}")
        sums = {k: torch.sum(torch.where(mask.bool(), y, 0))
                for k, y in metrics.items()}
        sums["_mask"] = torch.sum(mask)
        return sums

    def run(self, params):
        totals: dict = {}
        for batch in common.device_batches(
                self.source, lambda s: self.pp_fn(dict(s)), self.batch_size,
                self.device, num_workers=self.num_workers):
            mask = batch.pop("_mask")
            for k, v in self._eval_batch(params, batch, mask).items():
                totals[k] = totals.get(k, 0.0) + float(v)
        names = sorted(totals)
        totals = dict(zip(names, collectives.all_reduce_sum(
            [totals[k] for k in names]).tolist()))
        n = max(totals.pop("_mask", 0.0), 1)
        return [(k, v / n) for k, v in totals.items()]
