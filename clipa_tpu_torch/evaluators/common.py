"""Evaluator factory: builds evaluators from `config.evals` entries.

Port of ``clipa_tpu/evaluators/common.py``, with the same contract: each
entry has a `type`, optional `pred` (which function of the fns dict to
use), `prefix`, `log_steps` (or another cadence unit) and type-specific
kwargs; :func:`from_config` returns a list of (name, evaluator, log_steps,
prefix). An explicit `device` takes the place of the JAX mesh.

:func:`device_batches` is the evaluators' input: one padded pass of
``make_for_inference`` (``_mask`` 0 on the padding), moved to the device a
batch or two ahead of the forward.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Iterator

import torch

from clipa_tpu_torch.data import pipeline as pipeline_lib

_TYPE_ALIASES = {
    "zeroshot_classifier": "clipa_tpu_torch.evaluators.zeroshot",
    "proj.image_text.discriminative_classifier":
        "clipa_tpu_torch.evaluators.zeroshot",
    "contrastive": "clipa_tpu_torch.evaluators.contrastive",
    "proj.image_text.contrastive": "clipa_tpu_torch.evaluators.contrastive",
    "retrieval": "clipa_tpu_torch.evaluators.retrieval",
    "proj.image_text.retrieval": "clipa_tpu_torch.evaluators.retrieval",
    "fewshot": "clipa_tpu_torch.evaluators.fewshot",
    "fewshot_lsr": "clipa_tpu_torch.evaluators.fewshot",
    "classification": "clipa_tpu_torch.evaluators.classification",
    "mean": "clipa_tpu_torch.evaluators.mean",
}

_CONTROL_KEYS = ("type", "pred", "prefix", "log_steps", "log_percent",
                 "log_examples", "log_epochs", "skip_first")


def from_config(config: Any, predict_fns: dict[str, Callable],
                device="cuda", total_steps: int = 0) -> list:
    """Builds [(name, evaluator, log_steps, prefix)] from config.evals.

    Eval cadence may be given in steps/examples/epochs/percent units
    (resolved like every other duration). Any mapping is accepted as an
    entry (this package's ConfigDict, a dict, an ml_collections
    ConfigDict); any other value but None raises ``TypeError``. The
    evaluators run on `device` (the card unless the caller names the CPU).
    """
    from clipa_tpu_torch.config import steps as steps_cfg

    evaluators = []
    specs = dict(config.get("evals", {}))
    for name, cfg in specs.items():
        if not hasattr(cfg, "items"):
            if cfg is not None:
                raise TypeError(
                    f"config.evals.{name} must be a mapping (got "
                    f"{type(cfg).__name__})")
            continue
        cfg = dict(cfg.items())
        module_name = cfg.pop("type", name)
        module = importlib.import_module(
            _TYPE_ALIASES.get(module_name, module_name))
        pred_key = cfg.pop("pred", "predict")
        prefix = cfg.pop("prefix", f"{name}/")
        log_steps = steps_cfg(
            "log", cfg, batch_size=config.get_path("input.batch_size"),
            total_steps=total_steps, default=None)
        for k in _CONTROL_KEYS:
            cfg.pop(k, None)
        cfg.setdefault("batch_size", config.get(
            "eval_batch_size", config.get_path("input.batch_size", 256)))
        evaluator = module.Evaluator(predict_fns[pred_key], device, **cfg)
        evaluators.append((name, evaluator, log_steps, prefix))
    return evaluators


def device_batches(source, pp_fn: Callable, batch_size: int, device, *,
                   num_workers: int = 8) -> Iterator[dict]:
    """One padded pass over `source` through `pp_fn` (``make_for_inference``:
    every batch full, ``_mask`` 0 on the padding), each batch's arrays as
    tensors on `device`, copied ahead of the consumer."""
    batches, _ = pipeline_lib.make_for_inference(
        source, pp_fn, batch_size, num_workers=num_workers)
    return pipeline_lib.start_input_pipeline(batches, torch.device(device))
