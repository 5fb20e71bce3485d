"""The training step on one device.

Port of ``clipa_tpu/train/step.py`` for one GPU: :func:`create_model` builds
the two-tower model a config describes (the model ``clipa_tpu/train/loop.py``
builds, with its position tables sized from ``config.init_shapes`` as flax
sizes them from the init inputs), :func:`init_train_state` draws its fp32
parameters from a seeded ``torch.Generator`` on the device, and
:func:`make_update_fn` returns ``update(state, batch) -> (state,
measurements)``:

  uint8 images normalized on the device (``config.cpu_unit8``) -> train-mode
  forward in the config's compute dtype over fp32 parameters, with CLIPA's
  random image-token masking at ``config.mask_ratio`` (unmask-tuning) and
  the towers' ``remat_policy`` and ``attn_impl`` -> the loss
  (``config.loss``; only "softmax", the global InfoNCE, is ported) ->
  autograd, through the attention kernels' backward on a card -> the optax
  chain of ``optim.py``, applied in place -> the temperature clamp.

The measurements are the JAX step's: ``training_loss``, ``t``,
``t/parameter``, ``nimg``, ``ntxt``, ``ncorrect`` and, under
``config.norm_metrics`` "log" (default) / "always" / "never",
``l2_grads``, ``l2_params`` and ``l2_updates``: under "log" they are
computed on the first, the last and every ``log_training_steps``-th step and
are 0 on the others. Values are 0-d tensors on the device (no host sync).

:func:`make_predict_fn` is the evaluators' forward: eval mode, no masking,
no gradients, uint8 images normalized as the step normalizes them.

The masking noise of step s comes from a ``torch.Generator`` on the
device seeded from ``(config.seed, s)``: the counterpart of the JAX step's
``fold_in(rng, step)``. The two give different streams of the same
distribution.

Not ported yet (they raise): the sigmoid, chunked, ring and CoCa losses,
two-pass gradient accumulation (``grad_accum_steps > 1``), distillation and
the per-block gradient norms.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from clipa_tpu_torch import losses as losses_lib
from clipa_tpu_torch import optim, utils
from clipa_tpu_torch.models import get_model_module, layers
from clipa_tpu_torch.ops import preprocess


def create_model(config, device="cuda") -> torch.nn.Module:
    """The model of ``config.model`` (a two-tower config), on `device` (the
    card unless the caller names the CPU or ``meta``; raises without a
    card), with the towers' options as the config sets them
    (``remat_policy``, ``attn_impl``, ...)."""
    name = config.get("model_name", "two_towers")
    if name != "two_towers":
        raise NotImplementedError(f"model_name={name!r} is not ported to "
                                  "the training step yet")
    cfg = dict(config.model)
    img_shape, txt_shape = (tuple(s) for s in config.init_shapes)
    if cfg.get("image") is not None:
        cfg["image"] = {"image_size": img_shape[1:3], **cfg["image"]}
    if cfg.get("text") is not None:
        cfg["text"] = {"context_length": txt_shape[1], **cfg["text"]}
    with utils.resolve_device(device, "create_model"):
        return get_model_module(name).Model(**cfg)


def init_train_state(model: torch.nn.Module, config, generator:
                     torch.Generator, device) -> dict:
    """Moves `model` to `device` and draws its parameters from `generator`
    (which must live on `device`) with the flax initializers'
    distributions. Returns {"params": {JAX name: parameter}, "step": 0};
    the parameters are the model's own (fp32 masters), updated in place."""
    del config  # the model and the generator carry everything needed
    model.to(device)
    layers.init_parameters(model, generator)
    model.train()
    return {"params": optim.named_parameters(model), "step": 0}


def mask_generator(config, step: int, device) -> torch.Generator:
    """The masking noise's generator of step `step`, seeded from
    ``(config.seed, step)``."""
    seed = np.random.SeedSequence([int(config.get("seed", 0)), int(step)])
    return torch.Generator(device=device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))


def _sqsum(tensors) -> torch.Tensor:
    """Sum of squares over tensors, in fp32 (optax.global_norm squared)."""
    return sum(x.float().square().sum() for x in tensors)


def make_update_fn(model: torch.nn.Module, tx: optim.Optimizer, config,
                   total_steps: int = 0,
                   teacher_model: Optional[Any] = None) -> Callable:
    """Builds update(state, batch) -> (state, measurements).

    `state` is :func:`init_train_state`'s; its parameters must be the ones
    `tx` was made over. `batch`: {"image": (B, H, W, 3) uint8 or float,
    "labels": (B, l) token ids}, tensors on the model's device.
    `total_steps` (when known) lets the gated norm metrics fire on the
    last step too.
    """
    mask_ratio = float(config.get("mask_ratio", 0.0))
    loss_kind = config.get("loss", "softmax")
    normalize_on_device = bool(config.get("cpu_unit8", True))
    norm_metrics = config.get("norm_metrics", "log")  # log|always|never
    log_steps = int(config.get("log_training_steps", 50))
    temperature_clamp = config.get("temperature_clamp", False)
    t_clamp_max = (float(np.log(100.0)) if temperature_clamp is True
                   else float(temperature_clamp or 0.0))
    if loss_kind != "softmax":
        raise NotImplementedError(
            f"config.loss={loss_kind!r} is not ported yet (only 'softmax', "
            "the global InfoNCE)")
    if int(config.get("grad_accum_steps", 1)) > 1:
        raise NotImplementedError("grad_accum_steps > 1 (two-pass "
                                  "full-batch-negative accumulation) is not "
                                  "ported yet")
    if teacher_model is not None:
        raise NotImplementedError("distillation is not ported yet")
    if config.get("log_block_norms"):
        raise NotImplementedError("log_block_norms is not ported yet")
    if norm_metrics not in ("log", "always", "never"):
        raise ValueError(f"unknown norm_metrics {norm_metrics!r}")

    def update(state: dict, batch: dict):
        params = state["params"]
        images, labels = batch["image"], batch["labels"]
        if normalize_on_device and images.dtype == torch.uint8:
            images = preprocess.normalize_uint8(images)

        model.train()
        generator = (mask_generator(config, state["step"], images.device)
                     if mask_ratio > 0 else None)
        zimg, ztxt, extras = model(images, labels, mask_ratio=mask_ratio,
                                   generator=generator)
        loss, l_extras = losses_lib.bidirectional_contrastive_loss(
            zimg, ztxt, extras["t"], reduction=True)
        measurements = {
            "t": extras["t"][0].detach(),
            "t/parameter": extras["t/parameter"][0].detach().clone(),
            "nimg": extras["img/norm"].mean().detach(),
            "ntxt": extras["txt/norm"].mean().detach(),
            **{k: v.mean().detach() for k, v in l_extras.items()},
        }
        names = list(params)
        found = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, found)}

        updates = tx.update(grads)
        tx.apply(updates)
        if temperature_clamp and "t" in params:
            with torch.no_grad():
                params["t"].clamp_(0.0, t_clamp_max)

        measurements["training_loss"] = loss.detach()
        if norm_metrics != "never":
            # `step` is pre-increment; the loop logs this batch as step + 1
            logged = state["step"] + 1
            due = (norm_metrics == "always" or logged % log_steps == 0
                   or logged == 1 or logged == total_steps)
            zero = torch.zeros((), device=loss.device)
            with torch.no_grad():
                for key, tree in (("l2_grads", grads), ("l2_params", params),
                                  ("l2_updates", updates)):
                    measurements[key] = (torch.sqrt(_sqsum(tree.values()))
                                         if due else zero)
        state["step"] += 1
        return state, measurements

    return update



def make_predict_fn(model: torch.nn.Module, normalize: bool = True
                    ) -> Callable:
    """The predict fn handed to the evaluators: ``predict(params,
    image=None, text=None) -> (zimg, ztxt, out)``.

    uint8 images are normalized on the device with the statistics the
    update step uses (``preprocess.normalize_uint8``), so evaluator pp
    strings stay on the uint8 transfer path and train and eval inputs are
    identically distributed; float images (a pp string that applied its own
    value range) pass through untouched. The forward runs in eval mode under
    ``torch.inference_mode()`` with ``mask_ratio`` 0 and no generator: no
    token is masked at eval, whatever the config's ``mask_ratio``, and no
    generator that training draws from is touched. The next ``update()``
    puts the model back in train mode.

    `params` is the train state's parameter dict: its tensors are the
    model's own, which the forward reads through `model`; it is taken for
    the evaluators' ``run(params)`` contract.
    """
    def predict(params, image=None, text=None, **unused):
        del params, unused
        if normalize and image is not None and image.dtype == torch.uint8:
            image = preprocess.normalize_uint8(image)
        model.eval()
        with torch.inference_mode():
            return model(image, text, mask_ratio=0.0, generator=None)
    return predict
