"""Optimizer: the JAX package's regex-masked optax chain, by hand.

Port of ``clipa_tpu/optim.py``. ``torch.optim.AdamW`` computes something
else (weight decay scaled by the lr schedule inside the step, bias
correction of the stored moments), so the chain is written out per
parameter, in optax's stage order, which is the contract
(``PARITY.md``):

    clip_by_global_norm (config.grad_clip_norm)  -- over the unfrozen leaves
    -> Adam direction (config.optax)              -- unfrozen leaves
    -> + wd * mult * param (config.wd, wd_mults)  -- decoupled weight decay
    -> x lr -> x lr_mults -> x lwd -> x schedule(count) per group
    -> zero the frozen (schedule None) -> negate

Masks are first-match-wins ``fullmatch`` regexes over the JAX flat names
(``convert.to_jax_names``), so ``.*/kernel$`` decays the same tensors as in
the JAX package (the Dense, projection, patch-stem and head kernels; not
LayerNorm scales, ``Embed_0/embedding``, ``pos_embedding``, ``cls`` or
``t``).

``config.lwd`` (layer-wise lr decay, :func:`layerwise_decay`) scales the
image tower's encoder block i by ``lwd ** (depth - i)`` and its stem,
``cls`` and learned position embedding by ``lwd ** (depth + 1)``. The JAX
package means the same but names the stem by patterns (``embedding.*``,
``cls.*``) that never fullmatch a two-towers name (``img/...``), so there
the stem trains at the full rate (ROADMAP C).

Adam is optax's ``scale_by_adam`` to the rounding: fp32 arithmetic with
eps_root inside the square root, bias correction by the incremented count,
the update computed from the unrounded fp32 first moment, which is only
then stored in ``mu_dtype``. optax multiplies the stored moment by b1 in
its own dtype (``b1 * mu`` with mu bf16 is bf16(b1) * mu rounded to bf16);
``scale_by_fused_adam`` (``clipa_tpu/optim.py:143-230``) first upcasts it to
fp32, and may store the second moment in ``nu_dtype``. Both are here, as one
function with that one difference.

Parameters and moments live on the parameters' device; updates are fp32
tensors in the parameters' layout. :meth:`Optimizer.update` and
:meth:`Optimizer.apply` run in the spans ``train.optim.update`` and
``train.optim.apply`` (``tracing.py``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from clipa_tpu_torch import convert, tracing, utils as u
from clipa_tpu_torch.config import steps

# --------------------------------------------------------------------------
# Learning-rate schedules (clipa_tpu/optim.py:39-140): each decay family is
# a step -> lr map over the post-warmup span; warmup and cooldown are a
# multiplicative envelope. Evaluated in float64 and returned as the fp32
# value the JAX schedule gives (to fp32 rounding).
# --------------------------------------------------------------------------


def _poly_factory(span, kw):
    exponent = kw.get("power", 1)
    floor = kw.get("end", kw.get("linear_end", 0))
    return lambda frac, peak, step: floor + (peak - floor) * (
        1.0 - frac) ** exponent


def _cosine_factory(span, kw):
    floor = (kw["min_lr"] / kw["max_lr"]) if kw.get("min_lr") else 0.0
    return lambda frac, peak, step: floor + (peak - floor) * 0.5 * (
        1.0 + math.cos(math.pi * frac))


def _rsqrt_factory(span, kw):
    timescale = kw.get("timescale", 10_000)
    offset = timescale - span.warmup

    def fn(frac, peak, step):
        if step > span.warmup:
            return peak / math.sqrt((step + offset) / timescale)
        return peak
    return fn


def _const_factory(span, kw):
    return lambda frac, peak, step: peak  # envelope still applies


def _stair_factory(span, kw):
    boundaries = np.asarray(kw.get("steps", []))
    gains = [1.0] + list(kw.get("mults", []))
    return lambda frac, peak, step: peak * gains[
        int(np.searchsorted(boundaries, step + 1))]


_DECAY_FAMILIES = {
    "linear": _poly_factory, "polynomial": _poly_factory,
    "cosine": _cosine_factory, "rsqrt": _rsqrt_factory,
    "const": _const_factory, "constant": _const_factory,
    "stair": _stair_factory,
}


class _Span:
    """Resolved durations of one schedule (any unit -> steps)."""

    def __init__(self, total_steps, batch_size, data_size, kw):
        self.total = total_steps
        self.warmup = steps("warmup", kw, data_size, batch_size, total_steps,
                            default=0)
        self.cooldown = steps("cooldown", kw, data_size, batch_size,
                              total_steps, default=0)
        if total_steps > 1 and self.warmup >= total_steps:
            raise ValueError(f"warmup_steps ({self.warmup}) >= total_steps "
                             f"({total_steps})")

    def progress(self, step):
        frac = (step - self.warmup) / float(self.total - self.warmup)
        return min(max(frac, 0.0), 1.0)

    def envelope(self, step):
        gain = 1.0
        if self.warmup:
            gain *= min(1.0, step / self.warmup)
        if self.cooldown:
            gain *= min(1.0, (self.total - step) / self.cooldown)
        return gain


def create_learning_rate_schedule(total_steps: int, batch_size=None,
                                  data_size=None, base: float = 1.0,
                                  decay_type: str = "stair",
                                  scale_with_batchsize: bool = False,
                                  **kw) -> Callable[[int], float]:
    """Builds step -> lr (all duration kwargs resolvable in any unit)."""
    span = _Span(total_steps, batch_size, data_size, kw)
    try:
        decay = _DECAY_FAMILIES[decay_type](span, kw)
    except KeyError:
        raise ValueError(f"Unknown decay_type {decay_type!r}") from None
    # Goyal et al. (arxiv 1706.02677) linear scaling; literature ref bs 256.
    peak = base * batch_size / 256.0 if scale_with_batchsize else base

    def schedule(step: int) -> float:
        step = int(step)
        lr = decay(span.progress(step), peak, step) * span.envelope(step)
        return float(np.float32(lr))

    return schedule


# --------------------------------------------------------------------------
# The chain.
# --------------------------------------------------------------------------

_DIRECTIONS = ("scale_by_adam", "scale_by_fused_adam")
_ADAM_KEYS = {"scale_by_adam": {"b1", "b2", "eps", "eps_root", "mu_dtype"},
              "scale_by_fused_adam": {"b1", "b2", "eps", "mu_dtype",
                                      "nu_dtype", "small_leaf_elems"}}


def _first_match(names, patterns_values) -> dict[str, Any]:
    """{name: value of the first pattern that fullmatches it} (names no
    pattern matches are absent)."""
    patterns, values = zip(*patterns_values)
    masks = u.make_mask_trees(names, patterns)
    out = {}
    for mask, value in zip(masks, values):
        out.update({n: value for n, hit in mask.items() if hit})
    return out


def layerwise_decay(config, names) -> dict[str, float]:
    """{name: lr multiplier} of ``config.lwd`` (the JAX package's
    ``_layerwise_decay_txs``), first match wins: the image tower's encoder
    block i gets ``lwd ** (depth - i)``, with `depth` the image variant's
    (``models/vit.decode_variant``, as in the JAX package, whatever
    ``config.model.image.depth`` says); its head and ``encoder_norm`` 1;
    its patch stem, ``cls`` and a learned ``pos_embedding``
    ``lwd ** (depth + 1)``. The text tower and ``t`` are untouched."""
    from clipa_tpu_torch.models.vit import decode_variant
    depth = decode_variant(config.model.image.variant)["depth"]
    lwd = config.lwd
    patterns = [(rf"img/.*encoderblock_{i}/.*", lwd ** (depth - i))
                for i in range(depth)]
    patterns += [(r"img/head/.*", 1.0), (r"img/.*encoder_norm/.*", 1.0),
                 (r"img/(embedding/.*|pos_embedding|cls)", lwd ** (depth + 1))]
    return _first_match(names, patterns)


class Optimizer:
    """The optax chain of ``clipa_tpu.optim.make`` over named parameters.

    `params`: {JAX flat name: tensor}, updated in place by :meth:`apply`.
    State: ``count`` (steps taken; also the schedules' count), ``mu`` and
    ``nu`` ({name: moment} for the unfrozen parameters); :meth:`state_dict`
    and :meth:`load_state_dict` carry it through a checkpoint.
    """

    def __init__(self, config, params: dict[str, torch.Tensor],
                 sched_kw: dict, sqsum: Optional[Callable] = None):
        if "weight_decay" in config:
            raise ValueError("Use config.wd (decoupled), not weight_decay.")
        self.params = params
        self._sqsum = sqsum
        names = list(params)

        spec = config.schedule
        if not isinstance(spec, (tuple, list)):
            spec = [(".*", spec)]
        patterns = [p for p, _ in spec]
        masks = u.make_mask_trees(names, patterns)
        missed = [n for n in names if not any(m[n] for m in masks)]
        if missed:
            raise ValueError("config.schedule must cover all params "
                             f"(None freezes): {missed[:20]}")
        self.schedule_fns = []
        self.group: dict[str, Optional[int]] = {}  # None: frozen
        for (_, sched), mask in zip(spec, masks):
            if sched is not None:
                self.schedule_fns.append(create_learning_rate_schedule(
                    base=1.0, **sched_kw, **dict(sched)))
            for n, hit in mask.items():
                if hit:
                    self.group[n] = (None if sched is None
                                     else len(self.schedule_fns) - 1)
        self.frozen = {n for n, g in self.group.items() if g is None}

        self.clip = config.get("grad_clip_norm") or None
        self.lr = float(config.lr)
        self.lr_mults = {}
        if config.get("lr_mults"):
            self.lr_mults = _first_match(names, config.lr_mults)
            if not all(m > 0 for _, m in config.lr_mults):
                raise ValueError("Use schedule=None to freeze, not "
                                 "lr_mults=0.")
        self.lwd = layerwise_decay(config, names) if config.get("lwd") else {}
        self.wd = {}
        if config.get("wd"):
            mults = _first_match(
                names, config.get("wd_mults", [(".*/kernel$", 1.0)]))
            self.wd = {n: config.wd * m for n, m in mults.items()}

        name = config.get("optax_name", "scale_by_adam")
        if name not in _DIRECTIONS:
            raise NotImplementedError(
                f"optax_name={name!r} is not ported (ported: {_DIRECTIONS})")
        kw = dict(config.get("optax", {}))
        unknown = set(kw) - _ADAM_KEYS[name]
        if unknown:
            raise ValueError(f"config.optax keys {sorted(unknown)} are not "
                             f"taken by {name}")
        self.fused = name == "scale_by_fused_adam"
        self.b1 = kw.get("b1", 0.9)
        self.b2 = kw.get("b2", 0.999)
        self.eps = kw.get("eps", 1e-8)
        self.eps_root = kw.get("eps_root", 0.0)
        # small_leaf_elems only groups the JAX kernels; the numbers are the
        # same for any value.
        mu_dtype = u.resolve_dtype(kw.get("mu_dtype")) or torch.float32
        nu_dtype = u.resolve_dtype(kw.get("nu_dtype")) or torch.float32
        self.count = 0
        with torch.no_grad():
            self.mu = {n: torch.zeros_like(p, dtype=mu_dtype)
                       for n, p in params.items() if n not in self.frozen}
            self.nu = {n: torch.zeros_like(p, dtype=nu_dtype)
                       for n, p in params.items() if n not in self.frozen}

    def _direction(self, name: str, g: torch.Tensor, bc1, bc2):
        """Adam for one tensor: returns the update, stores the moments."""
        mu0, nu0 = self.mu[name], self.nu[name]
        if self.fused:
            decayed = mu0.float() * self.b1
        else:  # optax: b1 * mu in mu's own dtype (bf16(b1) * mu, rounded)
            decayed = mu0 * torch.tensor(self.b1, dtype=mu0.dtype)
        mu = g * (1 - self.b1) + decayed
        if self.fused:  # (1 - b2) * g * g, left to right
            nu = (g * (1 - self.b2)) * g + nu0.float() * self.b2
        else:           # (1 - b2) * g**2
            nu = (g * g) * (1 - self.b2) + nu0.float() * self.b2
        update = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root)
                               + self.eps)
        self.mu[name] = mu.to(mu0.dtype)
        self.nu[name] = nu.to(nu0.dtype)
        return update

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor]) -> dict[str,
                                                             torch.Tensor]:
        """One step of the chain: returns {name: fp32 update} (to be added
        to the parameters) and advances the moments and the count."""
        with tracing.span("train.optim.update"):
            names = list(self.params)
            grads = {n: grads[n].float() for n in names}
            active = [n for n in names if n not in self.frozen]
            if self.clip:
                norm = torch.sqrt(
                    self._sqsum(grads, active) if self._sqsum is not None
                    else sum(grads[n].square().sum() for n in active))
                keep = norm < self.clip
                for n in active:
                    grads[n] = torch.where(keep, grads[n],
                                           grads[n] / norm * self.clip)
            c = self.count + 1   # bias correction in fp32, as optax's
            bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(c))
            bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(c))
            sched = [float(fn(self.count)) for fn in self.schedule_fns]
            updates = {}
            for n in names:
                if n in self.frozen:
                    updates[n] = torch.zeros_like(grads[n])
                    continue
                x = self._direction(n, grads[n], bc1, bc2)
                if n in self.wd:
                    x = x + self.params[n].float() * self.wd[n]
                x = x * self.lr
                if n in self.lr_mults:
                    x = x * self.lr_mults[n]
                if n in self.lwd:
                    x = x * self.lwd[n]
                x = x * sched[self.group[n]]
                updates[n] = -x
            self.count = c
            return updates

    def state_dict(self) -> dict:
        """{"count": steps taken, "mu": {name: moment}, "nu": {...}}: the
        optimizer's tensors themselves (a checkpoint copies them)."""
        return {"count": self.count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copies a :meth:`state_dict` into the moments, bit for bit: each
        moment must have its counterpart's name, shape and dtype (a bf16
        `mu` stays bf16)."""
        for key in ("mu", "nu"):
            mine, theirs = getattr(self, key), state[key]
            if set(mine) != set(theirs):
                raise ValueError(f"optimizer state {key}: names differ: "
                                 f"{sorted(set(mine) ^ set(theirs))[:10]}")
            for name, t in mine.items():
                src = theirs[name]
                if src.shape != t.shape or src.dtype != t.dtype:
                    raise ValueError(
                        f"optimizer state {key}[{name!r}]: "
                        f"{tuple(src.shape)} {src.dtype}, expected "
                        f"{tuple(t.shape)} {t.dtype}")
                t.copy_(src)
        self.count = int(state["count"])

    @torch.no_grad()
    def apply(self, updates: dict[str, torch.Tensor]) -> None:
        """params += updates, in place (optax.apply_updates)."""
        with tracing.span("train.optim.apply"):
            for n, x in updates.items():
                p = self.params[n]
                p.copy_((p.float() + x).to(p.dtype))


def named_parameters(model: Union[nn.Module, dict]) -> dict[str,
                                                            torch.Tensor]:
    """{JAX flat name: parameter} of a module (or a dict passed through)."""
    if isinstance(model, dict):
        return model
    names = convert.to_jax_names(model)
    return {names[k]: p for k, p in model.named_parameters()}


def make(config: Any, model: Union[nn.Module, dict], *, sched_kw: dict,
         sqsum: Optional[Callable] = None):
    """Returns (optimizer, list of schedule fns), as ``clipa_tpu.optim.make``
    returns (optax transform, schedule fns). `model`: an nn.Module (its
    parameters by JAX name) or a {JAX name: tensor} dict (under FSDP, the
    train state's shards). `sqsum(grads, names)`: the sum of squares of the
    full gradients the clip's global norm takes (FSDP's sums the shards of
    every process); by default the local tensors'."""
    opt = Optimizer(config, named_parameters(model), sched_kw, sqsum)
    return opt, opt.schedule_fns
