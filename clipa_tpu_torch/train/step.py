"""The training step, on one device or on several processes.

Port of ``clipa_tpu/train/step.py``: :func:`create_model` builds
the two-tower or CoCa model a config describes (``config.model_name``; the
model ``clipa_tpu/train/loop.py`` builds, with its position tables sized
from ``config.init_shapes`` as flax sizes them from the init inputs),
:func:`init_train_state` draws its fp32 parameters from a seeded
``torch.Generator`` on the device, and
:func:`make_update_fn` returns ``update(state, batch) -> (state,
measurements)``:

  uint8 images normalized on the device (``config.cpu_unit8``) -> train-mode
  forward in the config's compute dtype over fp32 parameters, with CLIPA's
  random image-token masking at ``config.mask_ratio`` (unmask-tuning) and
  the towers' ``remat_policy``, ``attn_impl``, Dropout and DropPath -> the
  loss (``config.loss``: "softmax", the global InfoNCE; "sigmoid", with the
  towers' ``b`` where the model has one; "chunked", ``ops/infonce.py`` at
  ``config.loss_chunk_size``; "coca", the InfoNCE at
  ``config.coca_contrastive_loss_weight`` plus the caption cross-entropy at
  ``config.coca_caption_loss_weight`` over labels other than
  ``config.pad_id``, the batch's ``labels`` being the text ids) ->
  autograd, through the attention kernels' backward on a card -> the optax
  chain of ``optim.py``, applied in place -> the temperature clamp.

With ``config.grad_accum_steps`` = n > 1 the step is the JAX step's
two-pass full-batch-negative accumulation (the reference torch trainer's
cached-feature scheme): pass 1 embeds each of the n microbatches without
gradients; pass 2 re-embeds microbatch j live, splices it into the cached
full-batch features, takes the loss against the full batch's negatives and
adds its gradients. Each feature's contribution is counted once, so the
gradients equal the single pass's, except the loss's own parameters: every
pass sees the whole dL/dt (and, under ``loss="sigmoid"``, the whole dL/db),
so ``t`` and ``b`` receive n times the single-pass gradient, as in the JAX
step and the reference (ROADMAP, quirks). The measurements
are the last pass's. Microbatch j draws its masking noise from the same
generator, seeded from ``(config.seed, step, j)``, in both passes.

The measurements are the JAX step's: ``training_loss``, ``t``,
``t/parameter``, ``nimg``, ``ntxt``, ``ncorrect`` and, under
``config.norm_metrics`` "log" (default) / "always" / "never",
``l2_grads``, ``l2_params`` and ``l2_updates``: under "log" they are
computed on the first, the last and every ``log_training_steps``-th step and
are 0 on the others; with ``config.log_block_norms``, the image tower's
gradient norms per block (:func:`_block_norms`). Values are 0-d tensors on
the device (no host sync).

The step's host phases run in spans of ``tracing.py``: ``train.step``
around all of ``update()``; ``train.forward`` (the normalize and the
forward; under accumulation, the normalize and pass 1, then each
microbatch's live forward), ``train.loss``, ``train.backward`` (autograd),
``train.norms`` (the norm measurements), and the optimizer's
``train.optim.update`` and ``train.optim.apply``.

:func:`make_predict_fn` is the evaluators' forward: eval mode, no masking,
no gradients, uint8 images normalized as the step normalizes them.

The masking noise of step s comes from a ``torch.Generator`` on the
device seeded from ``(config.seed, s)``: the counterpart of the JAX step's
``fold_in(rng, step)``. The two give different streams of the same
distribution. Dropout and DropPath draw from two more generators of the
step (:func:`drop_generators`: the same key with a stream tag), handed to
the model through ``layers.random_streams``.

With a `teacher_model` (``config.distill``), the step distills from that
frozen two-tower as the JAX step does: the teacher's forward runs in eval
mode under ``torch.no_grad()`` on the normalized, unmasked images and the
same labels (only the student takes ``mask_ratio``), and the loss is
``losses.distill_contrastive_loss``: the InfoNCE plus the soft
cross-entropy to the teacher's logits at its own temperature, adding
``contrastive_loss`` and ``distill_loss`` to the measurements. As in the
JAX step (and the reference trainer), distillation takes ``loss=softmax``
and no gradient accumulation (ValueError otherwise).

On several processes (a `mesh` from ``parallel.mesh.create_mesh``: one
process per device, each holding its rows of the global batch under the
mesh's batch rule) the step is the JAX SPMD step's global math with
explicit collectives (``parallel/collectives.py``). Each process's loss is
its rows' share of the global loss: the embeddings are all-gathered
differentiably and its rows taken against the global columns (the
softmax, sigmoid, distillation and CoCa contrastive terms; CoCa's caption
term divides by the global count of non-pad labels), the ring losses
(``config.loss`` "ring" and "ring_sigmoid", ``ops/ring_infonce.py``) pass
the text shards around, and the chunked loss runs on the gathered batch on
every process. On a mesh of one process the gathered rows are the whole
batch, and its loss is the one-process loss of them (bit for bit the step
without a process group). The global loss is the mean over the
processes, and the gradients are averaged over them (the averaged
measurements likewise). The masking noise, Dropout and DropPath draw for
the global batch and take this process's rows (``layers.random_streams``'
`shard`), so a step does not depend on the process count. With
``config.fsdp`` > 1 (:func:`init_train_state`'s `mesh`), each process
keeps its shard of the large fp32 masters and of Adam's moments
(``collectives.ParamShards``), the gradients are reduce-scattered, the
norms formed from the shards, and the full parameters gathered into the
model after each update. Under ``grad_accum_steps`` each process's
microbatch j is the j-th slice of its rows.

Refused: a tower with BatchNorm statistics (the ModifiedResNet). The JAX
step applies ``{"params"}`` alone, so it cannot train one (flax raises
``ScopeCollectionNotFound`` for ``batch_stats``); training it would be a
feature the JAX package lacks.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from clipa_tpu_torch import losses as losses_lib
from clipa_tpu_torch import optim, tracing, utils
from clipa_tpu_torch.models import get_model_module, layers
from clipa_tpu_torch.ops import infonce, preprocess, ring_infonce
from clipa_tpu_torch.parallel import collectives
from clipa_tpu_torch.parallel import mesh as mesh_lib


def create_model(config, device="cuda") -> torch.nn.Module:
    """The model of ``config.model`` (``config.model_name``: "two_towers" or
    "coca"), on `device` (the card unless the caller names the CPU or
    ``meta``; raises without a card), with the towers' options as the
    config sets them (``remat_policy``, ``attn_impl``, ...)."""
    name = config.get("model_name", "two_towers")
    if name not in ("two_towers", "coca"):
        raise NotImplementedError(f"model_name={name!r} is not ported to "
                                  "the training step yet")
    cfg = dict(config.model)
    img_shape, txt_shape = (tuple(s) for s in config.init_shapes)
    if cfg.get("image") is not None:
        cfg["image"] = {"image_size": img_shape[1:3], **cfg["image"]}
    if cfg.get("text") is not None:
        # CoCa's tower reads text[:, :-1] and appends its cls
        ctx = txt_shape[1] - (1 if name == "coca" else 0)
        cfg["text"] = {"context_length": ctx, **cfg["text"]}
    with utils.resolve_device(device, "create_model"):
        return get_model_module(name).Model(**cfg)


def init_train_state(model: torch.nn.Module, config, generator:
                     torch.Generator, device, mesh=None,
                     min_size_to_shard: int = 2 ** 18) -> dict:
    """Moves `model` to `device` and draws its parameters from `generator`
    (which must live on `device`) with the flax initializers'
    distributions. Returns {"params": {JAX name: parameter}, "step": 0};
    the parameters are the model's own (fp32 masters), updated in place.

    With a `mesh` (several processes), process 0's parameters are
    broadcast to every process, and the state gains ``"shards"``
    (``collectives.ParamShards`` over the mesh's ``fsdp`` dim at
    `min_size_to_shard`): ``params`` then holds this process's shard of each
    parameter that FSDP shards (none at ``fsdp`` 1) and the model's own
    tensor of the others; the optimizer is made over that dict."""
    del config  # the model and the generator carry everything needed
    model.to(device)
    layers.init_parameters(model, generator)
    model.train()
    state = {"params": optim.named_parameters(model), "step": 0}
    if mesh is not None:
        collectives.broadcast_parameters(state["params"])
        shards = collectives.ParamShards(state["params"], mesh,
                                         min_size_to_shard)
        state.update(params=shards.local(), shards=shards)
    return state


def mask_generator(config, step: int, device,
                   microbatch: Optional[int] = None,
                   stream: int = 0) -> torch.Generator:
    """The masking noise's generator of step `step`, seeded from
    ``(config.seed, step)``; of its microbatch `microbatch` under gradient
    accumulation, from ``(config.seed, step, microbatch)``. A `stream` tag
    above 0 spawns another stream from the same key
    (:func:`drop_generators`)."""
    key = [int(config.get("seed", 0)), int(step)]
    if microbatch is not None:
        key.append(int(microbatch))
    seed = np.random.SeedSequence(key, spawn_key=(stream,) if stream else ())
    return torch.Generator(device=device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))


DROPOUT_STREAM, DROP_PATH_STREAM = 1, 2


def drop_generators(config, step: int, device,
                    microbatch: Optional[int] = None) -> dict:
    """The generators Dropout and DropPath draw from in step `step` (and
    microbatch `microbatch`): ``layers.random_streams``' arguments."""
    return {name: mask_generator(config, step, device, microbatch, tag)
            for name, tag in (("dropout", DROPOUT_STREAM),
                              ("drop_path", DROP_PATH_STREAM))}


def _sqsum(tensors) -> torch.Tensor:
    """Sum of squares over tensors, in fp32 (optax.global_norm squared)."""
    return sum(x.float().square().sum() for x in tensors)


LOSSES = ("softmax", "sigmoid", "chunked", "coca", "ring", "ring_sigmoid")


def _make_loss_dispatch(loss_kind: str, config, mesh=None) -> Callable:
    """Maps ``config.loss`` to its implementation, as the JAX step's
    dispatch: apply_loss(zimg, ztxt, extras, teacher_out=None) -> (loss,
    extras dict); a `teacher_out` triple (the teacher's zimg, ztxt, t)
    switches on distillation. With a `mesh`, the inputs are this process's
    rows and the loss its share of the global loss (module docstring).
    Raises ValueError for an unknown name."""
    if loss_kind not in LOSSES:
        raise ValueError(f"unknown config.loss {loss_kind!r} (one of "
                         f"{LOSSES})")
    chunk_size = int(config.get("loss_chunk_size", 4096))
    weights = dict(
        clip_loss_weight=float(config.get("coca_contrastive_loss_weight",
                                          1.0)),
        caption_loss_weight=float(config.get("coca_caption_loss_weight",
                                             2.0)),
        pad_id=int(config.get("pad_id", 0)))
    if mesh is not None:
        return _sharded_loss_dispatch(loss_kind, config, mesh, chunk_size,
                                      weights)

    def apply_loss(zimg, ztxt, extras, teacher_out=None):
        if teacher_out is not None:
            return losses_lib.distill_contrastive_loss(
                zimg, ztxt, extras["t"], *teacher_out)
        if loss_kind == "coca":
            return losses_lib.coca_loss(
                zimg, ztxt, extras["t"], extras["logits"], extras["labels"],
                **weights)
        if loss_kind == "sigmoid":
            return losses_lib.sigmoid_contrastive_loss(
                zimg, ztxt, extras["t"], bias=extras.get("b", 0.0),
                reduction=True)
        if loss_kind == "chunked":
            return infonce.chunked_contrastive_loss(
                zimg, ztxt, extras["t"], chunk_size=chunk_size)
        if loss_kind == "ring":   # one process: one hop, no sends
            return ring_infonce.ring_contrastive_loss(
                zimg, ztxt, extras["t"], group=ring_infonce.ALONE)
        if loss_kind == "ring_sigmoid":
            return ring_infonce.ring_sigmoid_contrastive_loss(
                zimg, ztxt, extras["t"], bias=extras.get("b", 0.0),
                group=ring_infonce.ALONE)
        return losses_lib.bidirectional_contrastive_loss(
            zimg, ztxt, extras["t"], reduction=True)

    return apply_loss


def _sharded_loss_dispatch(loss_kind: str, config, mesh, chunk_size: int,
                           weights: dict) -> Callable:
    """:func:`_make_loss_dispatch` on several processes: each process's
    share of the global loss from its rows (module docstring). On a mesh
    of one process its rows are the whole batch: the embeddings still go
    through the gather, and its share is the one-process loss of the
    gathered batch, the same computation as without a process group."""
    index, count = mesh_lib.batch_shard(mesh)
    alone = _make_loss_dispatch(loss_kind, config) if count == 1 else None

    def apply_loss(zimg, ztxt, extras, teacher_out=None):
        t = extras["t"]
        if alone is not None:
            if teacher_out is not None:
                t_zimg, t_ztxt, t_t = teacher_out
                teacher_out = (collectives.gather_rows_nograd(t_zimg),
                               collectives.gather_rows_nograd(t_ztxt), t_t)
            return alone(collectives.gather_rows(zimg),
                         collectives.gather_rows(ztxt), extras, teacher_out)
        if loss_kind == "ring":
            return ring_infonce.ring_contrastive_loss(zimg, ztxt, t)
        if loss_kind == "ring_sigmoid":
            return ring_infonce.ring_sigmoid_contrastive_loss(
                zimg, ztxt, t, bias=extras.get("b", 0.0))
        all_img = collectives.gather_rows(zimg)
        all_txt = collectives.gather_rows(ztxt)
        if teacher_out is not None:
            t_zimg, t_ztxt, t_t = teacher_out
            return losses_lib.local_distill_contrastive_loss(
                zimg, ztxt, all_img, all_txt, t, t_zimg, t_ztxt,
                collectives.gather_rows_nograd(t_zimg),
                collectives.gather_rows_nograd(t_ztxt), t_t, index)
        if loss_kind == "sigmoid":
            return losses_lib.local_sigmoid_contrastive_loss(
                zimg, all_txt, t, index, bias=extras.get("b", 0.0))
        if loss_kind == "chunked":   # the whole batch's loss, everywhere
            return infonce.chunked_contrastive_loss(
                all_img, all_txt, t, chunk_size=chunk_size)
        clip_l, out = losses_lib.local_contrastive_loss(
            zimg, ztxt, all_img, all_txt, t, index)
        if loss_kind != "coca":
            return clip_l, out
        # the caption mean is over the global count of non-pad labels
        total, n = losses_lib.caption_nll(extras["logits"], extras["labels"],
                                          weights["pad_id"])
        n = collectives.all_reduce_total(n)
        caption_l = total * count / n.clamp(min=1.0)
        clip_l = weights["clip_loss_weight"] * clip_l
        caption_l = weights["caption_loss_weight"] * caption_l
        return clip_l + caption_l, {**out, "contrastive_loss": clip_l,
                                    "caption_loss": caption_l}

    return apply_loss


# measurements that are this process's share, averaged over the processes
_AVERAGED = ("training_loss", "nimg", "ntxt", "ncorrect", "contrastive_loss",
             "distill_loss", "caption_loss")


def _block_norms(grads: dict, frozen=frozenset(), sqsum=None) -> dict:
    """Per-block gradient norms of the image tower (the JAX step's, from
    the reference's telemetry): ``l2_grad_{embedding,cls,head}`` over each
    subtree, the `frozen` names (the optimizer's) counted as 0, and
    ``l2_grad_<block>``, the norm of each encoder block's second MLP
    kernel. (The JAX step matches config.schedule against the names within
    each subtree, so a schedule that freezes by full name is not seen
    there; ROADMAP C.) `sqsum` sums the squares of a {name: tensor} dict
    (FSDP's counts the shards of every process)."""
    sqsum = sqsum or (lambda tree: _sqsum(tree.values()))
    out = {}
    for key in ("embedding", "cls", "head"):
        prefix = f"img/{key}"
        sub = [(n, g) for n, g in grads.items()
               if n == prefix or n.startswith(prefix + "/")]
        if sub:
            out[f"l2_grad_{key}"] = torch.sqrt(sqsum(
                {n: g * 0 if n in frozen else g for n, g in sub}))
    blocks = "img/Transformer/"
    kernel = "/MlpBlock_0/Dense_1/kernel"
    for name, g in grads.items():
        if name.startswith(blocks) and name.endswith(kernel):
            block = name[len(blocks):-len(kernel)]
            if "/" not in block:
                out[f"l2_grad_{block}"] = torch.sqrt(sqsum({name: g}))
    return out


def make_update_fn(model: torch.nn.Module, tx: optim.Optimizer, config,
                   total_steps: int = 0,
                   teacher_model: Optional[Any] = None,
                   mesh=None) -> Callable:
    """Builds update(state, batch) -> (state, measurements).

    `state` is :func:`init_train_state`'s; its parameters must be the ones
    `tx` was made over. `batch`: {"image": (B, H, W, 3) uint8 or float,
    "labels": (B, l) token ids}, tensors on the model's device; B must
    divide by ``config.grad_accum_steps``. `total_steps` (when known) lets
    the gated norm metrics fire on the last step too. `teacher_model`: a
    frozen two-tower on the same device to distill from (its parameters
    are never updated: it is not in `tx`). `mesh`: the process mesh of a
    step on several processes (module docstring); `batch` is then this
    process's rows, `state` :func:`init_train_state`'s with the same mesh,
    and the measurements are the global batch's.
    """
    stats = [k for k, _ in model.named_buffers()
             if k in model.state_dict(keep_vars=True)]
    if stats:   # module docstring
        raise NotImplementedError(
            f"the training step does not train a tower with BatchNorm "
            f"statistics ({stats[0]} and {len(stats) - 1} more): the JAX "
            "step applies the parameters alone and cannot train it either")
    mask_ratio = float(config.get("mask_ratio", 0.0))
    normalize_on_device = bool(config.get("cpu_unit8", True))
    norm_metrics = config.get("norm_metrics", "log")  # log|always|never
    log_steps = int(config.get("log_training_steps", 50))
    measure_block_norms = bool(config.get("log_block_norms", False))
    accum_steps = int(config.get("grad_accum_steps", 1))
    temperature_clamp = config.get("temperature_clamp", False)
    t_clamp_max = (float(np.log(100.0)) if temperature_clamp is True
                   else float(temperature_clamp or 0.0))
    loss_kind = config.get("loss", "softmax")
    apply_loss = _make_loss_dispatch(loss_kind, config, mesh)
    shard = mesh_lib.batch_shard(mesh) if mesh is not None else None
    if teacher_model is not None:
        # the JAX step's guards (the reference trainer's limits too)
        if loss_kind != "softmax":
            raise ValueError(f"config.distill requires loss='softmax', got "
                             f"{loss_kind!r}")
        if accum_steps > 1:
            raise ValueError("config.distill is incompatible with "
                             "grad_accum_steps > 1")
    if norm_metrics not in ("log", "always", "never"):
        raise ValueError(f"unknown norm_metrics {norm_metrics!r}")

    def loss_and_measurements(zimg, ztxt, extras, teacher_out=None):
        with tracing.span("train.loss"):
            loss, l_extras = apply_loss(zimg, ztxt, extras, teacher_out)
            return loss, {
                "t": extras["t"][0].detach(),
                "t/parameter": extras["t/parameter"][0].detach().clone(),
                "nimg": extras["img/norm"].mean().detach(),
                "ntxt": extras["txt/norm"].mean().detach(),
                **{k: v.mean().detach() for k, v in l_extras.items()},
            }

    def gradients(loss, params, names):
        with tracing.span("train.backward"):
            found = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
            return {n: torch.zeros_like(params[n]) if g is None else g
                    for n, g in zip(names, found)}

    def update(state: dict, batch: dict):
        with tracing.span("train.step"):
            return _update(state, batch)

    def _update(state: dict, batch: dict):
        params = state["params"]
        shards = state.get("shards")
        # autograd runs over the model's full parameters
        full = shards.full if shards is not None else params
        names = list(params)
        sqsum = (shards.sqsum if shards is not None
                 else lambda tree: _sqsum(tree.values()))
        images, labels = batch["image"], batch["labels"]
        # single pass: the normalize and the forward; accumulation: the
        # normalize and pass 1 (every microbatch's features, without
        # gradients)
        with tracing.span("train.forward"):
            if normalize_on_device and images.dtype == torch.uint8:
                images = preprocess.normalize_uint8(images)

            teacher_out = None
            if teacher_model is not None:
                # the frozen teacher: eval mode, no graph, unmasked images
                teacher_model.eval()
                with torch.no_grad():
                    t_zimg, t_ztxt, t_extras = teacher_model(images, labels)
                teacher_out = (t_zimg, t_ztxt, t_extras["t"])

            model.train()
            if accum_steps <= 1:
                generator = (mask_generator(config, state["step"],
                                            images.device)
                             if mask_ratio > 0 else None)
                with layers.random_streams(**drop_generators(
                        config, state["step"], images.device), shard=shard):
                    zimg, ztxt, extras = model(images, labels,
                                               mask_ratio=mask_ratio,
                                               generator=generator)
            else:
                if images.shape[0] % accum_steps:
                    raise ValueError(
                        f"grad_accum_steps={accum_steps} must divide the "
                        f"global batch size {images.shape[0]}")
                mb = images.shape[0] // accum_steps
                micro = [(images[j * mb:(j + 1) * mb],
                          labels[j * mb:(j + 1) * mb])
                         for j in range(accum_steps)]

                def embed(j):
                    generator = (mask_generator(config, state["step"],
                                                images.device, j)
                                 if mask_ratio > 0 else None)
                    with layers.random_streams(**drop_generators(
                            config, state["step"], images.device, j),
                            shard=shard):
                        return model(*micro[j], mask_ratio=mask_ratio,
                                     generator=generator)

                with torch.no_grad():
                    cached = [embed(j)[:2] for j in range(accum_steps)]
                zi_all = torch.cat([z for z, _ in cached])
                zt_all = torch.cat([z for _, z in cached])
                del cached
        if accum_steps <= 1:
            loss, measurements = loss_and_measurements(zimg, ztxt, extras,
                                                       teacher_out)
            grads = gradients(loss, full, names)
        else:
            # pass 2: microbatch j live, against the full batch's negatives
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in full.items()}
            for j in range(accum_steps):
                with tracing.span("train.forward"):
                    zimg_j, ztxt_j, extras = embed(j)
                rows = slice(j * mb, (j + 1) * mb)
                zimg = torch.cat([zi_all[:rows.start], zimg_j,
                                  zi_all[rows.stop:]])
                ztxt = torch.cat([zt_all[:rows.start], ztxt_j,
                                  zt_all[rows.stop:]])
                loss, measurements = loss_and_measurements(zimg, ztxt, extras)
                for n, g in gradients(loss, full, names).items():
                    grads[n].add_(g)

        if shards is not None:
            grads = shards.reduce_gradients(grads)
        updates = tx.update(grads)
        tx.apply(updates)
        if temperature_clamp and "t" in params:
            with torch.no_grad():
                params["t"].clamp_(0.0, t_clamp_max)
        if shards is not None:
            shards.gather(params)

        measurements["training_loss"] = loss.detach()
        if mesh is not None:
            measurements.update(collectives.reduce_scalar_mean(
                {k: v for k, v in measurements.items() if k in _AVERAGED}))
        with tracing.span("train.norms"), torch.no_grad():
            if norm_metrics != "never":
                # `step` is pre-increment; the loop logs this batch as
                # step + 1
                logged = state["step"] + 1
                due = (norm_metrics == "always" or logged % log_steps == 0
                       or logged == 1 or logged == total_steps)
                zero = torch.zeros((), device=loss.device)
                for key, tree in (("l2_grads", grads), ("l2_params", params),
                                  ("l2_updates", updates)):
                    measurements[key] = (torch.sqrt(sqsum(tree))
                                         if due else zero)
            if measure_block_norms:
                measurements.update(_block_norms(grads, tx.frozen, sqsum))
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
