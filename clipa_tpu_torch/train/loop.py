"""The trainer: config -> data -> train loop -> checkpoints, on one device.

Port of ``clipa_tpu/train/loop.py`` (``python -m clipa_tpu_torch.train``):

  * init priority: existing workdir checkpoint > config.resume (a port
    checkpoint: a step directory or its ``state.pt``) > config.model_init
    (per-tower npz + dont_load) > config.masked_init (cross-resolution
    merge) > scratch,
  * duration configs in steps/examples/epochs units (``config.total_steps``
    and its kin),
  * Chrono/metrics with the reference metric names, NaN hard-abort, periodic
    checkpoints and the evaluators of ``config.evals`` via `itstime`
    (built on first use; ``config.eval_only`` runs them once at the
    restored step and returns without training),
  * resumable checkpoints of {params, optimizer state, step, chrono} in step
    directories, and a flat-npz export of the params in the JAX layout
    (``params.npz``), wire-compatible with the JAX package's and released
    CLIPA weights (model_init and masked_init read that layout),
  * a ``torch.profiler`` trace at ``config.profile_at_step``,
  * a remote workdir (``gs://``, ``s3://``, ``file://``): staged on local
    disk (``pathio.stage_dir_for``, under ``config.local_stage_dir``) and
    pulled before resume, so a run restarted on a fresh host resumes from
    the URL's checkpoint (a failed pull raises, never starts afresh);
    mirrored to the URL (or to ``config.remote_sync.path``) by
    ``remote_sync.SyncThread`` every ``remote_sync.every_seconds`` and
    once at the end (a failed final pass raises),
  * distillation (``config.distill``): a frozen teacher two-tower built
    from ``distill.model`` (``model_name``, ``seed``, ``model_init`` with
    ``model_load``), rebuilt on every start; never in the optimizer, the
    checkpoints or the npz export.

As in the JAX loop, a resumed run restarts the data stream from its seed:
the batches after a resume are the first batches of the stream, not those
the stopped run would have seen next.

The card is the default device; ``device="cpu"`` (``--device cpu``) is how
tests ask for the CPU, and no path falls back to it. Not ported (they
raise ``NotImplementedError``): wandb (metrics go to metrics.jsonl), and
``fsdp > 1`` or several processes (ROADMAP A8).

CLI: python -m clipa_tpu_torch.train --config=<file.py>[:args] \
    --workdir=/tmp/run [--device cpu] [--config.input.batch_size=256 ...]
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional

import torch

from clipa_tpu_torch import convert
from clipa_tpu_torch import optim as optim_lib
from clipa_tpu_torch import pathio
from clipa_tpu_torch import registry
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.config import ConfigDict, apply_overrides, load_config
from clipa_tpu_torch.config import steps as steps_cfg
from clipa_tpu_torch.data import core as data_core
from clipa_tpu_torch.data import pipeline as pipeline_lib
from clipa_tpu_torch.evaluators import common as eval_common
from clipa_tpu_torch.models import get_model_module
from clipa_tpu_torch.train import checkpoint as ckpt_lib
from clipa_tpu_torch.train import metrics as metrics_lib
from clipa_tpu_torch.train import remote_sync as sync_lib
from clipa_tpu_torch.train import step as step_lib


def _refuse_unported(config: ConfigDict) -> None:
    """Raises NotImplementedError for what the JAX loop does and this one
    does not, naming the ROADMAP item."""
    refused = [
        (bool(config.get_path("wandb.log_wandb")),
         "wandb.log_wandb (metrics go to metrics.jsonl)"),
        (int(config.get("fsdp", 1)) > 1, "config.fsdp > 1 (multi-GPU: "
                                         "ROADMAP A8)"),
        (data_core.process_info()[1] > 1,
         "several processes (multi-GPU: ROADMAP A8)"),
    ]
    for hit, what in refused:
        if hit:
            raise NotImplementedError(f"{what} is not ported to the "
                                      f"PyTorch trainer yet")


def _copy_params(params: dict, values: dict) -> None:
    """Copies {name: tensor} `values` into the parameters, which must have
    the same names, shapes and dtypes."""
    if set(values) != set(params):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(values) ^ set(params))[:10]}")
    with torch.no_grad():
        for name, p in params.items():
            v = values[name]
            if v.shape != p.shape or v.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(v.shape)} {v.dtype}, "
                                 f"expected {tuple(p.shape)} {p.dtype}")
            p.copy_(v)


def checkpoint_state(state: dict, tx: optim_lib.Optimizer,
                     chrono: metrics_lib.Chrono) -> dict:
    """What a resumable checkpoint holds: {params, opt (the optimizer's
    state dict), step, chrono}."""
    return {"params": state["params"], "opt": tx.state_dict(),
            "step": state["step"], "chrono": chrono.save()}


def restore(checkpoint: dict, state: dict, tx: optim_lib.Optimizer,
            chrono: metrics_lib.Chrono) -> int:
    """Loads a :func:`checkpoint_state` into a live train state, optimizer
    and chrono, bit for bit; returns its step."""
    _copy_params(state["params"], checkpoint["params"])
    tx.load_state_dict(checkpoint["opt"])
    chrono.load(checkpoint["chrono"])
    state["step"] = int(checkpoint["step"])
    return state["step"]


def train(config: ConfigDict, workdir: Optional[str] = None,
          device="cuda") -> dict:
    """Runs the training job; returns the final state: {"params": {JAX
    name: the model's parameter (torch layout)}, "opt": the optimizer's
    state dict, "step": int}, on the device."""
    device = u.resolve_device(device, "train")
    _refuse_unported(config)
    write_note = print if u.process_index() == 0 else (lambda *_: None)
    remote_workdir = None
    if workdir and pathio.is_remote(workdir):
        remote_workdir = workdir
        workdir = _stage_remote_workdir(remote_workdir, config, write_note)
    batch_size = config.input.batch_size

    # ----- data -------------------------------------------------------------
    source = data_core.get_source(**dict(config.input.data))
    ntrain = source.total_examples()
    pp_fn = registry.get_preprocess_fn(config.input.pp)
    if config.input.get("mixup"):
        # Every loss this trainer supports is contrastive; mixing images
        # while captions stay unmixed silently corrupts the InfoNCE pairing.
        raise ValueError(
            "config.input.mixup is incompatible with contrastive losses "
            f"(loss={config.get('loss', 'softmax')!r}): images would be "
            "mixed while captions stay unmixed. Remove config.input.mixup.")
    batches = pipeline_lib.make_for_train(
        source, pp_fn, batch_size,
        shuffle_buffer=config.input.get("shuffle_buffer_size", 50_000),
        seed=config.get("seed", 0),
        num_workers=config.input.get("num_workers", 8),
        worker_processes=config.input.get("worker_processes", 0),
        pp_str=config.input.pp)
    train_iter = pipeline_lib.start_input_pipeline(
        batches, device, n_prefetch=config.get("prefetch_to_device", 2))

    metric = manager = profiler = syncer = None
    completed = False
    try:
        total_steps = steps_cfg("total", config, ntrain, batch_size)
        write_note(f"Training for {total_steps} steps "
                   f"({ntrain} examples, batch {batch_size}) on {device}")

        if config.get_path("wandb.debug_data"):
            # pipeline inspection mode: print batch shapes, never train
            for i, batch in enumerate(train_iter):
                write_note(f"batch {i}: " + str({
                    k: (tuple(v.shape), str(v.dtype))
                    for k, v in batch.items()}))
                if i >= 4:
                    return {}

        # ----- model / optimizer / state ------------------------------------
        model = step_lib.create_model(config, device)
        state = step_lib.init_train_state(
            model, config, torch.Generator(device=device).manual_seed(
                int(config.get("seed", 0))), device)
        tx, sched_fns = optim_lib.make(
            config, model, sched_kw=dict(total_steps=total_steps,
                                         batch_size=batch_size,
                                         data_size=ntrain))
        n_params = sum(p.numel() for p in state["params"].values())
        write_note(f"Model has {n_params / 1e6:.1f}M params")
        teacher = (_build_teacher(config, device, write_note)
                   if config.get("distill") else None)
        update_fn = step_lib.make_update_fn(model, tx, config,
                                            total_steps=total_steps,
                                            teacher_model=teacher)
        predict_fn = step_lib.make_predict_fn(
            model, normalize=bool(config.get("cpu_unit8", True)))

        # ----- metrics / chrono ---------------------------------------------
        metric = metrics_lib.MetricWriter(workdir)
        metric.write_config(config)
        if workdir and (config.get("remote_sync") or remote_workdir) and \
                u.process_index() == 0:
            syncer = _start_sync(workdir, config.get("remote_sync"),
                                 remote_workdir)
        chrono = metrics_lib.Chrono(device)
        profiler = metrics_lib.Profiler(
            workdir, start_step=config.get("profile_at_step", 10),
            device=device)

        # ----- init / resume ------------------------------------------------
        first_step = 0
        if workdir and config.get("save_ckpt", True):
            manager = ckpt_lib.CheckpointManager(
                os.path.join(workdir, "checkpoints"),
                max_to_keep=config.get("keep_ckpts", 3))
        resume_step = manager.latest_step() if manager else None
        if resume_step is not None:
            write_note(f"Resuming from checkpoint step {resume_step}...")
            first_step = restore(manager.restore(resume_step), state, tx,
                                 chrono)
        elif config.get("resume"):
            write_note(f"Resuming from {config.resume}...")
            first_step = restore(ckpt_lib.load_state(config.resume), state,
                                 tx, chrono)
        elif config.get("model_init"):
            write_note(f"Initializing towers from {config.model_init}...")
            _load_model_init(model, config.get("model_name", "two_towers"),
                             config.model_init, config.model,
                             config.get("model_load", {}))
        elif config.get("masked_init"):
            write_note(f"Masked-init (cross-resolution) from "
                       f"{config.masked_init}...")
            ckpt_lib.masked_init(model, config.masked_init,
                                 log=write_note,
                                 **dict(config.get("masked_no_load",
                                                   {"dont_load": []})))

        chrono.inform(first_step=first_step, total_steps=total_steps,
                      global_bs=batch_size,
                      steps_per_epoch=ntrain / batch_size)

        # ----- evaluators ---------------------------------------------------
        evaluators_cache: list = []

        def evaluators():
            if not evaluators_cache and config.get("evals"):
                evaluators_cache.extend(eval_common.from_config(
                    config, {"predict": predict_fn}, device=device,
                    total_steps=total_steps))
            return evaluators_cache

        def run_evals(step: int, force: bool = False):
            for (name, evaluator, every, prefix) in evaluators():
                # an entry without a cadence runs only under eval_only (the
                # JAX loop compares None < total_steps and raises)
                if force or u.itstime(step, every, total_steps,
                                      first=bool(every)
                                      and every < total_steps):
                    chrono.pause()
                    write_note(f"Running evaluator {name} at step {step}...")
                    for key, value in evaluator.run(state["params"]):
                        metric.measure(f"{prefix}{key}", value)
                    chrono.resume()

        if config.get("eval_only"):
            metric.step_start(first_step)
            run_evals(first_step, force=True)
            metric.step_end()
            completed = True
            return {"params": state["params"], "opt": tx.state_dict(),
                    "step": state["step"]}

        # ----- train loop ---------------------------------------------------
        log_steps = config.get("log_training_steps", 50)
        ckpt_steps = config.get("ckpt_steps", 1000)
        for step, batch in zip(range(first_step + 1, total_steps + 1),
                               train_iter):
            metric.step_start(step)
            profiler.maybe_start(step)
            with profiler.step_annotation(step):
                state, measurements = update_fn(state, batch)
            profiler.maybe_stop(step)

            if u.itstime(step, log_steps, total_steps, host=0):
                for name, value in measurements.items():
                    metric.measure(name, value)
                for i, sched_fn in enumerate(sched_fns):
                    metric.measure(f"global_schedule{i if i else ''}",
                                   sched_fn(step - 1) * config.lr)
                chrono.tick(step, measure=metric.measure,
                            write_note=write_note)
                loss = float(measurements["training_loss"])
                if not math.isfinite(loss):
                    raise RuntimeError(
                        f"Loss became {loss} at step {step}; aborting "
                        f"(reference behavior: clipa_jax/main.py:505-508)")

            if manager and u.itstime(step, ckpt_steps, total_steps,
                                     first=False):
                chrono.pause()
                manager.save(step, checkpoint_state(state, tx, chrono))
                chrono.resume()

            run_evals(step)
            metric.step_end()

        if manager:
            manager.save(total_steps, checkpoint_state(state, tx, chrono))
            manager.wait()
        if workdir and config.get("export_npz", True) and \
                u.process_index() == 0:
            ckpt_lib.save_params({"params": convert.to_jax_params(model)},
                                 os.path.join(workdir, "params.npz"))
        completed = True
        return {"params": state["params"], "opt": tx.state_dict(),
                "step": state["step"]}
    finally:
        train_iter.close()
        for closing in (profiler, manager, metric):
            if closing is not None:
                closing.close()
        # the last pass mirrors a finished run's artifacts; a failed run
        # stops the thread and pushes nothing more
        if syncer is not None and not syncer.stop(final_sync=completed):
            raise RuntimeError(f"the final sync of {workdir} to "
                               f"{syncer.remote_dir} failed")


def _stage_remote_workdir(remote: str, config: ConfigDict,
                          write_note) -> str:
    """The local stage of a remote workdir, pulled from `remote`: the step
    directories, metrics.jsonl and params.npz of an earlier run are there
    before resume. Raises RuntimeError if the pull fails: a fresh start
    would discard the run's checkpoints on the next push."""
    stage = pathio.stage_dir_for(remote, config.get("local_stage_dir"))
    os.makedirs(stage, exist_ok=True)
    write_note(f"Remote workdir {remote} staged at {stage}")
    if not sync_lib.pull(remote, stage):
        raise RuntimeError(f"Failed to pull remote workdir {remote}; "
                           "refusing to train (a fresh start would discard "
                           "the run's checkpoints on the next push)")
    return stage


def _start_sync(workdir: str, remote_sync, remote_workdir: Optional[str]
                ) -> sync_lib.SyncThread:
    """Mirrors `workdir` to ``remote_sync.path`` (a URL or a path; the
    remote workdir where not given) every ``remote_sync.every_seconds``
    (default 300)."""
    rs = remote_sync or {}
    rs = {"path": rs} if isinstance(rs, str) else dict(rs)
    target = rs.get("path") or remote_workdir
    if not target:
        raise ValueError("config.remote_sync needs a path")
    return sync_lib.SyncThread(
        workdir, target,
        every_seconds=float(rs.get("every_seconds", 300))).start()


def _load_model_init(model: torch.nn.Module, model_name: str, init,
                     model_cfg, model_load) -> None:
    """``config.model_init``: the model module's ``load`` merges the
    checkpoint(s) (the JAX layout; paths or URLs) into the model's
    parameters under ``model_load`` (``dont_load`` per tower)."""
    jax_params = convert.to_jax_params(model)
    tree = u.recover_tree(list(jax_params), list(jax_params.values()))
    tree = get_model_module(model_name).load(tree, init, model_cfg,
                                             **dict(model_load or {}))
    convert.load_jax_params(model, tree)


def _build_teacher(config: ConfigDict, device, write_note
                   ) -> torch.nn.Module:
    """The frozen distillation teacher of ``config.distill``: its model
    config at the student's input shapes (the reference assumes teacher
    and student share the tokenizer and the transforms), drawn from
    ``distill.seed``, then ``distill.model_init`` where set; in eval mode,
    no parameter requiring a gradient."""
    dcfg = config.distill
    tcfg = ConfigDict(model_name=dcfg.get("model_name", "two_towers"),
                      model=dcfg.model, init_shapes=config.init_shapes)
    teacher = step_lib.create_model(tcfg, device)
    step_lib.init_train_state(teacher, tcfg, torch.Generator(
        device=device).manual_seed(int(dcfg.get("seed", 0))), device)
    if dcfg.get("model_init"):
        write_note(f"Loading distillation teacher from "
                   f"{dcfg.model_init}...")
        _load_model_init(teacher, tcfg.model_name, dcfg.model_init,
                         dcfg.model, dcfg.get("model_load", {}))
    teacher.requires_grad_(False)
    return teacher.eval()


def main(argv=None) -> dict:
    """The CLI: ``--config=<file.py or module>[:args]``, ``--workdir``,
    ``--device`` (default cuda) and ``--config.a.b=value`` overrides.
    Returns :func:`train`'s final state."""
    parser = argparse.ArgumentParser(description="CLIPA trainer (PyTorch)")
    parser.add_argument("--config", required=True,
                        help="config file path[:arg_string]")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cpu for tests)")
    args, overrides = parser.parse_known_args(argv)
    config = load_config(args.config)
    apply_overrides(config, overrides)
    return train(config, args.workdir, device=args.device)
