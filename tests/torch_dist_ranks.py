"""Spawned gloo process groups for the port's multi-process tests.

The rank functions live here, in a module that imports neither ``jax`` nor
``clipa_tpu``: spawn re-imports the target's module in each child, so a
child starts in the time a torch import takes. :func:`run_ranks` starts
`world` processes on a ``FileStore`` rendezvous in the test's tmp dir (no
TCP port, so parallel test workers never collide), runs
``fn(rank, world, *args)`` in each and returns each rank's return value
(through ``torch.save`` files). Every group has a deadline of its own: a
hang kills the children and fails the test, never the whole run.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "clipa_tpu_torch", "configs", "smoke.py")


def _child(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        if world:
            dist.init_process_group(
                "gloo", store=dist.FileStore(os.path.join(tmp, "store"),
                                             world),
                rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=60))
        result = fn(rank, world, *args)
        torch.save({"ok": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if world and dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 180.0):
    """Runs ``fn(rank, world, *args)`` on `world` spawned processes of one
    gloo group (world 0: one process with no group) and returns the ranks'
    results in rank order."""
    tmp = str(tmp_path / f"group{time.monotonic_ns()}")
    os.makedirs(tmp)
    n = max(world, 1)
    ctx = mp.start_processes(_child, args=(fn, world, tmp, args), nprocs=n,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks did not "
                                   f"finish in {timeout} s")
    except mp.ProcessRaisedException:
        pass   # the rank's own traceback is in its file
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for rank in range(n):
        path = os.path.join(tmp, f"rank{rank}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {rank} of {fn.__name__} left no result")
        got = torch.load(path, weights_only=False)
        if "error" in got:
            raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                               f"{got['error']}")
        results.append(got["ok"])
    return results


# ---------------------------------------------------------------- the step

def tiny_config(**changes):
    """The smoke pre-training config at Ti widths (depth 2), 32 px, a global
    batch of 8, fp32, a constant lr."""
    from clipa_tpu_torch.config import load_config
    config = load_config(f"{SMOKE}:steps=2,batch=8")
    config.model.dtype = "float32"
    config.lr = 1e-3
    config.schedule = [(".*", dict(decay_type="const"))]
    config.log_training_steps = 1
    config.norm_metrics = "always"
    config.log_block_norms = True
    config.grad_clip_norm = 1.0
    for k, v in changes.items():
        config[k] = v
    return config


def batch_of(config, seed: int = 0, pads=None) -> dict:
    """The global batch: uint8 images and token ids from `seed`; `pads`
    (per row) zeroes the last ids of each row (CoCa's pad labels)."""
    rng = np.random.default_rng(seed)
    img_shape, txt_shape = (tuple(s) for s in config.init_shapes)
    b = config.input.batch_size
    images = rng.integers(0, 256, (b,) + img_shape[1:], dtype=np.uint8)
    vocab = int(config.model.text.get("vocab_size", 32000))
    labels = rng.integers(1, vocab, (b,) + txt_shape[1:]).astype(np.int32)
    if pads is not None:
        for i, n in enumerate(pads):
            if n:
                labels[i, -n:] = 0
    return {"image": images, "labels": labels}


def step_case(rank, world, config, steps=1, fsdp=1, min_size=256,
              teacher_config=None, pads=None):
    """`steps` update steps of `config` on this rank's rows of the global
    batch (world 0: no process group, the whole batch). Returns the
    measurements of each step, the full parameters after them and the
    gradients handed to the optimizer at the first step (rank 0's, full:
    the shards gathered; the other ranks' parameters as checksums)."""
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.parallel import mesh as mesh_lib
    from clipa_tpu_torch.train import step as step_lib

    teacher = None
    if teacher_config is not None:
        teacher = step_lib.create_model(teacher_config, device="cpu")
        step_lib.init_train_state(teacher, teacher_config,
                                  torch.Generator().manual_seed(5), "cpu")
        teacher.requires_grad_(False)
    model, state, tx, update, mesh = _built(config, world, fsdp, min_size,
                                            teacher, steps)
    shards = state.get("shards")
    seen = {}
    update_tx = tx.update

    def spy(grads):
        if not seen:
            seen.update({n: g.clone() for n, g in grads.items()})
        return update_tx(grads)

    tx.update = spy
    batch = batch_of(config, pads=pads)
    if mesh is not None:
        rows = mesh_lib.batch_rows(mesh, config.input.batch_size // world)
        batch = {k: v[rows] for k, v in batch.items()}
    batch = mesh_lib.local_batch_to_global(batch, "cpu")
    measured = []
    for _ in range(steps):
        state, meas = update(state, batch)
        measured.append({k: float(v) for k, v in meas.items()})
    if shards is not None:   # the first step's gradients, whole
        seen = shards.whole(seen)
    full = optim.named_parameters(model)
    if shards is not None and dist.get_rank() != 0:
        return {"measurements": measured,
                "param_sums": {n: float(p.detach().double().abs().sum())
                               for n, p in full.items()}}
    return {"measurements": measured,
            "params": {n: p.detach().clone() for n, p in full.items()},
            "grads": seen,
            "sharded": sorted(shards.sharded) if shards else []}


def compare_steps(ref: dict, got: dict, lr: float) -> dict:
    """How far a step on several processes (`got`, rank 0's) is from the
    same step on one (`ref`): the largest relative difference of each
    measurement; of the gradients, each tensor's largest difference over
    its largest element (at least a hundredth of the model's largest
    gradient); of the new parameters, the largest relative difference
    where the gradient is above 1e-3 of that scale, and the largest
    difference anywhere in units of the learning rate (Adam's first step
    moves an element by about lr * sign(g), whose sign is rounding noise
    where g is)."""
    scale = max(float(g.abs().max()) for g in ref["grads"].values())
    grads = {n: float((got["grads"][n] - g).abs().max())
             / max(float(g.abs().max()), 1e-2 * scale)
             for n, g in ref["grads"].items()}
    signal = anywhere = 0.0
    for n, p in ref["params"].items():
        d = (got["params"][n] - p).abs()
        anywhere = max(anywhere, float(d.max()) / lr)
        keep = ref["grads"][n].abs() > 1e-3 * scale
        if keep.any():
            signal = max(signal, float((d[keep] / p.abs()[keep].clamp(
                min=lr)).max()))
    meas = {}
    for step, (a, b) in enumerate(zip(ref["measurements"],
                                      got["measurements"])):
        for k, v in a.items():
            meas[f"{k}@{step}"] = abs(b[k] - v) / max(abs(v), 1e-30)
    return {"grads": max(grads.values()), "params_signal": signal,
            "params_anywhere_lr": anywhere, "measurements": meas}


def step_cases(rank, world, cases, fsdp, min_size=256):
    """Each case (name, config, step_case kwargs) stepped on `world`
    processes; rank 0 also steps it alone (no collective: the step of one
    process) and returns :func:`compare_steps` of the two per case, plus
    whether every rank ended with the same parameters."""
    out = {}
    for name, config, kw in cases:
        got = step_case(rank, world, config, fsdp=fsdp, min_size=min_size,
                        **kw)
        sums = [None] * world
        mine = got.get("param_sums") or {
            n: float(p.detach().double().abs().sum())
            for n, p in got["params"].items()}
        dist.all_gather_object(sums, mine)
        if rank == 0:
            ref = step_case(0, 0, config, **kw)
            out[name] = {**compare_steps(ref, got, config.lr),
                         "ranks_agree": all(s == sums[0] for s in sums),
                         "sharded": len(got["sharded"]),
                         "loss": ref["measurements"][0]["training_loss"]}
    return out


def _built(config, world, fsdp, min_size=256, teacher=None, steps=4):
    """(model, state, optimizer, update fn, mesh) of `config` on this
    process (world 0: no mesh)."""
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.parallel import mesh as mesh_lib
    from clipa_tpu_torch.train import step as step_lib

    mesh = mesh_lib.create_mesh(fsdp) if world else None
    model = step_lib.create_model(config, device="cpu")
    state = step_lib.init_train_state(
        model, config, torch.Generator().manual_seed(0), "cpu", mesh=mesh,
        min_size_to_shard=min_size)
    shards = state.get("shards")
    tx, _ = optim.make(config, state["params"],
                       sched_kw=dict(total_steps=steps),
                       sqsum=shards.sqsum if shards else None)
    update = step_lib.make_update_fn(model, tx, config, total_steps=steps,
                                     teacher_model=teacher, mesh=mesh)
    return model, state, tx, update, mesh


def _whole_state(state, tx) -> dict:
    """The full parameters and moments (shards gathered), and the counts."""
    shards = state.get("shards")
    whole = shards.whole if shards is not None else (lambda d: d)
    return {"params": {n: p.detach().clone()
                       for n, p in whole(state["params"]).items()},
            "mu": {n: m.clone() for n, m in whole(tx.mu).items()},
            "nu": {n: m.clone() for n, m in whole(tx.nu).items()},
            "step": state["step"], "count": tx.count}


def ckpt_save(rank, world, config, fsdp, directory, steps=2):
    """`steps` steps on this rank's rows, then a checkpoint of the state
    at step `steps` in `directory`; returns the whole state (rank 0)."""
    from clipa_tpu_torch.parallel import mesh as mesh_lib
    from clipa_tpu_torch.train import checkpoint, loop, metrics

    model, state, tx, update, mesh = _built(config, world, fsdp)
    batch = batch_of(config)
    if mesh is not None:
        rows = mesh_lib.batch_rows(mesh, config.input.batch_size // world)
        batch = {k: v[rows] for k, v in batch.items()}
    batch = mesh_lib.local_batch_to_global(batch, "cpu")
    for _ in range(steps):
        state, _ = update(state, batch)
    manager = checkpoint.CheckpointManager(directory,
                                           shards=state.get("shards"))
    assert manager.save(steps, loop.checkpoint_state(
        state, tx, metrics.Chrono("cpu")))
    manager.close()
    whole = _whole_state(state, tx)
    return whole if rank == 0 else None


def ckpt_restore(rank, world, config, fsdp, directory):
    """A fresh state restored from `directory`'s latest step; returns the
    whole state (rank 0) and the step directories seen."""
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.train import checkpoint, loop, metrics

    model, state, tx, update, mesh = _built(config, world, fsdp)
    shards = state.get("shards")
    chrono = metrics.Chrono("cpu")
    manager = checkpoint.CheckpointManager(directory, shards=shards)
    got = manager.restore(template=loop.checkpoint_state(state, tx, chrono))
    loop.restore(got, state, tx, chrono)
    if shards is not None:
        shards.gather(state["params"])
    manager.close()
    whole = _whole_state(state, tx)
    whole["model"] = {n: p.detach().clone() for n, p in
                      optim.named_parameters(model).items()}
    whole["steps"] = manager.all_steps()
    return whole if rank == 0 else None


def loop_run(rank, world, argv):
    """``train.loop.main(argv)`` on this rank (the group already made);
    returns the final step."""
    from clipa_tpu_torch.train import loop
    return loop.main(argv)["step"]


def ring_case(rank, world, zimg, ztxt, t, bias):
    """Both ring losses on this rank's rows of the global (B, C) `zimg` and
    `ztxt`: each one's value and the gradients of its backward (the rows',
    and this rank's partial sums for `t` and `bias`)."""
    from clipa_tpu_torch.ops import ring_infonce

    b = zimg.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for name in ("ring", "ring_sigmoid"):
        zi = torch.tensor(zimg[rows], requires_grad=True)
        zt = torch.tensor(ztxt[rows], requires_grad=True)
        tt = torch.tensor(t, requires_grad=True)
        bb = torch.tensor(bias, requires_grad=True)
        if name == "ring":
            loss, extras = ring_infonce.ring_contrastive_loss(zi, zt, tt)
        else:
            loss, extras = ring_infonce.ring_sigmoid_contrastive_loss(
                zi, zt, tt, bias=bb)
        loss.backward()
        out[name] = {"loss": float(loss.detach()),
                     "ncorrect": float(extras.get("ncorrect", 0.0)),
                     "zimg": zi.grad.numpy(), "ztxt": zt.grad.numpy(),
                     "t": tt.grad.numpy(),
                     "bias": (bb.grad.numpy() if bb.grad is not None
                              else np.zeros_like(bias))}
    return out


def mesh_checks(rank, world):
    """The mesh, the batch rule and the collectives on this rank."""
    from clipa_tpu_torch.parallel import collectives, mesh as mesh_lib

    out = {}
    for fsdp in (1, 2, world):
        mesh = mesh_lib.create_mesh(fsdp)
        out[fsdp] = {"shape": tuple(mesh.shape),
                     "names": tuple(mesh.mesh_dim_names),
                     "device_type": mesh.device_type,
                     "shard": mesh_lib.batch_shard(mesh),
                     "rows": mesh_lib.batch_rows(mesh, 3)}
    # ParamShards: shards of a parameter dict, gathered back; gradients
    # averaged; norms from the shards
    mesh = mesh_lib.create_mesh(2)
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(8, 6, generator=gen),
              "b": torch.randn(3, 10, generator=gen),
              "c": torch.randn(5, generator=gen)}
    shards = collectives.ParamShards(params, mesh, min_size_to_shard=16)
    local = shards.local()
    for n in shards.sharded:
        local[n].mul_(2.0)
    shards.gather(local)
    grads = {n: torch.full_like(p, float(rank + 1)) for n, p in
             params.items()}
    reduced = shards.reduce_gradients(grads)
    out["shards"] = {
        "dims": dict(shards.dims),
        "local_shapes": {n: tuple(x.shape) for n, x in local.items()},
        "params": {n: p.clone() for n, p in params.items()},
        "reduced": {n: g.clone() for n, g in reduced.items()},
        "sqsum": float(shards.sqsum(reduced)),
    }
    counts = rank + 1   # uneven rows per rank
    out["varlen"] = collectives.gather_varlen(
        np.arange(counts * 2, dtype=np.float32).reshape(counts, 2) + rank)
    out["sum"] = collectives.all_reduce_sum([rank, 1.0]).tolist()
    out["max"] = collectives.all_reduce_max(rank * 3)
    batch = mesh_lib.local_batch_to_global(
        {"x": np.full((2, 3), rank, np.int32)}, "cpu")
    out["local_batch"] = batch["x"]
    return out


def init_from_env(rank, world, port_env):
    """``init_distributed`` on torchrun's environment (one process, port 0:
    the store picks a free port)."""
    import torch.distributed as dist
    from clipa_tpu_torch.parallel import mesh as mesh_lib

    os.environ.update(port_env)
    device = mesh_lib.init_distributed("cpu")
    try:
        return (str(device), dist.is_initialized(), dist.get_backend(),
                dist.get_world_size())
    finally:
        dist.destroy_process_group()


def restore_and_export(rank, world, config, directory):
    """The trainer's model at one process with `directory`'s latest step
    restored, in the JAX layout (``convert.to_jax_params``)."""
    from clipa_tpu_torch import convert, optim
    from clipa_tpu_torch.train import checkpoint, loop, metrics
    from clipa_tpu_torch.train import step as step_lib

    model = step_lib.create_model(config, device="cpu")
    state = step_lib.init_train_state(model, config,
                                      torch.Generator().manual_seed(0), "cpu")
    tx, _ = optim.make(config, state["params"], sched_kw=dict(total_steps=2))
    chrono = metrics.Chrono("cpu")
    manager = checkpoint.CheckpointManager(directory)
    loop.restore(manager.restore(template=loop.checkpoint_state(
        state, tx, chrono)), state, tx, chrono)
    return {n: x.detach().clone()
            for n, x in convert.to_jax_params(model).items()}


# ---------------------------------------------------------------- evaluators

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "vocab.txt")


def eval_case(rank, world, data_dir, classes):
    """Every evaluator on the smoke two-towers (seeded, the same on every
    process) over `data_dir`'s tfrecords; returns {evaluator: results}."""
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.data import core
    from clipa_tpu_torch.evaluators import (classification, contrastive,
                                            fewshot, mean, retrieval,
                                            zeroshot)
    from clipa_tpu_torch.train import step as step_lib

    config = load_config(f"{SMOKE}:steps=2,batch=16")
    config.model.text.vocab_size = 30522
    model = step_lib.create_model(config, device="cpu")
    state = step_lib.init_train_state(model, config,
                                      torch.Generator().manual_seed(3), "cpu")
    params = state["params"]
    predict = step_lib.make_predict_fn(model)
    pp_txt = (f'bert_tokenize(inkey="texts", max_len=8, '
              f'vocab_path="{VOCAB}", sample_if_multi=False)')
    pp_img = 'decode|resize_small(32, method="bilinear")|central_crop(32)'

    def spec(name):
        return dict(name="tfrecord",
                    pattern=f"{data_dir}/{name}-validation*")

    out = {}
    zs = zeroshot.Evaluator(
        predict, "cpu", batch_size=8, dataset_names=["labeled"],
        data_dir=data_dir, class_names=classes,
        prompt_templates="clip_paper", pp_img=pp_img, pp_txt=pp_txt,
        max_labels=2, num_workers=1)
    got = zs.evaluate(params, "labeled")
    out["zeroshot"] = sorted(got.items())
    ret = retrieval.Evaluator(predict, "cpu", batch_size=8,
                              data=spec("captions"), pp_img=pp_img,
                              pp_txt=pp_txt, num_workers=1)
    out["retrieval"] = ret.run(params)
    zimg, _, ztxt, _ = ret._embed_all(params)
    out["counts"] = [("images", zimg.shape[0]), ("captions", ztxt.shape[0]),
                     ("zeroshot_count", got["count"])]
    out["contrastive"] = contrastive.Evaluator(
        predict, "cpu", batch_size=64, data=spec("captions"),
        pp=f'{pp_img}|{pp_txt}|keep("image", "labels")',
        num_workers=1).run(params)
    out["classification"] = classification.Evaluator(
        lambda p, image=None, **_: predict(p, image)[0][:, :4], "cpu",
        batch_size=8, data=spec("labeled"),
        pp=f'{pp_img}|onehot(4, key="label")|keep("image", "labels")',
        num_workers=1).run(params)
    def scalar_labels(source):   # the few-shot solver takes int labels
        rows = source.iter_process_shard

        def iter_process_shard(**kw):
            for sample in rows(**kw):
                yield {**sample, "label": int(np.reshape(sample["label"],
                                                         -1)[0])}
        source.iter_process_shard = iter_process_shard
        return source

    train, test = (scalar_labels(core.get_source(**spec("fewshot")))
                   for _ in range(2))
    out["fewshot"] = fewshot.Evaluator(
        predict, "cpu", batch_size=8, datasets={"fewshot": (train, test)},
        shots=(1, 2), pp=f'{pp_img}|keep("image", "label")').run(params)
    out["mean"] = mean.Evaluator(
        lambda p, batch: {"pixel_mean": batch["image"].float().mean(
            dim=(1, 2, 3))}, "cpu", batch_size=8, data=spec("labeled"),
        pp=f'{pp_img}|keep("image")', num_workers=1).run(params)
    return out
