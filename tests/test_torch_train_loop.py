"""The port's trainer (clipa_tpu_torch/train/loop.py, metrics.py, the
resumable checkpoints) on the CPU, against the JAX package's loop.

  * one shared smoke run (``configs/smoke.py``, 6 steps in process, then
    extended to 9 through ``python -m clipa_tpu_torch.train ... --device
    cpu``): metrics.jsonl, config.json, params.npz and the checkpoints;
    the extension resumes at step 6 and logs steps 5 and 6 once;
  * the step-6 checkpoint restores into a fresh model and optimizer equal
    to the run's final state bit for bit;
  * the optimizer's state dict round trip, bf16 `mu` included;
  * what the loop refuses (NotImplementedError naming its ROADMAP item:
    wandb, several GPUs; remote workdirs and distillation are
    tests/test_torch_remote_sync.py's and tests/test_torch_distill.py's);
  * loss parity: both loops from one masked_init npz of the JAX smoke
    model's initial parameters, 3 steps of the fp32 smoke config on the
    same synthetic data: `training_loss` within rtol 1e-5 at step 1 and
    1e-4 at steps 2-3, and the same metric keys; once as the config is,
    once with ``loss="chunked"``, ``grad_accum_steps=2`` and
    ``log_block_norms`` (the per-block norms reach metrics.jsonl under the
    JAX loop's names).

The JAX side tokenizes in Python: its native WordPiece is not thread-safe
(tests/test_torch_data.py::test_tokenization_is_thread_safe).
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu.config import load_config as jax_load_config
from clipa_tpu.models import get_model_module as jax_get_model_module
from clipa_tpu.pp import ops_text as jax_ops_text
from clipa_tpu.pp import tokenizer as jax_tokenizer
from clipa_tpu.train import checkpoint as jax_checkpoint
from clipa_tpu.train import loop as jax_loop
from clipa_tpu_torch import convert, optim, utils
from clipa_tpu_torch.config import load_config
from clipa_tpu_torch.train import checkpoint, loop, metrics, step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "clipa_tpu_torch", "configs", "smoke.py")
JAX_SMOKE = os.path.join(REPO, "clipa_tpu", "configs", "smoke.py")
STEPS = (6, 9)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The Ti smoke model's ops are small: one intra-op thread runs them as
    fast, and leaves the cores to the test workers beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("torch_smoke") / "run")
    first = loop.main([f"--config={SMOKE}:steps={STEPS[0]},batch=16",
                       f"--workdir={workdir}", "--device", "cpu"])
    resumed = subprocess.run(
        [sys.executable, "-m", "clipa_tpu_torch.train",
         f"--config={SMOKE}:steps={STEPS[1]},batch=16",
         f"--workdir={workdir}", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    return workdir, first, resumed.stdout


def test_smoke_run_writes_metrics_config_params_and_checkpoints(smoke_run):
    workdir, first, _ = smoke_run
    assert first["step"] == STEPS[0]
    rows = _rows(workdir)
    assert [r["step"] for r in rows] == [1, 5, 6, 9]
    assert all(math.isfinite(r["training_loss"]) for r in rows)
    assert all("core_hours_cpu" in r for r in rows)
    assert "img/sec/core" in rows[2]   # the first run's third tick
    with open(os.path.join(workdir, "config.json")) as f:
        assert json.load(f)["total_steps"] == STEPS[1]
    manager = checkpoint.CheckpointManager(os.path.join(workdir,
                                                        "checkpoints"))
    assert manager.all_steps() == [5, 6, 9]
    assert not [n for n in os.listdir(manager.directory)
                if not n.isdigit()]   # no temporary directory left behind
    exported = dict(utils.tree_flatten_with_names(checkpoint.load_params(
        os.path.join(workdir, "params.npz"))))
    assert exported.keys() == manager.restore(9)["params"].keys()


def test_extending_the_run_resumes_and_does_not_restart(smoke_run):
    workdir, _, stdout = smoke_run
    assert f"Resuming from checkpoint step {STEPS[0]}" in stdout
    steps = [r["step"] for r in _rows(workdir)]
    assert steps.count(5) == 1 and steps.count(6) == 1
    # the restored run continues the optimizer's count and the chrono
    saved = checkpoint.CheckpointManager(
        os.path.join(workdir, "checkpoints")).restore(STEPS[1])
    assert saved["step"] == saved["opt"]["count"] == STEPS[1]
    assert saved["chrono"]["accum_train_time"] > 0


def _fresh(config):
    model = step.create_model(config, device="cpu")
    state = step.init_train_state(model, config,
                                  torch.Generator().manual_seed(1), "cpu")
    tx, _ = optim.make(config, model, sched_kw=dict(total_steps=10))
    return state, tx


def _bits(t):
    ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(ints)


def test_restored_state_equals_the_saved_one_bit_for_bit(smoke_run):
    workdir, first, _ = smoke_run
    config = load_config(f"{SMOKE}:steps={STEPS[0]},batch=16")
    state, tx = _fresh(config)
    chrono = metrics.Chrono("cpu")
    manager = checkpoint.CheckpointManager(os.path.join(workdir,
                                                        "checkpoints"))
    assert loop.restore(manager.restore(STEPS[0]), state, tx,
                        chrono) == STEPS[0]
    got = tx.state_dict()
    assert got["count"] == first["opt"]["count"] == STEPS[0]
    for name, p in first["params"].items():
        assert torch.equal(_bits(state["params"][name]), _bits(p)), name
    for key in ("mu", "nu"):
        assert got[key].keys() == first["opt"][key].keys()
        for name, m in first["opt"][key].items():
            assert torch.equal(_bits(got[key][name]), _bits(m)), name


def test_resume_and_model_init_from_another_run(smoke_run, tmp_path,
                                                capsys):
    """config.resume continues another run's checkpoint (a step
    directory); config.model_init loads both towers and `t` from its
    params.npz (the JAX layout): at lr 0 the params stay as loaded."""
    workdir = smoke_run[0]
    config = load_config(f"{SMOKE}:steps={STEPS[1] + 1},batch=16")
    config.resume = os.path.join(workdir, "checkpoints", str(STEPS[1]))
    out = loop.train(config, str(tmp_path / "resumed"), device="cpu")
    assert "Resuming from" in capsys.readouterr().out
    assert out["step"] == out["opt"]["count"] == STEPS[1] + 1
    assert [r["step"] for r in _rows(str(tmp_path / "resumed"))] == \
        [STEPS[1] + 1]

    config = load_config(f"{SMOKE}:steps=2,batch=16")
    config.model_init = os.path.join(workdir, "params.npz")
    config.lr = 0.0
    loop.train(config, str(tmp_path / "init"), device="cpu")
    want = dict(utils.tree_flatten_with_names(checkpoint.load_params(
        config.model_init)))
    got = dict(utils.tree_flatten_with_names(checkpoint.load_params(
        str(tmp_path / "init" / "params.npz"))))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert torch.equal(got[name], w), name


def test_debug_data_prints_batches_and_does_not_train(tmp_path, capsys):
    config = load_config(f"{SMOKE}:steps=2,batch=4")
    config.wandb = {"debug_data": True}
    assert loop.train(config, str(tmp_path), device="cpu") == {}
    out = capsys.readouterr().out
    assert "batch 4: {'image': ((4, 32, 32, 3), 'torch.uint8')" in out
    assert not os.path.exists(tmp_path / "metrics.jsonl")


def test_optimizer_state_dict_round_trip_keeps_bf16_mu(tmp_path):
    config = load_config(f"{SMOKE}:steps=4,batch=4")
    config.optax.mu_dtype = "bfloat16"
    state, tx = _fresh(config)
    grads = {n: torch.randn_like(p, generator=torch.Generator().manual_seed(
        i)) for i, (n, p) in enumerate(state["params"].items())}
    for _ in range(2):
        tx.apply(tx.update(grads))
    manager = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=1)
    for s in (1, 2):
        assert manager.save(s, {"opt": tx.state_dict()})
    assert not manager.save(2, {"opt": {}})   # the step exists: a no-op
    manager.close()
    assert manager.all_steps() == [2]          # max_to_keep
    other_state, other = _fresh(config)
    other.load_state_dict(checkpoint.load_state(manager.step_dir(2))["opt"])
    assert other.count == tx.count == 2
    for key in ("mu", "nu"):
        for name, t in getattr(tx, key).items():
            got = getattr(other, key)[name]
            assert got.dtype == t.dtype
            assert torch.equal(_bits(got), _bits(t)), (key, name)
    assert {t.dtype for t in tx.mu.values()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="bfloat16"):
        bad = tx.state_dict()
        bad["mu"] = {n: m.float() for n, m in bad["mu"].items()}
        other.load_state_dict(bad)


@pytest.mark.parametrize("setting,match", [
    (("wandb", {"log_wandb": True}), "wandb"),
    (("fsdp", 2), "does not divide device count 1"),
])
def test_loop_refuses_what_is_not_ported(setting, match, tmp_path):
    """wandb is not ported; fsdp 2 on one process is refused as the JAX
    mesh refuses it (multi-process training:
    tests/test_torch_distributed_train.py)."""
    config = load_config(f"{SMOKE}:steps=2,batch=4")
    config[setting[0]] = setting[1]
    error = NotImplementedError if setting[0] == "wandb" else ValueError
    with pytest.raises(error, match=match):
        loop.train(config, str(tmp_path), device="cpu")


def test_loop_refuses_mixup_and_a_missing_card(tmp_path, monkeypatch):
    config = load_config(f"{SMOKE}:steps=2,batch=4")
    config.input.mixup = {"mixup_alpha": 0.8}
    with pytest.raises(ValueError, match="mixup"):
        loop.train(config, str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        loop.main([f"--config={SMOKE}:steps=2,batch=4",
                   f"--workdir={tmp_path}"])   # the card is the default


def test_loop_aborts_on_a_nan_loss(tmp_path, monkeypatch):
    make = step.make_update_fn

    def nan_loss(*args, **kw):
        update = make(*args, **kw)

        def run(state, batch):
            state, meas = update(state, batch)
            meas["training_loss"] = torch.tensor(float("nan"))
            return state, meas
        return run

    monkeypatch.setattr(step, "make_update_fn", nan_loss)
    config = load_config(f"{SMOKE}:steps=3,batch=4")
    with pytest.raises(RuntimeError, match="Loss became nan at step 1"):
        loop.train(config, str(tmp_path), device="cpu")


def test_profiler_writes_a_trace(tmp_path):
    prof = metrics.Profiler(str(tmp_path), start_step=2, num_steps=1)
    for s in (1, 2, 3):
        prof.maybe_start(s)
        with prof.step_annotation(s):
            torch.ones(8).sum()
        prof.maybe_stop(s)
    prof.close()
    traces = os.listdir(tmp_path / "traces")
    assert traces == ["train_steps_2-3.json"]


# config changes of the loss parity runs: the plain step, and two-pass
# accumulation on the chunked loss with the per-block gradient norms
PARITY = {"softmax": {},
          "chunked_accum": dict(loss="chunked", loss_chunk_size=4,
                                grad_accum_steps=2, log_block_norms=True)}


@pytest.fixture(scope="module", params=sorted(PARITY))
def parity_runs(tmp_path_factory, request):
    """The JAX loop and the port's from the same masked_init npz, 3 steps
    of the fp32 smoke config, logging every step, with the changes of
    PARITY[param] made in both."""
    root = tmp_path_factory.mktemp("loop_parity")
    spec = "steps=3,batch=16"
    config = jax_load_config(f"{JAX_SMOKE}:{spec}")
    model = jax_get_model_module("two_towers").Model(**dict(config.model))
    params = model.init(
        {"params": jax.random.PRNGKey(7)},
        jnp.zeros(config.init_shapes[0], jnp.float32),
        jnp.zeros(config.init_shapes[1], jnp.int32), train=False)["params"]
    init = str(root / "init.npz")
    jax_checkpoint.save_checkpoint({"params": params}, init)

    def prepare(config):
        config.masked_init = init
        config.log_training_steps = 1
        config.save_ckpt = False
        config.export_npz = False
        for key, value in PARITY[request.param].items():
            config[key] = value
        return config

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ops_text, "get_tokenizer", lambda path: (
            jax_tokenizer.get_tokenizer(path, backend="python")))
        jax_loop.train(prepare(config), str(root / "jax"))
    loop.train(prepare(load_config(f"{SMOKE}:{spec}")), str(root / "torch"),
               device="cpu")
    return _rows(str(root / "jax")), _rows(str(root / "torch"))


def _jax_smoke_params(seed=7):
    config = jax_load_config(f"{JAX_SMOKE}:steps=3,batch=16")
    model = jax_get_model_module("two_towers").Model(**dict(config.model))
    return model, model.init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros(config.init_shapes[0], jnp.float32),
        jnp.zeros(config.init_shapes[1], jnp.int32), train=False)["params"]


def test_masked_init_reads_the_jax_layout(tmp_path):
    """A checkpoint the JAX package writes initializes every parameter,
    the attention projections (JAX (d, H, hd), torch (H*hd, d)) and the
    Dense kernels (transposed) included."""
    _, params = _jax_smoke_params()
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint({"params": params}, path)
    model = step.create_model(load_config(f"{SMOKE}:steps=3,batch=16"),
                              device="cpu")
    step.init_train_state(model, None, torch.Generator().manual_seed(0),
                          "cpu")
    checkpoint.masked_init(model, path)
    want = dict(utils.tree_flatten_with_names(jax.device_get(params)))
    got = convert.to_jax_params(model)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)


def test_exported_npz_is_the_jax_models_layout(smoke_run):
    """params.npz holds the JAX model's names and shapes, and the JAX
    package reads it back into its model."""
    workdir = smoke_run[0]
    model, params = _jax_smoke_params()
    want = {n: np.shape(v) for n, v in
            utils.tree_flatten_with_names(jax.device_get(params))}
    exported = jax_checkpoint.load_params(os.path.join(workdir,
                                                       "params.npz"))
    got = {n: np.shape(v) for n, v in
           utils.tree_flatten_with_names(jax.device_get(exported))}
    assert got == want
    config = jax_load_config(f"{JAX_SMOKE}:steps=3,batch=16")
    zimg, ztxt, _ = model.apply(
        {"params": exported}, jnp.zeros((2, *config.init_shapes[0][1:])),
        jnp.ones((2, config.init_shapes[1][1]), jnp.int32))
    assert np.isfinite(np.asarray(zimg)).all() and zimg.shape == ztxt.shape


def test_loss_matches_the_jax_loop(parity_runs):
    want, got = parity_runs
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        rtol = 1e-5 if w["step"] == 1 else 1e-4
        np.testing.assert_allclose(g["training_loss"], w["training_loss"],
                                   rtol=rtol, err_msg=f"step {w['step']}")
        assert g["global_schedule"] == pytest.approx(w["global_schedule"],
                                                     rel=1e-6)


def test_metric_keys_match_the_jax_loop(parity_runs):
    want, got = parity_runs
    for g, w in zip(got, want):
        assert set(g) == set(w), w["step"]
    blocks = {k for k in got[0] if k.startswith("l2_grad_")}
    assert not blocks or {"l2_grad_embedding", "l2_grad_head",
                          "l2_grad_encoderblock_0"} <= blocks


def test_async_writer_saves_the_values_at_the_call(tmp_path):
    """AsyncCheckpointWriter copies the tensors before it returns: a
    parameter updated in place afterwards does not reach the file, which
    the JAX package reads."""
    params = {"img/kernel": torch.arange(6, dtype=torch.float32),
              "t": torch.ones(1, dtype=torch.bfloat16)}
    writer = checkpoint.AsyncCheckpointWriter()
    path = str(tmp_path / "p.npz")
    writer.save(params, path)
    params["img/kernel"].add_(100)
    writer.close()
    back = jax_checkpoint.load_params(path)
    np.testing.assert_array_equal(back["img"]["kernel"], np.arange(6))
    assert back["t"].dtype == jnp.bfloat16 and float(back["t"][0]) == 1.0
