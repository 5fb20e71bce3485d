"""The port's training step against clipa_tpu.train.step on the same inputs.

A tiny config cut from ``configs/clipa_pretrain.py`` (Ti/16 towers of depth 2
at 96 px: L = 37, so the port's image tower takes the fused attention path,
its plain versions on the CPU; 8 text tokens, the einsum path) runs one and
two update steps in both packages from the same parameters (flax init plus
seeded noise, carried across with ``convert.load_jax_params``) and the same
uint8 batch, in fp32 (JAX under default_matmul_precision("highest"), on a
one-device CPU mesh).

Tolerances: gradients 1e-4 of each tensor's largest element (fp32
summation order through two blocks; the key bias's gradient is 0 in exact
arithmetic, so tensors are measured against at least a hundredth of the
model's largest gradient). Adam's first steps are about lr * g / |g| per
element, so where |g| is at rounding level the sign of the step is noise:
new parameters are compared where |g| > 1e-3 of that scale, at 1e-3 * lr
after step 1, and within the step size (2.5 * lr) everywhere. Step 2 starts
from parameters that differ in those noise-level elements: there the
parameters are compared at 2e-2 * lr and the measurements at rtol 1e-4
(step 1: rtol 1e-5).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu import losses as jax_losses
from clipa_tpu import optim as jax_optim
from clipa_tpu import utils as jax_utils
from clipa_tpu.configs import clipa_pretrain
from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu.parallel import create_mesh
from clipa_tpu.train import step as jax_step
from clipa_tpu_torch import convert, losses, optim
from clipa_tpu_torch.compat import openclip
from clipa_tpu_torch.models import two_towers
from clipa_tpu_torch.train import step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
TOTAL = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_config(dtype="float32"):
    config = clipa_pretrain.get_config(
        "img=Ti/16,res=96,token_len=8,batchsize=8")
    config.model.image.update(depth=2, mlp_dim=128)
    config.model.text.update(depth=2, mlp_dim=128, vocab_size=100)
    config.model.dtype = dtype
    config.lr = LR
    config.schedule = [(".*", dict(decay_type="cosine"))]
    config.log_training_steps = 2
    return config


def _batch(config, seed=0):
    rng = np.random.RandomState(seed)
    b = config.input.batch_size
    res = config.init_shapes[0][1]
    return {"image": rng.randint(0, 255, (b, res, res, 3), dtype=np.uint8),
            "labels": rng.randint(1, 100, (b, 8)).astype(np.int32)}


def _jax_params(config, seed=0):
    model = jax_two_towers.Model(**dict(config.model))
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        jnp.zeros(config.init_shapes[0]),
                        jnp.zeros(config.init_shapes[1], jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    return model, jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_utils.tree_flatten_with_names(tree)[0]}


@pytest.fixture(scope="module")
def both_runs():
    """Two update steps in each package, plus the gradients of step 1."""
    config = tiny_config()
    model, params = _jax_params(config)
    batch = _batch(config)

    # JAX: the package's own step on a one-device mesh
    mesh = create_mesh(fsdp=1, devices=jax.devices()[:1])
    tx, _ = jax_optim.make(config, params, sched_kw=dict(total_steps=TOTAL))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = {"params": jp, "opt": tx.init(jp),
             "rng": jax.random.PRNGKey(0),
             "step": jnp.zeros((), jnp.int32)}
    update = jax_step.make_update_fn(model, tx, config, mesh,
                                     total_steps=TOTAL)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        from clipa_tpu.ops import preprocess
        zi, zt, out = model.apply({"params": p}, preprocess.normalize_uint8(
            jbatch["image"]), jbatch["labels"], train=True)
        return jax_losses.bidirectional_contrastive_loss(
            zi, zt, out["t"], reduction=True)[0]

    with jax.default_matmul_precision("highest"):
        jgrads = _flat(jax.grad(loss_fn)(jp))
        jax_meas, jax_params = [], []
        for _ in range(2):
            state, meas = update(state, jbatch)
            jax_meas.append({k: float(v) for k, v in meas.items()})
            jax_params.append(_flat(state["params"]))

    # the port
    port = step.create_model(config, device="cpu")
    convert.load_jax_params(port, params)
    pstate = {"params": optim.named_parameters(port), "step": 0}
    ptx, _ = optim.make(config, port, sched_kw=dict(total_steps=TOTAL))
    pupdate = step.make_update_fn(port, ptx, config, total_steps=TOTAL)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    port.zero_grad()
    zi, zt, out = port(step.preprocess.normalize_uint8(tbatch["image"]),
                       tbatch["labels"])
    losses.bidirectional_contrastive_loss(zi, zt, out["t"],
                                          reduction=True)[0].backward()
    pgrads = convert.to_jax_params(port, {k: p.grad for k, p in
                                          port.named_parameters()})
    port.zero_grad()
    port_meas, port_params = [], []
    for _ in range(2):
        pstate, meas = pupdate(pstate, tbatch)
        port_meas.append({k: float(v) for k, v in meas.items()})
        port_params.append({k: v.numpy().copy()
                            for k, v in convert.to_jax_params(port).items()})
    return dict(jgrads=jgrads, pgrads=pgrads, jax_meas=jax_meas,
                port_meas=port_meas, jax_params=jax_params,
                port_params=port_params, pstate=pstate)


def _scale(grads, name):
    """A tensor's gradient scale: its largest element, at least a hundredth
    of the model's largest gradient."""
    floor = 1e-2 * max(np.abs(x).max() for x in grads.values())
    return max(np.abs(grads[name]).max(), floor)


def test_step_gradients_match(both_runs):
    jg, pg = both_runs["jgrads"], both_runs["pgrads"]
    assert set(jg) == set(pg)
    for name, g in jg.items():
        err = np.abs(pg[name].numpy() - g).max()
        assert err <= 1e-4 * _scale(jg, name), (name, err)


@pytest.mark.parametrize("i", [0, 1])
def test_step_loss_and_measurements_match(both_runs, i):
    ours, ref = both_runs["port_meas"][i], both_runs["jax_meas"][i]
    assert set(ours) == set(ref)
    for key, want in ref.items():
        np.testing.assert_allclose(ours[key], want, rtol=(1e-5, 1e-4)[i],
                                   atol=1e-7, err_msg=key)
    assert both_runs["pstate"]["step"] == 2


@pytest.mark.parametrize("i", [0, 1])
def test_step_new_params_match(both_runs, i):
    ours, ref = both_runs["port_params"][i], both_runs["jax_params"][i]
    jg = both_runs["jgrads"]
    for name, want in ref.items():
        sure = np.abs(jg[name]) > 1e-3 * _scale(jg, name)
        got = ours[name]
        assert np.abs(got - want).max() <= 2.5 * LR, name
        np.testing.assert_allclose(got[sure], want[sure], rtol=0,
                                   atol=(1e-3, 2e-2)[i] * LR, err_msg=name)
    before = both_runs["port_params"][i - 1] if i else None
    if before is not None:   # the second step moved the parameters again
        assert all((ours[n] != before[n]).any() for n in ref)


def test_norm_metrics_gating_and_refusals():
    config = tiny_config()
    config.log_training_steps = 3
    port = step.create_model(config, device="cpu")
    state = step.init_train_state(port, config,
                                  torch.Generator().manual_seed(0), "cpu")
    tx, _ = optim.make(config, port, sched_kw=dict(total_steps=5))
    update = step.make_update_fn(port, tx, config, total_steps=5)
    batch = {k: torch.from_numpy(v) for k, v in _batch(config, 1).items()}
    logged = []
    for _ in range(5):
        state, meas = update(state, batch)
        logged.append(float(meas["l2_grads"]) > 0)
        assert np.isfinite(float(meas["training_loss"]))
    assert logged == [True, False, True, False, True]   # 1st, 3rd, last
    for key, value in (("loss", "sigmoid"), ("grad_accum_steps", 2),
                       ("log_block_norms", True)):
        bad = tiny_config()
        bad[key] = value
        with pytest.raises(NotImplementedError):
            step.make_update_fn(port, tx, bad)


def test_pretrain_config_builds_the_jax_model():
    """clipa_pretrain.py at the bench shape: the port's model has the JAX
    model's parameter names and shapes (meta device: no memory), about 415M
    parameters, bf16 compute over fp32 masters."""
    config = clipa_pretrain.get_config(
        "img=L/16,res=112,token_len=8,batchsize=384")
    model = jax_two_towers.Model(**dict(config.model))
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r}, jnp.zeros(config.init_shapes[0]),
                             jnp.zeros(config.init_shapes[1], jnp.int32))[
            "params"], jax.random.PRNGKey(0))
    want = {k: tuple(v.shape)
            for k, v in jax_utils.tree_flatten_with_names(shapes)[0]}
    port = step.create_model(config, device="meta")
    names = convert.to_jax_names(port)
    got = {}
    for key, p in port.named_parameters():
        got[names[key]] = p.shape
    assert set(got) == set(want)
    sd = convert.to_jax_params(port)
    for name, shape in want.items():
        assert tuple(sd[name].shape) == shape, name
    n = sum(int(np.prod(s)) for s in want.values())
    assert 400e6 < n < 430e6
    assert port.img.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert port.img.Transformer.depth == 24 and port.txt.num_pos == 8


@pytest.mark.parametrize("factory", ["compat.openclip", "train.step"])
def test_model_factories_default_to_the_card(monkeypatch, factory):
    """Both model factories default to "cuda": with torch reporting no CUDA
    device they raise before building anything, and nothing lands on the
    CPU unless the caller names it."""
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(two_towers, "Model",
                        lambda *a, **kw: built.append(kw))
    if factory == "train.step":
        def create(**kw):
            return step.create_model(tiny_config(), **kw)
    else:
        def create(**kw):
            return openclip.create_model("ViT-S-16", **kw)
    with pytest.raises(RuntimeError, match="CUDA device"):
        create()
    with pytest.raises(RuntimeError, match="CUDA device"):
        create(device="cuda:0")
    assert built == []
    if factory == "train.step":
        create(device="cpu")
        assert len(built) == 1


def test_training_modules_import_and_step_without_jax():
    """The training path never pulls in jax (the GPU machine has none)."""
    code = """
import sys
import torch
import clipa_tpu_torch.train.step as step, clipa_tpu_torch.optim as optim
import clipa_tpu_torch.losses, clipa_tpu_torch.convert
import clipa_tpu_torch.ops.block_attention
from clipa_tpu_torch.configs import clipa_pretrain
config = clipa_pretrain.get_config("img=Ti/16,res=96,token_len=8,batchsize=4")
config.model.image.update(depth=1)
config.model.text.update(depth=1, vocab_size=50)
config.schedule = [(".*", dict(decay_type="const"))]
model = step.create_model(config, device="cpu")
state = step.init_train_state(model, config, torch.Generator().manual_seed(0),
                              "cpu")
tx, _ = optim.make(config, model, sched_kw=dict(total_steps=3))
update = step.make_update_fn(model, tx, config, total_steps=3)
batch = {"image": torch.zeros(4, 96, 96, 3, dtype=torch.uint8),
         "labels": torch.ones(4, 8, dtype=torch.int32)}
state, meas = update(state, batch)
assert torch.isfinite(meas["training_loss"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "clipa_tpu"))
assert not bad, bad
print("jax-free")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "jax-free" in proc.stdout
