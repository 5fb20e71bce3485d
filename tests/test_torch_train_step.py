"""The port's training step against clipa_tpu.train.step on the same inputs.

A tiny config cut from ``configs/clipa_pretrain.py`` (Ti/16 towers of depth 2
at 96 px: L = 37, so the port's image tower takes the fused attention path,
its plain versions on the CPU; 8 text tokens, the einsum path) runs one and
two update steps in both packages from the same parameters (flax init plus
seeded noise, carried across with ``convert.load_jax_params``) and the same
uint8 batch, in fp32 (JAX under default_matmul_precision("highest"), on a
one-device CPU mesh).

The same runs with two-pass gradient accumulation (2 and 4 microbatches of
the batch of 8, with and without masking at 0.3, the masking noise handed
to both packages), the sigmoid loss with the towers' ``b`` and the chunked
InfoNCE compare the gradients each package hands its optimizer (an optax
transformation and ``Optimizer.update`` wrapped to record them) and every
measurement, the per-block norms of ``log_block_norms`` included, at the
same tolerances; the port's second step starts from the JAX step's first
parameters (Adam's first step moves each parameter by about lr * sign(g),
so the two packages' parameters differ where |g| is at rounding level).

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
    # the ring losses are ported (tests/test_torch_ring_infonce.py): on one
    # process the ring is one hop, and the step's loss is the global one's
    for loss, like in (("ring", "softmax"), ("ring_sigmoid", "sigmoid")):
        losses_of = []
        for kind in (loss, like):
            cfg = tiny_config()
            cfg.loss = kind
            model = step.create_model(cfg, device="cpu")
            st = step.init_train_state(model, cfg,
                                       torch.Generator().manual_seed(0), "cpu")
            opt, _ = optim.make(cfg, model, sched_kw=dict(total_steps=5))
            _, m = step.make_update_fn(model, opt, cfg)(st, batch)
            losses_of.append(float(m["training_loss"]))
        assert losses_of[0] == pytest.approx(losses_of[1], rel=1e-5), loss
    # the CoCa loss is ported (tests/test_torch_coca.py steps it against
    # the JAX step): the dispatch takes it
    coca = tiny_config()
    coca.loss = "coca"
    assert callable(step.make_update_fn(port, tx, coca))
    bad = tiny_config()
    bad.loss = "sigmoid"   # distillation takes the softmax loss only
    with pytest.raises(ValueError, match="softmax"):
        step.make_update_fn(port, tx, bad, teacher_model=port)
    bad = tiny_config()
    bad.loss = "softmx"
    with pytest.raises(ValueError, match="softmx"):
        step.make_update_fn(port, tx, bad)
    bad = tiny_config()
    bad.grad_accum_steps = 3   # does not divide the batch of 8
    with pytest.raises(ValueError, match="must divide"):
        step.make_update_fn(port, tx, bad)(state, batch)


# Accumulated and alternative-loss steps against the JAX step: (name,
# config changes). Masked cases hand both packages the same masking noise per
# microbatch (each package's random_masking patched, as in
# tests/test_torch_finetune.py); log_block_norms adds the per-block norms.
ACCUM_CASES = [
    ("accum2", dict(grad_accum_steps=2)),
    ("accum4", dict(grad_accum_steps=4)),
    ("accum2_mask", dict(grad_accum_steps=2, mask_ratio=0.3)),
    ("accum4_mask", dict(grad_accum_steps=4, mask_ratio=0.3)),
    ("sigmoid", dict(loss="sigmoid", bias_init=-10.0)),
    ("accum2_sigmoid", dict(loss="sigmoid", bias_init=-10.0,
                            grad_accum_steps=2)),
    ("chunked_accum2", dict(loss="chunked", loss_chunk_size=3,
                            grad_accum_steps=2)),
]
NOISE_KEY = jax.random.PRNGKey(7)


def _case_config(changes):
    config = tiny_config()
    config.log_block_norms = True
    for key, value in changes.items():
        if key == "bias_init":
            config.model.bias_init = value
        else:
            config[key] = value
    return config


def _fixed_noise(monkeypatch, n, l):
    """Both packages' random_masking draw the same (n, l) noise."""
    import functools
    from clipa_tpu.models import vit as jax_vit
    from clipa_tpu_torch.models import vit
    noise = jax.random.uniform(NOISE_KEY, (n, l))
    orig = jax_vit.random_masking
    monkeypatch.setattr(jax_vit, "random_masking",
                        lambda x, r, rng: orig(x, r, NOISE_KEY))
    monkeypatch.setattr(vit, "random_masking", functools.partial(
        vit.random_masking, noise=torch.from_numpy(np.array(noise))))


def _spied_runs(config, steps=2):
    """`steps` update steps of each package from the same parameters and
    batch; each optimizer's update is wrapped to record the gradients it
    is handed. Returns (JAX grads, port grads, JAX measurements, port
    measurements), per step."""
    import optax
    model, params = _jax_params(config)
    batch = _batch(config)
    mesh = create_mesh(fsdp=1, devices=jax.devices()[:1])
    tx, _ = jax_optim.make(config, params, sched_kw=dict(total_steps=TOTAL))
    jgrads = []

    def update_and_record(grads, opt_state, params=None):
        jax.debug.callback(lambda g: jgrads.append(_flat(g)), grads)
        return tx.update(grads, opt_state, params)

    spy = optax.GradientTransformation(tx.init, update_and_record)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = {"params": jp, "opt": spy.init(jp), "rng": jax.random.PRNGKey(0),
             "step": jnp.zeros((), jnp.int32)}
    update = jax_step.make_update_fn(model, spy, config, mesh,
                                     total_steps=TOTAL)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmeas, jparams = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(steps):
            state, meas = update(state, jbatch)
            jmeas.append({k: float(v) for k, v in meas.items()})
            jparams.append(_flat(state["params"]))
    jax.effects_barrier()

    port = step.create_model(config, device="cpu")
    convert.load_jax_params(port, params)
    pstate = {"params": optim.named_parameters(port), "step": 0}
    ptx, _ = optim.make(config, port, sched_kw=dict(total_steps=TOTAL))
    pgrads = []
    tx_update = ptx.update

    def record(grads):
        pgrads.append({k: v.detach().numpy().copy() for k, v in
                       convert.to_jax_params(port, {
                           key: grads[name] for key, name in
                           convert.to_jax_names(port).items()}).items()})
        return tx_update(grads)

    ptx.update = record
    pupdate = step.make_update_fn(port, ptx, config, total_steps=TOTAL)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pmeas = []
    for i in range(steps):
        if i:   # from the JAX step's parameters (see the module docstring)
            convert.load_jax_params(port, jparams[i - 1])
        pstate, meas = pupdate(pstate, tbatch)
        pmeas.append({k: float(v) for k, v in meas.items()})
    return jgrads, pgrads, jmeas, pmeas


@pytest.fixture(scope="module", params=ACCUM_CASES, ids=[c[0] for c in
                                                         ACCUM_CASES])
def accum_runs(request):
    _, changes = request.param
    config = _case_config(changes)
    with pytest.MonkeyPatch.context() as m:
        if config.get("mask_ratio", 0.0):
            mb = config.input.batch_size // config.get("grad_accum_steps", 1)
            _fixed_noise(m, mb, 36)   # 96 px / 16: 36 patches
        return _spied_runs(config)


@pytest.mark.parametrize("i", [0, 1])
def test_accumulated_step_gradients_match(accum_runs, i):
    """The gradients each package hands its optimizer at steps 1 and 2,
    within 1e-4 of each gradient's scale; ``t``'s is accum_steps times the
    single pass's in both."""
    jg, pg = accum_runs[0][i], accum_runs[1][i]
    assert set(jg) == set(pg)
    for name, g in jg.items():
        err = np.abs(pg[name] - g).max()
        assert err <= 1e-4 * _scale(jg, name), (name, err)


@pytest.mark.parametrize("i", [0, 1])
def test_accumulated_step_measurements_match(accum_runs, i):
    """Every measurement, the per-block gradient norms (log_block_norms)
    included, under the JAX step's names."""
    ours, ref = accum_runs[3][i], accum_runs[2][i]
    assert set(ours) == set(ref)
    assert {"l2_grad_embedding", "l2_grad_head", "l2_grad_encoderblock_0",
            "l2_grad_encoderblock_1"} <= set(ours)
    for key, want in ref.items():
        np.testing.assert_allclose(ours[key], want, rtol=(1e-5, 1e-4)[i],
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("loss", ["softmax", "sigmoid"])
def test_accumulated_step_equals_a_single_pass(loss, accum):
    """In the port, accum_steps microbatches give the single pass's loss
    and gradients, but ``t``'s (and the sigmoid loss's ``b``'s), which are
    accum_steps times as large (the reference's quirk: every pass sees the
    whole dL/dt and dL/db)."""
    config = tiny_config()
    config.loss = loss
    if loss == "sigmoid":
        config.model.bias_init = -10.0
    model, params = _jax_params(config)
    batch = {k: torch.from_numpy(v) for k, v in _batch(config).items()}
    got = {}
    for n in (1, accum):
        config.grad_accum_steps = n
        port = step.create_model(config, device="cpu")
        convert.load_jax_params(port, params)
        tx, _ = optim.make(config, port, sched_kw=dict(total_steps=TOTAL))
        grads = []
        tx_update = tx.update
        tx.update = lambda g: (grads.append({k: v.clone() for k, v in
                                             g.items()}), tx_update(g))[1]
        state = {"params": optim.named_parameters(port), "step": 0}
        _, meas = step.make_update_fn(port, tx, config)(state, batch)
        got[n] = grads[0], float(meas["training_loss"])
    (single, loss1), (accumulated, loss_n) = got[1], got[accum]
    np.testing.assert_allclose(loss_n, loss1, rtol=1e-6)
    floor = 1e-2 * max(float(g.abs().max()) for g in single.values())
    for name, g in single.items():
        want = g * accum if name in ("t", "b") else g
        err = float((accumulated[name] - want).abs().max())
        assert err <= 1e-4 * max(float(want.abs().max()), floor), (name, err)
    assert float(single["t"].abs().max()) > 0
    assert (loss == "sigmoid") == ("b" in single)


def test_block_norms_are_the_gradients_norms():
    """log_block_norms: the image stem's, cls's and head's gradient norms
    and each encoder block's MlpBlock_0/Dense_1 kernel norm, from the
    gradients the optimizer gets; a name the optimizer freezes counts as
    0. The JAX step matches config.schedule against the names within each
    subtree, so it does not see a freeze by full name (ROADMAP C)."""
    grads = {"img/embedding/kernel": torch.full((2, 2), 1.0),
             "img/embedding/bias": torch.full((3,), 2.0),
             "img/head/kernel": torch.full((4,), 3.0),
             "img/Transformer/encoderblock_0/MlpBlock_0/Dense_1/kernel":
                 torch.full((2,), 4.0),
             "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel":
                 torch.full((2,), 5.0),
             "txt/head/kernel": torch.full((1,), 6.0)}
    out = step._block_norms(grads)
    assert set(out) == {"l2_grad_embedding", "l2_grad_head",
                        "l2_grad_encoderblock_0"}
    np.testing.assert_allclose(float(out["l2_grad_embedding"]),
                               np.sqrt(4 * 1.0 + 3 * 4.0))
    np.testing.assert_allclose(float(out["l2_grad_head"]), 6.0)
    np.testing.assert_allclose(float(out["l2_grad_encoderblock_0"]),
                               np.sqrt(2 * 16.0))
    config = tiny_config()
    config.schedule = [("img/embedding/kernel", None),
                       (".*", dict(decay_type="cosine"))]
    port = step.create_model(config, device="cpu")
    tx, _ = optim.make(config, port, sched_kw=dict(total_steps=TOTAL))
    assert tx.frozen == {"img/embedding/kernel"}
    out = step._block_norms(grads, tx.frozen)
    np.testing.assert_allclose(float(out["l2_grad_embedding"]),
                               np.sqrt(3 * 4.0))
    # the JAX package's subtree names: "kernel", which the pattern misses
    sub = {"kernel": np.ones((2, 2)), "bias": np.full(3, 2.0)}
    with pytest.raises(ValueError, match="cover all params"):
        jax_optim.replace_frozen(config.schedule[:1], sub, 0.0)
    ref = jax_optim.replace_frozen(config.schedule, sub, 0.0)
    assert float(np.asarray(ref["kernel"]).max()) == 1.0


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
