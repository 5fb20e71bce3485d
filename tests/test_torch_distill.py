"""Distillation from a frozen teacher in the port (losses, the update step,
the trainer) against clipa_tpu's, on the CPU.

  * ``distill_contrastive_loss`` against the JAX loss on seeded embeddings
    (rtol 1e-5 on each term and the total), and no gradient reaches the
    teacher's inputs;
  * two update steps with a teacher in each package, the student and the
    teacher two tiny fp32 two-towers (Ti/16 of depth 2 at 96 px, 8 text
    tokens; the teacher's parameters drawn from another seed), from one
    flat parameter dict per model carried across with
    ``convert.load_jax_params``, unmasked and at mask 0.3 with the same
    masking noise in both packages (the teacher sees the unmasked images):
    the gradients each package hands its optimizer within 1e-4 of each
    gradient's scale (the largest element, at least a hundredth of the
    model's largest gradient, as tests/test_torch_train_step.py holds
    them), the measurements at rtol 1e-5; the teacher's parameters come
    out of the steps unchanged;
  * the guards (``loss`` softmax, no gradient accumulation);
  * both trainers on the smoke config with ``config.distill.model_init``
    an npz the JAX package wrote and the student from one masked_init
    npz: 3 steps, ``training_loss``, ``contrastive_loss`` and
    ``distill_loss`` within rtol 1e-5 at step 1 and 1e-4 after (as
    tests/test_torch_train_loop.py's loss parity), and the teacher equal
    to the npz bit for bit after the run.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clipa_tpu import losses as jax_losses
from clipa_tpu import optim as jax_optim
from clipa_tpu import utils as jax_utils
from clipa_tpu.config import ConfigDict as JaxConfigDict
from clipa_tpu.config import load_config as jax_load_config
from clipa_tpu.configs import clipa_pretrain
from clipa_tpu.models import get_model_module as jax_get_model_module
from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu.models import vit as jax_vit
from clipa_tpu.parallel import create_mesh
from clipa_tpu.pp import ops_text as jax_ops_text
from clipa_tpu.pp import tokenizer as jax_tokenizer
from clipa_tpu.train import checkpoint as jax_checkpoint
from clipa_tpu.train import loop as jax_loop
from clipa_tpu.train import step as jax_step
from clipa_tpu_torch import convert, losses, optim, utils
from clipa_tpu_torch.config import ConfigDict, load_config
from clipa_tpu_torch.models import vit
from clipa_tpu_torch.train import loop, step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "clipa_tpu_torch", "configs", "smoke.py")
JAX_SMOKE = os.path.join(REPO, "clipa_tpu", "configs", "smoke.py")
LR = 1e-3
TOTAL = 10
NOISE_KEY = jax.random.PRNGKey(7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _embeddings(b=16, c=8, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(b, c).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


@pytest.mark.parametrize("b,c,t,t_t", [(16, 8, 10.0, 50.0), (7, 32, 1.0, 1.0),
                                       (64, 16, 100.0, 14.3)])
def test_loss_matches_the_jax_loss(b, c, t, t_t):
    z = [_embeddings(b, c, seed=i) for i in range(4)]
    total, extras = losses.distill_contrastive_loss(
        *map(torch.from_numpy, z[:2]), torch.tensor([t]),
        *map(torch.from_numpy, z[2:]), torch.tensor([t_t]))
    j_total, j_extras = jax_losses.distill_contrastive_loss(
        *map(jnp.asarray, z[:2]), jnp.asarray([t]), *map(jnp.asarray, z[2:]),
        jnp.asarray([t_t]))
    assert set(extras) == set(j_extras) == {"contrastive_loss",
                                            "distill_loss", "ncorrect"}
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-5)
    for key, want in j_extras.items():
        np.testing.assert_allclose(float(extras[key]), float(want),
                                   rtol=1e-5, err_msg=key)


def test_no_gradient_reaches_the_teacher():
    z = [torch.from_numpy(_embeddings(seed=i)).requires_grad_()
         for i in range(4)]
    t = torch.tensor([8.0], requires_grad=True)
    t_t = torch.tensor([30.0], requires_grad=True)
    total, _ = losses.distill_contrastive_loss(z[0], z[1], t, z[2], z[3],
                                               t_t)
    total.backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0
               for x in (z[0], z[1], t))
    assert z[2].grad is None and z[3].grad is None and t_t.grad is None


def test_distill_term_is_least_where_the_student_is_the_teacher():
    z, w = (torch.from_numpy(_embeddings(seed=s)) for s in (4, 5))
    t = torch.tensor([12.0])
    same = losses.distill_contrastive_loss(z, w, t, z, w, t)[1]
    other = losses.distill_contrastive_loss(
        *(torch.from_numpy(_embeddings(seed=s)) for s in (6, 7)), t, z, w,
        t)[1]
    assert float(same["distill_loss"]) < float(other["distill_loss"])


# ---------------------------------------------------------------------------
# the update step against the JAX step
# ---------------------------------------------------------------------------

def tiny_config(mask_ratio=0.0):
    config = clipa_pretrain.get_config(
        "img=Ti/16,res=96,token_len=8,batchsize=8")
    config.model.image.update(depth=2, mlp_dim=128)
    config.model.text.update(depth=2, mlp_dim=128, vocab_size=100)
    config.model.dtype = "float32"
    config.lr = LR
    config.schedule = [(".*", dict(decay_type="cosine"))]
    config.log_training_steps = 2
    config.mask_ratio = mask_ratio
    return config


def _jax_params(config, seed):
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


def _batch(config, seed=0):
    rng = np.random.RandomState(seed)
    b = config.input.batch_size
    res = config.init_shapes[0][1]
    return {"image": rng.randint(0, 255, (b, res, res, 3), dtype=np.uint8),
            "labels": rng.randint(1, 100, (b, 8)).astype(np.int32)}


def _fixed_noise(monkeypatch, n, l):
    """Both packages' random_masking draw the same (n, l) noise."""
    noise = jax.random.uniform(NOISE_KEY, (n, l))
    orig = jax_vit.random_masking
    monkeypatch.setattr(jax_vit, "random_masking",
                        lambda x, r, rng: orig(x, r, NOISE_KEY))
    monkeypatch.setattr(vit, "random_masking", functools.partial(
        vit.random_masking, noise=torch.from_numpy(np.array(noise))))


def _distilled_runs(config, steps=2):
    """`steps` distilled update steps in each package from the same student
    and teacher parameters and batch, each optimizer's update wrapped to
    record its gradients. Returns (JAX grads, port grads, JAX
    measurements, port measurements, teacher params before, port teacher
    after)."""
    model, params = _jax_params(config, 0)
    _, t_params = _jax_params(config, 11)
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
                                     total_steps=TOTAL, teacher_model=model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jt = jax.tree_util.tree_map(jnp.asarray, t_params)
    jmeas, jparams = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(steps):
            state, meas = update(state, jbatch, jt)
            jmeas.append({k: float(v) for k, v in meas.items()})
            jparams.append(_flat(state["params"]))
    jax.effects_barrier()

    port = step.create_model(config, device="cpu")
    convert.load_jax_params(port, params)
    teacher = step.create_model(config, device="cpu")
    convert.load_jax_params(teacher, t_params)
    teacher.requires_grad_(False)
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
    pupdate = step.make_update_fn(port, ptx, config, total_steps=TOTAL,
                                  teacher_model=teacher)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pmeas = []
    for i in range(steps):
        if i:   # from the JAX step's parameters (test_torch_train_step.py)
            convert.load_jax_params(port, jparams[i - 1])
        pstate, meas = pupdate(pstate, tbatch)
        pmeas.append({k: float(v) for k, v in meas.items()})
    teacher_after = {k: v.numpy().copy() for k, v in
                     convert.to_jax_params(teacher).items()}
    return jgrads, pgrads, jmeas, pmeas, _flat(t_params), teacher_after


@pytest.fixture(scope="module", params=[0.0, 0.3], ids=["unmasked",
                                                         "mask0.3"])
def distilled_runs(request):
    config = tiny_config(request.param)
    with pytest.MonkeyPatch.context() as m:
        if request.param:
            _fixed_noise(m, config.input.batch_size, 36)  # 96 px / 16: 36
        return _distilled_runs(config)


def _scale(grads, name):
    floor = 1e-2 * max(np.abs(x).max() for x in grads.values())
    return max(np.abs(grads[name]).max(), floor)


@pytest.mark.parametrize("i", [0, 1])
def test_distilled_step_gradients_match(distilled_runs, i):
    jg, pg = distilled_runs[0][i], distilled_runs[1][i]
    assert set(jg) == set(pg)
    for name, g in jg.items():
        err = np.abs(pg[name] - g).max()
        assert err <= 1e-4 * _scale(jg, name), (name, err)


@pytest.mark.parametrize("i", [0, 1])
def test_distilled_step_measurements_match(distilled_runs, i):
    ours, ref = distilled_runs[3][i], distilled_runs[2][i]
    assert set(ours) == set(ref)
    assert {"contrastive_loss", "distill_loss"} <= set(ours)
    for key, want in ref.items():
        np.testing.assert_allclose(ours[key], want, rtol=(1e-5, 1e-4)[i],
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(
        ours["training_loss"], ours["contrastive_loss"]
        + ours["distill_loss"], rtol=1e-6)


def test_the_teacher_stays_frozen(distilled_runs):
    before, after = distilled_runs[4], distilled_runs[5]
    assert before.keys() == after.keys()
    for name, want in before.items():
        np.testing.assert_array_equal(after[name], want, err_msg=name)


@pytest.mark.parametrize("change,match", [
    (dict(loss="sigmoid"), "softmax"), (dict(loss="chunked"), "softmax"),
    (dict(grad_accum_steps=2), "grad_accum_steps")])
def test_guards(change, match):
    config = tiny_config()
    config.update(change)
    port = step.create_model(config, device="cpu")
    tx, _ = optim.make(config, port, sched_kw=dict(total_steps=TOTAL))
    with pytest.raises(ValueError, match=match):
        step.make_update_fn(port, tx, config, teacher_model=port)
    jax_config = JaxConfigDict(dict(config))
    with pytest.raises(ValueError, match=match.split("_")[0]):
        jax_step.make_update_fn(jax_two_towers.Model(**dict(config.model)),
                                optax.identity(), jax_config,
                                create_mesh(fsdp=1,
                                            devices=jax.devices()[:1]),
                                teacher_model=object())


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """Both trainers, 3 steps of the fp32 smoke config, the student from one
    masked_init npz and the teacher (seed 3, then distill.model_init) from
    an npz of other parameters, both written by the JAX package."""
    root = tmp_path_factory.mktemp("distill_loop")
    spec = "steps=3,batch=16"
    config = jax_load_config(f"{JAX_SMOKE}:{spec}")
    model = jax_get_model_module("two_towers").Model(**dict(config.model))
    paths = {}
    for name, seed in (("student", 7), ("teacher", 11)):
        params = model.init(
            {"params": jax.random.PRNGKey(seed)},
            jnp.zeros(config.init_shapes[0], jnp.float32),
            jnp.zeros(config.init_shapes[1], jnp.int32),
            train=False)["params"]
        paths[name] = str(root / f"{name}.npz")
        jax_checkpoint.save_checkpoint({"params": params}, paths[name])

    def prepare(config, config_dict):
        config.masked_init = paths["student"]
        config.log_training_steps = 1
        config.save_ckpt = False
        config.export_npz = False
        config.distill = config_dict(model_name="two_towers",
                                     model=config.model.copy(), seed=3,
                                     model_init=paths["teacher"])
        return config

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ops_text, "get_tokenizer", lambda path: (
            jax_tokenizer.get_tokenizer(path, backend="python")))
        jax_loop.train(prepare(config, JaxConfigDict), str(root / "jax"))
    teachers = []
    build = loop._build_teacher

    def keep(*args, **kw):
        teachers.append(build(*args, **kw))
        return teachers[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_build_teacher", keep)
        config = prepare(load_config(f"{SMOKE}:{spec}"), ConfigDict)
        config.local_stage_dir = str(root / "stage")   # a file:// workdir
        state = loop.train(config, f"file://{root}/torch", device="cpu")
    return (_rows(str(root / "jax")), _rows(str(root / "torch")), teachers,
            paths["teacher"], state)


def test_distilled_loss_matches_the_jax_loop(loop_runs):
    want, got = loop_runs[:2]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        rtol = 1e-5 if w["step"] == 1 else 1e-4
        for key in ("training_loss", "contrastive_loss", "distill_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"{key} step {w['step']}")


def test_the_loops_teacher_is_the_jax_npz_and_stays_frozen(loop_runs):
    teachers, path, state = loop_runs[2:]
    assert len(teachers) == 1
    teacher = teachers[0]
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    want = dict(utils.tree_flatten_with_names(
        jax_checkpoint.load_params(path)))
    got = convert.to_jax_params(teacher)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)
    # the student's optimizer and state hold none of the teacher's tensors
    ids = {id(p) for p in teacher.parameters()}
    assert not ids & {id(p) for p in state["params"].values()}
