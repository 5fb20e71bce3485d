"""clipa_tpu_torch.optim against clipa_tpu.optim (optax), on the same inputs.

Schedules: every decay family and the warmup/cooldown envelope, in every
duration unit, at every step; rtol 1e-6 plus one fp32 ulp of the peak (6e-8
at 0.5): the port evaluates in float64 and rounds to fp32 once, JAX in fp32
throughout, where cos(pi * frac) carries an absolute error of an ulp of its
O(1) value.

The chain: a small tree of named parameters with JAX names and layouts,
three steps of identical gradients through ``optim.make`` of both packages.
Updates, parameters and the second moment at rtol 1e-5 (fp32: the bias
correction and the clip norm's summation order differ by an ulp); the bf16
first moment to one bf16 ulp (2^-7 relative: an fp32 difference of an ulp
can round to the neighbouring bf16 value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clipa_tpu import optim as jax_optim
from clipa_tpu import utils as jax_utils
from clipa_tpu.config import ConfigDict
from clipa_tpu_torch import optim

SHAPES = {
    "img/embedding/kernel": (4, 4, 3, 8),
    "img/cls": (1, 1, 8),
    "img/Transformer/encoderblock_0/LayerNorm_0/scale": (8,),
    "img/Transformer/encoderblock_0/MultiHeadDotProductAttention_0/query/"
    "kernel": (8, 2, 4),
    "img/Transformer/encoderblock_0/MultiHeadDotProductAttention_0/query/"
    "bias": (2, 4),
    "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel": (8, 16),
    "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/bias": (16,),
    "img/head/kernel": (8, 4),
    "txt/Embed_0/embedding": (10, 8),
    "txt/pos_embedding": (1, 3, 8),
    "txt/head/kernel": (8, 4),
    "t": (1,),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCHEDULES = [
    dict(decay_type="linear", warmup_steps=3, cooldown_steps=2),
    dict(decay_type="polynomial", power=2, end=0.1, warmup_percent=0.2),
    dict(decay_type="cosine", min_lr=0.1, max_lr=1.0, warmup_examples=64),
    dict(decay_type="cosine"),
    dict(decay_type="rsqrt", timescale=5, warmup_steps=3),
    dict(decay_type="const", warmup_steps=4, cooldown_percent=0.25),
    dict(decay_type="stair", steps=[5, 10], mults=[0.5, 0.1],
         warmup_epochs=1),
    dict(decay_type="cosine", scale_with_batchsize=True, warmup_steps=2),
]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=[f"{s['decay_type']}{i}"
                              for i, s in enumerate(SCHEDULES)])
def test_schedules_match_jax(kw):
    sched_kw = dict(total_steps=20, batch_size=32, data_size=128)
    ref = jax_optim.create_learning_rate_schedule(base=0.5, **sched_kw, **kw)
    ours = optim.create_learning_rate_schedule(base=0.5, **sched_kw, **kw)
    for step in range(21):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(ours(step), want, rtol=1e-6, atol=6e-8,
                                   err_msg=f"step {step}")
    with pytest.raises(ValueError, match="decay_type"):
        optim.create_learning_rate_schedule(total_steps=5,
                                            decay_type="nope")


def _config(**kw):
    base = dict(
        lr=1e-2, wd=0.2,
        optax_name="scale_by_adam",
        optax=dict(b1=0.9, b2=0.95, mu_dtype="bfloat16"),
        schedule=[("img/head/.*", None),
                  ("txt/.*", dict(decay_type="linear", warmup_steps=1)),
                  (".*", dict(decay_type="cosine"))],
        grad_clip_norm=0.5,
        lr_mults=[("img/Transformer/.*", 2.0)],
    )
    base.update(kw)
    return ConfigDict(**base)


def _run_both(config, steps=3, seed=0):
    rng = np.random.RandomState(seed)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(steps)]
    tree = jax_utils.recover_tree(list(params), list(params.values()))
    sched_kw = dict(total_steps=10)
    tx, _ = jax_optim.make(config, tree, sched_kw=sched_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jp)
    ours_params = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ours, _ = optim.make(config, ours_params, sched_kw=sched_kw)
    history = []
    for g in grads:
        with jax.default_matmul_precision("highest"):
            jg = jax.tree_util.tree_map(
                jnp.asarray, jax_utils.recover_tree(list(g), list(g.values())))
            updates, state = tx.update(jg, state, jp)
            jp = optax.apply_updates(jp, updates)
        upd = ours.update({n: torch.from_numpy(a) for n, a in g.items()})
        ours.apply(upd)
        snapshot = optim.Optimizer.__new__(optim.Optimizer)
        snapshot.params = {n: p.clone() for n, p in ours.params.items()}
        snapshot.mu = {n: m.clone() for n, m in ours.mu.items()}
        snapshot.nu = {n: m.clone() for n, m in ours.nu.items()}
        history.append((dict(jax_utils.tree_flatten_with_names(updates)[0]),
                        dict(jax_utils.tree_flatten_with_names(jp)[0]),
                        state, upd, snapshot))
    return history


def _adam_state(state):
    (adam,) = jax_optim.find_states(state, optax.ScaleByAdamState)
    flat = lambda t: {n: v for n, v in jax_utils.tree_flatten_with_names(t)[0]
                      if not isinstance(v, optax.MaskedNode)}
    return flat(adam.mu), flat(adam.nu)


@pytest.mark.parametrize("variant", ["clip_wd_frozen_mults", "plain_fp32"])
def test_chain_matches_optax_for_three_steps(variant):
    config = (_config() if variant == "clip_wd_frozen_mults" else _config(
        grad_clip_norm=None, lr_mults=None,
        optax=dict(b1=0.9, b2=0.999, mu_dtype="float32", eps=1e-6),
        schedule=[(".*", dict(decay_type="const", warmup_steps=2))]))
    for step, (j_upd, j_params, j_state, upd, ours) in enumerate(
            _run_both(config)):
        for name in SHAPES:
            np.testing.assert_allclose(
                upd[name].numpy(), np.asarray(j_upd[name]), rtol=1e-5,
                atol=1e-9, err_msg=f"update {name} step {step}")
            np.testing.assert_allclose(
                ours.params[name].numpy(), np.asarray(j_params[name]),
                rtol=1e-6, atol=1e-8, err_msg=f"param {name} step {step}")
        mu, nu = _adam_state(j_state)
        assert set(mu) == set(ours.mu)       # frozen leaves have no moments
        for name in mu:
            assert ours.mu[name].dtype == (
                torch.bfloat16 if variant == "clip_wd_frozen_mults"
                else torch.float32)
            np.testing.assert_allclose(
                ours.mu[name].float().numpy(),
                np.asarray(mu[name].astype(jnp.float32)), rtol=2 ** -7,
                atol=1e-30, err_msg=f"mu {name}")
            np.testing.assert_allclose(
                ours.nu[name].numpy(), np.asarray(nu[name]), rtol=1e-5,
                err_msg=f"nu {name}")
    if variant == "clip_wd_frozen_mults":
        # the frozen head never moved
        np.testing.assert_array_equal(
            ours.params["img/head/kernel"].numpy(),
            np.asarray(j_params["img/head/kernel"]))


def test_fused_adam_matches_clipa_fused_adam():
    config = _config(optax_name="scale_by_fused_adam",
                     optax=dict(b1=0.9, b2=0.95, mu_dtype="bfloat16",
                                nu_dtype="bfloat16", small_leaf_elems=64))
    for step, (j_upd, j_params, _, upd, ours) in enumerate(
            _run_both(config, seed=1)):
        for name in SHAPES:
            np.testing.assert_allclose(
                upd[name].numpy(), np.asarray(j_upd[name]), rtol=1e-5,
                atol=1e-9, err_msg=f"update {name} step {step}")
        assert ours.nu[next(iter(ours.nu))].dtype == torch.bfloat16


def test_decay_mask_is_the_kernel_regex_on_jax_names():
    ours, _ = optim.make(_config(), {n: torch.zeros(s)
                                     for n, s in SHAPES.items()},
                         sched_kw=dict(total_steps=10))
    assert set(ours.wd) == {n for n in SHAPES if n.endswith("/kernel")}
    assert ours.frozen == {"img/head/kernel"}
    assert all(ours.wd[n] == pytest.approx(0.2) for n in ours.wd)


def test_refusals():
    params = {n: torch.zeros(s) for n, s in SHAPES.items()}
    kw = dict(sched_kw=dict(total_steps=10))
    with pytest.raises(NotImplementedError, match="optax_name"):
        optim.make(_config(optax_name="scale_by_lion"), params, **kw)
    with pytest.raises(ValueError, match="nesterov"):
        optim.make(_config(optax=dict(nesterov=True)), params, **kw)
    with pytest.raises(ValueError, match="weight_decay"):
        optim.make(_config(weight_decay=0.1), params, **kw)
    with pytest.raises(ValueError, match="cover all params"):
        optim.make(_config(schedule=[("img/.*", dict(decay_type="const"))]),
                   params, **kw)
    with pytest.raises(ValueError, match="lr_mults"):
        optim.make(_config(lr_mults=[(".*", 0.0)]), params, **kw)


# --------------------------------------------------------------------------
# config.lwd: layer-wise lr decay over the image tower
# --------------------------------------------------------------------------

LWD = 0.85


def _model_names(arg):
    """The JAX flat names of the pretrain config's two-towers at `arg`
    (built on the meta device: names only)."""
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch.train import step
    config = clipa_pretrain.get_config(arg)
    names = list(optim.named_parameters(step.create_model(config, "meta")))
    return config.model.image.variant, names + ["img/pos_embedding"]


def _update_multipliers(names, variant, lwd, port):
    """Each name's update on one step of ones through the chain with
    `lwd`, over the same step without it (lr 1, const schedule, no wd, no
    clip): the multiplier the chain applies, in the port or in optax."""
    out = []
    for decay in (lwd, None):
        config = _config(lr=1.0, wd=None, grad_clip_norm=None,
                         lr_mults=None, lwd=decay,
                         schedule=[(".*", dict(decay_type="const"))],
                         model=ConfigDict(image=ConfigDict(variant=variant)))
        if port:
            ours, _ = optim.make(config, {n: torch.zeros(1) for n in names},
                                 sched_kw=dict(total_steps=10))
            upd = ours.update({n: torch.ones(1) for n in names})
            out.append({n: float(u[0]) for n, u in upd.items()})
        else:
            tree = jax_utils.recover_tree(names, [jnp.zeros(1)] * len(names))
            tx, _ = jax_optim.make(config, tree, sched_kw=dict(total_steps=10))
            upd, _ = tx.update(jax.tree_util.tree_map(jnp.ones_like, tree),
                               tx.init(tree), tree)
            out.append({n: float(u[0]) for n, u in
                        jax_utils.tree_flatten_with_names(upd)[0]})
    return {n: out[0][n] / out[1][n] for n in names}


@pytest.mark.parametrize("arg", [
    "img=L/16,res=112,token_len=8,batchsize=384",
    "img=H/14,res=84,token_len=8,batchsize=256",
    "img=B/16,res=112,token_len=16,batchsize=64"])
def test_lwd_multipliers_match_jax_on_blocks_and_text(arg):
    variant, names = _model_names(arg)
    ours = _update_multipliers(names, variant, LWD, port=True)
    ref = _update_multipliers(names, variant, LWD, port=False)
    depth = {"L/16": 24, "H/14": 32, "B/16": 12}[variant]
    checked = [n for n in names if "encoderblock_" in n
               or n.startswith("txt/") or n == "t"]
    assert len(checked) > depth
    for name in checked:
        np.testing.assert_allclose(ours[name], ref[name], rtol=1e-6,
                                   err_msg=name)
        if name.startswith("img/"):
            block = int(name.split("encoderblock_")[1].split("/")[0])
            np.testing.assert_allclose(ours[name], LWD ** (depth - block),
                                       rtol=1e-6, err_msg=name)
        else:
            assert ours[name] == 1.0, name   # text tower and t untouched
    # the stem, cls and a learned posemb one step below block 0; the head
    # and encoder_norm at 1
    stem = [n for n in names if n.startswith("img/embedding/")]
    for name in stem + ["img/cls", "img/pos_embedding"]:
        np.testing.assert_allclose(ours[name], LWD ** (depth + 1),
                                   rtol=1e-6, err_msg=name)
    rest = [n for n in names if n.startswith(("img/head/",
                                              "img/encoder_norm/"))]
    assert stem and rest
    for name in rest:
        assert ours[name] == 1.0, name


def test_reference_lwd_misses_the_stem():
    """The JAX package's stem patterns (``embedding.*``, ``cls.*``,
    ``pos_embedding.*``) are fullmatched against two-towers names that
    start with ``img/``, so there the stem, cls and posemb train at the
    full rate: the JAX chain leaves them at 1 where the port applies
    ``lwd ** (depth + 1)`` (ROADMAP C). The blocks agree."""
    variant, names = _model_names("img=L/16,res=112,token_len=8,"
                                  "batchsize=384")
    ours = _update_multipliers(names, variant, LWD, port=True)
    ref = _update_multipliers(names, variant, LWD, port=False)
    for name in ("img/embedding/kernel", "img/cls", "img/pos_embedding"):
        assert ref[name] == 1.0, name
        np.testing.assert_allclose(ours[name], LWD ** 25, rtol=1e-6)
    block = "img/Transformer/encoderblock_23/MlpBlock_0/Dense_0/kernel"
    np.testing.assert_allclose(ours[block], ref[block], rtol=1e-6)
    np.testing.assert_allclose(ours[block], LWD, rtol=1e-6)


def test_lwd_chain_matches_optax_off_the_stem_for_three_steps():
    """The whole chain with lwd beside clip, wd, lr_mults and a frozen
    group: every update but the stem's (the reference fault above) at the
    chain test's rtol 1e-5."""
    config = _config(lwd=0.8, model=ConfigDict(image=ConfigDict(
        variant="Ti/16")))
    stem = {"img/embedding/kernel", "img/cls"}
    for step, (j_upd, _, _, upd, _) in enumerate(_run_both(config, seed=2)):
        for name in set(SHAPES) - stem:
            np.testing.assert_allclose(
                upd[name].numpy(), np.asarray(j_upd[name]), rtol=1e-5,
                atol=1e-9, err_msg=f"update {name} step {step}")
