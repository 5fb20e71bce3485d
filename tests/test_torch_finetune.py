"""CLIPA unmask-tuning in the port against clipa_tpu, on the CPU.

Random token masking, the masked ViT with remat "minimal" on the flash
route, position-embedding resampling and ``merge_params``, the npz format
both ways, ``masked_init``, and one and two fine-tune steps of
``configs/clipa_finetune.py`` cut to Ti/16 towers of depth 2 (64 px: 16
patches, 11 kept at mask 0.3, plus cls: L = 12 on the flash route; 8 text
tokens on the einsum path), all in fp32 from the same parameters (flax init
plus seeded noise, carried across with ``convert.load_jax_params``) and the
same inputs. JAX draws its masking noise from a key and the port from a
``torch.Generator``: the tests hand both the same noise, by monkeypatching
each package's ``random_masking`` (no JAX file is edited).

Tolerances. Masking, the npz round trip and ``masked_init``'s copies:
exact. Forward values and gradients: 1e-4 of each tensor's largest element,
at least a hundredth of the model's largest gradient (fp32 summation order
through two blocks; JAX under default_matmul_precision("highest"); the key
bias's gradient is 0 in exact arithmetic). Resampled position embeddings:
1e-5 absolute (both interpolate in fp32 with the same weights). The
training steps: as tests/test_torch_train_step.py states them.
"""

import functools
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
from clipa_tpu.configs import clipa_finetune
from clipa_tpu.models import common as jax_common
from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu.models import vit as jax_vit
from clipa_tpu.parallel import create_mesh
from clipa_tpu.train import checkpoint as jax_checkpoint
from clipa_tpu.train import step as jax_step
from clipa_tpu_torch import convert, losses, optim
from clipa_tpu_torch.models import common, layers, text, vit
from clipa_tpu_torch.train import checkpoint, step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_RTOL = 1e-4
POSEMB_ATOL = 1e-5
LR = 1e-3
TOTAL = 10
KEY = jax.random.PRNGKey(42)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch's
    intra-op pool from oversubscribing the cores the JAX tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_utils.tree_flatten_with_names(tree)[0]}


def _noisy_init(module, *args, seed=0, **kw):
    params = module.init({"params": jax.random.PRNGKey(seed)}, *args,
                         **kw)["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)


def _scale(grads, name):
    """A tensor's gradient scale: its largest element, at least a hundredth
    of the model's largest gradient."""
    floor = 1e-2 * max(np.abs(x).max() for x in grads.values())
    return max(np.abs(grads[name]).max(), floor)


def _check_grads(ours, ref):
    assert set(ours) == set(ref)
    for name, g in ref.items():
        err = np.abs(np.asarray(ours[name], np.float32) - g).max()
        assert err <= F32_RTOL * _scale(ref, name), (name, err)


def _fixed_noise(monkeypatch, n, l):
    """Both packages' random_masking draw the same noise: JAX's from KEY,
    whatever key its caller passes; the port's that noise, handed in."""
    noise = jax.random.uniform(KEY, (n, l))
    orig = jax_vit.random_masking
    monkeypatch.setattr(jax_vit, "random_masking",
                        lambda x, r, rng: orig(x, r, KEY))
    monkeypatch.setattr(vit, "random_masking", functools.partial(
        vit.random_masking, noise=torch.from_numpy(np.array(noise))))


@pytest.mark.parametrize("n,l,ratio", [(3, 16, 0.3), (2, 576, 0.4),
                                       (4, 49, 0.75), (2, 196, 0.0)])
def test_random_masking_matches_jax(n, l, ratio):
    x = np.random.RandomState(l).randn(n, l, 8).astype(np.float32)
    key = jax.random.PRNGKey(l)
    kept, mask, restore = jax_vit.random_masking(jnp.asarray(x), ratio, key)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (n, l))))
    ours = vit.random_masking(torch.from_numpy(x), ratio, noise=noise)
    assert ours[0].shape == (n, int(l * (1 - ratio)), 8)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(kept))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(mask))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(restore))
    assert ours[1].dtype == torch.float32
    # from a generator: a valid mask of the same size, another per seed
    draws = [vit.random_masking(torch.from_numpy(x), 0.5,
                                torch.Generator().manual_seed(s))[1]
             for s in (0, 0, 1)]
    assert all(int(d.sum()) == n * (l - int(l * 0.5)) for d in draws)
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0],
                                                               draws[2])


VIT_KW = dict(width=64, depth=2, num_heads=4, mlp_dim=128,
              patch_size=(8, 8), pool_type="gap", posemb="sincos2d",
              attn_impl="pallas")


def test_masked_vit_with_remat_matches_flax(monkeypatch):
    """The unmask-tuning tower: mask 0.3 after the position embedding, cls
    in front, the flash route at L = 26, remat "minimal" in both."""
    image = np.random.RandomState(2).randn(3, 48, 48, 3).astype(np.float32)
    w = np.random.RandomState(5).randn(3, 32).astype(np.float32)
    _fixed_noise(monkeypatch, 3, 36)
    model = jax_vit.Model(32, dtype=jnp.float32, remat_policy="minimal",
                          **VIT_KW)
    params = _noisy_init(model, image)

    def f(p):
        z, out = model.apply({"params": p}, image, train=True,
                             mask_ratio=0.3, rngs={"random_mask": KEY})
        return jnp.sum(z * w), (z, out["mask"])

    with jax.default_matmul_precision("highest"):
        (_, (ref, ref_mask)), jgrads = jax.value_and_grad(
            f, has_aux=True)(params)

    port = vit.Model(32, image_size=48, dtype="float32",
                     remat_policy="minimal", **VIT_KW).train()
    convert.load_jax_params(port, params)
    z, out = port(torch.from_numpy(image), mask_ratio=0.3)
    np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(ref_mask))
    assert int(out["mask"][0].sum()) == 36 - 25
    (z * torch.from_numpy(w)).sum().backward()
    ref = np.asarray(ref)
    assert np.abs(z.detach().numpy() - ref).max() <= F32_RTOL * np.abs(
        ref).max()
    _check_grads({k: v.numpy() for k, v in convert.to_jax_params(
        port, {k: p.grad for k, p in port.named_parameters()}).items()},
        _flat(jgrads))


def _grads(module, *args, **kw):
    module.zero_grad()
    z, _ = module(*args, **kw)
    (z * torch.linspace(-1, 1, z.numel()).reshape(z.shape)).sum().backward()
    return {k: p.grad.clone() for k, p in module.named_parameters()}


@pytest.mark.parametrize("attn_impl", ["pallas", "auto"])
def test_remat_changes_no_number(attn_impl):
    """On the CPU the gradients with remat "minimal" and with full
    recompute (any other name: "full", bench.py's "actcp") are identical,
    bit for bit, to those without (the recompute repeats the forward
    exactly)."""
    torch.manual_seed(0)
    port = vit.Model(32, image_size=48, dtype="float32",
                     **{**VIT_KW, "attn_impl": attn_impl}).train()
    layers.init_parameters(port, torch.Generator().manual_seed(0))
    image = torch.randn(3, 48, 48, 3)
    noise = torch.rand(3, 36)
    masking = functools.partial(vit.random_masking, noise=noise)
    grads = []
    for policy in REMAT_POLICIES:
        port.Transformer.remat_policy = policy
        with pytest.MonkeyPatch.context() as m:
            m.setattr(vit, "random_masking", masking)
            grads.append(_grads(port, image, mask_ratio=0.3))
    assert all(torch.isfinite(g).all() for g in grads[0].values())
    for other in grads[1:]:
        assert all(torch.equal(grads[0][k], other[k]) for k in grads[0])
    tower = text.Model(16, width=64, depth=2, num_heads=4, mlp_dim=128,
                       vocab_size=50, context_length=8).train()
    layers.init_parameters(tower, torch.Generator().manual_seed(1))
    tokens = torch.randint(1, 50, (3, 8))
    tgrads = []
    for policy in REMAT_POLICIES:
        tower.Transformer.remat_policy = policy
        tgrads.append(_grads(tower, tokens))
    for other in tgrads[1:]:
        assert all(torch.equal(tgrads[0][k], other[k]) for k in tgrads[0])
    # every name the JAX Encoder takes builds ("full" recomputes the block)
    built = text.Model(16, width=64, depth=1, num_heads=4,
                       remat_policy="full")
    assert built.Transformer.remat_policy == "full"


REMAT_POLICIES = ("none", "minimal", "full", "actcp")


@pytest.mark.parametrize("tower", ["vit", "text"])
def test_remat_replays_the_drop_masks(tower):
    """Dropout and DropPath in training: under the same generators every
    remat policy gives the gradients of the un-rematted block bit for bit
    (the recompute redraws the forward's masks from the generators' state
    at the block's entry), and other generators give other gradients."""
    torch.manual_seed(0)
    if tower == "vit":
        model = vit.Model(32, image_size=48, dtype="float32", dropout=0.1,
                          drop_path=0.3, **{**VIT_KW, "depth": 3}).train()
        inputs = (torch.randn(3, 48, 48, 3),)
    else:
        model = text.Model(16, width=64, depth=3, num_heads=4, mlp_dim=128,
                           vocab_size=50, context_length=8, dropout=0.1,
                           drop_path=0.3, causal_mask=True).train()
        inputs = (torch.randint(1, 50, (3, 8)),)
    layers.init_parameters(model, torch.Generator().manual_seed(1))

    def run(policy, seed):
        model.Transformer.remat_policy = policy
        with layers.random_streams(
                dropout=torch.Generator().manual_seed(seed),
                drop_path=torch.Generator().manual_seed(seed + 1)):
            return _grads(model, *inputs)

    ref = run("none", 0)
    for policy in REMAT_POLICIES[1:]:
        got = run(policy, 0)
        assert all(torch.equal(ref[k], got[k]) for k in ref), policy
    other = run("none", 5)
    assert any(not torch.equal(ref[k], other[k]) for k in ref)
    with pytest.raises(RuntimeError, match="random_streams"):
        model.Transformer.remat_policy = "none"
        model(*inputs)


def _tree(shapes, seed):
    rng = np.random.RandomState(seed)
    return jax_utils.recover_tree(
        list(shapes), [rng.randn(*s).astype(np.float32)
                       for s in shapes.values()])


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            jax_utils.tree_flatten_with_names(tree)[0]}


@pytest.mark.parametrize("old,new", [
    ({"img/pos_embedding": (1, 1 + 7 * 7, 16)},
     {"img/pos_embedding": (1, 1 + 14 * 14, 16)}),     # 2D grid, up
    ({"img/pos_embedding": (1, 1 + 14 * 14, 16)},
     {"img/pos_embedding": (1, 1 + 7 * 7, 16)}),       # down: antialiased
    ({"img/pos_embedding": (1, 1 + 16 * 16, 16)},
     {"img/pos_embedding": (1, 1 + 24 * 24, 16)}),     # 224 -> 336 px, /14
    ({"txt/pos_embedding": (1, 8, 16)},
     {"txt/pos_embedding": (1, 32, 16)}),              # 1D: text 8 -> 32
    ({"txt/pos_embedding": (1, 32, 16)},
     {"txt/pos_embedding": (1, 8, 16)}),
])
def test_merge_params_resamples_like_jax(old, new):
    other = {"img/head/kernel": (16, 4), "t": (1,)}
    loaded = _tree({**old, **other}, 0)
    inited = _tree({**new, **other}, 1)
    want = _flat(jax_common.merge_params(loaded, inited))
    got = {k: v.numpy() for k, v in jax_utils.tree_flatten_with_names(
        common.merge_params(_torch_tree(loaded), _torch_tree(inited)))[0]}
    assert set(got) == set(want)
    for name in other:
        np.testing.assert_array_equal(got[name], want[name])
    name = next(iter(new))
    assert got[name].shape == new[name]
    np.testing.assert_allclose(got[name], want[name], rtol=0,
                               atol=POSEMB_ATOL)


def test_merge_params_dont_load_and_mismatch():
    shapes = {"img/head/kernel": (16, 4), "img/cls": (1, 1, 16),
              "t": (1,)}
    loaded, inited = _tree(shapes, 0), _tree(shapes, 1)
    keep = ["img/head/.*"]
    want = _flat(jax_common.merge_params(loaded, inited, keep))
    got = dict(jax_utils.tree_flatten_with_names(common.merge_params(
        _torch_tree(loaded), _torch_tree(inited), keep))[0])
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value)
    np.testing.assert_array_equal(got["img/head/kernel"].numpy(),
                                  _flat(inited)["img/head/kernel"])
    # a tensor on one side only raises unless dont_load covers it
    extra = _tree({**shapes, "img/extra": (2,)}, 0)
    for merge, tree_of in ((jax_common.merge_params, lambda t: t),
                           (common.merge_params, _torch_tree)):
        with pytest.raises(ValueError, match="not covered by dont_load"):
            merge(tree_of(extra), tree_of(inited))
        merge(tree_of(extra), tree_of(inited), ["img/extra"])


@pytest.mark.parametrize("old,new", [(7, 14), (14, 7)])
def test_resample_posemb_matches_jax(old, new):
    grid = np.random.RandomState(old).randn(1, old * old, 16).astype(
        np.float32)
    want = np.asarray(jax_vit.resample_posemb(
        jnp.asarray(grid), jnp.zeros((1, new * new, 16))))
    got = vit.resample_posemb(torch.from_numpy(grid),
                              torch.zeros(1, new * new, 16))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POSEMB_ATOL)


def test_vit_load_matches_jax(tmp_path):
    """vit.load: a tower checkpoint at another resolution merged into the
    init, its learned posemb resampled; and the sincos table where
    dont_load names the posemb."""
    saved = _tree({"pos_embedding": (1, 1 + 4 * 4, 16),
                   "cls": (1, 1, 16)}, 0)
    init = _tree({"pos_embedding": (1, 1 + 6 * 6, 16), "cls": (1, 1, 16)}, 1)
    path = str(tmp_path / "tower.npz")
    jax_checkpoint.save_checkpoint(saved, path)
    for dont_load in ((), ("pos_embedding",)):
        want = _flat(jax_vit.load(init, path, dont_load=dont_load))
        got = vit.load(_torch_tree(init), path, dont_load=dont_load)
        got = {k: np.asarray(v, np.float32) for k, v in
               jax_utils.tree_flatten_with_names(got)[0]}
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=POSEMB_ATOL, err_msg=name)


def _mixed_tree(seed):
    rng = np.random.RandomState(seed)
    return {"img": {"kernel": rng.randn(4, 3).astype(np.float32),
                    "bf16": rng.randn(5).astype(jnp.bfloat16)},
            "t": np.float32(rng.randn(1))}


def test_npz_round_trip_with_jax_bit_for_bit(tmp_path):
    # the port writes, JAX reads
    tree = _mixed_tree(0)
    ours = {"img/kernel": torch.from_numpy(tree["img"]["kernel"]),
            "img/bf16": torch.from_numpy(
                tree["img"]["bf16"].view(np.int16)).view(torch.bfloat16),
            "t": torch.from_numpy(np.atleast_1d(tree["t"]))}
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(ours, path)
    back = jax_checkpoint.load_params(path)
    assert back["img"]["bf16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["img"]["bf16"]).view(np.uint16),
        tree["img"]["bf16"].view(np.uint16))
    np.testing.assert_array_equal(back["img"]["kernel"],
                                  tree["img"]["kernel"])
    # JAX writes, the port reads
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(_mixed_tree(1), path)
    got = checkpoint.load_params(path)
    want = _mixed_tree(1)
    assert got["img"]["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["img"]["bf16"].view(torch.int16)
                                  .numpy(), want["img"]["bf16"].view(
                                      np.int16))
    np.testing.assert_array_equal(got["img"]["kernel"].numpy(),
                                  want["img"]["kernel"])


def tiny_config(res=64, tokens=8):
    config = clipa_finetune.get_config(
        f"img=Ti/16,res={res},token_len={tokens},batchsize=8,"
        f"mask_ratio=0.3")
    config.model.image.update(depth=2, mlp_dim=128, attn_impl="pallas")
    config.model.text.update(depth=2, mlp_dim=128, vocab_size=100)
    config.model.dtype = "float32"
    config.lr = LR
    config.schedule = [(".*", dict(decay_type="cosine"))]
    config.log_training_steps = 2
    return config


def test_masked_init_from_a_pretrain_checkpoint(tmp_path):
    """The fine-tune model from a saved pretrain state: every tensor copied
    bit for bit but the text posemb, resampled from 8 to 32 positions as
    JAX's merge_params resamples it."""
    pre = step.create_model(tiny_config(res=32, tokens=8), device="cpu")
    state = step.init_train_state(pre, None,
                                  torch.Generator().manual_seed(0), "cpu")
    path = str(tmp_path / "pretrain.npz")
    checkpoint.save_params(convert.to_jax_params(pre), path)
    tune = step.create_model(tiny_config(res=64, tokens=32), device="cpu")
    params = step.init_train_state(tune, None,
                                   torch.Generator().manual_seed(1),
                                   "cpu")["params"]
    init_np = {k: v.detach().numpy().copy()
               for k, v in convert.to_jax_params(tune).items()}
    assert checkpoint.masked_init(tune, path) is tune
    saved = state["params"]
    for name, p in params.items():
        if name != "txt/pos_embedding":
            assert torch.equal(p, saved[name]), name
    want = _flat(jax_common.merge_params(
        jax_checkpoint.load_params(path),
        jax_utils.recover_tree(list(init_np), list(init_np.values()))))
    got = params["txt/pos_embedding"].detach().numpy()
    assert got.shape == (1, 32, 192)
    np.testing.assert_allclose(got, want["txt/pos_embedding"], rtol=0,
                               atol=POSEMB_ATOL)


def _batch(config, seed=0):
    rng = np.random.RandomState(seed)
    b = config.input.batch_size
    res = config.init_shapes[0][1]
    return {"image": rng.randint(0, 255, (b, res, res, 3), dtype=np.uint8),
            "labels": rng.randint(1, 100, (b, 8)).astype(np.int32)}


@pytest.fixture(scope="module")
def both_runs():
    """Two fine-tune steps in each package from the same parameters, batch
    and masking noise, plus the gradients of step 1."""
    config = tiny_config()
    model = jax_two_towers.Model(**dict(config.model))
    params = _noisy_init(model, jnp.zeros(config.init_shapes[0]),
                         jnp.zeros(config.init_shapes[1], jnp.int32))
    batch = _batch(config)
    with pytest.MonkeyPatch.context() as m:
        _fixed_noise(m, config.input.batch_size, 16)
        mesh = create_mesh(fsdp=1, devices=jax.devices()[:1])
        tx, _ = jax_optim.make(config, params,
                               sched_kw=dict(total_steps=TOTAL))
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        state = {"params": jp, "opt": tx.init(jp),
                 "rng": jax.random.PRNGKey(0),
                 "step": jnp.zeros((), jnp.int32)}
        update = jax_step.make_update_fn(model, tx, config, mesh,
                                         total_steps=TOTAL)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(p):
            from clipa_tpu.ops import preprocess
            zi, zt, out = model.apply(
                {"params": p}, preprocess.normalize_uint8(jbatch["image"]),
                jbatch["labels"], train=True, mask_ratio=config.mask_ratio,
                rngs={"random_mask": KEY})
            return jax_losses.bidirectional_contrastive_loss(
                zi, zt, out["t"], reduction=True)[0]

        with jax.default_matmul_precision("highest"):
            jgrads = _flat(jax.grad(loss_fn)(jp))
            jax_meas, jax_params = [], []
            for _ in range(2):
                state, meas = update(state, jbatch)
                jax_meas.append({k: float(v) for k, v in meas.items()})
                jax_params.append(_flat(state["params"]))

        port = step.create_model(config, device="cpu")
        convert.load_jax_params(port, params)
        pstate = {"params": optim.named_parameters(port), "step": 0}
        ptx, _ = optim.make(config, port, sched_kw=dict(total_steps=TOTAL))
        pupdate = step.make_update_fn(port, ptx, config, total_steps=TOTAL)
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        port.zero_grad()
        zi, zt, out = port(step.preprocess.normalize_uint8(tbatch["image"]),
                           tbatch["labels"], mask_ratio=config.mask_ratio)
        losses.bidirectional_contrastive_loss(zi, zt, out["t"],
                                              reduction=True)[0].backward()
        pgrads = {k: v.numpy() for k, v in convert.to_jax_params(
            port, {k: p.grad for k, p in port.named_parameters()}).items()}
        port.zero_grad()
        port_meas, port_params = [], []
        for _ in range(2):
            pstate, meas = pupdate(pstate, tbatch)
            port_meas.append({k: float(v) for k, v in meas.items()})
            port_params.append({k: v.numpy().copy() for k, v in
                                convert.to_jax_params(port).items()})
    return dict(jgrads=jgrads, pgrads=pgrads, jax_meas=jax_meas,
                port_meas=port_meas, jax_params=jax_params,
                port_params=port_params, pstate=pstate, port=port)


def test_finetune_config_builds_the_flash_tower_with_remat(both_runs):
    img = both_runs["port"].img
    assert img.Transformer.remat_policy == "minimal"
    mha = img.Transformer.encoderblock_0.MultiHeadDotProductAttention_0
    assert mha.attn_impl == "pallas"
    assert both_runs["port"].txt.num_pos == 8


def test_finetune_step_gradients_match(both_runs):
    _check_grads(both_runs["pgrads"], both_runs["jgrads"])


@pytest.mark.parametrize("i", [0, 1])
def test_finetune_step_loss_and_measurements_match(both_runs, i):
    ours, ref = both_runs["port_meas"][i], both_runs["jax_meas"][i]
    assert set(ours) == set(ref)
    for key, want in ref.items():
        np.testing.assert_allclose(ours[key], want, rtol=(1e-5, 1e-4)[i],
                                   atol=1e-7, err_msg=key)
    assert both_runs["pstate"]["step"] == 2


@pytest.mark.parametrize("i", [0, 1])
def test_finetune_step_new_params_match(both_runs, i):
    ours, ref = both_runs["port_params"][i], both_runs["jax_params"][i]
    jg = both_runs["jgrads"]
    for name, want in ref.items():
        sure = np.abs(jg[name]) > 1e-3 * _scale(jg, name)
        got = ours[name]
        assert np.abs(got - want).max() <= 2.5 * LR, name
        np.testing.assert_allclose(got[sure], want[sure], rtol=0,
                                   atol=(1e-3, 2e-2)[i] * LR, err_msg=name)


def test_step_masks_with_a_generator_seeded_from_the_step():
    config = tiny_config()
    a, b = (step.mask_generator(config, s, "cpu") for s in (3, 3))
    c = step.mask_generator(config, 4, "cpu")
    draws = [torch.rand(5, generator=g) for g in (a, b, c)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


def test_port_modules_import_and_finetune_without_jax(tmp_path):
    """Every module of the port, and chip_smoke.py, imports without jax; a
    tiny unmask-tuning step (masked_init from an npz, mask 0.3, remat, the
    flash route) runs without pulling it in."""
    code = f"""
import importlib, pkgutil, sys
import torch
import clipa_tpu_torch, chip_smoke
for m in pkgutil.walk_packages(clipa_tpu_torch.__path__, "clipa_tpu_torch."):
    importlib.import_module(m.name)
from clipa_tpu_torch.configs import clipa_finetune
from clipa_tpu_torch import convert, optim
from clipa_tpu_torch.ops import flash_attention
from clipa_tpu_torch.train import checkpoint, step
config = clipa_finetune.get_config(
    "img=Ti/16,res=32,token_len=8,batchsize=4,mask_ratio=0.3")
config.model.image.update(depth=1, attn_impl="pallas")
config.model.text.update(depth=1, vocab_size=50)
config.schedule = [(".*", dict(decay_type="const"))]
model = step.create_model(config, device="cpu")
state = step.init_train_state(model, config, torch.Generator().manual_seed(0),
                              "cpu")
checkpoint.save_params(convert.to_jax_params(model),
                       {str(tmp_path / 'p.npz')!r})
checkpoint.masked_init(model, {str(tmp_path / 'p.npz')!r})
tx, _ = optim.make(config, model, sched_kw=dict(total_steps=3))
update = step.make_update_fn(model, tx, config, total_steps=3)
batch = {{"image": torch.zeros(4, 32, 32, 3, dtype=torch.uint8),
         "labels": torch.ones(4, 8, dtype=torch.int32)}}
calls = []
plain = flash_attention.flash_plain_fwd
flash_attention.flash_plain_fwd = lambda *a: calls.append(1) or plain(*a)
state, meas = update(state, batch)
assert torch.isfinite(meas["training_loss"]) and len(calls) == 2
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
