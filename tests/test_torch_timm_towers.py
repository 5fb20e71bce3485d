"""The port's Swin and relpos-ViT towers, the timm ViT name table and their
open_clip maps, against clipa_tpu on the same inputs.

Tiny towers in both packages from one seeded parameter dict (flax init
plus seeded noise, carried across with ``convert.load_jax_params``):
Swin at 56 px (patch 4, window 7: a shifted 14 x 14 stage, then a 7 x 7
one the window covers), relpos-ViT at 48 px (patch 8, both coordinate
modes). The three timm configs at full width are held by their
translation and their parameter trees (the meta device against
``jax.eval_shape``); through ``create_model`` and the open_clip files, at
their tables' sizes shrunk alike in both packages.

Tolerances: forwards in fp32 at rtol 1e-5 / atol 1e-5, in bf16 at cosine
>= 0.999; gradients against ``jax.grad`` at cosine >= 0.999 per tensor;
the helpers and the maps exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu import utils as jax_utils
from clipa_tpu.compat import openclip as jax_openclip
from clipa_tpu.models import swin as jax_swin
from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu.models import vit_relpos as jax_relpos
from clipa_tpu_torch import convert
from clipa_tpu_torch.compat import export, openclip
from clipa_tpu_torch.models import (get_model_module, layers, swin,
                                    two_towers, vit_relpos)
from tests.test_torch_train_models import _DROP_RNGS, _inject_masks

TIMM_CONFIGS = ["swin_base_patch4_window7_224", "vit_medium_patch16_gap_256",
                "vit_relpos_medium_patch16_cls_224"]
SWIN = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window=7,
            patch_size=4)
RELPOS = dict(width=32, depth=2, num_heads=4, patch_size=8, rel_pos_dim=16)
# the towers: (JAX module, port module, kwargs, image size)
TOWERS = {
    "swin": (jax_swin, swin, SWIN, 56),
    "relpos_cr": (jax_relpos, vit_relpos, RELPOS, 48),
    "relpos_swinv2": (jax_relpos, vit_relpos,
                      dict(RELPOS, coords_mode="swinv2"), 48),
    "relpos_head_bias": (jax_relpos, vit_relpos,
                         dict(RELPOS, head_bias=True), 48),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(model, *inputs, seed=0):
    """flax init plus seeded noise: no parameter sits at its init value."""
    params = jax.jit(lambda r, *x: model.init({"params": r}, *x))(
        jax.random.PRNGKey(seed), *inputs)["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)


def _apply(model, params, *inputs):
    """The JAX model's forward at full fp32 matmul precision, jitted."""
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda p, *x: model.apply({"params": p}, *x))(
            params, *inputs)


def _grad(loss, params):
    """jax.grad of `loss` at `params`, jitted, at full fp32 precision, as
    {JAX name: gradient}."""
    with jax.default_matmul_precision("highest"):
        return _flat(jax.jit(jax.grad(loss))(params))


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_utils.tree_flatten_with_names(tree)[0]}


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _pair(name, dtype=None, seed=0):
    """(JAX tower, its params, the port tower holding them, images)."""
    jmod, pmod, kw, size = TOWERS[name]
    img = np.random.RandomState(seed).rand(2, size, size, 3).astype(
        np.float32)
    jm = jmod.Model(16, dtype=dtype, **kw)
    params = _init(jm, img, seed=seed)
    port = pmod.Model(16, image_size=size,
                      dtype=None if dtype is None else "bfloat16", **kw)
    convert.load_jax_params(port, params)
    return jm, params, port.eval(), img


# ------------------------------------------------------------------ towers

@pytest.mark.parametrize("name", sorted(TOWERS))
def test_tower_forward_matches_jax(name):
    jm, params, port, img = _pair(name)
    ref, _ = _apply(jm, params, img)
    with torch.no_grad():
        got, out = port(torch.tensor(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_tower_bf16_matches_jax(name):
    """bf16 compute over fp32 parameters: the scores in bf16, the bias and
    the -1e9 shift mask cast to bf16 and added there, the softmax in fp32,
    as the JAX towers order it; the serving layout (weights in bf16, the
    relpos bias MLP kept fp32) computes the same."""
    jm, params, port, img = _pair(name, dtype=jnp.bfloat16)
    ref, _ = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, img.astype(jnp.bfloat16))
    with torch.no_grad():
        x = torch.tensor(img).to(torch.bfloat16)
        got, _ = port(x)
        layers.cast_params(port, torch.bfloat16)
        served, _ = port(x)
    for row in range(img.shape[0]):
        assert _cosine(got[row], ref[row]) >= 0.999, row
    torch.testing.assert_close(served, got, rtol=0, atol=0)
    for m in port.modules():
        if isinstance(m, vit_relpos.RelPosMlpBias):
            assert m.fc1.weight.dtype == torch.float32


@pytest.mark.parametrize("name", ["swin", "relpos_cr"])
def test_tower_gradients_match_jax(name):
    jm, params, port, img = _pair(name, seed=1)
    cot = np.random.RandomState(5).normal(size=(2, 16)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, img)[0] * cot)

    ref = _grad(loss, params)
    port.train()
    (port(torch.tensor(img))[0] * torch.tensor(cot)).sum().backward()
    got = {k: v.numpy() for k, v in convert.to_jax_params(port, {
        k: p.grad for k, p in port.named_parameters()}).items()}
    assert set(got) == set(ref)
    for k in ref:
        if not np.abs(ref[k]).any():   # a ReLU that stays off: zero in both
            assert not np.abs(got[k]).any(), k
            continue
        assert _cosine(got[k], ref[k]) >= 0.999, k


@pytest.mark.parametrize("name", ["swin", "relpos_cr"])
def test_drop_path_matches_flax_with_injected_masks(name, monkeypatch):
    """Training-mode DropPath (0.3 at the last block) with the masks
    injected into both packages: per-sample masks, in the same order."""
    seen = _inject_masks(monkeypatch)
    jmod, pmod, kw, size = TOWERS[name]
    kw = dict(kw, drop_path=0.3)
    img = np.random.RandomState(2).rand(3, size, size, 3).astype(np.float32)
    jm = jmod.Model(16, **kw)
    params = _init(jm, img)
    port = pmod.Model(16, image_size=size, **kw)
    convert.load_jax_params(port, params)
    with jax.default_matmul_precision("highest"):
        ref, _ = jm.apply({"params": params}, img, train=True,
                          rngs=_DROP_RNGS)
    port.train()
    with torch.no_grad(), layers.random_streams(
            drop_path=torch.Generator().manual_seed(0)):
        got, _ = port(torch.tensor(img))
    assert seen["port"] and len(seen["port"]) == len(seen["jax"])
    assert all(np.prod(a) == np.prod(b) == 3
               for a, b in zip(seen["port"], seen["jax"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_swin_helpers_are_the_jax_towers():
    x = np.random.RandomState(0).rand(2, 14, 14, 3).astype(np.float32)
    part = swin._window_partition(torch.tensor(x), 7)
    np.testing.assert_array_equal(
        part.numpy(), np.asarray(jax_swin._window_partition(x, 7)))
    np.testing.assert_array_equal(
        swin._window_reverse(part, 7, 14, 14).numpy(), x)
    for w in (2, 7):
        np.testing.assert_array_equal(swin._relative_position_index(w),
                                      jax_swin._relative_position_index(w))
    np.testing.assert_array_equal(swin._shift_attn_mask(14, 14, 7, 3),
                                  jax_swin._shift_attn_mask(14, 14, 7, 3))


def test_relpos_helpers_are_the_jax_towers():
    for mode in ("cr", "swinv2"):
        np.testing.assert_array_equal(vit_relpos._rel_coords_log(6, 4, mode),
                                      jax_relpos._rel_coords_log(6, 4, mode))
    np.testing.assert_array_equal(vit_relpos._rel_index(6, 4),
                                  jax_relpos._rel_index(6, 4))
    with pytest.raises(ValueError, match="coords_mode"):
        vit_relpos._rel_coords_log(2, 2, "linear")


def test_swin_refuses_a_grid_the_window_does_not_divide():
    with pytest.raises(ValueError, match="not divisible by window"):
        swin.Model(16, image_size=64, **SWIN)


def test_layer_norm_epsilons_are_flax_defaults():
    for port in (swin.Model(16, image_size=56, **SWIN),
                 vit_relpos.Model(16, image_size=48, **RELPOS)):
        eps = {m.eps for m in port.modules()
               if isinstance(m, torch.nn.LayerNorm)}
        assert eps == {1e-6}


def test_model_registry_resolves_the_image_towers():
    assert get_model_module("swin") is swin
    assert get_model_module("vit_relpos") is vit_relpos
    for v in ("T", "B"):
        assert swin.decode_variant(v) == jax_swin.decode_variant(v)
    assert vit_relpos.decode_variant("M/16") == jax_relpos.decode_variant(
        "M/16")


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("name", TIMM_CONFIGS)
def test_timm_configs_translate_as_the_jax_package_does(name):
    cfg = openclip.get_model_config(name)
    assert cfg == jax_openclip.get_model_config(name)
    ours = openclip._to_two_towers_cfg(cfg)
    ref = jax_openclip._to_two_towers_cfg(cfg)
    assert ours["image"].pop("image_size") == cfg["vision_cfg"]["image_size"]
    assert {k: v for k, v in ours["text"].items()
            if k != "context_length"} == ref["text"]
    assert ours["image"] == ref["image"]
    assert ours["image_model"] == ref["image_model"]
    for k in ("text_model", "out_dim", "temperature_init"):
        assert ours[k] == ref[k], k


def test_convnext_configs_raise_naming_a10c():
    """The convnext trunks map to the ConvNeXt tower as the JAX table maps
    them; an unknown trunk raises."""
    v = jax_openclip.get_model_config("convnext_base")["vision_cfg"]
    assert openclip._timm_vision_cfg(v) == jax_openclip._timm_vision_cfg(v)
    assert openclip._timm_vision_cfg(v)[0] == "convnext"
    with pytest.raises(NotImplementedError, match="no native tower"):
        openclip._timm_vision_cfg({"timm_model_name": "deit_tiny"})


@pytest.mark.parametrize("name", TIMM_CONFIGS)
def test_timm_configs_build_the_jax_parameter_tree(name):
    """At full width, on the meta device: every parameter of the port's
    model has the name and shape of the flax model's (eval_shape); the
    vit_medium tower is the ViT at L = 257 (a cls slot, as the JAX ViT
    always has), 8 heads of 64."""
    cfg = openclip.get_model_config(name)
    size = cfg["vision_cfg"]["image_size"]
    model, _ = openclip._build(cfg, size, precision="float32",
                               device=torch.device("meta"), attn_impl="auto")
    ours = {k: tuple(v.shape)
            for k, v in convert.to_jax_params(model).items()}
    jm = jax_two_towers.Model(**jax_openclip._to_two_towers_cfg(cfg))
    shapes = jax.eval_shape(
        lambda r: jm.init({"params": r}, jnp.zeros((1, size, size, 3)),
                          jnp.zeros((1, 77), jnp.int32))["params"],
        jax.random.PRNGKey(0))
    ref = {k: tuple(v.shape)
           for k, v in jax_utils.tree_flatten_with_names(shapes)[0]}
    assert ours == ref
    if name.startswith("vit_medium"):
        assert ours["img/pos_embedding"] == (1, 257, 512)
        mha = model.img.Transformer.encoderblock_0.\
            MultiHeadDotProductAttention_0
        assert mha.num_heads == 8


TINY_TIMM = {"swin": SWIN, "vit_relpos": RELPOS,
             "vit": dict(width=32, depth=2, num_heads=2, mlp_dim=64,
                         patch_size=(8, 8))}
TINY_TEXT = {"width": 32, "heads": 2, "layers": 2, "context_length": 12,
             "vocab_size": 64}


@pytest.fixture
def tiny_timm(monkeypatch, tmp_path):
    """The timm table's towers shrunk alike in both packages, and a tiny
    copy of each timm JSON (its text tower narrowed, 56 px for Swin, 48 for
    the others): returns {config name: path}."""
    def shrink(table):
        def tiny(v):
            model, kw = table(v)
            return model, {**kw, **TINY_TIMM[model]}
        return tiny

    for module in (openclip, jax_openclip):
        monkeypatch.setattr(module, "_timm_vision_cfg",
                            shrink(module._timm_vision_cfg))
    paths = {}
    for name in TIMM_CONFIGS:
        cfg = json.loads(json.dumps(jax_openclip.get_model_config(name)))
        cfg["embed_dim"] = 16
        cfg["vision_cfg"]["image_size"] = 56 if "swin" in name else 48
        cfg["text_cfg"] = TINY_TEXT
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(cfg, f)
    return paths


@pytest.mark.parametrize("name", TIMM_CONFIGS)
def test_timm_configs_embed_as_the_jax_create_model(name, tiny_timm):
    path = tiny_timm[name]
    size = 56 if "swin" in name else 48
    img = np.random.RandomState(3).rand(2, size, size, 3).astype(np.float32)
    ids = np.random.RandomState(4).randint(1, 63, (2, 12)).astype(np.int32)
    jclip = jax_openclip.create_model(path)
    params = _init(jclip.model, img, ids)
    jclip.params = jax.tree_util.tree_map(jnp.asarray, params)
    ours = openclip.create_model(path, device="cpu")
    convert.load_jax_params(ours.model, params)
    with jax.default_matmul_precision("highest"):
        ref = (jclip.encode_image(img), jclip.encode_text(ids))
    for a, b in zip((ours.encode_image(img), ours.encode_text(ids)), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


# -------------------------------------------------------------------- maps

@pytest.mark.parametrize("name", ["swin_base_patch4_window7_224",
                                  "vit_relpos_medium_patch16_cls_224"])
def test_timm_maps_match_the_jax_maps_both_ways(name, tiny_timm):
    """JAX export -> the port's converter, the port's export -> the JAX
    converter, and each exporter against the other: bit for bit."""
    path = tiny_timm[name]
    size = 56 if "swin" in name else 48
    jm = jax_two_towers.Model(**jax_openclip._to_two_towers_cfg(
        jax_openclip.get_model_config(path)))
    params = _init(jm, np.zeros((1, size, size, 3), np.float32),
                   np.zeros((1, 12), np.int32))
    port = openclip.create_model(path, device="cpu")
    convert.load_jax_params(port.model, params)
    ref = jax_openclip.export_torch_state_dict(params)
    ours = openclip.export_torch_state_dict(port)
    assert set(ours) == set(ref)
    assert any(k.startswith("visual.trunk.") for k in ours)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    heads = openclip._heads_of(port.model)
    want = _flat(params)
    for back in (openclip.convert_torch_variables(ref, heads=heads),
                 jax_openclip.convert_torch_variables(ours, heads=heads)):
        back = _flat(back["params"])
        assert set(back) == set(want)
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_patch_merging_rows_follow_timm_order():
    """The exported ``reduction`` weight applied to timm's concatenation
    ((0,0), (1,0), (0,1), (1,1)) gives what the tower computes from its
    own ((0,0), (0,1), (1,0), (1,1)); the permutation is its own inverse."""
    merge = swin.PatchMerging(4)
    layers.init_parameters(merge, torch.Generator().manual_seed(0))
    x = torch.randn(1, 2, 2, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = merge(x)
        timm_cat = torch.cat([x[:, 0, 0], x[:, 1, 0], x[:, 0, 1],
                              x[:, 1, 1]], -1)
        kernel = merge.reduction.weight.T.numpy()
        timm_w = torch.tensor(openclip._permute_merge_rows(kernel).T)
        timm_out = merge.norm(timm_cat) @ timm_w.T
    np.testing.assert_allclose(ours[0, 0, 0].numpy(), timm_out[0].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        openclip._permute_merge_rows(openclip._permute_merge_rows(kernel)),
        kernel)


@pytest.mark.parametrize("name", TIMM_CONFIGS)
def test_timm_models_export_and_load_back_bit_for_bit(name, tiny_timm,
                                                      tmp_path):
    """save_open_clip, then create_model from the .bin: every tensor bit
    for bit (vit_medium through open_clip's ViT layout, as in the JAX
    package; Swin and relpos through timm's trunk layout)."""
    path = tiny_timm[name]
    model = openclip.create_model(path, device="cpu", seed=3)
    out = export.save_open_clip(model, path, str(tmp_path / "export"))
    loaded = openclip.create_model(path, f"{out}/{export.WEIGHTS_FILENAME}",
                                   device="cpu")
    a, b = model.model.state_dict(), loaded.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_maps_refuse_what_they_cannot_carry(tiny_timm):
    path = tiny_timm["vit_relpos_medium_patch16_cls_224"]
    port = openclip.create_model(path, device="cpu")
    sd = openclip.export_torch_state_dict(port)
    with pytest.raises(NotImplementedError, match="qkv bias"):
        openclip.convert_torch_variables(
            {**sd, "visual.trunk.blocks.0.attn.qkv.bias": np.zeros(96)})
    with pytest.raises(ValueError, match="unconsumed"):
        openclip.convert_torch_variables(
            {**sd, "visual.trunk.blocks.0.mystery": np.zeros(2)},
            heads=openclip._heads_of(port.model))
    # a ConvNeXt stem makes the dicts a ConvNeXt's, whose other entries
    # they lack
    with pytest.raises(KeyError, match="visual.trunk.stem.0.bias"):
        openclip.convert_torch_variables(
            {**sd, "visual.trunk.stem.0.weight": np.zeros((4, 3, 4, 4))})
    flat = openclip._jax_layout_flat(port)
    with pytest.raises(KeyError, match="img/embedding/kernel"):
        openclip.export_torch_state_dict(
            {**flat, "img/downsample_layers01/scale": np.ones(4)})
