"""clipa_tpu_torch towers vs the flax towers, on the same parameters.

Each case inits the flax module, perturbs every parameter with seeded numpy
noise (so zero-initialized biases and unit LayerNorm scales are exercised),
carries the tree across with ``convert.load_jax_params`` and runs both on
the same numpy input in fp32, JAX under default_matmul_precision("highest").
Image inputs are 48 px with patch 8, so L = 37 >= 33 and the port takes the
fused attention branch (its plain version on the CPU) while flax off-TPU
takes the einsum path. Tolerance 1e-4 on outputs of order one: fp32
summation order through two blocks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu import utils as jax_utils
from clipa_tpu.compat import openclip as jax_openclip
from clipa_tpu.models import layers as jax_layers
from clipa_tpu.models import text as jax_text
from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu.models import vit as jax_vit
from clipa_tpu_torch import convert
from clipa_tpu_torch.compat import openclip
from clipa_tpu_torch.models import get_model_module, layers, text, two_towers
from clipa_tpu_torch.models import vit

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch's
    intra-op pool from oversubscribing the cores the JAX tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TINY_CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 48, "layers": 2, "width": 64,
                   "head_width": 16, "patch_size": 8,
                   "gelu_approximate": "tanh", "ln_pre": False,
                   "pool_style": "big_vision_gap",
                   "global_average_pool": True},
    "text_cfg": {"context_length": 8, "vocab_size": 100, "width": 64,
                 "heads": 4, "layers": 2, "bert_tokenizer": True,
                 "gelu_approximate": "tanh",
                 "pool_style": "big_vision_last", "attention_mask": False},
}


def _init(module, *args, seed=0, **kw):
    params = module.init({"params": jax.random.PRNGKey(seed)}, *args,
                         **kw)["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)


def _apply(module, params, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return module.apply({"params": params}, *args, **kw)


def _unit(x):
    x = np.asarray(x, np.float64)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("gelu", [True, False, "quick"])
@pytest.mark.parametrize("ls_init", [None, 0.5])
@pytest.mark.parametrize("layout", ["flat", "3d_causal"])
def test_encoder_block_matches_flax(gelu, ls_init, layout):
    b, l, d, h = 2, 37, 64, 4
    rng = np.random.RandomState(1)
    x = rng.randn(b, l, d).astype(np.float32)
    if layout == "flat":
        x, seq_len, mask = x.reshape(b * l, d), l, None
    else:
        seq_len, mask = None, np.tril(np.ones((l, l), bool))[None, None]
    block = jax_layers.EncoderBlock(num_heads=h, gelu_approx=gelu,
                                    ln_eps=1e-5, ls_init=ls_init,
                                    seq_len=seq_len)
    params = _init(block, x, True, mask)
    ref = _apply(block, params, x, True, mask)

    port = layers.EncoderBlock(d, h, gelu_approx=gelu, ln_eps=1e-5,
                               ls_init=ls_init).eval()
    convert.load_jax_params(port, params)
    with torch.inference_mode():
        out = port(torch.from_numpy(x),
                   mask=None if mask is None else torch.from_numpy(mask),
                   seq_len=seq_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("pool,posemb,ln_pre", [
    ("gap", "learn", False),        # CLIPA-v2 BigVision (H/14's layout)
    ("gap_all", "sincos2d", True),
    ("tok", "learn", True),
    ("0", "learn", False),
])
def test_vit_matches_flax(pool, posemb, ln_pre):
    kw = dict(width=64, depth=2, num_heads=4, mlp_dim=128,
              patch_size=(8, 8), pool_type=pool, posemb=posemb,
              ln_pre=ln_pre, gelu_approx=True, ln_eps=1e-5)
    image = np.random.RandomState(2).randn(3, 48, 48, 3).astype(np.float32)
    model = jax_vit.Model(32, **kw)
    params = _init(model, image)
    ref, ref_out = _apply(model, params, image)

    port = vit.Model(32, image_size=48, **kw).eval()
    convert.load_jax_params(port, params)
    with torch.inference_mode():
        out, out_d = port(torch.from_numpy(image))
    assert out.shape == (3, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(out_d["encoded"].numpy(),
                               np.asarray(ref_out["encoded"]), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(_unit(out), _unit(ref), atol=ATOL)


@pytest.mark.parametrize("pool,causal", [
    ("last", False),                # CLIPA-v2 BigVision text tower
    ("tok", True), ("gap", False), ("eot", True),
])
def test_text_tower_matches_flax(pool, causal):
    kw = dict(width=64, depth=2, num_heads=4, mlp_dim=128, vocab_size=100,
              pool_type=pool, causal_mask=causal, gelu_approx=True,
              ln_eps=1e-5)
    tokens = np.random.RandomState(3).randint(1, 100, (3, 8)).astype(
        np.int32)
    model = jax_text.Model(32, **kw)
    params = _init(model, tokens)
    ref, _ = _apply(model, params, tokens)

    port = text.Model(32, context_length=8, **kw).eval()
    convert.load_jax_params(port, params)
    with torch.inference_mode():
        out, _ = port(torch.from_numpy(tokens))
    np.testing.assert_allclose(_unit(out), _unit(ref), atol=ATOL)


def test_two_towers_matches_flax():
    cfg = TINY_CFG
    model = jax_two_towers.Model(**jax_openclip._to_two_towers_cfg(cfg))
    rng = np.random.RandomState(4)
    image = rng.randn(2, 48, 48, 3).astype(np.float32)
    tokens = rng.randint(1, 100, (2, 8)).astype(np.int32)
    params = _init(model, image[:1], tokens[:1])
    zimg_ref, ztxt_ref, out_ref = _apply(model, params, image, tokens)

    port = two_towers.Model(**openclip._to_two_towers_cfg(cfg)).eval()
    convert.load_jax_params(port, params)
    with torch.inference_mode():
        zimg, ztxt, out = port(torch.from_numpy(image),
                               torch.from_numpy(tokens))
    np.testing.assert_allclose(zimg.numpy(), np.asarray(zimg_ref), atol=ATOL)
    np.testing.assert_allclose(ztxt.numpy(), np.asarray(ztxt_ref), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(zimg.numpy(), axis=1), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(out["t"].numpy(), np.asarray(out_ref["t"]),
                               rtol=1e-6)


@pytest.mark.parametrize("name", [
    "ViT-B-16-CL32-GAP-BigVision", "ViT-H-14-CL32-GAP-BigVision",
    "ViT-L-14-CL32-GAP-BigVision", "ViT-L-16-CL32-GAP-BigVision",
    "ViT-bigG-14-CL32-GAP-BigVision"])
def test_config_translation_matches_jax(name):
    cfg = openclip.get_model_config(name)
    ours = openclip._to_two_towers_cfg(cfg)
    ref = jax_openclip._to_two_towers_cfg(cfg)
    image = {k: v for k, v in ours["image"].items() if k != "image_size"}
    txt = {k: v for k, v in ours["text"].items() if k != "context_length"}
    assert image == ref["image"]
    assert txt == ref["text"]
    assert ours["out_dim"] == ref["out_dim"]
    assert ours["temperature_init"] == ref["temperature_init"]
    assert ours["image"]["image_size"] == cfg["vision_cfg"]["image_size"]


def test_h14_layout_and_parameter_count():
    """The served model at full width, built on the meta device (no
    memory): 16 heads of 80 in the image tower, and the parameter count of
    the flax tree computed from the same config's shapes."""
    cfg = openclip.get_model_config("ViT-H-14-CL32-GAP-BigVision")
    with torch.device("meta"):
        model = two_towers.Model(**openclip._to_two_towers_cfg(cfg))
    mha = model.img.Transformer.encoderblock_0.MultiHeadDotProductAttention_0
    assert mha.num_heads == 16 and mha.query.weight.shape == (1280, 1280)
    assert model.img.pos_embedding.shape == (1, 257, 1280)
    assert model.txt.pos_embedding.shape == (1, 32, 1024)
    assert model.img.Transformer.depth == 32
    assert model.txt.Transformer.depth == 24

    def block(w, mlp):  # 2 LNs, qkv+out with biases, MLP with biases
        return 4 * w + 4 * (w * w + w) + 2 * w * mlp + mlp + w

    img = (14 * 14 * 3 * 1280 + 1280 + 257 * 1280 + 32 * block(1280, 5120)
           + 2 * 1280 + 1280 * 1024)
    txt = (32000 * 1024 + 32 * 1024 + 24 * block(1024, 4096) + 2 * 1024
           + 1024 * 1024)
    assert sum(p.numel() for p in model.parameters()) == img + txt + 1


def test_converter_refuses_unknown_and_missing_names():
    with pytest.raises(ValueError, match="no torch counterpart"):
        convert.from_jax_params({"img/relpos/mystery": np.zeros((1, 1, 4))})
    # the MAP head's probe has a counterpart since the map pool is ported
    assert set(convert.from_jax_params(
        {"img/MAPHead_0/probe": np.zeros((1, 1, 4))})) == {
            "img.MAPHead_0.probe"}
    port = layers.EncoderBlock(64, 4)
    model = jax_layers.EncoderBlock(num_heads=4)
    params = _init(model, np.zeros((1, 37, 64), np.float32))
    flat = dict(jax_utils.tree_flatten_with_names(params)[0])
    del flat["LayerNorm_1/bias"]
    with pytest.raises(RuntimeError, match="LayerNorm_1.bias"):
        convert.load_jax_params(port, flat)


def test_converter_name_table():
    sd = convert.from_jax_params({
        "img/Transformer/encoderblock_0/MultiHeadDotProductAttention_0/"
        "query/kernel": np.zeros((64, 4, 16), np.float32),
        "img/Transformer/encoderblock_0/MultiHeadDotProductAttention_0/"
        "out/kernel": np.zeros((4, 16, 32), np.float32),
        "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel":
            np.zeros((64, 256), np.float32),
        "img/embedding/kernel": np.zeros((8, 8, 3, 64), np.float32),
        "txt/Embed_0/embedding": np.zeros((100, 64), np.float32),
        "txt/encoder_norm/scale": np.zeros((64,), np.float32),
        "t": np.zeros((1,), np.float32),
    })
    pre = "img.Transformer.encoderblock_0."
    assert sd[pre + "MultiHeadDotProductAttention_0.query.weight"].shape \
        == (64, 64)
    assert sd[pre + "MultiHeadDotProductAttention_0.out.weight"].shape \
        == (32, 64)
    assert sd[pre + "MlpBlock_0.Dense_0.weight"].shape == (256, 64)
    assert sd["img.embedding.kernel"].shape == (8, 8, 3, 64)
    assert sd["txt.Embed_0.weight"].shape == (100, 64)
    assert "txt.encoder_norm.weight" in sd and "t" in sd


def test_seeded_init_follows_flax_distributions(tmp_path):
    """Random init draws each parameter from the flax initializer's
    distribution: same spread per tensor (not the same bits), constants
    exact, and the same seed gives the same weights."""
    model = jax_two_towers.Model(**jax_openclip._to_two_towers_cfg(TINY_CFG))
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 48, 48, 3)),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    ref = {k: np.asarray(v)
           for k, v in jax_utils.tree_flatten_with_names(params)[0]}
    ref_sd = convert.from_jax_params(ref)

    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(TINY_CFG))

    def build(seed):
        return openclip.create_model(str(cfg_path), seed=seed,
                                      device="cpu").model

    port_sd = build(0).state_dict()
    assert set(port_sd) == set(ref_sd)
    for name, a in ref_sd.items():
        p = port_sd[name].float()
        if a.numel() >= 1000 and a.min() < a.max():
            assert abs(p.std().item() / a.std().item() - 1) < 0.15, name
        elif a.min() == a.max():
            torch.testing.assert_close(p, a, rtol=1e-6, atol=0)
    again = build(0).state_dict()
    other = build(1).state_dict()
    key = "img.Transformer.encoderblock_0.MlpBlock_0.Dense_0.weight"
    assert torch.equal(port_sd[key], again[key])
    assert not torch.equal(port_sd[key], other[key])


def test_model_registry():
    assert get_model_module("vit") is vit
    assert get_model_module("text_transformer") is text
    # the conv towers resolve; an unknown name raises
    assert get_model_module("convnext").__name__ == \
        "clipa_tpu_torch.models.convnext"
    with pytest.raises(NotImplementedError, match="no_such_tower"):
        get_model_module("no_such_tower")
