"""The port's BERT, RoBERTa-family (hf_text) and mT5 (t5_text) text towers,
CoCa's HF trunk and the HF configs, against clipa_tpu on the same inputs.

Tiny towers (width 64, depth 2, vocab 120) in both packages from one
seeded parameter dict (flax init plus seeded noise, carried across with
``convert.load_jax_params``), seeded ids with pad tails. The full-width
configs are held by their translation and their parameter trees (built on
the meta device against ``jax.eval_shape``); their embeddings at the
tables' tiny stand-ins (``HF_ARCHS`` / ``T5_ARCHS`` patched alike in both
packages), through both packages' ``create_model``.

Tolerances: forwards in fp32 at rtol 1e-5 / atol 1e-5, in bf16 at cosine
>= 0.999; gradients against ``jax.grad`` at cosine >= 0.999 per tensor; the
HuggingFace converters, the open_clip tokenizer ids and the T5 buckets
exact; ``generate`` token for token.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu import losses as jax_losses
from clipa_tpu import utils as jax_utils
from clipa_tpu.compat import openclip as jax_openclip
from clipa_tpu.models import bert as jax_bert
from clipa_tpu.models import coca as jax_coca
from clipa_tpu.models import hf_text as jax_hf_text
from clipa_tpu.models import t5_text as jax_t5_text
from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu_torch import convert, losses
from clipa_tpu_torch.compat import openclip
from clipa_tpu_torch.models import (bert, coca, get_model_module, hf_text,
                                    layers, t5_text, two_towers)
from clipa_tpu_torch.ops import block_attention
from clipa_tpu_torch.serving import EmbeddingService

HF_CONFIGS = ["roberta-ViT-B-32", "xlm-roberta-base-ViT-B-32",
              "xlm-roberta-large-ViT-H-14", "mt5-base-ViT-B-32",
              "mt5-xl-ViT-H-14", "coca_roberta-ViT-B-32"]
VOCAB = 120
TINY = dict(width=64, depth=2, num_heads=4, mlp_dim=128, vocab_size=VOCAB)
TINY_HF = dict(TINY, max_len=80, pad_id=1)
TINY_T5 = dict(TINY, head_dim=16, mlp_dim=96)
# the towers: (name, JAX module, port module, kwargs, pad id)
TOWERS = {
    "bert": (jax_bert, bert, dict(TINY, max_len=48), None),
    "hf_text": (jax_hf_text, hf_text, TINY_HF, 1),
    "hf_text_linear": (jax_hf_text, hf_text, dict(TINY_HF, proj="linear"),
                       1),
    "t5_text": (jax_t5_text, t5_text, TINY_T5, 0),
    "t5_text_linear": (jax_t5_text, t5_text, dict(TINY_T5, proj="linear"),
                       0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(b=3, l=40, pad=1, seed=0):
    """Ids in [3, VOCAB) with pad tails of seeded lengths (row 0 unpadded)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, VOCAB, (b, l)).astype(np.int32)
    for i in range(1, b):
        ids[i, rng.randint(1, l):] = pad
    return ids


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


def _pair(name, dtype=None, seed=0, l=40):
    """(JAX tower, its params, the port tower holding them, ids)."""
    jmod, pmod, kw, pad = TOWERS[name]
    ids = _ids(l=l, pad=1 if pad is None else pad, seed=seed)
    jm = jmod.Model(16, dtype=dtype, **kw)
    params = _init(jm, ids, seed=seed)
    port = pmod.Model(16, dtype=None if dtype is None else "bfloat16", **kw)
    convert.load_jax_params(port, params)
    return jm, params, port.eval(), ids


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ------------------------------------------------------------------ towers

@pytest.mark.parametrize("name", sorted(TOWERS))
def test_tower_forward_matches_jax(name):
    jm, params, port, ids = _pair(name)
    ref, rout = _apply(jm, params, ids)
    with torch.no_grad():
        got, out = port(torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["encoded"].numpy(),
                               np.asarray(rout["encoded"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_tower_bf16_matches_jax(name):
    jm, params, port, ids = _pair(name, dtype=jnp.bfloat16)
    ref, _ = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, ids)
    with torch.no_grad():
        got, _ = port(torch.tensor(ids))
        # the serving layout (weights stored in bf16) computes the same
        layers.cast_params(port, torch.bfloat16)
        served, _ = port(torch.tensor(ids))
    for row in range(ids.shape[0]):
        assert _cosine(got[row], ref[row]) >= 0.999, row
    torch.testing.assert_close(served, got, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_tower_gradients_match_jax(name):
    jm, params, port, ids = _pair(name, seed=1)
    cot = np.random.RandomState(5).normal(size=(ids.shape[0], 16)).astype(
        np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, ids)[0] * cot)

    ref = _grad(loss, params)
    port.train()
    (port(torch.tensor(ids))[0] * torch.tensor(cot)).sum().backward()
    _assert_gradients_match(port, ref)


def _assert_gradients_match(port, ref):
    """The port's gradients, in the JAX layout, against `ref` ({JAX name:
    gradient}): cosine >= 0.999 each, but for the key biases, which get
    no gradient in exact arithmetic (both sides hold rounding noise)."""
    got = {k: v.numpy() for k, v in convert.to_jax_params(port, {
        k: p.grad for k, p in port.named_parameters()}).items()}
    assert set(got) == set(ref)
    for k in ref:
        if k.endswith("/key/bias"):
            assert np.abs(got[k]).max() < 1e-6, k
            continue
        assert _cosine(got[k], ref[k]) >= 0.999, k


def _count_plain(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = (block_attention.attention_plain,
                block_attention.attention_plain_bwd)

    def counted_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(block_attention, "attention_plain", counted_fwd)
    monkeypatch.setattr(block_attention, "attention_plain_bwd", counted_bwd)
    return calls


@pytest.mark.parametrize("l,fused", [(40, True), (16, False)])
def test_bert_takes_the_fused_route_from_33_tokens(monkeypatch, l, fused):
    """The unmasked BERT tower reaches the fused path (its plain versions
    on a CPU tensor, q/k/v biases inside) once per block and direction at
    L = 40, and the einsum path at L = 16, as the JAX dispatch routes it;
    the hf_text tower's masks keep it on the einsum path."""
    calls = _count_plain(monkeypatch)
    jm, params, port, ids = _pair("bert", l=l)
    port.train()
    port(torch.tensor(ids))[0].sum().backward()
    depth = TINY["depth"]
    assert calls == ({"fwd": depth, "bwd": depth} if fused
                     else {"fwd": 0, "bwd": 0})
    _, _, hf, hf_ids = _pair("hf_text", l=l)
    calls.update(fwd=0, bwd=0)
    with torch.no_grad():
        hf(torch.tensor(hf_ids))
    assert calls == {"fwd": 0, "bwd": 0}


def test_layer_norm_epsilons_are_the_jax_towers():
    """flax's default 1e-6 in BERT's blocks and embeddings norm, in the
    blocks of hf_text, and T5's RMS norms; hf_text's embeddings norm at its
    ln_eps, 1e-5 (HF RoBERTa has 1e-5 everywhere: ROADMAP C)."""
    import flax.linen as nn
    flax_default = nn.LayerNorm().epsilon
    assert flax_default == 1e-6
    b = bert.Model(16, **TINY, max_len=48)
    h = hf_text.Model(16, **TINY_HF)
    t = t5_text.Model(16, **TINY_T5)
    for block in (b.encoderblock_0, h.encoderblock_1):
        assert block.LayerNorm_0.eps == block.LayerNorm_1.eps == flax_default
    assert b.embeddings_norm.eps == flax_default
    assert h.embeddings_norm.eps == jax_hf_text._Model().ln_eps == 1e-5
    assert (t.block_0_ln0.eps == t.final_norm.eps
            == jax_t5_text._Model().ln_eps == 1e-6)


def test_t5_buckets_match_jax_at_every_distance():
    """Every relative distance in [-511, 511], with the zoo's 32 buckets
    over 128 and a narrower table, bucket for bucket."""
    rel = np.arange(-511, 512, dtype=np.int32)
    for buckets, distance in ((32, 128), (8, 20)):
        ref = np.asarray(jax_t5_text.relative_position_bucket(
            jnp.asarray(rel), buckets, distance))
        got = t5_text.relative_position_bucket(torch.tensor(rel), buckets,
                                               distance)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got.dtype == torch.int32 and ref.max() == buckets - 1


def test_all_pad_rows_pool_as_the_jax_towers_do():
    """hf_text divides its mean by the count of non-pad ids with no floor,
    so a row of pads alone gives NaN in both packages (ROADMAP C); t5_text
    floors the count at 1 and stays finite."""
    for name, pad in (("hf_text", 1), ("t5_text", 0)):
        jm, params, port, ids = _pair(name)
        ids = ids.copy()
        ids[1] = pad
        ref, _ = jm.apply({"params": params}, ids)
        with torch.no_grad():
            got, _ = port(torch.tensor(ids))
        ref, got = np.asarray(ref), got.numpy()
        assert np.isnan(ref[1]).all() == np.isnan(got[1]).all() == (
            name == "hf_text")
        assert np.isfinite(got[[0, 2]]).all()
        np.testing.assert_allclose(got[[0, 2]], ref[[0, 2]], atol=1e-5)


def test_model_registry_resolves_the_new_towers():
    for name, module in (("bert", bert), ("proj.flaxformer.bert", bert),
                         ("hf_text", hf_text), ("t5_text", t5_text)):
        assert get_model_module(name) is module
    for name in ("convnext", "resnet"):
        assert get_model_module(name).__name__ == \
            f"clipa_tpu_torch.models.{name}"


def test_bert_variants_are_the_jax_packages():
    for v in ("base", "large"):
        assert bert.decode_variant(v) == jax_bert.decode_variant(v)
    assert hf_text.HF_ARCHS == jax_hf_text.HF_ARCHS
    assert t5_text.T5_ARCHS == jax_t5_text.T5_ARCHS


# ------------------------------------------------- HuggingFace checkpoints

def _hf_model(kind):
    trf = pytest.importorskip("transformers")
    common = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  hidden_act="gelu")
    torch.manual_seed(0)
    if kind == "bert":
        return trf.BertModel(trf.BertConfig(max_position_embeddings=48,
                                            **common))
    if kind == "roberta":
        return trf.RobertaModel(trf.RobertaConfig(
            max_position_embeddings=80, pad_token_id=1, **common))
    if kind == "xlm-roberta":
        return trf.XLMRobertaModel(trf.XLMRobertaConfig(
            max_position_embeddings=80, pad_token_id=1, type_vocab_size=2,
            **common))
    return trf.MT5EncoderModel(trf.MT5Config(
        vocab_size=VOCAB, d_model=64, d_kv=16, d_ff=96, num_layers=2,
        num_heads=4, feed_forward_proj="gated-gelu", pad_token_id=0))


def _convert(kind, sd, pkg):
    if kind == "bert":
        return pkg[0].convert_hf_state_dict(sd, 2, 4)
    if kind == "mt5":
        return pkg[2].convert_hf_mt5(sd, 2)
    return pkg[1].convert_hf_roberta(sd, 2, 4)


@pytest.mark.parametrize("kind", ["bert", "roberta", "xlm-roberta", "mt5"])
def test_hf_converters_match_jax_and_are_strict(kind):
    sd = {k: v.detach().numpy()
          for k, v in _hf_model(kind).state_dict().items()}
    ours = _flat(_convert(kind, sd, (bert, hf_text, t5_text)))
    ref = _flat(_convert(kind, sd, (jax_bert, jax_hf_text, jax_t5_text)))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    if kind == "xlm-roberta":   # two token-type rows: row 0 only
        assert ours["type_embeddings"].shape == (1, 1, 64)
    with pytest.raises(ValueError, match="nconsumed"):
        _convert(kind, {**sd, "encoder.mystery.weight": np.zeros(2)},
                 (bert, hf_text, t5_text))
    missing = dict(sd)
    missing.pop(next(k for k in sd if "layer" in k or "block" in k))
    with pytest.raises(KeyError):
        _convert(kind, missing, (bert, hf_text, t5_text))


@pytest.mark.parametrize("kind", ["roberta", "mt5"])
def test_converted_hf_weights_compute_the_jax_towers_function(kind):
    """A HuggingFace trunk's weights, converted by the port and loaded into
    its tower (the projection from the JAX tower's init), give the JAX
    tower's embedding and sequence."""
    sd = {k: v.detach().numpy()
          for k, v in _hf_model(kind).state_dict().items()}
    name = "hf_text" if kind == "roberta" else "t5_text"
    jmod, pmod, kw, pad = TOWERS[name]
    ids = _ids(pad=pad)
    jm = jmod.Model(16, **kw)
    params = {**_init(jm, ids), **_convert(kind, sd, (bert, hf_text,
                                                      t5_text))}
    port = pmod.Model(16, **kw).eval()
    convert.load_jax_params(port, params)
    ref, rout = _apply(jm, params, ids)
    with torch.no_grad():
        got, out = port(torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("suffix", [".bin", ".safetensors", ".npz"])
def test_bert_load_reads_hf_files_and_npz(tmp_path, suffix):
    """``bert.load`` from a HuggingFace ``.bin`` (``torch.load``), a
    ``.safetensors`` file (``bert.`` prefixes dropped) and an npz: the
    JAX ``load``'s tree, merged into the tower's."""
    hf = _hf_model("bert")
    sd = hf.state_dict()
    path = str(tmp_path / f"model{suffix}")
    if suffix == ".bin":
        torch.save(sd, path)
    elif suffix == ".safetensors":
        from safetensors.torch import save_file
        save_file({f"bert.{k}": v.contiguous() for k, v in sd.items()}, path)
    else:
        flat = _flat(bert.convert_hf_state_dict(
            {k: v.numpy() for k, v in sd.items()}, 2, 4))
        np.savez(path, **flat)
    port = bert.Model(None, **TINY, max_len=48)
    init = convert.to_jax_params(port)
    tree = jax_utils.recover_tree(list(init), list(init.values()))
    got = _flat(bert.load(tree, path, {"num_heads": 4}))
    jm = jax_bert.Model(None, **TINY, max_len=48)
    jtree = jm.init({"params": jax.random.PRNGKey(0)}, _ids())["params"]
    ref = _flat(jax_bert.load(jtree, path, {"num_heads": 4}))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("name", HF_CONFIGS)
def test_hf_configs_translate_as_the_jax_package_does(name):
    cfg = openclip.get_model_config(name)
    assert cfg == jax_openclip.get_model_config(name)
    if "multimodal_cfg" in cfg:
        ours, ref = openclip._to_coca_cfg(cfg), jax_openclip._to_coca_cfg(cfg)
    else:
        ours = openclip._to_two_towers_cfg(cfg)
        ref = jax_openclip._to_two_towers_cfg(cfg)
    assert ours["image"].pop("image_size") == cfg["vision_cfg"]["image_size"]
    assert ours == ref
    assert ours["text"] == {"variant": cfg["text_cfg"]["hf_model_name"]
                            .split("/")[-1], "proj": cfg["text_cfg"]["proj"]}
    assert ours["text_model"] == ("t5_text" if "mt5" in name else "hf_text")


@pytest.mark.parametrize("name", HF_CONFIGS)
def test_hf_configs_build_the_jax_parameter_tree(name):
    """At full width, on the meta device: every parameter of the port's
    model has the name and shape of the flax model's (eval_shape)."""
    cfg = openclip.get_model_config(name)
    size = cfg["vision_cfg"]["image_size"]
    model, _ = openclip._build(cfg, size, precision="float32",
                               device=torch.device("meta"), attn_impl="auto")
    ours = {k: tuple(v.shape)
            for k, v in convert.to_jax_params(model).items()}
    if "multimodal_cfg" in cfg:
        jm = jax_coca.Model(**jax_openclip._to_coca_cfg(cfg))
    else:
        jm = jax_two_towers.Model(**jax_openclip._to_two_towers_cfg(cfg))
    shapes = jax.eval_shape(
        lambda r: jm.init({"params": r}, jnp.zeros((1, size, size, 3)),
                          jnp.zeros((1, 77), jnp.int32))["params"],
        jax.random.PRNGKey(0))
    ref = {k: tuple(v.shape)
           for k, v in jax_utils.tree_flatten_with_names(shapes)[0]}
    assert ours == ref


TINY_VISION = {"image_size": 32, "layers": 2, "width": 64,
               "head_width": 32, "patch_size": 16}


@pytest.fixture
def tiny_tables(monkeypatch):
    """The HF tables' entries at tiny sizes, alike in both packages."""
    for table in (hf_text.HF_ARCHS, jax_hf_text.HF_ARCHS):
        for key in list(table):
            monkeypatch.setitem(table, key, TINY_HF)
    for table in (t5_text.T5_ARCHS, jax_t5_text.T5_ARCHS):
        for key in list(table):
            monkeypatch.setitem(table, key, TINY_T5)


def _tiny_json(name, tmp_path):
    cfg = json.loads(json.dumps(jax_openclip.get_model_config(name)))
    cfg["embed_dim"] = 32
    cfg["vision_cfg"] = dict(TINY_VISION, **{
        k: v for k, v in cfg["vision_cfg"].items() if k == "output_tokens"})
    if "multimodal_cfg" in cfg:
        cfg["text_cfg"]["width"] = 64
        cfg["multimodal_cfg"] = {"context_length": 11, "width": 64,
                                 "heads": 4, "layers": 2,
                                 "vocab_size": VOCAB}
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.parametrize("name,precision", [
    *[(n, "float32") for n in HF_CONFIGS if "coca" not in n],
    ("roberta-ViT-B-32", "bf16"), ("mt5-base-ViT-B-32", "bf16")])
def test_hf_configs_embed_as_the_jax_create_model(name, precision,
                                                  tiny_tables, tmp_path):
    """Each HF config's image and text embeddings through both packages'
    create_model from one parameter dict (the port's bf16 model stores its
    weights in bf16, the serving layout)."""
    path = _tiny_json(name, tmp_path)
    pad = 0 if "mt5" in name else 1
    ids = _ids(b=3, l=77, pad=pad, seed=2)
    img = np.random.RandomState(3).rand(3, 32, 32, 3).astype(np.float32)
    jclip = jax_openclip.create_model(path, precision=precision)
    params = _init(jclip.model, img, ids)
    jclip.params = jax.tree_util.tree_map(jnp.asarray, params)
    ours = openclip.create_model(path, device="cpu", precision=precision)
    convert.load_jax_params(ours.model, params)
    with jax.default_matmul_precision("highest"):
        ref = (jclip.encode_image(img), jclip.encode_text(ids))
    got = (ours.encode_image(img), ours.encode_text(ids))
    for a, b in zip(got, ref):
        if precision == "float32":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
        else:
            for row in range(3):
                assert _cosine(a[row].float(), b[row]) >= 0.999


def test_create_model_builds_every_hf_config_with_seeded_weights(
        tiny_tables, tmp_path):
    """Seeded weights: the same seed gives the same model, another seed
    another one, and the towers are the HF ones."""
    for name in HF_CONFIGS:
        path = _tiny_json(name, tmp_path)
        a = openclip.create_model(path, device="cpu", seed=0)
        b = openclip.create_model(path, device="cpu", seed=0)
        c = openclip.create_model(path, device="cpu", seed=1)
        kind = t5_text._Model if "mt5" in name else hf_text._Model
        assert isinstance(a.model.txt, kind), name
        key = "txt.word_embeddings.weight"
        sa, sb, sc = (m.model.state_dict()[key] for m in (a, b, c))
        assert torch.equal(sa, sb) and not torch.equal(sa, sc), name


def test_lit_bert_two_towers_loss_and_gradients_match_jax(monkeypatch):
    """The LiT pairing (a ViT image tower beside ``proj.flaxformer.bert``)
    in the two-tower model: the contrastive loss and every gradient
    against jax.grad, the text tower at 40 ids on the fused path (its
    plain versions, once per block and direction)."""
    calls = _count_plain(monkeypatch)
    image = dict(variant=None, width=64, depth=2, num_heads=4, mlp_dim=128,
                 patch_size=(8, 8), pool_type="gap", posemb="sincos2d")
    kw = dict(text=dict(TINY, max_len=48), text_model="proj.flaxformer.bert",
              out_dim=(16, 16), temperature_init=10.0)
    img = np.random.RandomState(6).rand(4, 16, 16, 3).astype(np.float32)
    ids = _ids(b=4, l=40, seed=6)
    jm = jax_two_towers.Model(image=image, **kw)
    params = _init(jm, img, ids)
    port = two_towers.Model(image=dict(image, image_size=16), **kw)
    convert.load_jax_params(port, params)

    def loss(p):
        zi, zt, out = jm.apply({"params": p}, img, ids)
        return jax_losses.bidirectional_contrastive_loss(
            zi, zt, out["t"], reduction=True)[0]

    ref = _grad(loss, params)
    with jax.default_matmul_precision("highest"):
        ref_loss = float(loss(params))
    port.train()
    zi, zt, out = port(torch.tensor(img), torch.tensor(ids))
    got_loss = losses.bidirectional_contrastive_loss(zi, zt, out["t"],
                                                     reduction=True)[0]
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), ref_loss, rtol=1e-5)
    _assert_gradients_match(port, ref)
    assert calls == {"fwd": TINY["depth"], "bwd": TINY["depth"]}


def test_service_embeds_token_ids(tiny_tables, tmp_path):
    """``EmbeddingService.embed_tokens`` (ids tokenized elsewhere: the HF
    tokenizers need ``transformers``) gives the model's text embeddings
    through the bucketed path; ``embed_texts`` is it after the tokenizer."""
    path = _tiny_json("xlm-roberta-base-ViT-B-32", tmp_path)
    svc = EmbeddingService(path, None, device="cpu", precision="float32",
                           buckets=(2, 4), num_workers=0)
    ids = _ids(b=5, l=77, pad=1, seed=7)
    got = svc.embed_tokens(ids)
    np.testing.assert_allclose(got, svc.clip.encode_text(ids).numpy(),
                               rtol=1e-5, atol=1e-6)
    svc.tokenizer = lambda texts: ids[:len(texts)]
    np.testing.assert_array_equal(svc.embed_texts(["a"] * 5), got)


# -------------------------------------------------------------------- CoCa

@pytest.fixture
def coca_pair(tiny_tables, tmp_path):
    path = _tiny_json("coca_roberta-ViT-B-32", tmp_path)
    cfg = jax_openclip.get_model_config(path)
    ids = _ids(b=4, l=12, pad=1, seed=4)
    img = np.random.RandomState(5).rand(4, 32, 32, 3).astype(np.float32)
    jm = jax_coca.Model(**jax_openclip._to_coca_cfg(cfg))
    params = _init(jm, img, ids)
    port = coca.Model(**openclip._to_coca_cfg(cfg))
    convert.load_jax_params(port, params)
    return jm, params, port.eval(), img, ids, cfg


def test_coca_hf_trunk_forward_matches_jax(coca_pair):
    """The pooled projection is ztxt, the decoder reads the unprojected
    ``encoded`` of ``text[:, :-1]``, the labels are ``text[:, 1:]``."""
    jm, params, port, img, ids, _ = coca_pair
    assert isinstance(port.txt, hf_text._Model)
    zi, zt, out = _apply(jm, params, img, ids)
    with torch.no_grad():
        pzi, pzt, pout = port(torch.tensor(img), torch.tensor(ids))
    assert pout["logits"].shape == (4, 11, VOCAB)
    assert pout["txt/encoded"].shape == (4, 11, 64)
    for a, b in ((pzi, zi), (pzt, zt), (pout["logits"], out["logits"]),
                 (pout["txt/encoded"], out["txt/encoded"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(pout["labels"].numpy(), ids[:, 1:])
    np.testing.assert_array_equal(np.asarray(out["labels"]), ids[:, 1:])


def test_coca_hf_loss_counts_roberta_pads_as_the_jax_loss_does(coca_pair):
    """CoCa's pad_id is 0 and RoBERTa pads with 1: both losses count the
    pad-1 labels; a label past the decoder's vocabulary gives NaN in
    both."""
    jm, params, port, img, ids, _ = coca_pair
    zi, zt, out = _apply(jm, params, img, ids)
    args = [np.asarray(x) for x in (zi, zt, out["t"], out["logits"],
                                    out["labels"])]
    assert (args[-1] == 1).any()
    ref, rex = jax_losses.coca_loss(*args)
    got, ex = losses.coca_loss(*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(ex["caption_loss"]),
                               float(rex["caption_loss"]), rtol=1e-5)
    args[-1] = args[-1].copy()
    args[-1][0, 0] = VOCAB + 5
    assert np.isnan(float(jax_losses.coca_loss(*args)[0]))
    assert np.isnan(float(losses.coca_loss(*(torch.tensor(a)
                                             for a in args))[0]))


def test_coca_hf_gradients_match_jax(coca_pair):
    jm, params, port, img, ids, _ = coca_pair

    def loss(p):
        zi, zt, out = jm.apply({"params": p}, img, ids)
        return jax_losses.coca_loss(zi, zt, out["t"], out["logits"],
                                    out["labels"])[0]

    ref = _grad(loss, params)
    port.train()
    zi, zt, out = port(torch.tensor(img), torch.tensor(ids))
    losses.coca_loss(zi, zt, out["t"], out["logits"],
                     out["labels"])[0].backward()
    _assert_gradients_match(port, ref)


@pytest.mark.parametrize("kw", [
    dict(generation_type="beam_search", num_beams=4, num_beam_groups=2),
    dict(generation_type="top_p", top_p=0.9, seed=3),
])
def test_coca_hf_generate_matches_jax_token_for_token(coca_pair, kw):
    pytest.importorskip("transformers")
    jm, params, port, img, _, cfg = coca_pair
    jclip = jax_openclip.CoCaModel(
        jm, jax.tree_util.tree_map(jnp.asarray, params), cfg, 32, 77)
    pclip = openclip.CoCaModel(port, cfg, 32, 77, torch.device("cpu"))
    args = dict(seq_len=8, sot_token_id=90, eos_token_id=91, min_seq_len=2,
                **kw)
    with jax.default_matmul_precision("highest"):
        ref = jclip.generate(img[:2], **args)
    np.testing.assert_array_equal(pclip.generate(img[:2], **args), ref)


# --------------------------------------------------------------- tokenizer

def _roberta_tokenizer_dir(path):
    """A RoBERTa byte-level BPE tokenizer directory: a synthetic vocab.json
    and merges.txt (the bytes, their letter pairs, the specials)."""
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode
    letters = sorted(set(bytes_to_unicode().values()))
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in letters:
        vocab.setdefault(ch, len(vocab))
    merges = []
    for a in "aeiostnrhlĠ":
        for b in "aeiostnrhl":
            merges.append(f"{a} {b}")
            vocab.setdefault(a + b, len(vocab))
    vocab["<mask>"] = len(vocab)
    path.mkdir()
    with open(path / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(path / "merges.txt", "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    with open(path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "RobertaTokenizer",
                   "model_max_length": 512}, f)
    return str(path)


@pytest.mark.parametrize("name", ["roberta-ViT-B-32",
                                  "coca_roberta-ViT-B-32"])
def test_hf_tokenizer_ids_match_jax(tmp_path, name):
    pytest.importorskip("transformers")
    local = _roberta_tokenizer_dir(tmp_path / "tok")
    texts = ["a photo of a cat", "the rose is there, then it is not",
             " ".join(["hello"] * 100), ""]
    ours = openclip.get_tokenizer(name, vocab_path=local)
    ref = jax_openclip.get_tokenizer(name, vocab_path=local)
    got = ours(texts)
    assert got.dtype == np.int32 and got.shape == (4, 77)
    np.testing.assert_array_equal(got, ref(texts))
    assert (got[:, 0] == 0).all() and (got[3, 2:] == 1).all()
    assert got[2, -1] == 2   # truncated at 77 with </s>
    np.testing.assert_array_equal(ours("a photo of a cat"), got[:1])
