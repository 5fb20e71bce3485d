"""clipa_tpu_torch.compat.openclip against clipa_tpu.compat.openclip.

  * ``get_tokenizer`` for every model config the port ships (37): the same
    ids as the JAX package's on the same captions (WordPiece on
    data/vocab.txt, BPE on chip_smoke.py's 48 894-merge file), the syntax
    configs with the same ``rng``;
  * the state-dict converter: ``convert_torch_variables`` on open_clip
    state dicts (``CLIP`` and ``CustomTextCLIP`` prefixes, ``module.``,
    the ignorable buffers) equals the JAX converter's tree bit for bit and
    raises on leftovers as it does, and on a partial layout of a tower;
  * ``export_torch_state_dict`` from a port model and from a JAX-layout
    tree: the JAX exporter's dict, key for key and bit for bit;
  * ``create_model`` from an open_clip ``.bin`` / ``.pt`` and
    ``load_openai_model`` (plain state dict and TorchScript archive): the
    JAX package's embeddings within atol 1e-5 (fp32);
  * the open_clip spec in float64 (tests/test_compat.py's torch forward
    from the exported weights) on the port's towers, atol 1e-6;
  * ``image_transform``, ``create_loss`` and the factory wrappers.

The tiny configs are .json files in a temporary directory, addressed by
path. The port runs on the CPU (its attention takes the kernel's plain
version).
"""

import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from clipa_tpu.compat import openclip as jax_openclip
from clipa_tpu_torch import convert, utils as u
from clipa_tpu_torch.compat import openclip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "data", "vocab.txt")

# CLIPA-v1 / open_clip layout (ln_pre, class-token or gap_all pool, causal
# text pooled at eot) and the BigVision layout (no ln_pre, gap, last-token
# pool, bidirectional text, tanh GELU).
TINY = {
    "openclip": {
        "embed_dim": 32,
        "vision_cfg": {"image_size": 48, "layers": 2, "width": 64,
                       "head_width": 16, "patch_size": 8},
        "text_cfg": {"context_length": 8, "vocab_size": 64, "width": 64,
                     "heads": 4, "layers": 2}},
    "gap_all": {
        "embed_dim": 32,
        "vision_cfg": {"image_size": 48, "layers": 2, "width": 64,
                       "head_width": 32, "patch_size": 8,
                       "global_average_pool": True},
        "text_cfg": {"context_length": 8, "vocab_size": 64, "width": 64,
                     "heads": 2, "layers": 1, "text_mask": "syntax"}},
    "bigvision": {
        "embed_dim": 32,
        "vision_cfg": {"image_size": 48, "layers": 2, "width": 64,
                       "head_width": 16, "patch_size": 8,
                       "gelu_approximate": "tanh", "ln_pre": False,
                       "pool_style": "big_vision_gap",
                       "global_average_pool": True},
        "text_cfg": {"context_length": 8, "vocab_size": 64, "width": 64,
                     "heads": 4, "layers": 2, "gelu_approximate": "tanh",
                     "pool_style": "big_vision_last",
                     "attention_mask": False, "bert_tokenizer": True}},
}
CAPTIONS = [
    "a photo of a cat",
    "A small brown dog running on the green grass near a quiet river!",
    "two red cars parked beside an old stone church at night",
    "Café naïve façade, Straße in 東京 — 'quoted' “curly”",
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
    " ".join(["word"] * 40),
    "",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "merges.txt")
    chip_smoke._write_merges(path)
    return path


def _jax_params(cfg, seed=0):
    """A JAX two-towers of `cfg` with seeded weights, every leaf perturbed
    (non-zero biases, non-unit LayerNorm scales)."""
    from clipa_tpu.models import two_towers
    model = two_towers.Model(**jax_openclip._to_two_towers_cfg(cfg))
    size = cfg["vision_cfg"]["image_size"]
    ctx = cfg["text_cfg"]["context_length"]
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        jnp.zeros((1, size, size, 3)),
                        jnp.zeros((1, ctx), jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """{kind: (config path, JAX params, open_clip state dict, .bin path)}."""
    d = tmp_path_factory.mktemp("torch_compat")
    out = {}
    for i, (kind, cfg) in enumerate(TINY.items()):
        path = str(d / f"Tiny-{kind}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        params = _jax_params(cfg, seed=i)
        sd = jax_openclip.export_torch_state_dict(params)
        bin_path = str(d / f"{kind}.bin")
        torch.save({k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in sd.items()}, bin_path)
        out[kind] = (path, params, sd, bin_path)
    return out


def _flat(tree):
    return {k: np.asarray(v) for k, v in u.tree_flatten_with_names(tree)}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _images(n, size=48, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def _tokens(n, ctx=8, vocab=64, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab - 1, (n, ctx))
    ids[:, -2] = vocab - 1   # eot: the max id, before the last slot
    ids[:, -1] = 0
    return ids.astype(np.int32)


# ---------------------------------------------------------------- tokenizers

@pytest.fixture(scope="module")
def hf_tokenizer_dir(tmp_path_factory):
    """A local RoBERTa tokenizer directory (synthetic vocab and merges):
    the HF-text configs' tokenizer, in both packages."""
    from tests.test_torch_hf_text import _roberta_tokenizer_dir
    return _roberta_tokenizer_dir(tmp_path_factory.mktemp("hf") / "tok")


@pytest.mark.parametrize("name", openclip.list_models())
def test_get_tokenizer_matches_jax(name, merges, hf_tokenizer_dir,
                                   monkeypatch):
    from clipa_tpu.pp import ops_text as jax_ops_text
    # the JAX WordPiece route: its Python tokenizer (the native one is the
    # port's own, held by tests/test_torch_native.py)
    monkeypatch.setattr(jax_ops_text, "get_tokenizer",
                        lambda path, backend="python", _f=jax_ops_text
                        .get_tokenizer: _f(path, backend="python"))
    text_cfg = openclip.get_model_config(name)["text_cfg"]
    # OpenAI's BPE for the 49408-vocab configs; coca_base's 64000-id vocab
    # takes the WordPiece route in both packages
    bpe = not text_cfg.get("bert_tokenizer") and \
        text_cfg.get("vocab_size") == 49408
    vocab = merges if bpe else VOCAB
    if "hf_tokenizer_name" in text_cfg:   # transformers' AutoTokenizer
        vocab = hf_tokenizer_dir
    ours = openclip.get_tokenizer(name, vocab_path=vocab)
    ref = jax_openclip.get_tokenizer(name, vocab_path=vocab)
    kw = {}
    if text_cfg.get("text_mask") == "syntax":
        kw = {"rng": np.random.default_rng(7)}
        got = ours(CAPTIONS, rng=np.random.default_rng(7))
    else:
        got = ours(CAPTIONS)
    want = ref(CAPTIONS, **kw)
    ctx = text_cfg.get("context_length", 77)
    assert got.shape == (len(CAPTIONS), ctx) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if bpe:
        assert got.max() == 49407   # <end_of_text>: the vocab's last row


def test_syntax_bpe_samples_words_past_the_budget(merges):
    """At 8 tokens the syntax tokenizer keeps nouns and adjectives of a long
    caption in their order (not plain truncation), as the JAX one does."""
    from clipa_tpu_torch.pp.bpe_tokenizer import SimpleTokenizer
    tok = openclip.get_tokenizer("ViT-L-16-CL8-Syntax-GAP",
                                 vocab_path=merges)
    long = CAPTIONS[1]
    got = tok([long])
    plain = SimpleTokenizer(merges)([long], 8)
    assert got[0, 0] == 49406 and got[0, -1] == 49407
    assert not np.array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_openclip.get_tokenizer(
        "ViT-L-16-CL8-Syntax-GAP", vocab_path=merges)([long]))


def test_get_tokenizer_refuses_what_is_not_ported(tmp_path):
    """The BPE configs need a merges file; an HF tokenizer goes to
    transformers' AutoTokenizer, which refuses a directory without a
    tokenizer in both packages alike (the hub is never asked)."""
    with pytest.raises(ValueError, match="BPE"):
        openclip.get_tokenizer("ViT-L-16-CL32-GAP")
    cfg = json.loads(json.dumps(TINY["bigvision"]))
    cfg["text_cfg"]["hf_tokenizer_name"] = "xlm-roberta-base"
    path = str(tmp_path / "hf_text.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    empty = tmp_path / "empty"
    empty.mkdir()
    errors = []
    for package in (openclip, jax_openclip):
        with pytest.raises(Exception) as info:
            package.get_tokenizer(path, vocab_path=str(empty))
        errors.append(type(info.value))
    assert errors[0] is errors[1]


# ----------------------------------------------------------------- converter

def _text_prefixed(sd):
    """The CustomTextCLIP layout: the text tower under ``text.``."""
    top = ("token_embedding", "positional_embedding", "text_projection",
           "ln_final", "transformer.", "cls_emb")
    return {(f"text.{k}" if k.startswith(top) else k): v
            for k, v in sd.items()}


@pytest.mark.parametrize("kind", sorted(TINY))
@pytest.mark.parametrize("layout", ["clip", "custom_text", "module"])
def test_converter_matches_jax(tiny, kind, layout):
    _, params, sd, _ = tiny[kind]
    if layout == "custom_text":
        sd = _text_prefixed(sd)
    elif layout == "module":
        sd = {f"module.{k}": v for k, v in sd.items()}
    sd = dict(sd, **{"transformer.resblocks.0.attn_mask": np.zeros((8, 8)),
                     "logit_bias": np.zeros(1)})   # ignorable buffers
    heads = jax_openclip._heads_from_params(params)
    assert openclip._heads_from_params(params) == heads
    want = jax_openclip.convert_torch_variables(sd, heads=heads)
    got = openclip.convert_torch_variables(sd, heads=heads)
    assert sorted(got) == sorted(want) == ["params"]
    _assert_trees_equal(got["params"], want["params"])
    _assert_trees_equal(got["params"], params)
    # without heads, both infer head_width 64 the same way
    _assert_trees_equal(openclip.convert_torch_state_dict(sd),
                        jax_openclip.convert_torch_state_dict(sd))


def test_converter_leftovers_raise_as_jax(tiny):
    """A key the converter does not know raises in both packages, in either
    tower, under either text prefix and under ``module.``; nothing skips
    it."""
    _, params, sd, _ = tiny["openclip"]
    mystery = np.zeros((3, 3), np.float32)
    for base, key in [(sd, "visual.mystery.weight"),
                      (sd, "transformer.resblocks.0.mystery"),
                      (_text_prefixed(sd), "text.mystery.weight"),
                      ({f"module.{k}": v for k, v in sd.items()},
                       "module.visual.mystery.weight")]:
        bad = dict(base, **{key: mystery})
        for conv in (openclip, jax_openclip):
            with pytest.raises(ValueError, match="unconsumed"):
                conv.convert_torch_state_dict(bad)
            with pytest.raises(ValueError, match="mystery"):
                conv.convert_torch_variables(bad)


@pytest.mark.parametrize("extra,error,what", [
    # the conv towers and CoCa are ported: a state dict with a piece of
    # their layout but not the rest raises on the first missing key
    ({"visual.trunk.stem.0.weight": np.zeros((4, 3, 4, 4))}, KeyError,
     "visual.trunk.stem.0.bias"),
    ({"visual.attnpool.positional_embedding": np.zeros((5, 8))}, KeyError,
     "visual.bn1.weight"),
    ({"text_decoder.ln_final.weight": np.zeros(8)}, KeyError,
     "text_decoder.resblocks.0.ln_1.weight"),
    ({"visual.attn_pool.query": np.zeros((4, 8))}, KeyError,
     "visual.attn_pool.ln_q.weight"),
])
def test_converter_refuses_unported_towers(tiny, extra, error, what):
    _, _, sd, _ = tiny["openclip"]
    with pytest.raises(error, match=what):
        openclip.convert_torch_variables(dict(sd, **extra))


def test_converter_refuses_hf_text(tiny):
    _, _, sd, _ = tiny["openclip"]
    sd = {k: v for k, v in _text_prefixed(sd).items()
          if not k.startswith("text.token_embedding")}
    with pytest.raises(NotImplementedError, match="HF text.*load"):
        openclip.convert_torch_variables(sd)


# ------------------------------------------------------------------ exporter

@pytest.mark.parametrize("kind", sorted(TINY))
def test_exporter_matches_jax(tiny, kind):
    """From a port model holding the JAX weights, from the JAX tree itself
    and from its flat names: the JAX exporter's dict, key for key."""
    path, params, sd, _ = tiny[kind]
    model = openclip.create_model(path, device="cpu")
    convert.load_jax_params(model.model, params)
    for source in (model, model.model, params, _flat(params)):
        got = openclip.export_torch_state_dict(source)
        assert sorted(got) == sorted(sd)
        for k in sd:
            assert got[k].dtype == sd[k].dtype, k
            np.testing.assert_array_equal(got[k], sd[k], err_msg=k)


def test_exporter_refuses_what_it_would_drop(tiny):
    _, params, _, _ = tiny["openclip"]
    flat = _flat(params)
    with pytest.raises(ValueError, match="b"):
        openclip.export_torch_state_dict(dict(flat, b=np.zeros(1)))
    ls = dict(flat, **{"img/Transformer/encoderblock_0/ls1": np.ones(64)})
    with pytest.raises(ValueError, match="ls1"):
        openclip.export_torch_state_dict(ls)
    # a pool makes the tree a ModifiedResNet's, whose other parameters
    # it lacks
    with pytest.raises(KeyError, match="img/conv1/kernel"):
        openclip.export_torch_state_dict(
            dict(flat, **{"img/attnpool/pos_embedding": np.zeros((5, 8))}))
    # a decoder makes the tree CoCa's, whose other parameters it lacks
    with pytest.raises(KeyError, match="img_encoder_norm"):
        openclip.export_torch_state_dict(
            dict(flat, **{"decoder/head/kernel": np.zeros((8, 8))}))


def test_models_export_and_load_back_bit_for_bit(tiny, tmp_path):
    path, _, _, _ = tiny["gap_all"]
    model = openclip.create_model(path, device="cpu", seed=3)
    sd = openclip.export_torch_state_dict(model)
    bin_path = str(tmp_path / "model.bin")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, bin_path)
    back = openclip.create_model(path, bin_path, device="cpu")
    a, b = model.model.state_dict(), back.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------- loading, embeddings

@pytest.mark.parametrize("kind", sorted(TINY))
@pytest.mark.parametrize("suffix", [".bin", ".pt", ".pth"])
def test_create_model_from_torch_checkpoint_matches_jax(tiny, kind, suffix,
                                                        tmp_path):
    path, params, _, bin_path = tiny[kind]
    ckpt = str(tmp_path / f"weights{suffix}")
    os.link(bin_path, ckpt)
    ours = openclip.create_model(path, ckpt, device="cpu")
    ref = jax_openclip.create_model(path, ckpt)
    images, tokens = _images(3), _tokens(3)
    with jax.default_matmul_precision("highest"):
        want_img = np.asarray(ref.encode_image(images))
        want_txt = np.asarray(ref.encode_text(tokens))
    np.testing.assert_allclose(ours.encode_image(images).numpy(), want_img,
                               atol=1e-5)
    np.testing.assert_allclose(ours.encode_text(tokens).numpy(), want_txt,
                               atol=1e-5)
    np.testing.assert_allclose(ours.logit_scale.numpy(),
                               np.exp(params["t"]), rtol=1e-6)


def test_create_model_from_npz_and_state_dict_agree(tiny, tmp_path):
    """The same weights as the JAX package's npz and as an open_clip .bin,
    from a path or a file:// URL, load into the same tensors."""
    from clipa_tpu.train import checkpoint as jax_ckpt
    path, params, _, bin_path = tiny["openclip"]
    npz = str(tmp_path / "params.npz")
    jax_ckpt.save_checkpoint({"params": params}, npz)
    a = openclip.create_model(path, npz, device="cpu").model.state_dict()
    for source in (bin_path, "file://" + bin_path):
        b = openclip.create_model(path, source,
                                  device="cpu").model.state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_create_model_refuses_unknown_pretrained(tiny):
    path, _, _, _ = tiny["openclip"]
    with pytest.raises(KeyError, match="known tags"):
        openclip.create_model(path, "no_such_tag", device="cpu")
    with pytest.raises(KeyError, match="laion2b_s34b_b79k"):
        openclip.create_model("ViT-B-32", "no_such_tag", device="cpu")


def test_unported_configs_raise_naming_a10(tmp_path):
    """The conv towers of the JAX zoo, timm's convnext and the
    ModifiedResNet: their configs build (on the meta device, at full
    width) the towers the JAX translation names
    (tests/test_torch_conv_towers.py holds the towers to the JAX ones)."""
    for name, tower in (("convnext_base", "convnext"),
                        ("convnext_large_d", "convnext"), ("RN50", "resnet"),
                        ("RN101", "resnet")):
        path = str(tmp_path / f"{name}.json")
        with open(path, "w") as f:
            json.dump(jax_openclip.get_model_config(name), f)
        cfg = openclip.get_model_config(path)
        model, _ = openclip._build(cfg, cfg["vision_cfg"]["image_size"],
                                   precision="float32",
                                   device=torch.device("meta"),
                                   attn_impl="auto")
        assert type(model.img).__module__ == \
            f"clipa_tpu_torch.models.{tower}"
        assert jax_openclip._to_two_towers_cfg(cfg).get(
            "image_model") == tower


def _openai_state_dict(seed=0):
    """tests/test_compat.py's synthetic state dict in the OpenAI release
    layout: ViT-style, 64 wide (one head of 64, as the shapes infer)."""
    from tests.test_compat import _openai_style_state_dict
    return _openai_style_state_dict(seed=seed)


def _to_torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _torchscript_archive(sd, path):
    """A TorchScript archive whose state_dict() is `sd` (nested modules
    named after the key's parts, as OpenAI's scripted releases are)."""
    class Holder(torch.nn.Module):
        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return x

    root = Holder()
    for key, value in sd.items():
        *parents, leaf = key.split(".")
        node = root
        for part in parents:
            if not hasattr(node, part):
                node.add_module(part, Holder())
            node = getattr(node, part)
        node.register_parameter(leaf, torch.nn.Parameter(
            torch.from_numpy(np.array(value)), requires_grad=False))
    torch.jit.save(torch.jit.script(root), path)


@pytest.mark.parametrize("form", ["state_dict", "torchscript"])
def test_load_openai_model_matches_jax(form, tmp_path):
    sd = _openai_state_dict()
    path = str(tmp_path / "openai.pt")
    if form == "state_dict":
        torch.save(_to_torch(sd), path)
    else:
        _torchscript_archive(sd, path)
        assert openclip._is_torchscript(path)
    ours = openclip.load_openai_model(path, device="cpu")
    ref = jax_openclip.load_openai_model(path)
    assert ours.config == ref.config
    assert (ours.image_size, ours.context_length) == (32, 8)
    images, tokens = _images(2, 32), _tokens(2)
    np.testing.assert_allclose(ours.encode_image(images).numpy(),
                               np.asarray(ref.encode_image(images)),
                               atol=1e-5)
    np.testing.assert_allclose(ours.encode_text(tokens).numpy(),
                               np.asarray(ref.encode_text(tokens)),
                               atol=1e-5)
    np.testing.assert_array_equal(
        ours.model.img.pos_embedding.detach().numpy()[0],
        sd["visual.positional_embedding"])


def test_load_openai_model_drops_the_release_metadata(tmp_path):
    """OpenAI's archives carry input_resolution, context_length and
    vocab_size beside the weights; the reference's build_model deletes
    them, and so does the port (the JAX package's converter refuses them as
    leftovers). Any other unknown entry still raises."""
    sd = _openai_state_dict()
    meta = {"input_resolution": np.asarray(32),
            "context_length": np.asarray(8), "vocab_size": np.asarray(64)}
    path = str(tmp_path / "release.pt")
    torch.save(_to_torch({**sd, **meta}), path)
    plain = str(tmp_path / "plain.pt")
    torch.save(_to_torch(sd), plain)
    a = openclip.load_openai_model(path, device="cpu").model.state_dict()
    b = openclip.load_openai_model(plain, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="unconsumed"):
        jax_openclip.load_openai_model(path)
    torch.save(_to_torch({**sd, "visual.extra": np.zeros(2)}), path)
    with pytest.raises(ValueError, match="unconsumed"):
        openclip.load_openai_model(path, device="cpu")


def test_infer_openai_config_matches_jax():
    """The ViT branch here, the ModifiedResNet branch in
    test_infer_openai_config_matches_jax_on_a_resnet."""
    sd = _openai_state_dict()
    assert openclip._infer_openai_config(sd) == \
        jax_openclip._infer_openai_config(sd)



def test_is_torchscript_tells_archives_apart(tmp_path):
    plain = str(tmp_path / "plain.pt")
    torch.save({"a": torch.zeros(2)}, plain)
    assert zipfile.is_zipfile(plain) and not openclip._is_torchscript(plain)
    other = tmp_path / "other.txt"
    other.write_text("not a zip")
    assert not openclip._is_torchscript(str(other))


# ------------------------------------------------- the open_clip spec, fp64

def _spec_block(x, sd, b, heads, attn_bias=None, gelu="erf"):
    """tests/test_compat.py's reference block (pre-LN), written from the
    open_clip spec."""
    w = x.shape[-1]
    hd = w // heads
    y = F.layer_norm(x, (w,), sd[f"{b}.ln_1.weight"], sd[f"{b}.ln_1.bias"])
    qkv = y @ sd[f"{b}.attn.in_proj_weight"].T + sd[f"{b}.attn.in_proj_bias"]
    q, k, v = qkv.split(w, dim=-1)
    bsz, length, _ = q.shape
    q, k, v = (t.view(bsz, length, heads, hd).transpose(1, 2)
               for t in (q, k, v))
    logits = q @ k.transpose(-1, -2) / hd ** 0.5
    if attn_bias is not None:
        logits = logits + attn_bias
    a = (logits.softmax(-1) @ v).transpose(1, 2).reshape(bsz, length, w)
    x = x + a @ sd[f"{b}.attn.out_proj.weight"].T + sd[
        f"{b}.attn.out_proj.bias"]
    y = F.layer_norm(x, (w,), sd[f"{b}.ln_2.weight"], sd[f"{b}.ln_2.bias"])
    y = y @ sd[f"{b}.mlp.c_fc.weight"].T + sd[f"{b}.mlp.c_fc.bias"]
    y = F.gelu(y, approximate="tanh" if gelu == "tanh" else "none")
    return x + y @ sd[f"{b}.mlp.c_proj.weight"].T + sd[f"{b}.mlp.c_proj.bias"]


@pytest.mark.parametrize("style", ["openclip", "bigvision"])
def test_open_clip_spec_in_float64(style):
    """tests/test_compat.py:165-237 on the port: the towers in float64
    against a torch forward of the open_clip spec from the exported weights
    (CLIPA-v1's ln_pre, causal text, eot pool, erf GELU; or BigVision's
    no ln_pre, gap excluding cls, last-token pool, tanh GELU)."""
    from clipa_tpu_torch.models import layers, two_towers
    cfg = {"embed_dim": 32,
           "vision_cfg": {"image_size": 16, "layers": 2, "width": 64,
                          "head_width": 32, "patch_size": 8},
           "text_cfg": {"context_length": 8, "vocab_size": 64, "width": 64,
                        "heads": 2, "layers": 2}}
    if style == "bigvision":
        cfg = json.loads(json.dumps(TINY["bigvision"]))
        cfg["vision_cfg"].update(image_size=16, head_width=32)
        cfg["text_cfg"]["heads"] = 2
    gelu = "tanh" if style == "bigvision" else "erf"
    model = two_towers.Model(**openclip._to_two_towers_cfg(cfg),
                             dtype=torch.float64)
    layers.init_parameters(model, torch.Generator().manual_seed(1))
    model.double().eval()
    rng = np.random.RandomState(0)
    img = torch.tensor(rng.rand(2, 16, 16, 3))
    txt = torch.tensor([[2, 9, 7, 30, 3, 0, 0, 0],
                        [2, 14, 5, 8, 21, 50, 1, 7]])
    with torch.no_grad():
        zimg, ztxt, _ = model(img, txt)
    sd = {k: torch.tensor(v, dtype=torch.float64)
          for k, v in openclip.export_torch_state_dict(model).items()}

    x = F.conv2d(img.permute(0, 3, 1, 2), sd["visual.conv1.weight"],
                 stride=8).reshape(2, 64, -1).permute(0, 2, 1)
    x = torch.cat([sd["visual.class_embedding"].expand(2, 1, -1), x], 1)
    x = x + sd["visual.positional_embedding"]
    if style == "openclip":
        x = F.layer_norm(x, (64,), sd["visual.ln_pre.weight"],
                         sd["visual.ln_pre.bias"])
    for i in range(2):
        x = _spec_block(x, sd, f"visual.transformer.resblocks.{i}", 2,
                        gelu=gelu)
    pooled = x[:, 0] if style == "openclip" else x[:, 1:].mean(1)
    pooled = F.layer_norm(pooled, (64,), sd["visual.ln_post.weight"],
                          sd["visual.ln_post.bias"])
    zimg_t = pooled @ sd["visual.proj"]
    zimg_t = zimg_t / zimg_t.norm(dim=-1, keepdim=True)

    x = sd["token_embedding.weight"][txt] + sd["positional_embedding"]
    causal = (torch.full((8, 8), float("-inf"), dtype=torch.float64).triu(1)
              if style == "openclip" else None)
    for i in range(2):
        x = _spec_block(x, sd, f"transformer.resblocks.{i}", 2,
                        attn_bias=causal, gelu=gelu)
    x = F.layer_norm(x, (64,), sd["ln_final.weight"], sd["ln_final.bias"])
    pooled = (x[torch.arange(2), txt.argmax(-1)] if style == "openclip"
              else x[:, -1])
    ztxt_t = pooled @ sd["text_projection"]
    ztxt_t = ztxt_t / ztxt_t.norm(dim=-1, keepdim=True)
    np.testing.assert_allclose(zimg.numpy(), zimg_t.numpy(), atol=1e-6)
    np.testing.assert_allclose(ztxt.numpy(), ztxt_t.numpy(), atol=1e-6)


# ------------------------------------------- transforms, losses, factories

def _jpeg(seed=0, hw=(100, 120)):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (*hw, 3), dtype=np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("square", [False, True])
def test_image_transform_eval_matches_jax(square):
    from PIL import Image
    img = Image.open(io.BytesIO(_jpeg()))
    for mean, std in ((None, None), (openclip.IMAGENET_MEAN,
                                     openclip.IMAGENET_STD)):
        kw = dict(mean=mean, std=std, square_resize_only=square)
        ours = openclip.image_transform(32, False, **kw)
        ref = jax_openclip.image_transform(32, False, **kw)
        assert ours.image_size == ref.image_size == 32
        for item in (img, np.asarray(img), _jpeg(1)):
            got = ours(item)
            assert got.shape == (3, 32, 32) and got.dtype == np.float32
            np.testing.assert_array_equal(got, ref(item))


def test_image_transform_train_matches_jax_with_the_same_draws(monkeypatch):
    """The train crop and flip from one seeded generator: the JAX transform
    draws from np.random.default_rng(), patched here to the same seed."""
    from clipa_tpu.pp import ops_image as jax_ops_image
    from clipa_tpu_torch.pp import ops_image
    monkeypatch.setattr(jax_ops_image, "_native_lib", lambda: None)
    monkeypatch.setattr(ops_image, "_native_lib", lambda: None)
    ours = openclip.image_transform(32, True, interpolation="bilinear")
    ref = jax_openclip.image_transform(32, True, interpolation="bilinear")
    for seed in range(3):
        got = ours(_jpeg(seed), rng=np.random.default_rng(seed))
        real = np.random.default_rng
        monkeypatch.setattr(np.random, "default_rng",
                            lambda *a, _s=seed: real(_s))
        want = ref(_jpeg(seed))
        monkeypatch.setattr(np.random, "default_rng", real)
        np.testing.assert_array_equal(got, want)


def test_create_loss():
    from clipa_tpu_torch import losses
    loss = openclip.create_loss("ViT-L-14")
    assert loss.func is losses.bidirectional_contrastive_loss
    assert loss.keywords == {"reduction": True}
    assert openclip.create_loss("ViT-L-14", distill=True) is \
        losses.distill_contrastive_loss
    z = torch.nn.functional.normalize(torch.randn(4, 8, generator=torch
                                                  .Generator().manual_seed(0)),
                                      dim=1)
    value, _ = loss(z, z.flip(0), torch.tensor(10.0))
    assert value.dim() == 0
    coca = openclip.create_loss(jax_openclip.get_model_config(
        "coca_ViT-B-32"))
    assert coca.func is losses.coca_loss
    assert coca.keywords == {"clip_loss_weight": 1.0,
                             "caption_loss_weight": 2.0, "pad_id": 0}


def test_create_model_and_transforms(tiny):
    path, _, _, bin_path = tiny["openclip"]
    model, train_t, val_t = openclip.create_model_and_transforms(
        path, bin_path, device="cpu")
    assert model.image_size == train_t.image_size == val_t.image_size == 48
    x = val_t(_jpeg())
    ref = jax_openclip.image_transform(48, False)(_jpeg())
    np.testing.assert_array_equal(x, ref)
    z = model.encode_image(x)   # one CHW image
    assert z.shape == (1, 32)
    model2, val2 = openclip.create_model_from_pretrained(path, bin_path,
                                                         device="cpu")
    np.testing.assert_array_equal(val2(_jpeg()), x)
    torch.testing.assert_close(model2.encode_image(x), z)


# --------------------------------------------------------------- conv towers

CONV_CONFIGS = [n for n in jax_openclip.list_models()
                if n.startswith(("convnext_", "RN"))]
CONV_TEXT = {"context_length": 8, "vocab_size": 64, "width": 64, "heads": 1,
             "layers": 1}
TINY_CONV = {
    "convnext": {
        "embed_dim": 32,
        "vision_cfg": {"timm_model_name": "convnext_tiny",
                       "timm_model_pretrained": False, "timm_pool": "",
                       "timm_proj": "mlp", "timm_drop": 0.0,
                       "timm_drop_path": 0.1, "image_size": 64},
        "text_cfg": CONV_TEXT},
    "resnet": {
        "embed_dim": 32,
        "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1],
                       "width": 16, "patch_size": None},
        "text_cfg": CONV_TEXT},
}


def test_conv_configs_are_the_seventeen():
    assert len(CONV_CONFIGS) == 17
    assert set(CONV_CONFIGS) <= set(openclip.list_models())


@pytest.mark.parametrize("name", CONV_CONFIGS)
def test_conv_configs_translate_as_the_jax_package_and_build(name):
    """The same kwargs as the JAX translation (the port's image dict adds
    `image_size`), and the full-width model builds on the meta device (no
    memory), its image tower the one the translation names."""
    cfg = openclip.get_model_config(name)
    assert cfg == jax_openclip.get_model_config(name)
    ours = openclip._to_two_towers_cfg(cfg)
    ref = jax_openclip._to_two_towers_cfg(cfg)
    assert ours["image"].pop("image_size") == cfg["vision_cfg"]["image_size"]
    assert {k: v for k, v in ours["text"].items()
            if k != "context_length"} == ref["text"]
    assert ours["image"] == ref["image"]
    for k in ("image_model", "text_model", "out_dim", "temperature_init"):
        assert ours[k] == ref[k], k
    model, _ = openclip._build(cfg, cfg["vision_cfg"]["image_size"],
                               precision="float32",
                               device=torch.device("meta"), attn_impl="auto")
    assert type(model.img).__module__ == \
        f"clipa_tpu_torch.models.{ref['image_model']}"
    stats = convert.to_jax_batch_stats(model)
    assert bool(stats) == (ref["image_model"] == "resnet")


@pytest.fixture
def conv_tiny(tmp_path, monkeypatch):
    """{tower: (config path, JAX variables, open_clip state dict, .bin)}:
    the timm convnext_tiny trunk shrunk alike in both packages, every
    parameter and statistic perturbed."""
    from clipa_tpu.models import two_towers
    tiny_dims = dict(dims=(16, 32, 64, 128), depths=(1, 1, 2, 1))
    for module in (openclip, jax_openclip):
        monkeypatch.setitem(module._TIMM_CONVNEXT, "convnext_tiny",
                            tiny_dims)
    out = {}
    for i, (tower, cfg) in enumerate(TINY_CONV.items()):
        path = str(tmp_path / f"Tiny-{tower}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        model = two_towers.Model(**jax_openclip._to_two_towers_cfg(cfg))
        variables = model.init({"params": jax.random.PRNGKey(i)},
                               jnp.zeros((1, 64, 64, 3)),
                               jnp.zeros((1, 8), jnp.int32))
        rng = np.random.RandomState(i)
        v = {"params": jax.tree_util.tree_map(
            lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
                np.float32), variables["params"])}
        if "batch_stats" in variables:
            v["batch_stats"] = jax.tree_util.tree_map(
                lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
                variables["batch_stats"])
        sd = jax_openclip.export_torch_state_dict(
            v["params"], batch_stats=v.get("batch_stats"))
        bin_path = str(tmp_path / f"{tower}.bin")
        torch.save({k: torch.from_numpy(np.array(x, np.float32))
                    for k, x in sd.items()}, bin_path)
        out[tower] = (path, v, sd, bin_path)
    return out


@pytest.mark.parametrize("tower", sorted(TINY_CONV))
def test_conv_maps_match_the_jax_maps_both_ways(conv_tiny, tower):
    """The open_clip maps of both towers, the ModifiedResNet's statistics
    with them: the port's exporter (from a model, whose BatchNorm buffers
    are the statistics, and from the JAX tree with `batch_stats`) gives
    the JAX exporter's dict, and both converters give back the JAX
    variables, bit for bit (num_batches_tracked dropped)."""
    path, variables, sd, _ = conv_tiny[tower]
    model = openclip.create_model(path, device="cpu")
    convert.load_jax_params(model.model, variables)
    stats = variables.get("batch_stats")
    for got in (openclip.export_torch_state_dict(model),
                openclip.export_torch_state_dict(variables["params"],
                                                 batch_stats=stats),
                openclip.export_torch_state_dict(_flat(variables["params"]),
                                                 batch_stats=stats)):
        assert sorted(got) == sorted(sd)
        for k in sd:
            assert got[k].dtype == sd[k].dtype, k
            np.testing.assert_array_equal(got[k], sd[k], err_msg=k)
    if tower == "resnet":
        assert "visual.layer4.0.downsample.1.running_var" in sd
        sd = dict(sd, **{"visual.bn1.num_batches_tracked": np.asarray(7)})
    else:
        assert "visual.head.mlp.fc1.weight" in sd
    heads = openclip._heads_of(model.model)
    want = jax_openclip.convert_torch_variables(sd, heads=heads)
    got = openclip.convert_torch_variables(sd, heads=heads)
    assert sorted(got) == sorted(want) == sorted(variables)
    for coll in variables:
        _assert_trees_equal(got[coll], want[coll])
        _assert_trees_equal(got[coll], variables[coll])


@pytest.mark.parametrize("tower", sorted(TINY_CONV))
def test_conv_models_from_open_clip_files_match_jax(conv_tiny, tower):
    """create_model(pretrained=<.bin>) in both packages (the JAX one
    carries the statistics as model_state): the same embeddings within
    atol 1e-5, the statistics bit for bit."""
    path, variables, _, bin_path = conv_tiny[tower]
    ours = openclip.create_model(path, bin_path, device="cpu")
    ref = jax_openclip.create_model(path, bin_path)
    images, tokens = _images(2, 64), _tokens(2)
    with jax.default_matmul_precision("highest"):
        want = (ref.encode_image(images), ref.encode_text(tokens))
    for got, w in zip((ours.encode_image(images), ours.encode_text(tokens)),
                      want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5)
    _assert_trees_equal(
        {k: v.numpy() for k, v in convert.to_jax_batch_stats(
            ours.model).items()},
        _flat(ref.model_state.get("batch_stats", {})))


def test_resnet_export_needs_its_statistics(conv_tiny):
    """An export never invents BatchNorm statistics (the JAX exporter
    writes zeros and ones in their place) and never drops one."""
    _, variables, _, _ = conv_tiny["resnet"]
    with pytest.raises(ValueError, match="BatchNorm statistics"):
        openclip.export_torch_state_dict(variables["params"])
    stats = dict(_flat(variables["batch_stats"]),
                 **{"img/bn9/mean": np.zeros(2)})
    with pytest.raises(ValueError, match="batch_stats/img/bn9/mean"):
        openclip.export_torch_state_dict(variables["params"],
                                         batch_stats=stats)


def _rn_openai_state_dict(conv_tiny):
    """An OpenAI RN release's layout: open_clip's CLIP keys with the
    BatchNorms' num_batches_tracked counters."""
    _, _, sd, _ = conv_tiny["resnet"]
    sd = dict(sd)
    for k in list(sd):
        if k.endswith(".running_mean"):
            sd[k.replace("running_mean", "num_batches_tracked")] = \
                np.asarray(3, np.int64)
    return sd


@pytest.mark.parametrize("form", ["state_dict", "torchscript"])
def test_load_openai_model_takes_a_resnet_release(conv_tiny, form,
                                                  tmp_path):
    sd = _rn_openai_state_dict(conv_tiny)
    path = str(tmp_path / "rn.pt")
    if form == "state_dict":
        torch.save(_to_torch(sd), path)
    else:
        _torchscript_archive(sd, path)
        assert openclip._is_torchscript(path)
    ours = openclip.load_openai_model(path, device="cpu")
    ref = jax_openclip.load_openai_model(path)
    assert ours.config == ref.config
    assert ours.config["vision_cfg"]["layers"] == [1, 1, 1, 1]
    images, tokens = _images(2, 64), _tokens(2)
    with jax.default_matmul_precision("highest"):
        want = (ref.encode_image(images), ref.encode_text(tokens))
    for got, w in zip((ours.encode_image(images), ours.encode_text(tokens)),
                      want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_array_equal(
        ours.model.img.layer2_0.downsample_bn.var.numpy(),
        sd["visual.layer2.0.downsample.1.running_var"])


def test_jax_npz_with_batch_stats_loads_and_saves_back(conv_tiny, tmp_path):
    """A JAX-written npz whose ``batch_stats/...`` keys sit beside the
    parameters (as the JAX loaders read it) loads into the port, embeds as
    the JAX create_model from it, and saves back the same keys and
    arrays."""
    from clipa_tpu.train import checkpoint as jax_ckpt
    from clipa_tpu_torch.train import checkpoint as ckpt
    path, variables, _, _ = conv_tiny["resnet"]
    npz = str(tmp_path / "rn.npz")
    jax_ckpt.save_checkpoint(
        {**variables["params"], "batch_stats": variables["batch_stats"]},
        npz)
    ours = openclip.create_model(path, npz, device="cpu")
    ref = jax_openclip.create_model(path, npz)
    images = _images(2, 64)
    with jax.default_matmul_precision("highest"):
        want = ref.encode_image(images)
    np.testing.assert_allclose(ours.encode_image(images).numpy(),
                               np.asarray(want), atol=1e-5)
    back = str(tmp_path / "back.npz")
    ckpt.save_variables(convert.to_jax_variables(ours.model), back)
    a, b = ckpt.npload(back), ckpt.npload(npz)
    assert sorted(a) == sorted(b)
    assert any(k.startswith("batch_stats/img/") for k in a)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sorted(ckpt.load_variables(npz)) == ["batch_stats", "params"]
    # a strict load: parameters without their statistics do not load
    with pytest.raises(RuntimeError, match="bn1.mean"):
        convert.load_jax_params(ours.model, variables["params"])


def test_infer_openai_config_matches_jax_on_a_resnet(conv_tiny):
    sd = _rn_openai_state_dict(conv_tiny)
    cfg = openclip._infer_openai_config(sd)
    assert cfg == jax_openclip._infer_openai_config(sd)
    assert cfg["vision_cfg"] == {"layers": [1, 1, 1, 1], "width": 16,
                                 "patch_size": None, "image_size": 64}


def test_convnext_head_without_bias_is_refused_as_in_jax(conv_tiny,
                                                        tmp_path):
    """The JAX ConvNeXt tower's head always has a bias, while open_clip's
    linear timm head has none by default (``timm_proj_bias`` false): a
    state dict without ``visual.head.proj.bias`` loads in neither package
    (a quirk of the reference, reproduced: ROADMAP C)."""
    path, variables, sd, _ = conv_tiny["convnext"]
    cfg = dict(TINY_CONV["convnext"])
    cfg["vision_cfg"] = dict(cfg["vision_cfg"], timm_proj="linear")
    linear = str(tmp_path / "Tiny-convnext-linear.json")
    with open(linear, "w") as f:
        json.dump(cfg, f)
    from clipa_tpu.models import two_towers
    model = two_towers.Model(**jax_openclip._to_two_towers_cfg(cfg))
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 64, 64, 3)),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    sd = jax_openclip.export_torch_state_dict(params)
    del sd["visual.head.proj.bias"]
    bin_path = str(tmp_path / "no_head_bias.bin")
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in sd.items()}, bin_path)
    with pytest.raises(ValueError, match="img/head/bias"):
        jax_openclip.create_model(linear, bin_path)
    with pytest.raises(RuntimeError, match="img.head.bias"):
        openclip.create_model(linear, bin_path, device="cpu")
