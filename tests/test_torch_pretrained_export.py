"""clipa_tpu_torch.compat.pretrained and .export against the JAX package's.

  * the registry: every list, query and cfg equal to the JAX module's; the
    publisher sha256s; a ``file://`` download with its sha256 checked (and
    a corrupt one refused), offline; the HF branch's missing package;
  * ``create_model`` resolving a tag through the (monkeypatched) registry;
  * ``save_open_clip``: the round trip bit for bit, and the weights,
    config JSON and README text equal to the JAX exporter's; the npz path
    and the command line.
"""

import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu.compat import export as jax_export
from clipa_tpu.compat import openclip as jax_openclip
from clipa_tpu.compat import pretrained as jax_registry
from clipa_tpu_torch.compat import export, openclip
from clipa_tpu_torch.compat import pretrained as registry

TINY_CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64,
                   "head_width": 32, "patch_size": 16},
    "text_cfg": {"context_length": 8, "vocab_size": 64, "width": 64,
                 "heads": 2, "layers": 1},
}
CARD = {"description": "test model", "license": "apache-2.0",
        "details": {"Dataset": "LAION-2B", "Resolution": [224, 336],
                    "Papers": {"CLIPA": "arXiv:2305.07017"}},
        "usage": "import open_clip", "citation": "@article{x}"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(config path, JAX params with perturbed leaves)."""
    from clipa_tpu.models import two_towers
    d = tmp_path_factory.mktemp("torch_export")
    path = str(d / "Tiny-Export.json")
    with open(path, "w") as f:
        json.dump(TINY_CFG, f)
    model = two_towers.Model(**jax_openclip._to_two_towers_cfg(TINY_CFG))
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 32, 32, 3)),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)
    return path, params


# ------------------------------------------------------------------ registry

def test_registry_lists_match_jax():
    assert registry.list_pretrained() == jax_registry.list_pretrained()
    assert registry.list_pretrained(as_str=True) == \
        jax_registry.list_pretrained(as_str=True)
    models = {m for m, _ in jax_registry.list_pretrained()}
    for model in sorted(models):
        assert registry.list_pretrained_tags_by_model(model) == \
            jax_registry.list_pretrained_tags_by_model(model)
        for tag in registry.list_pretrained_tags_by_model(model):
            cfg = registry.get_pretrained_cfg(model, tag)
            assert cfg == jax_registry.get_pretrained_cfg(model, tag)
            assert registry.get_pretrained_url(model, tag) == \
                jax_registry.get_pretrained_url(model, tag)
            assert registry._expected_sha256(cfg["url"]) == \
                jax_registry._expected_sha256(cfg["url"])
            assert registry.list_pretrained_models_by_tag(tag) == \
                jax_registry.list_pretrained_models_by_tag(tag)
    assert registry.is_pretrained_cfg("ViT-B-32", "LAION2B-S34B-B79K")
    assert registry.is_pretrained_cfg("ViT-L-14-quickgelu", "openai")
    assert registry.is_pretrained_cfg("ViT-H-14-CL32-GAP-BigVision",
                                      "datacomp1b_336")
    assert registry._expected_sha256(registry.get_pretrained_url(
        "ViT-L-14", "openai")).startswith("b8cca3fd")
    assert registry.get_pretrained_cfg("ViT-L-14", "laion2b_s32b_b82k")[
        "mean"] == (0.5, 0.5, 0.5)


@pytest.fixture
def release(tmp_path):
    """A checkpoint file under a path that carries the publisher's sha256
    the way mlfoundations' release names do, and an empty cache dir."""
    payload = b"checkpoint bytes"
    sha8 = hashlib.sha256(payload).hexdigest()[:8]
    src = tmp_path / "mlfoundations" / f"vit_b_32-test-{sha8}.pt"
    src.parent.mkdir()
    src.write_bytes(payload)
    cache = tmp_path / "cache"
    return src, cache, payload


def test_file_url_download_checks_sha256(release):
    src, cache, payload = release
    url = src.as_uri()
    assert registry._expected_sha256(url) == src.stem.split("-")[-1]
    path = registry.download_pretrained_from_url(url, cache_dir=str(cache))
    assert path == str(cache / src.name)
    with open(path, "rb") as f:
        assert f.read() == payload
    assert registry.checkpoint_sha256(path) == \
        jax_registry.checkpoint_sha256(path)
    # a corrupt cache entry is fetched again; a corrupt source is refused
    (cache / src.name).write_bytes(b"corrupted")
    assert registry.download_pretrained_from_url(
        url, cache_dir=str(cache)) == path
    src.write_bytes(b"corrupted")
    (cache / src.name).unlink()
    with pytest.raises(RuntimeError, match="sha256"):
        registry.download_pretrained_from_url(url, cache_dir=str(cache))


def test_download_pretrained_dispatch(release, monkeypatch):
    src, cache, _ = release
    cfg = {"url": src.as_uri(), "hf_hub": ""}
    assert registry.download_pretrained(cfg, cache_dir=str(cache)) == \
        str(cache / src.name)
    assert registry.download_pretrained("ViT-B-32", str(src)) == str(src)
    assert registry.download_pretrained(str(src)) == str(src)
    with pytest.raises(KeyError, match="openai"):
        registry.download_pretrained("ViT-B-32", "no_such_tag")
    calls = []
    monkeypatch.setattr(registry, "download_pretrained_from_hf",
                        lambda model_id, **kw: calls.append((model_id, kw))
                        or "hub-file")
    assert registry.download_pretrained(
        {"url": "", "hf_hub": "org/repo/"}, cache_dir="c") == "hub-file"
    assert calls == [("org/repo", {"cache_dir": "c"})]
    assert registry.download_pretrained({"url": "", "hf_hub": ""}) == ""


def test_hf_download_needs_huggingface_hub(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        registry.download_pretrained_from_hf("org/repo")
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        export.push_to_hf_hub({}, "ViT-B-32", "org/repo")


def test_create_model_resolves_registry_tag(monkeypatch):
    """create_model('<name>', '<tag>') goes through the registry, as the
    JAX package's does."""
    calls = {}

    def fake_download(model, tag, **kw):
        calls["args"] = (model, tag)
        raise RuntimeError("offline")

    monkeypatch.setattr(registry, "download_pretrained", fake_download)
    with pytest.raises(RuntimeError, match="offline"):
        openclip.create_model("RN50", "openai", device="cpu")
    assert calls["args"] == ("RN50", "openai")


def test_create_model_loads_a_tag_through_a_file_url(tiny, tmp_path,
                                                     monkeypatch):
    """A tag registered for the tiny config (the registry monkeypatched)
    resolves to a file:// URL, downloads into the cache under $HOME and
    loads: the weights of the export, bit for bit."""
    path, params = tiny
    folder = tmp_path / "release"
    export.save_open_clip(params, path, str(folder))
    weights = folder / export.WEIGHTS_FILENAME
    monkeypatch.setitem(registry._PRETRAINED, path, {
        "tiny_tag": {"url": weights.as_uri(), "hf_hub": "", "mean": None,
                     "std": None}})
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    model = openclip.create_model(path, "TINY-TAG", device="cpu")
    cached = tmp_path / "home" / ".cache" / "clip" / weights.name
    assert cached.is_file()
    want = openclip.create_model(path, str(weights), device="cpu")
    a, b = model.model.state_dict(), want.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# -------------------------------------------------------------------- export

def _loaded(path):
    return {k: v.numpy() for k, v in torch.load(
        path, map_location="cpu", weights_only=True).items()}


def test_save_open_clip_matches_jax(tiny, tmp_path):
    """The same params through both exporters: the same .bin contents, the
    same config JSON and the same README, byte for byte."""
    path, params = tiny
    ours = export.save_open_clip(params, path, str(tmp_path / "ours"),
                                 model_card=CARD, mean=(0.5, 0.5, 0.5))
    ref = jax_export.save_open_clip(params, path, str(tmp_path / "ref"),
                                    model_card=CARD, mean=(0.5, 0.5, 0.5))
    a = _loaded(os.path.join(ours, export.WEIGHTS_FILENAME))
    b = _loaded(os.path.join(ref, jax_export.WEIGHTS_FILENAME))
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in (export.CONFIG_FILENAME, "README.md"):
        with open(os.path.join(ours, name)) as f, \
                open(os.path.join(ref, name)) as g:
            assert f.read() == g.read(), name
    assert export.generate_readme({}, "ViT-B-32") == \
        jax_export.generate_readme({}, "ViT-B-32")
    with open(os.path.join(ours, export.CONFIG_FILENAME)) as f:
        cfg = json.load(f)
    assert cfg["model_cfg"] == TINY_CFG
    assert cfg["preprocess_cfg"]["std"] == list(openclip.OPENAI_STD)


def test_save_open_clip_round_trip(tiny, tmp_path):
    """A port model -> open_clip folder -> create_model(pretrained=.bin):
    every tensor bit for bit."""
    path, _ = tiny
    model = openclip.create_model(path, device="cpu", seed=5)
    out = export.save_open_clip(model, path, str(tmp_path / "export"))
    assert sorted(os.listdir(out)) == sorted(
        [export.WEIGHTS_FILENAME, export.CONFIG_FILENAME, "README.md"])
    back = openclip.create_model(
        path, os.path.join(out, export.WEIGHTS_FILENAME), device="cpu")
    a, b = model.model.state_dict(), back.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_save_open_clip_from_npz_and_cli(tiny, tmp_path, capsys):
    """The command-line pathway: the JAX package's flat npz -> an open_clip
    folder whose weights are the JAX exporter's."""
    from clipa_tpu.train import checkpoint as jax_ckpt
    path, params = tiny
    npz = str(tmp_path / "model.npz")
    jax_ckpt.save_checkpoint({"params": params}, npz)
    export.main(["--model", path, "--checkpoint", npz, "--out",
                 str(tmp_path / "cli")])
    assert "wrote" in capsys.readouterr().out
    ref = jax_export.save_open_clip(params, path, str(tmp_path / "ref"))
    a = _loaded(str(tmp_path / "cli" / export.WEIGHTS_FILENAME))
    b = _loaded(os.path.join(ref, jax_export.WEIGHTS_FILENAME))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(SystemExit):
        export.main(["--model", path, "--checkpoint", npz])


# --------------------------------------------------------------- conv towers

def test_conv_registry_tags_resolve_to_configs_that_build():
    """Every registered tag of a convnext or RN model names a config the
    port ships and builds (at full width, on the meta device), except
    convnext_large_d_320, whose JSON neither package has."""
    conv = sorted({m for m, _ in registry.list_pretrained()
                   if m.startswith(("convnext", "RN"))})
    assert "RN50x64" in conv and "convnext_xxlarge" in conv
    missing = []
    for model in conv:
        if model not in openclip.list_models():
            missing.append(model)
            assert model not in jax_openclip.list_models()
            continue
        assert registry.list_pretrained_tags_by_model(model)
        cfg = openclip.get_model_config(model)
        built, _ = openclip._build(cfg, cfg["vision_cfg"]["image_size"],
                                   precision="float32",
                                   device=torch.device("meta"),
                                   attn_impl="auto")
        assert type(built.img).__name__ == "_Model"
    assert missing == ["convnext_large_d_320"]


def test_save_open_clip_with_batch_stats_matches_jax(tmp_path):
    """A ModifiedResNet's npz, its ``batch_stats/...`` keys beside the
    parameters, through both packages' save_open_clip (the statistics
    popped from the file), and the tree with `batch_stats=` given: the
    same .bin contents, running means and variances included."""
    from tests.test_torch_conv_towers import RN_JSON
    from clipa_tpu.models import two_towers
    from clipa_tpu.train import checkpoint as jax_ckpt
    path = str(tmp_path / "Tiny-RN.json")
    with open(path, "w") as f:
        json.dump(RN_JSON, f)
    model = two_towers.Model(**jax_openclip._to_two_towers_cfg(RN_JSON))
    v = model.init({"params": jax.random.PRNGKey(1)},
                   jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
        v["batch_stats"])
    npz = str(tmp_path / "rn.npz")
    jax_ckpt.save_checkpoint({**params, "batch_stats": stats}, npz)
    ref = _loaded(os.path.join(jax_export.save_open_clip(
        npz, path, str(tmp_path / "ref")), jax_export.WEIGHTS_FILENAME))
    assert "visual.bn1.running_var" in ref
    for source, kw in ((npz, {}), (params, {"batch_stats": stats})):
        out = export.save_open_clip(source, path, str(tmp_path / "ours"),
                                    **kw)
        ours = _loaded(os.path.join(out, export.WEIGHTS_FILENAME))
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
