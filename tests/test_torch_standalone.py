"""The port stands alone: it imports nothing of the JAX package, and its own
copies of that package's host-only modules compute what those do.

  * Every module of ``clipa_tpu_torch`` and ``chip_smoke.py`` (whose imports
    sit inside functions that only run on a card) is parsed, and no import
    names ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``clipa_tpu``.
  * Against the JAX package on the same inputs, all exact: the experiment
    configs over argument strings, the argument parser and the duration
    resolver, the open_clip model JSON files, WordPiece tokenization, and
    image loading (decode, shorter side resized bilinearly, centre crop).
"""

import ast
import importlib
import io
import json
import os
import random

import numpy as np
import pytest

import clipa_tpu.pp  # noqa: F401  (registers the JAX package's pp ops)
from clipa_tpu import config as jax_config
from clipa_tpu.compat import openclip as jax_openclip
from clipa_tpu.pp import tokenizer as jax_tokenizer
from clipa_tpu.registry import get_preprocess_fn
from clipa_tpu_torch import config, tokenizer
from clipa_tpu_torch.compat import openclip
from clipa_tpu_torch.serving import load_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "data", "vocab.txt")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "clipa_tpu")
SOURCES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in os.walk(os.path.join(REPO, "clipa_tpu_torch"))
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]


def _imported(source: str) -> list:
    """Every module an import statement (or ``importlib.import_module`` of
    a literal) in `source` names."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names.append(node.args[0].value)
    return names


def _forbidden(source: str) -> list:
    return [n for n in _imported(source) if n.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("path", SOURCES)
def test_no_module_imports_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        assert _forbidden(f.read()) == [], path


@pytest.mark.parametrize("snippet", [
    "from clipa_tpu.configs import clipa_finetune",
    "import clipa_tpu",
    "def f():\n    from clipa_tpu import pathio",
    "import importlib\nimportlib.import_module('clipa_tpu.pp')",
    "import jax.numpy as jnp",
])
def test_the_import_scan_finds_the_jax_package(snippet):
    assert _forbidden(snippet), snippet
    assert not _forbidden("from clipa_tpu_torch.configs import common\n"
                          "import clipa_tpu_torch")


CONFIG_ARGS = [
    ("clipa_pretrain", None),
    ("clipa_pretrain", "img=L/16,res=112,token_len=8,batchsize=384"),
    ("clipa_pretrain", "img=G/14,loss=chunked,runlocal"),
    ("clipa_pretrain", "img=B/16,text_sampling=plain,data_dir=/data"),
    ("clipa_finetune", None),
    ("clipa_finetune",
     "img=L/16,res=224,token_len=32,mask_ratio=0.3,batchsize=128"),
    ("clipa_finetune",
     "img=H/14,res=336,mask_ratio=0.4,schedule_x=1,init=/ckpt/params.npz"),
    ("clipa_finetune", "img=L/16,data_dir=/data,runlocal"),
]


@pytest.mark.parametrize("name,arg", CONFIG_ARGS)
def test_experiment_configs_match_jax(name, arg):
    ours = importlib.import_module(f"clipa_tpu_torch.configs.{name}")
    ref = importlib.import_module(f"clipa_tpu.configs.{name}")
    assert (json.loads(ours.get_config(arg).to_json())
            == json.loads(ref.get_config(arg).to_json()))


@pytest.mark.parametrize("name,arg", CONFIG_ARGS[1::4])
def test_load_config_by_path_and_module(name, arg):
    by_path = config.load_config(
        os.path.join(REPO, "clipa_tpu_torch", "configs", f"{name}.py")
        + f":{arg}")
    by_module = config.load_config(f"clipa_tpu_torch.configs.{name}:{arg}")
    # the JAX package's loader takes the file path only: with a module path
    # its function-local `import importlib.util` leaves `importlib` unbound
    ref = jax_config.load_config(
        os.path.join(REPO, "clipa_tpu", "configs", f"{name}.py") + f":{arg}")
    assert by_path.to_json() == by_module.to_json() == ref.to_json()
    with pytest.raises(UnboundLocalError):
        jax_config.load_config(f"clipa_tpu.configs.{name}:{arg}")


@pytest.mark.parametrize("arg,lazy", [
    ("", False), ("96", False), ("res=96,runlocal", False),
    ("res=96.0,name=x,scale=2", False), ("res=1e3,extra=(1, 2)", True),
    ("runlocal=false,name=None", False),
])
def test_parse_arg_matches_jax(arg, lazy):
    defaults = dict(res=84, runlocal=False, name="a", scale=1.5)
    assert (config.parse_arg(arg, lazy=lazy, **defaults)
            == jax_config.parse_arg(arg, lazy=lazy, **defaults))


@pytest.mark.parametrize("cfg,kw", [
    ({"warmup_steps": 7}, {}),
    ({"warmup_examples": 1000}, {"batch_size": 64}),
    ({"warmup_epochs": 0.5}, {"batch_size": 64, "data_size": 10_000}),
    ({"warmup_percent": 0.1}, {"total_steps": 333}),
    ({}, {"default": 3}),
])
def test_steps_matches_jax(cfg, kw):
    assert (config.steps("warmup", cfg, **kw)
            == jax_config.steps("warmup", cfg, **kw))


def test_steps_refuses_what_jax_refuses():
    for steps in (config.steps, jax_config.steps):
        with pytest.raises(ValueError):
            steps("warmup", {"warmup_steps": 1, "warmup_percent": 0.1})
        with pytest.raises(ValueError):
            steps("warmup", {})


def _port_model_names():
    return sorted(f[:-5] for f in os.listdir(openclip._CONFIG_DIR)
                  if f.endswith(".json"))


@pytest.mark.parametrize("name", _port_model_names())
def test_model_config_files_match_jax(name):
    ref = jax_openclip.get_model_config(name)
    assert openclip.get_model_config(name) == ref
    openclip._to_two_towers_cfg(ref)   # a tower the port builds


def test_model_config_files_are_every_vit_text_config():
    """The port ships every open_clip JSON file its translation takes."""
    def takes(name):
        try:
            openclip._to_two_towers_cfg(jax_openclip.get_model_config(name))
        except NotImplementedError:
            return False
        return True
    assert _port_model_names() == [n for n in jax_openclip.list_models()
                                   if takes(n)]
    assert openclip.list_models() == _port_model_names()


CAPTIONS = [
    "a photo of 3 cats",
    "A RED car, parked on the street (at night)!",
    "don't stop: $5+tax=~ok? #1 [draft] {x} <y> a|b ^ `q`",
    "tab\tnew\nline\rreturn",
    "Café naïve façade, Straße in 東京 — 'quoted' “curly”",
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
    " ".join(["word"] * 40),
    "",
]


@pytest.mark.parametrize("max_len", [8, 32])
@pytest.mark.parametrize("text", CAPTIONS)
def test_bert_tokenize_matches_jax(text, max_len):
    ref = get_preprocess_fn(
        f'bert_tokenize(inkey="texts", max_len={max_len}, '
        f'vocab_path="{VOCAB}", sample_if_multi=False)')({"texts": text})
    ours = tokenizer.bert_tokenize(text, tokenizer.get_wordpiece(VOCAB),
                                   max_len)
    np.testing.assert_array_equal(ours, ref["labels"])


def test_wordpiece_matches_jax_on_random_text():
    """The ASCII fast path and the general path against the JAX package's
    Python tokenizer, over random strings of all ASCII characters (control
    characters included) and some non-ASCII ones."""
    rng = random.Random(0)
    alphabet = ([chr(i) for i in range(128)] + list("éÉñ東京ß—“” ")
                + list("the cat sat, on A mat. ") * 4)
    ours = tokenizer.get_wordpiece(VOCAB)
    ref = jax_tokenizer.WordPieceTokenizer(VOCAB)
    for _ in range(2000):
        text = "".join(rng.choice(alphabet)
                       for _ in range(rng.randint(0, 60)))
        assert (tokenizer.basic_tokenize(text)
                == jax_tokenizer.basic_tokenize(text)), repr(text)
        assert ours.encode(text) == ref.encode(text), repr(text)


def test_get_tokenizer_pads_to_the_context_length(tmp_path):
    tok = openclip.get_tokenizer("ViT-L-16-CL32-GAP-BigVision",
                                 vocab_path=VOCAB)
    out = tok(CAPTIONS[:3] + [CAPTIONS[0].encode()])
    assert out.shape == (4, 32) and out.dtype == np.int32
    np.testing.assert_array_equal(out[0], out[3])
    # a user's JSON file of a WordPiece tower with syntax masking
    cfg = dict(openclip.get_model_config("ViT-L-16-CL32-GAP-BigVision"))
    cfg["text_cfg"] = dict(cfg["text_cfg"], text_mask="syntax")
    path = str(tmp_path / "syntax_tower.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError, match="syntax"):
        openclip.get_tokenizer(path, vocab_path=VOCAB)


@pytest.mark.parametrize("shape,fmt", [((50, 70, 3), "PNG"),
                                       ((90, 40, 3), "JPEG"),
                                       ((32, 32, 3), "PNG")])
@pytest.mark.parametrize("form", ["bytes", "array", "path"])
def test_load_image_matches_jax(shape, fmt, form, tmp_path):
    from PIL import Image
    arr = np.random.RandomState(shape[0]).randint(0, 256, shape).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt)
    item = {"bytes": buf.getvalue(), "array": arr,
            "path": str(tmp_path / f"x.{fmt.lower()}")}[form]
    if form == "path":
        with open(item, "wb") as f:
            f.write(buf.getvalue())
    ref = get_preprocess_fn(
        'decode|resize_small(24, method="bilinear")|central_crop(24)')(
        {"image": item if form != "path" else buf.getvalue()})["image"]
    ours = load_image(item, 24)
    assert ours.shape == (24, 24, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
