"""The port's pp ops (clipa_tpu_torch/pp, registry.py) against the JAX
package's, on the same inputs: all exact.

  * the numpy resample against ``PIL.Image.resize`` for the five methods
    (hypothesis-drawn sizes: up- and down-scales, odd sizes, 1-pixel
    edges; 2-D and float inputs as the JAX package's ``_to_pil`` takes
    them);
  * every registered op against its JAX counterpart on the same sample and
    the same seeded ``_rng`` (AutoAugment, Cutout and RandAugment
    included): equal outputs, dtypes and generator states after the op
    (the same draws, in the same order);
  * syntax_tokenize on the golden caption corpus;
  * the pretrain and smoke pp strings end to end, JPEG bytes included.

The JAX side takes the PIL route: its C++ decode library
(``clipa_tpu/native``) is patched away, as the port does not have it.
"""

import copy
import io
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

import clipa_tpu.pp  # noqa: F401  (registers the JAX package's pp ops)
import clipa_tpu_torch.pp  # noqa: F401
from clipa_tpu import registry as jax_registry
from clipa_tpu.configs import clipa_pretrain as jax_pretrain
from clipa_tpu.configs import smoke as jax_smoke
from clipa_tpu.pp import ops_image as jax_ops_image
from clipa_tpu_torch import registry
from clipa_tpu_torch.configs import clipa_pretrain, smoke
from clipa_tpu_torch.pp import ops_image, ops_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "data", "vocab.txt")
PIL_METHODS = {"bilinear": Image.Resampling.BILINEAR,
               "bicubic": Image.Resampling.BICUBIC,
               "nearest": Image.Resampling.NEAREST,
               "lanczos": Image.Resampling.LANCZOS,
               "area": Image.Resampling.BOX}
CAPTIONS = ["a golden retriever puppy playing with a red ball on green grass",
            "aerial view of a small fishing village on a rocky coastline",
            "vintage wooden chair", "Ünïcödé café: naïve résumé, don't!"]


@pytest.fixture(autouse=True)
def pil_route(monkeypatch):
    """Both packages' ops decode JPEG bytes through PIL (the native
    route's cases, in both packages, are test_native_route_*)."""
    monkeypatch.setattr(jax_ops_image, "_native_lib", lambda: None)
    monkeypatch.setattr(ops_image, "_native_lib", lambda: None)


def _encoded(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **({"quality": 90}
                                           if fmt == "JPEG" else {}))
    return buf.getvalue()


def _sample(seed=0, h=57, w=83):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return {"image": img, "jpg": _encoded(img, "JPEG"),
            "png": _encoded(img, "PNG"),
            "big_jpg": _encoded(rng.integers(0, 256, (300, 260, 3),
                                             dtype=np.uint8), "JPEG"),
            "texts": np.asarray(CAPTIONS), "txt": CAPTIONS[0].encode(),
            "label": np.asarray(seed % 1000), "labels": np.asarray([3, 1, 4]),
            "nested": {"a": np.ones(2), "b": {"c": np.zeros(3)}},
            "float_image": rng.uniform(-20, 280, (h, w, 3)).astype(np.float32),
            "gray": img[..., 0], "_keep_me": np.asarray(7)}


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        g, w = got[key], want[key]
        if key == "_rng":
            assert g.bit_generator.state == w.bit_generator.state, what
        elif isinstance(w, dict):
            _assert_same(g, w, f"{what}[{key}]")
        elif isinstance(w, (bytes, str)):
            assert g == w, (what, key)
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype, (what, key, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {key}")


def _both(spec, sample, seed):
    """Runs the JAX and the port op of `spec` on copies of `sample`, each
    with a generator seeded from `seed`."""
    outs = []
    for reg in (jax_registry, registry):
        s = copy.deepcopy(sample)
        s["_rng"] = np.random.default_rng(seed)
        outs.append(reg.get_preprocess_fn(spec)(s))
    return outs


@settings(max_examples=60, deadline=None, database=None)
@given(ih=st.integers(1, 97), iw=st.integers(1, 97),
       h=st.integers(1, 97), w=st.integers(1, 97),
       seed=st.integers(0, 2 ** 31))
def test_resample_is_pillows_bit_for_bit(ih, iw, h, w, seed):
    img = np.random.default_rng(seed).integers(0, 256, (ih, iw, 3),
                                               dtype=np.uint8)
    for method, pil in PIL_METHODS.items():
        want = np.asarray(Image.fromarray(img).resize((w, h), pil))
        got = ops_image._resize_np(img, h, w, method)
        assert got.dtype == np.uint8 and got.shape == want.shape, method
        np.testing.assert_array_equal(got, want, err_msg=method)


@pytest.mark.parametrize("method", sorted(PIL_METHODS))
@pytest.mark.parametrize("shape,size", [
    ((500, 375), (112, 112)),   # a photo to the pretrain size: 4.5x down
    ((144, 144), (112, 112)),   # the card phase's synthetic images
    ((1, 1), (64, 33)),         # 1-pixel edges, up
    ((1, 257), (1, 3)),         # a 1-pixel row, down
    ((96, 1), (7, 1)),          # a 1-pixel column, down
    ((37, 53), (37, 101)),      # one axis kept: one pass
    ((11, 13), (229, 227)),     # odd sizes, 20x up
])
def test_resample_against_jax_package(method, shape, size):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    h, w = size
    np.testing.assert_array_equal(
        ops_image._resize_np(img, h, w, method),
        jax_ops_image._resize_np(img, h, w, method))
    # 2-D images, and float images clipped and cast as _to_pil does
    np.testing.assert_array_equal(
        ops_image._resize_np(img[..., 1], h, w, method),
        jax_ops_image._resize_np(img[..., 1], h, w, method))
    noisy = rng.uniform(-30, 290, (*shape, 3))
    np.testing.assert_array_equal(
        ops_image._resize_np(noisy, h, w, method),
        jax_ops_image._resize_np(noisy, h, w, method))


def test_resample_refuses_what_pil_would_treat_otherwise():
    with pytest.raises(ValueError):
        ops_image._resize_np(np.zeros((4, 4, 4), np.uint8), 2, 2, "bilinear")
    with pytest.raises(ValueError):
        ops_image._resize_np(np.zeros((4, 4, 3), np.uint8), 0, 2, "bilinear")
    with pytest.raises(KeyError):
        ops_image._resize_np(np.zeros((4, 4, 3), np.uint8), 2, 2, "hamming")


# Every op the port registers, with the arguments and inputs a case needs.
OP_CASES = {
    "keep": ['keep("image", "labels")'],
    "drop": ['drop("jpg", "png", "big_jpg")'],
    "copy": ['copy("image", "other")'],
    "flatten": ["flatten"],
    "squeeze": ['squeeze(inkey="label", outkey="s")'],
    "onehot": ["onehot(10)", 'onehot(10, multi=False, key="label")'],
    "cast": ['cast("float32")'],
    "pad_to_shape": ["pad_to_shape((6,), pad_value=-1)"],
    "lookup": ['lookup("{vocab}", inkey="labels", outkey="tokens")'],
    "decode": ['decode(inkey="jpg", outkey="d")',
               'decode(inkey="png", outkey="d")', "decode",
               'decode(inkey="jpg", outkey="d", channels=1)'],
    "resize": ["resize(48)", 'resize((31, 17), method="bicubic")',
               'resize(40, method="nearest")',
               'resize(24, inkey="float_image", method="lanczos")',
               'resize(19, inkey="gray", method="area")'],
    "resize_small": ['resize_small(30, method="bilinear")',
                     'resize_small(100, method="bicubic")'],
    "central_crop": ["central_crop(32)", "central_crop((21, 40))"],
    "random_crop": ["random_crop(32)", "random_crop((17, 80))"],
    "inception_crop": ["inception_crop(32, area_min=60)",
                       "inception_crop()",
                       'inception_crop(21, area_min=5, method="lanczos")'],
    "decode_jpeg_and_inception_crop": [
        'decode_jpeg_and_inception_crop(inkey="jpg", size=32, area_min=40)',
        'decode_jpeg_and_inception_crop(inkey="big_jpg", size=48, '
        'area_min=5)',
        'decode_jpeg_and_inception_crop(inkey="big_jpg", size=112, '
        'area_min=40, method="bilinear", antialias=True)',
        'decode_jpeg_and_inception_crop(inkey="big_jpg")',
        "decode_jpeg_and_inception_crop(size=32, area_min=40)"],
    "flip_lr": ["flip_lr"],
    "value_range": ["value_range(-1, 1)",
                    "value_range(0, 1, clip_values=True)"],
    "vgg_value_range": ["vgg_value_range"],
    "openai_value_range": ["openai_value_range"],
    "simclr_jitter_gray": ["simclr_jitter_gray(jitter_strength=0.4)",
                           'simclr_jitter_gray(0.9, jitter_prob=1.0, '
                           'gray_prob=0.5)',
                           'simclr_jitter_gray(inkey="float_image")'],
    "random_grayscale": ["random_grayscale(0.5)"],
    "random_erase": ["random_erase(prob=0.9, max_count=3)",
                     'random_erase(prob=0.9, inkey="float_image")'],
    "color_jitter": ["color_jitter(hue=0.1, prob=0.8)",
                     "color_jitter(0.2, 0.0, 0.3)"],
    "three_augment": ["three_augment(0.3)"],
    "three_aug": ["three_aug"],
    "bert_tokenize": ['bert_tokenize(vocab_path="{vocab}", max_len=8)',
                      'bert_tokenize(vocab_path="{vocab}", max_len=32, '
                      'sample_if_multi=False)',
                      'bert_tokenize(inkey="txt", vocab_path="{vocab}", '
                      'max_len=5)'],
    "custom_bert_tokenize": [
        f'custom_bert_tokenize(vocab_path="{{vocab}}", max_len=6, '
        f'mask_type="{m}")' for m in ("first", "random", "block")] + [
        'custom_bert_tokenize(vocab_path="{vocab}", max_len=6, '
        'train=False)'],
    "syntax_tokenize": ['syntax_tokenize(vocab_path="{vocab}", max_len=8)',
                        'syntax_tokenize(inkey="txt", vocab_path="{vocab}", '
                        'max_len=4)',
                        'syntax_tokenize(vocab_path="{vocab}", max_len=64)'],
    "noun_tokenize": ['noun_tokenize(vocab_path="{vocab}", max_len=6)'],
    "lower": ['lower(inkey="txt")', 'lower(inkey="nested_text")'],
    "clip_i1k_label_names": ["clip_i1k_label_names"],
    "autoaug": ["autoaug", 'autoaug(policy="test")',
                'autoaug(inkey="image", outkey="aug")'],
    "cutout": ["cutout", "cutout(pad_size=20)", "cutout(pad_size=100)"],
    "randaug": ["randaug", "randaug(num_layers=3, magnitude=30)",
                "randaug(magnitude=9, magnitude_std=0.0, prob=0.5)",
                "randaug(num_layers=6, magnitude=15, magnitude_std=4.0)"],
    "randaug_timm": ["randaug_timm(2, 9)",
                     'randaug_timm(num_layers=4, magnitude=20, '
                     'inkey="image", outkey="aug")'],
}
SPECS = [(name, spec) for name, specs in OP_CASES.items() for spec in specs]


def test_every_registered_op_has_a_case():
    ported = {k.split(".", 1)[1] for k in registry.Registry._registry
              if k.startswith("preprocess_ops.")}
    assert ported == set(OP_CASES)
    jax_ops = {k.split(".", 1)[1]: fn.__module__
               for k, fn in jax_registry.Registry._registry.items()
               if k.startswith("preprocess_ops.")}
    # every JAX op is ported (the AutoAugment/RandAugment modules' ops last)
    assert {m for n, m in jax_ops.items() if n not in ported} == set()
    assert ported == set(jax_ops)


@pytest.mark.parametrize("name,spec", SPECS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_matches_jax_package(name, spec, seed):
    sample = _sample(seed)
    sample["nested_text"] = "MiXeD Case"
    spec = spec.format(vocab=VOCAB)
    want, got = _both(spec, sample, seed)
    _assert_same(got, want, spec)


def test_syntax_tokenize_on_the_golden_corpus():
    with open(os.path.join(REPO, "tests", "golden",
                           "syntax_corpus.json")) as f:
        corpus = json.load(f)["corpus"]
    spec = f'syntax_tokenize(vocab_path="{VOCAB}", max_len=8)'
    for i, entry in enumerate(corpus):
        assert ops_text.pos_priorities(entry["words"]) == \
            entry["priorities"], entry["caption"]
        want, got = _both(spec, {"texts": entry["caption"]}, i)
        _assert_same(got, want, entry["caption"])


def _pretrain_pp(config_mod, decoded):
    pp = config_mod.get_config(
        f"img=L/16,res=112,token_len=8,batchsize=384,vocab_path={VOCAB}"
    ).input.pp
    if decoded:
        pp = pp.replace('inkey="jpg"', 'inkey="image"').replace(
            'inkey="txt"', 'inkey="texts"')
    return pp


@pytest.mark.parametrize("decoded", [False, True])
def test_pretrain_pp_string_end_to_end(decoded):
    pp = _pretrain_pp(clipa_pretrain, decoded)
    assert pp == _pretrain_pp(jax_pretrain, decoded)
    for seed in range(4):
        sample = _sample(seed, h=144, w=144)
        sample["jpg"] = sample["big_jpg"]
        want, got = _both(pp, sample, seed)
        _assert_same(got, want, pp)
        assert got["image"].shape == (112, 112, 3)
        assert got["labels"].shape == (8,)


# the route builders as imported (pil_route patches both to None)
NATIVE_LIBS = (jax_ops_image._native_lib, ops_image._native_lib)


@pytest.fixture
def native_route(monkeypatch):
    """Both packages' decode_jpeg_and_inception_crop on their native
    libraries, the port's route counters at 0."""
    from clipa_tpu import native as jax_native
    assert jax_native.available()
    monkeypatch.setattr(jax_ops_image, "_native_lib", NATIVE_LIBS[0])
    monkeypatch.setattr(ops_image, "_native_lib", NATIVE_LIBS[1])
    monkeypatch.setattr(ops_image, "native_decodes", 0)
    monkeypatch.setattr(ops_image, "pil_decodes", 0)


@pytest.mark.parametrize("hw,size", [((57, 83), 32), ((300, 260), 112),
                                     ((144, 144), 112), ((427, 640), 112),
                                     ((31, 500), 64)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_route_matches_jax_native_route(native_route, hw, size,
                                               seed):
    """The fused libjpeg decode, crop and resize: the same pixels and the
    same generator state after the op (the box drawn in the JAX order)."""
    rng = np.random.default_rng(seed)
    jpg = _encoded(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), "JPEG")
    spec = (f'decode_jpeg_and_inception_crop(inkey="jpg", size={size}, '
            f'area_min=40)')
    want, got = _both(spec, {"jpg": jpg}, seed)
    _assert_same(got, want, spec)
    assert got["image"].shape == (size, size, 3)
    assert (ops_image.native_decodes, ops_image.pil_decodes) == (1, 0)


def test_native_route_falls_back_to_pil_per_sample(native_route):
    """Bytes the library refuses (a PNG) take the PIL route in both
    packages, sample by sample; the pretrain pp string end to end on the
    native route."""
    sample = _sample(3)
    spec = 'decode_jpeg_and_inception_crop(inkey="png", size=32)'
    want, got = _both(spec, sample, 3)
    _assert_same(got, want, spec)
    assert (ops_image.native_decodes, ops_image.pil_decodes) == (0, 1)
    pp = _pretrain_pp(clipa_pretrain, decoded=False)
    for seed in range(3):
        sample = _sample(seed, h=144, w=144)
        sample["jpg"] = sample["big_jpg"]
        want, got = _both(pp, sample, seed)
        _assert_same(got, want, pp)
    assert (ops_image.native_decodes, ops_image.pil_decodes) == (3, 1)


@pytest.mark.parametrize("op", ["bert_tokenize", "custom_bert_tokenize",
                                "syntax_tokenize"])
def test_tokenize_ops_count_encodes_by_route(monkeypatch, op):
    """Each tokenize op counts the captions it encodes under the tokenizer
    it was built with: the native WordPiece by default, the Python one when
    get_tokenizer is asked for it."""
    from clipa_tpu_torch import tokenizer
    monkeypatch.setattr(ops_text, "native_encodes", 0)
    monkeypatch.setattr(ops_text, "python_encodes", 0)
    spec = f'{op}(inkey="txt", max_len=8, vocab_path="{VOCAB}")'
    sample = {"txt": b"a small red car parked near the old stone house"}
    want = registry.get_preprocess_fn(spec)(dict(sample))["labels"]
    assert (ops_text.native_encodes, ops_text.python_encodes) == (1, 0)
    monkeypatch.setattr(ops_text, "get_tokenizer",
                        lambda path: tokenizer.get_tokenizer(
                            path, backend="python"))
    got = registry.get_preprocess_fn(spec)(dict(sample))["labels"]
    assert (ops_text.native_encodes, ops_text.python_encodes) == (1, 1)
    np.testing.assert_array_equal(got, want)


def test_smoke_pp_string_end_to_end():
    pp = smoke.get_config(f"vocab={VOCAB}").input.pp
    assert pp == jax_smoke.get_config(f"vocab={VOCAB}").input.pp
    for seed in range(4):
        want, got = _both(pp, {"image": _sample(seed, 40, 40)["image"],
                               "texts": "a photo of a cat", "label": 1},
                          seed)
        _assert_same(got, want, pp)


def test_ops_build_without_pil_and_refuse_bytes_with_its_name(monkeypatch):
    """On a machine without PIL the image ops build and take decoded
    arrays; encoded bytes raise ImportError naming the op."""
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    fn = registry.get_preprocess_fn(
        'decode|decode_jpeg_and_inception_crop(size=32)|resize(16)')
    out = fn({"image": np.zeros((40, 50, 3), np.uint8)})
    assert out["image"].shape == (16, 16, 3)
    for spec in ('decode(inkey="jpg")',
                 'decode_jpeg_and_inception_crop(inkey="jpg", size=32)'):
        op = spec.split("(")[0]
        with pytest.raises(RuntimeError, match=op) as e:
            registry.get_preprocess_fn(spec)(_sample())
        assert isinstance(e.value.__cause__, ImportError)
        assert op in str(e.value.__cause__)


def test_registry_language_matches_jax_package():
    for spec in ('a.b(1, "x", k=(2, 3))', "plain", "f()", "g(None, z=-1.5)"):
        assert registry.parse_name(spec) == jax_registry.parse_name(spec)
    for bad in ("1abc", "f(x)", "f(**k)", "a..b"):
        with pytest.raises(ValueError):
            registry.parse_name(bad)
        with pytest.raises(ValueError):
            jax_registry.parse_name(bad)
    with pytest.raises(KeyError, match="Unknown op"):
        registry.get_preprocess_fn("no_such_op")
    with registry.Registry.temporary_ops(twice=lambda: lambda s: {
            **s, "x": s["x"] * 2}):
        assert registry.get_preprocess_fn("twice|twice")({"x": 3})["x"] == 12
    assert not registry.Registry.knows("preprocess_ops.twice")
