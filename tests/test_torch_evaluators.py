"""The port's evaluators (clipa_tpu_torch/evaluators/) against the JAX
package's on the CPU, on the same inputs.

One flat parameter dict of the fp32 smoke two-towers (Ti towers of depth 2
at 32 px, the text tower's vocabulary widened to the shipped WordPiece
vocab), made from a seed by the JAX model's init, goes into both packages
(``convert.load_jax_params``); both predict fns (``train.step.
make_predict_fn``) feed the evaluators the same sources through the same pp
strings: tfrecords this file writes (JPEG bytes, labels, captions) and the
synthetic source.

Tolerances: class embeddings rtol 1e-5 (atol 1e-7 for the elements near 0
of a unit-norm vector); zero-shot correct/count, retrieval recalls,
contrastive ncorrect, classification prec@1 and few-shot accuracies equal;
the contrastive and classification losses rtol 1e-5; the classification
losses against ``clipa_tpu.losses`` rtol 1e-6; the mean evaluator rtol
1e-6. The JAX package's ops decode through PIL and tokenize in Python, as
the port's do.
"""

import io
import os

import jax
import jax.numpy as jnp
import ml_collections
import numpy as np
import pytest
import torch
from PIL import Image

from clipa_tpu import losses as jax_losses
from clipa_tpu import registry as jax_registry
from clipa_tpu.config import ConfigDict as JaxConfigDict
from clipa_tpu.config import load_config as jax_load_config
from clipa_tpu.configs import common as jax_configs_common
from clipa_tpu.data import core as jax_core
from clipa_tpu.data import tfrecord as jax_tfrecord
from clipa_tpu.evaluators import classification as jax_classification
from clipa_tpu.evaluators import common as jax_eval_common
from clipa_tpu.evaluators import contrastive as jax_contrastive
from clipa_tpu.evaluators import fewshot as jax_fewshot
from clipa_tpu.evaluators import mean as jax_mean
from clipa_tpu.evaluators import retrieval as jax_retrieval
from clipa_tpu.evaluators import zeroshot as jax_zeroshot
from clipa_tpu.models import get_model_module as jax_get_model_module
from clipa_tpu.parallel import create_mesh
from clipa_tpu.pp import ops_image as jax_ops_image
from clipa_tpu.pp import ops_text as jax_ops_text
from clipa_tpu.pp import tokenizer as jax_tokenizer
from clipa_tpu.train import step as jax_step
from clipa_tpu_torch import convert, losses, optim, registry
from clipa_tpu_torch.config import ConfigDict, load_config
from clipa_tpu_torch.configs import common as configs_common
from clipa_tpu_torch.data import core
from clipa_tpu_torch.evaluators import (classification, common, contrastive,
                                        fewshot, mean, prompts, retrieval,
                                        zeroshot)
from clipa_tpu_torch.ops import preprocess
from clipa_tpu_torch.pp import ops_image
from clipa_tpu_torch.train import step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "data", "vocab.txt")
VOCAB_SIZE = 30522
PP_TXT = (f'bert_tokenize(inkey="texts", max_len=8, vocab_path="{VOCAB}", '
          f'sample_if_multi=False)')
PP_IMG = 'decode|resize_small(32, method="bilinear")|central_crop(32)'
CLASSES = ["a photo of a cat, a kitten", "a photo of a dog",
           "a picture of a house", "an image of a tree, a green plant"]
WORDS = ("red blue green small large old new wooden stone glass cat dog "
         "house tree river car boat bird road city").split()
N_IMAGES = 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def python_route(monkeypatch):
    """Both packages' ops decode JPEG bytes through PIL; the JAX ops
    tokenize in Python (its native WordPiece is not thread-safe)."""
    monkeypatch.setattr(jax_ops_image, "_native_lib", lambda: None)
    monkeypatch.setattr(ops_image, "_native_lib", lambda: None)
    monkeypatch.setattr(jax_ops_text, "get_tokenizer", lambda path: (
        jax_tokenizer.get_tokenizer(path, backend="python")))


def _jpeg(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Two labeled tfrecord datasets: `synthetic4-validation` (JPEGs with a
    class-dependent channel signal, every third with a second label) and
    `captions-validation` (JPEGs with one to three distinct captions)."""
    d = tmp_path_factory.mktemp("evaldata")
    rng = np.random.default_rng(0)

    def labeled():
        for i in range(N_IMAGES):
            cls = int(rng.integers(0, len(CLASSES)))
            arr = rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
            arr[..., cls % 3] //= 2
            label = [cls] if i % 3 else [cls, (cls + 1) % len(CLASSES)]
            yield jax_tfrecord.build_example({"image": _jpeg(arr),
                                              "label": np.asarray(label)})

    def captioned():
        for i in range(24):
            arr = rng.integers(0, 255, (36, 36, 3), dtype=np.uint8)
            caps = [" ".join(rng.choice(WORDS, 4)) + f" {i} {j}"
                    for j in range(1 + i % 3)]
            yield jax_tfrecord.build_example({
                "image": _jpeg(arr),
                "texts": [c.encode() for c in caps] if len(caps) > 1
                else caps[0].encode()})

    jax_tfrecord.write_records(
        str(d / "synthetic4-validation.tfrecord-00000-of-00001"), labeled())
    jax_tfrecord.write_records(
        str(d / "captions-validation.tfrecord-00000-of-00001"), captioned())
    return str(d)


@pytest.fixture(scope="module")
def towers():
    """(JAX predict fn, JAX params, the port's predict fn, its params, its
    model): the smoke two-towers from one seeded flat parameter dict."""
    spec = "clipa_tpu/configs/smoke.py:steps=2,batch=16"
    jax_config = jax_load_config(os.path.join(REPO, spec))
    jax_config.model.text.vocab_size = VOCAB_SIZE
    jax_model = jax_get_model_module("two_towers").Model(
        **dict(jax_config.model))
    params = jax_model.init(
        {"params": jax.random.PRNGKey(3)},
        jnp.zeros(jax_config.init_shapes[0], jnp.float32),
        jnp.zeros(jax_config.init_shapes[1], jnp.int32),
        train=False)["params"]
    config = load_config(os.path.join(
        REPO, spec.replace("clipa_tpu/", "clipa_tpu_torch/")))
    config.model.text.vocab_size = VOCAB_SIZE
    model = step.create_model(config, device="cpu")
    convert.load_jax_params(model, jax.device_get(params))
    return (jax_step.make_predict_fn(jax_model), params,
            step.make_predict_fn(model), optim.named_parameters(model), model)


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(fsdp=1)


def _both(jax_cls, port_cls, towers, mesh, **kw):
    """The JAX evaluator and the port's, built with the same kwargs."""
    jax_predict, _, predict, _, _ = towers
    return jax_cls(jax_predict, mesh, **kw), port_cls(predict, "cpu", **kw)


# ---------------------------------------------------------------- zero-shot

def _zeroshot_kwargs(data_dir, max_labels):
    return dict(batch_size=16, dataset_names=["synthetic4"],
                dataset_specs={"synthetic4": {
                    "name": "tfrecord",
                    "pattern": f"{data_dir}/synthetic4-validation*"}},
                class_names=CLASSES, prompt_templates="clip_paper",
                first_class_name_only=False, pp_img=PP_IMG, pp_txt=PP_TXT,
                max_labels=max_labels, num_workers=2)


@pytest.mark.parametrize("max_labels", [1, 2])
def test_zeroshot_matches_jax(towers, mesh, data_dir, max_labels):
    """Class embeddings (4 classes, two of them with an alias, x 81
    templates) and correct/count over the tfrecords, multi-label hits
    included."""
    jax_ev, ev = _both(jax_zeroshot.Evaluator, zeroshot.Evaluator, towers,
                       mesh, **_zeroshot_kwargs(data_dir, max_labels))
    _, jax_params, _, params, _ = towers
    want = jax_ev._class_embeddings(jax_params, "synthetic4")
    got = ev._class_embeddings(params, "synthetic4")
    assert got.shape == want.shape == (4, 192) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    want = jax_ev.evaluate(jax_params, "synthetic4")
    got = ev.evaluate(params, "synthetic4")
    assert got == want
    assert got["count"] == N_IMAGES
    assert ev.run(params) == [("synthetic4_accuracy", got["accuracy"])]


def test_zeroshot_multi_label_hits(towers, data_dir):
    """A prediction counts when it hits any of an example's labels: the
    second label of every third example adds hits (7 -> 14 of 40 here)."""
    _, _, predict, params, _ = towers
    one, two = (zeroshot.Evaluator(predict, "cpu",
                                   **_zeroshot_kwargs(data_dir, m)).evaluate(
        params, "synthetic4")["correct"] for m in (1, 2))
    assert two > one


def _fake_tokenize(sample):
    """A deterministic 'tokenizer': 16 int32 ids hashed from the text."""
    h = np.frombuffer(sample["texts"].encode()[:64].ljust(64, b"\0"),
                      np.uint8)
    rng = np.random.default_rng(int(h.astype(np.uint64).sum()))
    return {"labels": rng.integers(0, 30000, size=(16,)).astype(np.int32)}


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_shard_host_prompts_match_jax(nproc):
    """1000 ImageNet classes x 81 templates, every process's share."""
    names = prompts.get_class_names("imagenet2012")
    templates = prompts.get_prompt_templates("clip_paper")
    assert len(names) == 1000 and len(templates) == 81
    texts, owner = zeroshot.build_prompts(names, templates)
    assert (texts, owner) == jax_zeroshot.build_prompts(names, templates)
    seen = 0
    for pidx in range(nproc):
        got = zeroshot.shard_host_prompts(texts, owner, nproc, pidx,
                                          384 // nproc, _fake_tokenize)
        want = jax_zeroshot.shard_host_prompts(texts, owner, nproc, pidx,
                                               384 // nproc, _fake_tokenize)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        seen += int(got[2].sum())
    assert seen == len(texts)


@pytest.mark.parametrize("dataset", ["imagenet_a", "imagenet_r",
                                     "imagenet2012"])
def test_label_subset_remap_matches_jax(towers, mesh, dataset):
    """IN-A / IN-R restrict the classifier to their 200 classes; the class
    names, templates and prompt owners equal the JAX evaluator's."""
    source = core.SyntheticSource(n_examples=4, res=36)
    jax_ev, ev = _both(
        jax_zeroshot.Evaluator, zeroshot.Evaluator, towers, mesh,
        dataset_names=[dataset], pp_img=PP_IMG, pp_txt=PP_TXT,
        sources={dataset: source})
    got, want = ev.datasets[dataset], jax_ev.datasets[dataset]
    assert got["class_names"] == want["class_names"]
    assert got["templates"] == want["templates"]
    subset = prompts.get_label_subset(dataset)
    assert len(got["class_names"]) == (1000 if subset is None else 200)
    assert (zeroshot.build_prompts(got["class_names"], got["templates"])
            == jax_zeroshot.build_prompts(want["class_names"],
                                          want["templates"]))


def test_disclf_eval_decodes_jpeg_bytes_where_jax_raises(data_dir):
    """The reference fault: the JAX package's disclf_eval pp has no decode
    and fails on the encoded JPEG bytes of a tfrecord split; the port's
    decodes them, and gives the JAX result on an already-decoded image."""
    jpeg = _jpeg(np.random.default_rng(1).integers(0, 255, (144, 160, 3),
                                                   dtype=np.uint8))
    jax_pp = jax_registry.get_preprocess_fn(
        jax_configs_common.disclf_eval(112, PP_TXT)["pp_img"])
    pp_img = configs_common.disclf_eval(112, PP_TXT)["pp_img"]
    assert pp_img.startswith("decode|")
    with pytest.raises(Exception):
        jax_pp({"image": jpeg})
    got = registry.get_preprocess_fn(pp_img)({"image": jpeg})["image"]
    assert got.shape == (112, 112, 3) and got.dtype == np.uint8
    decoded = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    np.testing.assert_array_equal(
        registry.get_preprocess_fn(pp_img)({"image": decoded})["image"],
        jax_pp({"image": decoded})["image"])
    np.testing.assert_array_equal(got, jax_pp({"image": decoded})["image"])


# ---------------------------------------------------------------- retrieval

def test_retrieval_recall_functions_match_jax():
    """One random similarity matrix with ties (values on a 0.1 grid), 30
    images with 1-4 captions each."""
    rng = np.random.default_rng(0)
    ids = np.repeat(np.arange(30), rng.integers(1, 5, 30)).astype(np.int32)
    sim = np.round(rng.uniform(-1, 1, (30, len(ids))), 1)
    rows = rng.permutation(30).astype(np.int32)
    for fn, jax_fn in ((retrieval.image_to_text_retrieval_eval,
                        jax_retrieval.image_to_text_retrieval_eval),
                       (retrieval.text_to_image_retrieval_eval,
                        jax_retrieval.text_to_image_retrieval_eval)):
        for kw in ({}, {"image_row_ids": rows}):
            got = fn(sim, ids, (1, 5, 10), **kw)
            assert got == jax_fn(sim, ids, (1, 5, 10), **kw)
            assert set(got) == {"Recall@1", "Recall@5", "Recall@10"}


def test_retrieval_evaluator_matches_jax(towers, mesh, data_dir):
    """24 images with 1-3 distinct captions each, in batches of 8."""
    jax_ev, ev = _both(
        jax_retrieval.Evaluator, retrieval.Evaluator, towers, mesh,
        data=dict(name="tfrecord",
                  pattern=f"{data_dir}/captions-validation*"),
        batch_size=8, pp_img=PP_IMG, pp_txt=PP_TXT, num_workers=2)
    _, jax_params, _, params, _ = towers
    got, want = ev.run(params), jax_ev.run(jax_params)
    assert [k for k, _ in got] == [k for k, _ in want] == [
        f"{d}/Recall@{k}" for d in ("img2txt", "txt2img") for k in (1, 5, 10)]
    assert got == want
    zimg, image_ids, ztxt, text_ids = ev._embed_all(params)
    assert zimg.shape == (24, 192) and ztxt.shape == (48, 192)
    np.testing.assert_array_equal(image_ids, np.arange(24))
    np.testing.assert_array_equal(np.bincount(text_ids), [1, 2, 3] * 8)


# -------------------------------------------------------------- contrastive

def test_contrastive_matches_jax(towers, mesh):
    """40 synthetic pairs through the smoke train pp in batches of 16 (8
    padded rows masked out)."""
    pp = load_config(os.path.join(
        REPO, "clipa_tpu_torch/configs/smoke.py")).input.pp
    jax_predict, jax_params, predict, params, _ = towers
    kw = dict(batch_size=16, pp=pp, num_workers=2)
    got = dict(contrastive.Evaluator(
        predict, "cpu", source=core.SyntheticSource(n_examples=40, res=40),
        **kw).run(params))
    want = dict(jax_contrastive.Evaluator(
        jax_predict, mesh,
        source=jax_core.SyntheticSource(n_examples=40, res=40),
        **kw).run(jax_params))
    assert set(got) == {"loss", "ncorrect"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["ncorrect"] == want["ncorrect"]
    assert np.isfinite(got["loss"])


# ----------------------------------------------------------- classification

def _loss_inputs(name, rng):
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    if name == "weighted_softmax_xent":
        return dict(logits=rng.normal(size=(3, 4, 7)).astype(np.float32),
                    labels=rng.integers(0, 7, (3, 4)))
    labels = rng.uniform(size=(6, 5)).astype(np.float32)
    if name == "softmax_xent":
        labels /= labels.sum(1, keepdims=True)
    return dict(logits=logits, labels=labels)


@pytest.mark.parametrize("name,extra", [
    ("sigmoid_xent", {}), ("softmax_xent", {}), ("softmax_xent", {"kl": True}),
    ("bce_logits", {}), ("bce_logits", {"weight": "w"}),
    ("weighted_softmax_xent", {}),
    ("weighted_softmax_xent", {"label_smoothing": 0.1, "weights": "w"}),
    ("weighted_softmax_xent", {"normalize": False}),
])
@pytest.mark.parametrize("reduction", [True, False])
def test_classification_losses_match_jax(name, extra, reduction):
    rng = np.random.default_rng(0)
    inputs = _loss_inputs(name, rng)
    kw = dict(extra)
    if kw.get("weight") == "w":
        kw["weight"] = rng.uniform(size=inputs["logits"].shape).astype(
            np.float32)
    if kw.get("weights") == "w":
        kw["weights"] = rng.uniform(size=inputs["labels"].shape).astype(
            np.float32) + 0.5
    want = getattr(jax_losses, name)(
        **{k: jnp.asarray(v) for k, v in inputs.items()},
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}, reduction=reduction)
    got = getattr(losses, name)(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()},
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}, reduction=reduction)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_weighted_softmax_xent_refuses_bad_shapes():
    with pytest.raises(ValueError, match="Bad shapes"):
        losses.weighted_softmax_xent(logits=torch.zeros(2, 3),
                                     labels=torch.zeros(2, 3))


def _channel_logits(params, image=None, **unused):
    """Class c halves channel c of a synthetic image: the negated channel
    mean peaks at the true class."""
    del params, unused
    if isinstance(image, torch.Tensor):
        return -image.float().mean(dim=(1, 2)) / 16.0
    return -jnp.mean(image.astype(jnp.float32), axis=(1, 2)) / 16.0


def _zero_label_source(base):
    class ZeroLabelSource(base):
        def iter_process_shard(self, **kw):
            for i, s in enumerate(super().iter_process_shard(**kw)):
                if i % 2:
                    s["label"] = np.zeros((0,), np.int64)  # all-zero onehot
                yield s
    return ZeroLabelSource


@pytest.mark.parametrize("loss_name", ["softmax_xent", "sigmoid_xent"])
@pytest.mark.parametrize("zero_rows", [False, True])
def test_classification_matches_jax(mesh, loss_name, zero_rows):
    """22 examples in batches of 8 (2 padded rows, whose all-zero onehot
    the labels.max() rule drops too); with `zero_rows` every second row's
    label is empty, and those rows are excluded."""
    kw = dict(batch_size=8, loss_name=loss_name, num_workers=0,
              pp='onehot(3, key="label")|keep("image", "labels")')
    args = dict(n_examples=22, res=24, captions=["cat", "dog", "house"])
    make = (_zero_label_source if zero_rows else lambda base: base)
    got = dict(classification.Evaluator(
        _channel_logits, "cpu", source=make(core.SyntheticSource)(**args),
        **kw).run(None))
    want = dict(jax_classification.Evaluator(
        _channel_logits, mesh,
        source=make(jax_core.SyntheticSource)(**args), **kw).run(None))
    assert got["prec@1"] == want["prec@1"] == 1.0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_classification_resolves_logits():
    logits = torch.ones(2, 3)
    for out in (logits, (logits, None), [logits], {"logits": logits}):
        assert classification._resolve_logits(out) is logits


# --------------------------------------------------------------------- mean

def test_mean_matches_jax(mesh):
    def predict(params, batch):
        del params
        img = batch["image"]
        if isinstance(img, torch.Tensor):
            img = img.float()
            return {"pixel_mean": img.mean(dim=(1, 2, 3)),
                    "pixel_max": img.amax(dim=(1, 2, 3))}
        img = img.astype(jnp.float32)
        return {"pixel_mean": jnp.mean(img, axis=(1, 2, 3)),
                "pixel_max": jnp.max(img, axis=(1, 2, 3))}

    kw = dict(batch_size=8, pp='keep("image")', num_workers=0)
    got = dict(mean.Evaluator(predict, "cpu", source=core.SyntheticSource(
        n_examples=19, res=24), **kw).run(None))
    want = dict(jax_mean.Evaluator(
        predict, mesh, source=jax_core.SyntheticSource(n_examples=19, res=24),
        **kw).run(None))
    assert set(got) == set(want) == {"pixel_mean", "pixel_max"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    imgs = np.stack([s["image"] for s in
                     core.SyntheticSource(n_examples=19,
                                          res=24).iter_process_shard()])
    np.testing.assert_allclose(got["pixel_mean"], imgs.mean(), rtol=1e-6)


@pytest.mark.parametrize("metrics,error", [
    (lambda b: torch.ones(len(b["image"])), TypeError),
    (lambda b: {"x": torch.ones(len(b["image"]), 2)}, ValueError),
])
def test_mean_checks_the_predict_output(metrics, error):
    ev = mean.Evaluator(lambda params, batch: metrics(batch), "cpu",
                        batch_size=4, pp='keep("image")', num_workers=0,
                        source=core.SyntheticSource(n_examples=4, res=8))
    with pytest.raises(error):
        ev.run(None)


# ----------------------------------------------------------------- few-shot

def test_fewshot_on_identical_embeddings_matches_jax(mesh):
    """Both packages embed an image as its 4x-subsampled pixels over 255
    (the same float32 values): the ridge, the GCV choice and the accuracy
    at 1 and 2 shots are equal."""
    def predict(params, image=None, text=None):
        del params, text
        z = image[:, ::4, ::4, :].reshape(image.shape[0], -1)
        if isinstance(z, torch.Tensor):
            return z.float() / 255.0, None, {}
        return z.astype(jnp.float32) / 255.0, None, {}

    def datasets(src):
        return {"syn": (src(n_examples=24, res=16, captions=["a", "b", "c"]),
                        src(n_examples=18, res=16,
                            captions=["a", "b", "c"]))}

    kw = dict(batch_size=8, shots=(1, 2), pp='keep("image", "label")')
    got = fewshot.Evaluator(predict, "cpu", datasets=datasets(
        core.SyntheticSource), **kw).run(None)
    want = jax_fewshot.Evaluator(predict, mesh, datasets=datasets(
        jax_core.SyntheticSource), **kw).run(None)
    assert [k for k, _ in got] == ["syn/1shot", "syn/2shot"]
    assert got == want


# ------------------------------------------------------------- the factory

def _eval_specs():
    return dict(
        val=dict(type="contrastive", data=dict(name="synthetic",
                                               n_examples=8, res=24),
                 pp='keep("image", "labels")', log_steps=3),
        cls=dict(type="classification", prefix="c/",
                 data=dict(name="synthetic", n_examples=8, res=24),
                 pp='onehot(3, key="label")|keep("image", "labels")',
                 log_percent=0.5),
        avg=dict(type="mean", data=dict(name="synthetic", n_examples=8,
                                        res=24),
                 pp='keep("image")', log_examples=64, batch_size=4),
        ret=dict(type="proj.image_text.retrieval",
                 data=dict(name="synthetic", n_examples=8, res=24)),
        skipped=None,
    )


def test_from_config_matches_jax(mesh):
    """(name, log_steps, prefix) and the evaluator type of every entry, the
    batch size from input.batch_size or eval_batch_size."""
    def build(config_cls, from_config, device):
        config = config_cls(input=dict(batch_size=16), evals=_eval_specs())
        return from_config(config, {"predict": _channel_logits}, device,
                           total_steps=20)

    got = build(ConfigDict, common.from_config, "cpu")
    want = build(JaxConfigDict, jax_eval_common.from_config, mesh)
    assert [(n, s, p) for n, _, s, p in got] == \
        [(n, s, p) for n, _, s, p in want] == [
            ("val", 3, "val/"), ("cls", 10, "c/"), ("avg", 4, "avg/"),
            ("ret", None, "ret/")]
    assert [type(e).__module__.split(".")[-1] for _, e, _, _ in got] == \
        [type(e).__module__.split(".")[-1] for _, e, _, _ in want]
    assert [e.batch_size for _, e, _, _ in got] == [16, 16, 4, 16]
    config = ConfigDict(input=dict(batch_size=16), eval_batch_size=8,
                        evals=dict(val=_eval_specs()["val"]))
    [(_, ev, _, _)] = common.from_config(config, {"predict": None}, "cpu")
    assert ev.batch_size == 8


def test_from_config_takes_ml_collections_and_refuses_non_mappings():
    config = ConfigDict(input=dict(batch_size=16))
    config.evals = ml_collections.ConfigDict()
    config.evals.val = ml_collections.ConfigDict(_eval_specs()["val"])
    [(name, ev, log_steps, _)] = common.from_config(
        config, {"predict": None}, "cpu", total_steps=2)
    assert (name, log_steps) == ("val", 3)
    assert isinstance(ev, contrastive.Evaluator)
    config.evals = {"bad": 7}
    with pytest.raises(TypeError, match="must be a mapping"):
        common.from_config(config, {"predict": None}, "cpu")


def test_evaluators_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    source = core.SyntheticSource(n_examples=4, res=8)
    for cls in (contrastive.Evaluator, classification.Evaluator,
                mean.Evaluator, retrieval.Evaluator):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            cls(None, source=source)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fewshot.Evaluator(None)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        zeroshot.Evaluator(None, sources={"imagenet2012": source})
    config = ConfigDict(input=dict(batch_size=4),
                        evals=dict(val=_eval_specs()["val"]))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        common.from_config(config, {"predict": None})


# ------------------------------------------------------------ predict fn

def test_predict_fn_matches_jax_and_normalizes_uint8(towers):
    """uint8 images are normalized as the train step does (equal to feeding
    the normalized floats), and the embeddings equal the JAX predict fn's."""
    jax_predict, jax_params, predict, params, _ = towers
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (4, 32, 32, 3)).astype(np.uint8)
    txt = rng.randint(1, VOCAB_SIZE, (4, 8)).astype(np.int32)
    zimg, ztxt, out = predict(params, torch.from_numpy(img),
                              torch.from_numpy(txt))
    zfloat, _, _ = predict(params, preprocess.normalize_uint8(
        torch.from_numpy(img)))
    np.testing.assert_allclose(zimg.numpy(), zfloat.numpy(), atol=1e-6)
    want_img, want_txt, _ = jax_predict(jax_params, jnp.asarray(img),
                                        jnp.asarray(txt))
    np.testing.assert_allclose(zimg.numpy(), np.asarray(want_img),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ztxt.numpy(), np.asarray(want_txt),
                               rtol=1e-4, atol=1e-6)
    assert not zimg.requires_grad and "t" in out


def test_predict_fn_masks_nothing_and_draws_no_random_numbers(towers):
    """Under a fine-tune config's mask ratio the eval forward still sees
    every token, in eval mode, without drawing from torch's generator; the
    next update puts the model back in train mode."""
    _, _, predict, params, model = towers
    img = torch.from_numpy(np.random.RandomState(1).randint(
        0, 255, (2, 32, 32, 3)).astype(np.uint8))
    model.train()
    state = torch.random.get_rng_state()
    zimg, _, out = predict(params, img)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert not model.training
    with torch.no_grad():
        want, _, _ = model(preprocess.normalize_uint8(img))
    torch.testing.assert_close(zimg, want, rtol=0, atol=0)
    config = load_config(os.path.join(
        REPO, "clipa_tpu_torch/configs/smoke.py:steps=2,batch=2"))
    config.mask_ratio = 0.3
    tx, _ = optim.make(config, model, sched_kw=dict(total_steps=2))
    update = step.make_update_fn(model, tx, config)
    snapshot = {n: p.detach().clone() for n, p in params.items()}
    update({"params": params, "step": 0},
           {"image": img, "labels": torch.ones(2, 8, dtype=torch.int32)})
    assert model.training
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(snapshot[n])
