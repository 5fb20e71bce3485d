"""clipa_tpu_torch.serving vs clipa_tpu.serving on one tiny checkpoint.

The tiny model config is a .json in a temporary directory, addressed by
path. Both services load the same npz (written by the JAX package) and
embed the same uint8 images and captions; the port runs on the CPU, where
its attention takes the kernel's plain version. fp32: atol 1e-4 on unit
embeddings (summation order through two blocks). bf16: per-row cosine >=
0.999 (the two frameworks round bf16 at different places).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clipa_tpu_torch.serving import EmbeddingService, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 48, "layers": 2, "width": 64,
                   "head_width": 16, "patch_size": 8,
                   "gelu_approximate": "tanh", "ln_pre": False,
                   "pool_style": "big_vision_gap",
                   "global_average_pool": True},
    "text_cfg": {"context_length": 8, "vocab_size": 32, "width": 64,
                 "heads": 4, "layers": 2, "bert_tokenizer": True,
                 "gelu_approximate": "tanh",
                 "pool_style": "big_vision_last", "attention_mask": False},
}
TEXTS = ["a photo of a cat", "a dog", "photo of a photo", "cat dog", "a"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch's
    intra-op pool from oversubscribing the cores the JAX tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(config path, npz written by the JAX package, vocab path)."""
    import jax.numpy as jnp
    from clipa_tpu.compat import openclip as jax_openclip
    from clipa_tpu.models import two_towers
    from clipa_tpu.train import checkpoint as jax_ckpt

    d = tmp_path_factory.mktemp("torch_serve")
    cfg_path = str(d / "Tiny-Torch.json")
    with open(cfg_path, "w") as f:
        json.dump(TINY_CFG, f)
    model = two_towers.Model(**jax_openclip._to_two_towers_cfg(TINY_CFG))
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 48, 48, 3)),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(0)  # non-zero biases, non-unit LN scales
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)
    ckpt_path = str(d / "params.npz")
    jax_ckpt.save_checkpoint({"params": params}, ckpt_path)
    vocab_path = str(d / "vocab.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "photo",
                           "of", "cat", "dog"]))
    return cfg_path, ckpt_path, vocab_path


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 48, 48, 3),
                                               np.uint8)


def _service(tiny, **kw):
    cfg_path, ckpt_path, vocab_path = tiny
    kw = {"buckets": (4, 8), "num_workers": 2, "device": "cpu", **kw}
    return EmbeddingService(cfg_path, ckpt_path, vocab_path=vocab_path, **kw)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_service_matches_jax_service(tiny, precision):
    from clipa_tpu.serving import EmbeddingService as JaxService

    cfg_path, ckpt_path, vocab_path = tiny
    ref_svc = JaxService(cfg_path, ckpt_path, vocab_path=vocab_path,
                         precision=precision, buckets=(4, 8), num_workers=0)
    svc = _service(tiny, precision=precision)
    imgs = _images(11)
    with jax.default_matmul_precision("highest"):
        ref_img = ref_svc.embed_images(imgs)
        ref_txt = ref_svc.embed_texts(TEXTS)
    zimg = svc.embed_images(imgs)
    ztxt = svc.embed_texts(TEXTS)
    assert zimg.shape == (11, 32) and ztxt.shape == (5, 32)
    assert zimg.dtype == np.float32
    for ours, ref in ((zimg, ref_img), (ztxt, ref_txt)):
        if precision == "float32":
            np.testing.assert_allclose(ours, ref, atol=1e-4)
        else:
            cos = (ours * ref).sum(1) / (np.linalg.norm(ours, axis=1)
                                         * np.linalg.norm(ref, axis=1))
            assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(svc.clip.logit_scale.numpy(),
                               np.exp(np.load(ckpt_path)["params/t"]),
                               rtol=1e-6)


def test_bucketing_consistency(tiny):
    """Padding to a bucket and the chunk boundaries change no result."""
    svc = _service(tiny, precision="float32")
    imgs = _images(13, seed=1)
    z_all = svc.embed_images(imgs)              # chunks 8 + 4 (1 padded)
    z_one = svc.embed_images(imgs[:3])          # one padded bucket of 4
    np.testing.assert_allclose(z_all[:3], z_one, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(z_all, axis=1), 1.0,
                               atol=1e-5)
    assert [take for _, take in svc._chunks(imgs)] == [8, 5]


def test_streaming_memmap(tiny, tmp_path):
    svc = _service(tiny)
    imgs = _images(6, seed=2)
    path = str(tmp_path / "img.npy")
    assert svc.embed_images_to(imgs, path) == 6
    np.testing.assert_allclose(np.load(path), svc.embed_images(imgs),
                               atol=1e-6)
    tpath = str(tmp_path / "txt.npy")
    assert svc.embed_texts_to(TEXTS[:3], tpath) == 3
    np.testing.assert_allclose(np.load(tpath), svc.embed_texts(TEXTS[:3]),
                               atol=1e-6)


def test_streaming_from_image_files(tiny, tmp_path):
    svc = _service(tiny)
    rng = np.random.RandomState(3)
    files = []
    for i in range(5):
        path = str(tmp_path / f"img{i}.jpg")
        Image.fromarray(rng.randint(0, 255, (50, 60, 3), np.uint8)).save(path)
        files.append(path)
    out = str(tmp_path / "emb.npy")
    assert svc.embed_images_to(files, out) == 5
    np.testing.assert_allclose(np.load(out), svc.embed_images(files),
                               atol=1e-6)


def test_cli(tiny, tmp_path, capsys):
    cfg_path, ckpt_path, vocab_path = tiny
    rng = np.random.RandomState(4)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (48, 48, 3), np.uint8)).save(
            str(tmp_path / f"{i}.jpg"))
    captions = tmp_path / "captions.txt"
    captions.write_text("a photo of a cat\n\na dog\n")
    out = tmp_path / "out"
    main(["--model", cfg_path, "--pretrained", ckpt_path, "--vocab",
          vocab_path, "--images", str(tmp_path / "*.jpg"), "--texts",
          str(captions), "--out", str(out), "--device", "cpu"])
    assert np.load(out / "image_embeddings.npy").shape == (3, 32)
    assert np.load(out / "text_embeddings.npy").shape == (2, 32)
    assert len((out / "image_files.txt").read_text().split("\n")) == 3
    assert "embedded 3 images" in capsys.readouterr().out


def test_clip_model_intake_and_similarity(tiny):
    """CLIPModel takes normalized NHWC or NCHW images (or one image); the
    service's similarity is the scaled cosine matrix."""
    from clipa_tpu_torch.ops import preprocess

    svc = _service(tiny, precision="float32")
    imgs = _images(3, seed=7)
    x = preprocess.normalize_uint8(torch.from_numpy(imgs))
    z_nhwc = svc.clip.encode_image(x)
    z_nchw = svc.clip.encode_image(x.permute(0, 3, 1, 2))
    torch.testing.assert_close(z_nhwc, z_nchw)
    torch.testing.assert_close(svc.clip.encode_image(x[0]), z_nhwc[:1])
    np.testing.assert_allclose(z_nhwc.numpy(), svc.embed_images(imgs),
                               atol=1e-6)
    zimg, ztxt, scale = svc.clip(x, svc.tokenizer(TEXTS[:2]))
    sim = svc.similarity(imgs, TEXTS[:2])
    assert sim.shape == (3, 2)
    np.testing.assert_allclose(
        sim, (zimg @ ztxt.T * scale).numpy(), rtol=1e-5, atol=1e-5)


def test_random_weights_without_pretrained(tiny):
    """No checkpoint: seeded random weights (same seed, same embeddings)."""
    cfg_path, _, vocab_path = tiny
    a, b, c = (EmbeddingService(cfg_path, vocab_path=vocab_path,
                                device="cpu", seed=s, buckets=(4,),
                                num_workers=0) for s in (0, 0, 1))
    imgs = _images(2, seed=5)
    np.testing.assert_array_equal(a.embed_images(imgs), b.embed_images(imgs))
    assert np.abs(a.embed_images(imgs) - c.embed_images(imgs)).max() > 1e-3


def test_cuda_device_without_a_card_raises(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _service(tiny, device="cuda")


def test_port_imports_and_serves_without_jax(tiny):
    """Importing and running the port never pulls in jax (the GPU machine
    has none)."""
    cfg_path, _, vocab_path = tiny
    code = f"""
import sys
import numpy as np
import clipa_tpu_torch.serving, clipa_tpu_torch.convert
from clipa_tpu_torch.serving import EmbeddingService
svc = EmbeddingService({cfg_path!r}, vocab_path={vocab_path!r},
                       device="cpu", buckets=(4,), num_workers=0)
assert svc.embed_images(np.zeros((2, 48, 48, 3), np.uint8)).shape == (2, 32)
assert svc.embed_texts(["a cat"]).shape == (1, 32)
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


def _multi(tiny, max_live=1):
    from clipa_tpu_torch.serving import MultiModelService
    cfg_path, ckpt_path, vocab_path = tiny
    spec = dict(model_name=cfg_path, pretrained=ckpt_path,
                vocab_path=vocab_path, buckets=(4,), num_workers=1,
                device="cpu")
    return MultiModelService({"a": spec, "b": dict(spec),
                              "c": dict(spec, seed=1, pretrained=None)},
                             max_live=max_live)


def test_multi_model_service_evicts_least_recently_used(tiny):
    """The JAX package's LRU: services build on first use, at most max_live
    stay, a hit refreshes; nothing keeps an evicted service's model or
    decode pool (weakrefs die without a gc pass), so its weights go back to
    the allocator."""
    import weakref

    svc = _multi(tiny, max_live=2)
    assert svc.names == ["a", "b", "c"]
    imgs = _images(2, seed=5)
    za = svc.embed_images("a", imgs)
    model_a = weakref.ref(svc.get("a").clip.model)
    pool_a = weakref.ref(svc.get("a")._pool)
    zb = svc.embed_images("b", imgs)
    np.testing.assert_array_equal(za, zb)   # the same weights
    svc.embed_texts("b", TEXTS)
    assert list(svc._live) == ["a", "b"]
    svc.get("a")                            # a hit: "b" is now the oldest
    assert list(svc._live) == ["b", "a"]
    zc = svc.embed_images("c", imgs)        # evicts "b"
    assert list(svc._live) == ["a", "c"]
    assert np.abs(zc - za).max() > 1e-3     # other (seeded) weights
    svc.embed_texts("c", TEXTS)
    svc.get("b")                            # evicts "a"
    assert list(svc._live) == ["c", "b"]
    assert model_a() is None and pool_a() is None
    assert svc.similarity("b", imgs, TEXTS).shape == (2, len(TEXTS))
    with pytest.raises(KeyError, match="registered"):
        svc.get("missing")
    with pytest.raises(ValueError):
        _multi(tiny, max_live=0)


def test_multi_model_service_evicts_under_a_running_request(tiny,
                                                             tmp_path):
    """Thread B switches models while thread A streams paths through the
    service it got: A's request runs on to its end on the evicted service,
    chunk after chunk through its decode pool, and writes what the
    in-RAM path gives."""
    import threading
    from PIL import Image

    svc = _multi(tiny, max_live=1)
    files = []
    for i, img in enumerate(_images(9, seed=7)):   # buckets of 4: 3 chunks
        files.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(img).save(files[-1])
    held = svc.get("a")
    want = held.embed_images(files)
    switched = threading.Event()

    def switch():
        svc.get("b")
        switched.set()

    load = held._load_image

    def load_then_wait_for_switch(item):
        if item == files[0]:
            threading.Thread(target=switch).start()
            assert switched.wait(60)
        return load(item)

    held._load_image = load_then_wait_for_switch
    out = str(tmp_path / "a.npy")
    result = {}
    thread_a = threading.Thread(
        target=lambda: result.update(n=held.embed_images_to(files, out)))
    thread_a.start()
    thread_a.join(120)
    assert switched.is_set() and list(svc._live) == ["b"]
    assert result.get("n") == len(files)
    np.testing.assert_array_equal(np.load(out), want)


def test_multi_model_service_matches_jax(tiny):
    """max_live=1 against the JAX package's MultiModelService on the same
    checkpoint: the same embeddings (fp32: atol 1e-4), one model live."""
    from clipa_tpu.serving import MultiModelService as JaxMulti

    cfg_path, ckpt_path, vocab_path = tiny
    ref = JaxMulti({"a": dict(model_name=cfg_path, pretrained=ckpt_path,
                              vocab_path=vocab_path, buckets=(4,),
                              num_workers=0, precision="float32")},
                   max_live=1)
    from clipa_tpu_torch.serving import MultiModelService
    svc = MultiModelService({"a": dict(
        model_name=cfg_path, pretrained=ckpt_path, vocab_path=vocab_path,
        buckets=(4,), num_workers=0, precision="float32", device="cpu")},
        max_live=1)
    imgs = _images(5, seed=6)
    with jax.default_matmul_precision("highest"):
        want_img = ref.embed_images("a", imgs)
        want_txt = ref.embed_texts("a", TEXTS)
    np.testing.assert_allclose(svc.embed_images("a", imgs), want_img,
                               atol=1e-4)
    np.testing.assert_allclose(svc.embed_texts("a", TEXTS), want_txt,
                               atol=1e-4)


def test_streaming_zarr_matches_npy(tiny, tmp_path):
    """fmt="zarr" streams to a TensorStore zarr array equal to the .npy
    path and to the in-RAM path (tensorstore is optional: the op imports it
    only when asked)."""
    ts = pytest.importorskip("tensorstore")
    svc = _service(tiny, buckets=(4,))
    imgs = _images(6, seed=8)
    for fmt, name in (("zarr", "img.zarr"), ("npy", "img.npy")):
        assert svc.embed_images_to(imgs, str(tmp_path / name), fmt=fmt) == 6
    assert svc.embed_texts_to(TEXTS, str(tmp_path / "txt.zarr"),
                              fmt="zarr") == len(TEXTS)

    def read(path):
        return ts.open({"driver": "zarr", "kvstore": {
            "driver": "file", "path": str(path)}}).result().read().result()

    np.testing.assert_array_equal(read(tmp_path / "img.zarr"),
                                  np.load(tmp_path / "img.npy"))
    np.testing.assert_allclose(read(tmp_path / "img.zarr"),
                               svc.embed_images(imgs), atol=1e-6)
    np.testing.assert_allclose(read(tmp_path / "txt.zarr"),
                               svc.embed_texts(TEXTS), atol=1e-6)
    with pytest.raises(ValueError, match="format"):
        svc.embed_images_to(imgs, str(tmp_path / "x"), fmt="parquet")


def test_cli_zarr(tiny, tmp_path):
    ts = pytest.importorskip("tensorstore")
    cfg_path, ckpt_path, vocab_path = tiny
    for i in range(3):
        Image.fromarray(_images(1, seed=i)[0]).save(str(tmp_path / f"{i}.png"))
    captions = tmp_path / "captions.txt"
    captions.write_text("a photo of a cat\na dog\n")
    out = tmp_path / "out"
    main(["--model", cfg_path, "--pretrained", ckpt_path, "--vocab",
          vocab_path, "--images", str(tmp_path / "*.png"), "--texts",
          str(captions), "--out", str(out), "--device", "cpu",
          "--format", "zarr"])
    arr = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": str(out / "image_embeddings.zarr")}}
    ).result().read().result()
    assert arr.shape == (3, 32)
    assert (out / "text_embeddings.zarr").is_dir()


BPE_CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 48, "layers": 2, "width": 64,
                   "head_width": 16, "patch_size": 8,
                   "global_average_pool": True},
    "text_cfg": {"context_length": 8, "vocab_size": 49408, "width": 64,
                 "heads": 4, "layers": 2, "text_mask": "syntax"},
}


def test_bpe_service_from_open_clip_checkpoint_matches_jax(tmp_path):
    """A CLIPA-v1-style config (BPE, syntax masking at 8 tokens, gap_all)
    served from an open_clip .bin: the JAX service's embeddings on the same
    file and captions (fp32: atol 1e-4)."""
    import chip_smoke
    import jax.numpy as jnp
    from clipa_tpu.compat import openclip as jax_openclip
    from clipa_tpu.models import two_towers
    from clipa_tpu.serving import EmbeddingService as JaxService

    cfg_path = str(tmp_path / "Tiny-BPE.json")
    with open(cfg_path, "w") as f:
        json.dump(BPE_CFG, f)
    merges = str(tmp_path / "merges.txt")
    chip_smoke._write_merges(merges)
    model = two_towers.Model(**jax_openclip._to_two_towers_cfg(BPE_CFG))
    params = model.init({"params": jax.random.PRNGKey(2)},
                        jnp.zeros((1, 48, 48, 3)),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    sd = jax_openclip.export_torch_state_dict(params)
    bin_path = str(tmp_path / "open_clip_pytorch_model.bin")
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in sd.items()}, bin_path)
    captions = ["a small brown dog running on the green grass near a river",
                "a photo of a cat", "two red cars beside an old church"]
    kw = dict(vocab_path=merges, precision="float32", buckets=(4, 8))
    ref = JaxService(cfg_path, bin_path, num_workers=0, **kw)
    svc = EmbeddingService(cfg_path, bin_path, device="cpu", num_workers=0,
                           **kw)
    np.testing.assert_array_equal(svc._tokenize(captions),
                                  ref._tokenize(captions))
    imgs = _images(5, seed=9)
    with jax.default_matmul_precision("highest"):
        want_img = ref.embed_images(imgs)
        want_txt = ref.embed_texts(captions)
    np.testing.assert_allclose(svc.embed_images(imgs), want_img, atol=1e-4)
    np.testing.assert_allclose(svc.embed_texts(captions), want_txt,
                               atol=1e-4)


def test_evicted_syntax_service_is_freed_in_a_fresh_process(tmp_path):
    """The first syntax-sampled caption of a process imports nltk, whose
    import keeps a traceback (nltk/parse/bllip.py): the port imports it on a
    thread of its own, so the serving frames, and the evicted model, are
    not pinned. A fresh process, where that import has not happened yet."""
    cfg_path = str(tmp_path / "Tiny-BPE.json")
    cfg = json.loads(json.dumps(BPE_CFG))
    cfg["vision_cfg"]["layers"] = cfg["text_cfg"]["layers"] = 1
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    merges = str(tmp_path / "merges.txt")
    code = f"""
import sys, weakref
import chip_smoke
from clipa_tpu_torch.serving import MultiModelService
chip_smoke._write_merges({merges!r})
assert "nltk" not in sys.modules
spec = dict(model_name={cfg_path!r}, vocab_path={merges!r},
            device="cpu", num_workers=0, buckets=(4,))
svc = MultiModelService({{"a": spec, "b": spec}}, max_live=1)
model = weakref.ref(svc.get("a").clip.model)
svc.embed_texts("a", ["a small brown dog running on the grass by a river"])
svc.get("b")
assert model() is None, "the evicted model is still referenced"
print("freed")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "freed" in proc.stdout
