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
