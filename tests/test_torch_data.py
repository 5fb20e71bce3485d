"""The port's data layer (clipa_tpu_torch/data, pathio.py) against the JAX
package's, on shards the tests write: all exact.

  * TFRecord framing and tf.Example bytes both ways, and CRC32C vectors;
  * every source ``get_source`` names (tfrecord, webdataset, csv,
    image_folder, synthetic, mixture): the same samples in the same order,
    single pass and repeated, whole and split across simulated processes;
  * ``make_for_train``: batches byte-identical to the JAX package's for the
    same source, pp string (the pretrain one included) and seed, on thread
    and process workers;
  * ``make_for_inference``: the same padded batches and count;
  * ``even_file_splits``: the port raises where a process would get no
    shard file; the JAX package's leaves it an empty stream;
  * ``start_input_pipeline`` on the CPU (tests/test_torch_cuda.py holds it
    on the card).
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

import clipa_tpu.pp  # noqa: F401  (registers the JAX package's pp ops)
from clipa_tpu import registry as jax_registry
from clipa_tpu.data import core as jax_core
from clipa_tpu.data import pipeline as jax_pipeline
from clipa_tpu.data import tfrecord as jax_tfrecord
from clipa_tpu.pp import ops_image as jax_ops_image
from clipa_tpu.pp import ops_text as jax_ops_text
from clipa_tpu.pp import tokenizer as jax_tokenizer
from clipa_tpu_torch import pathio, registry, tokenizer
from clipa_tpu_torch.configs import clipa_pretrain
from clipa_tpu_torch.data import core, pipeline, tfrecord
from clipa_tpu_torch.pp import ops_image
from clipa_tpu_torch.train import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "data", "vocab.txt")
CAPTIONS = ["a photo of a small red car parked near an old stone house",
            "two dogs running on the beach", "a bowl of fresh fruit",
            "aerial view of a green forest with a winding river"]
N = 10   # examples per source


@pytest.fixture(autouse=True)
def python_route(monkeypatch):
    """Both packages' ops decode JPEG bytes through PIL (their native
    decoders: test_make_for_train_on_the_native_decode_matches); the JAX
    ops tokenize in Python: its native WordPiece shares one output buffer
    between the pipeline's threads (see test_tokenization_is_thread_safe).
    The port's tokenizer is its native one where it builds (the same ids,
    tests/test_torch_native.py)."""
    monkeypatch.setattr(jax_ops_image, "_native_lib", lambda: None)
    monkeypatch.setattr(ops_image, "_native_lib", lambda: None)
    monkeypatch.setattr(jax_ops_text, "get_tokenizer", lambda path: (
        jax_tokenizer.get_tokenizer(path, backend="python")))


def _jpeg(seed, h=48, w=64):
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """One small dataset written in each on-disk format: {name: kwargs of
    get_source}."""
    root = tmp_path_factory.mktemp("shards")
    examples = [(_jpeg(i, 40 + i, 60 - i), CAPTIONS[i % 4], i % 3)
                for i in range(N)]
    # tfrecord: 3 shards, uneven
    for s, part in enumerate((examples[:5], examples[5:8], examples[8:])):
        jax_tfrecord.write_records(str(root / f"d.tfrecord-{s:05d}"), [
            jax_tfrecord.build_example({"jpg": j, "txt": t,
                                        "label": np.asarray([c])})
            for j, t, c in part])
    # webdataset: 2 tar shards of (key.jpg, key.txt, key.json)
    for s, part in enumerate((examples[:6], examples[6:])):
        with tarfile.open(root / f"wds-{s:03d}.tar", "w") as tar:
            for i, (j, t, c) in enumerate(part):
                for ext, data in (("jpg", j), ("txt", t.encode()),
                                  ("json", json.dumps({"c": c}).encode())):
                    info = tarfile.TarInfo(f"s{s}_{i:04d}.{ext}")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    # csv + image folder
    folder = root / "folder"
    rows = ["filepath\ttitle"]
    for i, (j, t, c) in enumerate(examples):
        (folder / f"class{c}").mkdir(parents=True, exist_ok=True)
        (folder / f"class{c}" / f"{i:03d}.jpg").write_bytes(j)
        rows.append(f"folder/class{c}/{i:03d}.jpg\t{t}")
    (root / "d.csv").write_text("\n".join(rows) + "\n")
    return {
        "tfrecord": dict(name="tfrecord",
                         pattern=str(root / "d.tfrecord-*")),
        "webdataset": dict(name="webdataset",
                           pattern=str(root / "wds-{000..001}.tar"),
                           n_examples=N),
        "csv": dict(name="csv", path=str(root / "d.csv")),
        "image_folder": dict(name="image_folder", root=str(folder)),
        "synthetic": dict(name="synthetic", n_examples=N, res=24,
                          captions=CAPTIONS),
        "mixture": dict(name="mixture", sources=[
            dict(name="synthetic", n_examples=6, res=16),
            dict(name="tfrecord", pattern=str(root / "d.tfrecord-*"))],
            weights=[0.3, 0.7]),
    }


def _same(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (bytes, str, int, float)):
        assert got == want, what
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.fixture
def processes(monkeypatch):
    """Simulates process `i` of `p` in both packages' data layers."""
    def set_(i, p):
        monkeypatch.setattr(core, "_PROCESS_OVERRIDE", (i, p))
        monkeypatch.setattr(jax_core, "_PROCESS_OVERRIDE", (i, p))
    return set_


def test_crc32c_vectors():
    # RFC 3720 B.4 and the standard check value
    for data, want in ((b"123456789", 0xE3069283), (b"", 0),
                       (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
                       (bytes(range(32)), 0x46DD794E)):
        assert tfrecord.crc32c(data) == want == jax_tfrecord.crc32c(data)
        assert tfrecord.masked_crc32c(data) == \
            jax_tfrecord.masked_crc32c(data)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4095, 4096, 4097, 4099, 4100,
                               8192, 10000])
def test_crc32c_by_chunks_matches_the_bytewise_crc(n):
    """The chunked CRC (a 4096-byte table per chunk) against the JAX
    package's byte-at-a-time loop, across the chunk boundaries and with
    tails of fewer than four bytes."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data)


def test_tfrecord_round_trip_both_ways(tmp_path):
    features = {"jpg": b"\x00\xffbytes", "txt": "caption é",
                "many": [b"a", b"bc"], "f": np.asarray([1.5, -2.25],
                                                       np.float32),
                "i": np.asarray([-1, 0, 2 ** 40])}
    payload = tfrecord.build_example(features)
    assert payload == jax_tfrecord.build_example(features)
    _same(tfrecord.parse_example(payload),
          jax_tfrecord.parse_example(payload))
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert tfrecord.write_records(ours, [payload, b"", payload]) == 3
    jax_tfrecord.write_records(theirs, [payload, b"", payload])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert list(tfrecord.read_records(theirs, verify=True)) == \
        [payload, b"", payload]
    with open(ours, "r+b") as f:   # corrupt one payload byte
        f.seek(12)
        f.write(b"\x01")
    with pytest.raises(IOError, match="CRC"):
        list(tfrecord.read_records(ours, verify=True))


@pytest.mark.parametrize("name", ["tfrecord", "webdataset", "csv",
                                  "image_folder", "synthetic", "mixture"])
@pytest.mark.parametrize("split", [(0, 1), (0, 2), (1, 2)])
def test_source_matches_jax_package(shards, processes, name, split):
    processes(*split)
    ours = core.get_source(**shards[name])
    theirs = jax_core.get_source(**shards[name])
    assert ours.total_examples() == theirs.total_examples()
    assert ours.num_examples_per_process() == \
        theirs.num_examples_per_process()
    _same(ours.template_example(), theirs.template_example(), name)
    if name != "mixture":   # a mixture is a repeated stream only
        _same(list(ours.iter_process_shard(repeat=False)),
              list(theirs.iter_process_shard(repeat=False)), name)
    for seed in (None, 3):
        _same(_take(ours.iter_process_shard(repeat=True, seed=seed), 2 * N),
              _take(theirs.iter_process_shard(repeat=True, seed=seed),
                    2 * N), f"{name} seed {seed}")


def test_even_file_splits_raises_where_the_jax_package_starves(processes):
    files = ["b", "a", "c"]
    assert core.even_file_splits(files, 1, 2) == \
        jax_core.even_file_splits(files, 1, 2) == ["b"]
    # 3 files, 4 processes: process 3 gets none
    assert jax_core.even_file_splits(files, 3, 4) == []
    with pytest.raises(ValueError, match="process 3 of 4 gets no shard"):
        core.even_file_splits(files, 3, 4)


def test_a_starved_process_raises_at_its_training_stream(shards, processes):
    processes(3, 4)
    spec = dict(shards["tfrecord"])
    assert list(jax_core.get_source(**spec).process_files()) == []
    with pytest.raises(ValueError, match="gets no shard"):
        next(core.get_source(**spec).iter_process_shard(repeat=True,
                                                        seed=0))


def test_process_info_reads_torch_distributed():
    assert core.process_info() == (0, 1)   # torch.distributed uninitialized


def _batches(mod, reg, source_kw, pp, n, **kw):
    src = mod[0].get_source(**source_kw)
    it = mod[1].make_for_train(src, reg.get_preprocess_fn(pp), 4,
                               shuffle_buffer=6, seed=5, pp_str=pp, **kw)
    out = _take(it, n)
    it.close()
    return out


SMOKE_PP = ('inception_crop(size=16, area_min=60)|flip_lr|'
            f'bert_tokenize(inkey="texts", max_len=8, vocab_path="{VOCAB}")|'
            'keep("image", "labels")')


@pytest.mark.parametrize("name,pp", [
    ("synthetic", SMOKE_PP),
    ("synthetic", "pretrain decoded"),
    ("tfrecord", "pretrain"),
    ("webdataset", 'decode|resize(20, method="bicubic")|'
                   'simclr_jitter_gray(0.4)|custom_bert_tokenize('
                   f'vocab_path="{VOCAB}", max_len=6, mask_type="random")|'
                   'keep("image", "labels")'),
    ("mixture", 'onehot(4, key="label")|keep("labels")'),
])
@pytest.mark.parametrize("workers", [dict(num_workers=3),
                                     dict(num_workers=0)])
def test_make_for_train_matches_jax_package(shards, name, pp, workers):
    if pp.startswith("pretrain"):
        decoded = pp == "pretrain decoded"
        pp = clipa_pretrain.get_config(
            f"img=L/16,res=32,token_len=8,vocab_path={VOCAB}").input.pp
        if decoded:
            pp = pp.replace('inkey="jpg"', 'inkey="image"').replace(
                'inkey="txt"', 'inkey="texts"')
    want = _batches((jax_core, jax_pipeline), jax_registry, shards[name],
                    pp, 5, **workers)
    got = _batches((core, pipeline), registry, shards[name], pp, 5,
                   **workers)
    _same(got, want, f"{name} {pp}")
    assert all(b[k].shape[0] == 4 for b in got for k in b)


# the route builders as imported (python_route patches both to None)
NATIVE_LIBS = (jax_ops_image._native_lib, ops_image._native_lib)


@pytest.mark.parametrize("workers", [dict(num_workers=3),
                                     dict(worker_processes=2)])
def test_make_for_train_on_the_native_decode_matches(shards, monkeypatch,
                                                     workers):
    """The pretrain pp over JPEG tfrecords with both packages on their
    native JPEG decode (the JAX text in Python, as python_route sets):
    byte-identical batches, on the port's threads or worker processes; on
    threads every sample of the port's took the native route."""
    from clipa_tpu import native as jax_native
    assert jax_native.available()
    monkeypatch.setattr(jax_ops_image, "_native_lib", NATIVE_LIBS[0])
    monkeypatch.setattr(ops_image, "_native_lib", NATIVE_LIBS[1])
    monkeypatch.setattr(ops_image, "native_decodes", 0)
    monkeypatch.setattr(ops_image, "pil_decodes", 0)
    pp = clipa_pretrain.get_config(
        f"img=L/16,res=32,token_len=8,vocab_path={VOCAB}").input.pp
    want = _batches((jax_core, jax_pipeline), jax_registry,
                    shards["tfrecord"], pp, 5, num_workers=3)
    got = _batches((core, pipeline), registry, shards["tfrecord"], pp, 5,
                   **workers)
    _same(got, want, pp)
    if "num_workers" in workers:
        assert ops_image.pil_decodes == 0
        assert ops_image.native_decodes >= 5 * 4


def test_make_for_train_on_worker_processes_matches(shards):
    want = _batches((jax_core, jax_pipeline), jax_registry,
                    shards["synthetic"], SMOKE_PP, 3, num_workers=0)
    got = _batches((core, pipeline), registry, shards["synthetic"],
                   SMOKE_PP, 3, worker_processes=2)
    _same(got, want)


@pytest.mark.parametrize("split", [(0, 1), (1, 3)])
def test_make_for_inference_padding_matches(shards, processes, split):
    processes(*split)
    pp = 'decode|central_crop(32)|keep("image", "label")'
    outs = []
    for mod_core, mod_pipe, reg in ((jax_core, jax_pipeline, jax_registry),
                                    (core, pipeline, registry)):
        src = mod_core.get_source(**shards["image_folder"])
        it, n = mod_pipe.make_for_inference(src, reg.get_preprocess_fn(pp),
                                            6)
        outs.append((list(it), n))
    (want, n_want), (got, n_got) = outs
    assert n_got == n_want == len(got)
    _same(got, want)
    masks = np.concatenate([b["_mask"] for b in got])
    assert masks.sum() == core.get_source(
        **shards["image_folder"]).num_examples_per_process()
    assert masks.size == n_got * (6 // split[1])


def test_start_input_pipeline_on_the_cpu():
    host = [{"image": np.full((2, 3), i, np.uint8),
             "labels": np.arange(4, dtype=np.int32) + i,
             "texts": np.asarray(["a", "b"])} for i in range(5)]
    for n_prefetch in (0, 2):
        got = list(pipeline.start_input_pipeline(iter(host), "cpu",
                                                 n_prefetch=n_prefetch))
        assert len(got) == 5
        for want, batch in zip(host, got):
            assert batch["image"].dtype.is_floating_point is False
            np.testing.assert_array_equal(batch["image"].numpy(),
                                          want["image"])
            np.testing.assert_array_equal(batch["labels"].numpy(),
                                          want["labels"])
            assert list(batch["texts"]) == ["a", "b"]


def test_start_input_pipeline_surfaces_errors_and_stops_on_close():
    def failing():
        yield {"x": np.zeros(2)}
        raise OSError("shard vanished")

    it = pipeline.start_input_pipeline(failing(), "cpu", n_prefetch=2)
    next(it)
    with pytest.raises(OSError, match="shard vanished"):
        next(it)

    closed = []

    def endless():
        try:
            while True:
                yield {"x": np.zeros(2)}
        finally:
            closed.append(True)

    it = pipeline.start_input_pipeline(endless(), "cpu", n_prefetch=2)
    next(it)
    it.close()   # joins the producer, which closes its source
    assert closed == [True]


def test_pathio_is_local_only(tmp_path):
    """Local paths read as files; `local_path`, for callers that need a
    real file, refuses a URL (remote IO: tests/test_torch_pathio.py)."""
    path = str(tmp_path / "f.bin")
    with open(path, "wb") as f:
        f.write(b"abc")
    with pathio.open_file(path) as f:
        assert f.read() == b"abc"
    assert pathio.dirname(path) == str(tmp_path)
    assert pathio.local_path(path) == path
    assert pathio.is_remote("gs://bucket/x") and not pathio.is_remote(path)
    with pytest.raises(NotImplementedError, match="local path is required"):
        pathio.local_path("gs://bucket/x")
    with pytest.raises(NotImplementedError, match="local path is required"):
        checkpoint.CheckpointManager("gs://bucket/run/checkpoints")


def test_tokenization_is_thread_safe():
    """The pipeline maps pp ops on threads: the port's WordPiece gives each
    caption its own ids under 8 threads. (The JAX package's native
    tokenizer, ``clipa_tpu/native/wordpiece.py``, writes every call into
    one shared buffer and mixes captions under threads: ROADMAP C.)"""
    from concurrent.futures import ThreadPoolExecutor
    tok = tokenizer.get_wordpiece(VOCAB)
    reference = jax_tokenizer.WordPieceTokenizer(
        jax_tokenizer.load_vocab(VOCAB))
    captions = CAPTIONS * 500
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(tok.encode, captions))
    assert got == [reference.encode(c) for c in captions]
