"""The port's native host library (clipa_tpu_torch/native) against the JAX
package's (clipa_tpu/native), on the same inputs: all exact.

  * ``jpeg_info`` and ``jpeg_decode_crop_resize`` bit for bit on PIL-made
    JPEGs of several sizes and qualities, with a crop box and the full
    image, and the same error codes on bad input (not a JPEG, truncated, a
    box outside the image); the library linked against Pillow's bundled
    libjpeg-turbo through the repository's 6.2-API headers (the build of a
    machine without libjpeg headers) gives the same pixels;
  * ``tfr_scan`` offsets and lengths against the JAX library and the
    Python reader, the masked CRC32C against the JAX library and the
    port's Python ``crc32c``; a corrupt or truncated record is caught;
  * the native WordPiece against the Python tokenizer on data/vocab.txt,
    with ASCII and non-ASCII text, and under 8 threads; the JAX wrapper's
    shared output buffer, pinned beside it;
  * ``tokenizer.get_tokenizer``'s backends, and the build: a hashed file
    under clipa_tpu_torch/build, a failed compile raising with g++'s
    output.
"""

import ctypes
import io
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from clipa_tpu import native as jax_native
from clipa_tpu.native import wordpiece as jax_wordpiece
from clipa_tpu.pp import tokenizer as jax_tokenizer
from clipa_tpu_torch import native, tokenizer
from clipa_tpu_torch.data import tfrecord
from clipa_tpu_torch.native import wordpiece

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "data", "vocab.txt")
CAPTIONS = ["a golden retriever puppy playing with a red ball on green grass",
            "Aerial view of a small fishing village, on a rocky coastline!",
            "vintage wooden chair (1950s) with a soft blue cushion",
            "two children building a large sandcastle on a sunny beach",
            "café au lait — naïve résumé", "東京 tower at night",
            "", "   ", "don't stop-believing #42 @home"]


def _jpeg(seed, h, w, quality=90):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _info(lib, data):
    w, h = ctypes.c_int(), ctypes.c_int()
    ret = lib.jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h))
    return ret, (w.value, h.value) if ret == 0 else None


def _decode(lib, data, box, size):
    out = np.zeros((size, size, 3), np.uint8)
    ret = lib.jpeg_decode_crop_resize(
        data, len(data), *box, size, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return ret, out


@pytest.fixture(scope="module")
def libs():
    return native.load(), jax_native.load()


@pytest.mark.parametrize("hw,quality", [((48, 64), 90), ((300, 260), 75),
                                        ((500, 375), 95), ((31, 513), 60),
                                        ((112, 112), 90)])
@pytest.mark.parametrize("size", [32, 84, 112])
def test_jpeg_decode_matches_jax_bit_for_bit(libs, hw, quality, size):
    ours, ref = libs
    data = _jpeg(hw[0] * size, *hw, quality)
    assert _info(ours, data) == _info(ref, data) == (0, (hw[1], hw[0]))
    rng = np.random.default_rng(size)
    h, w = hw
    boxes = [(0, 0, 0, 0), (0, 0, h, w)]   # the full image, both ways
    for _ in range(4):
        ch, cw = int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1))
        boxes.append((int(rng.integers(0, h - ch + 1)),
                      int(rng.integers(0, w - cw + 1)), ch, cw))
    for box in boxes:
        got, want = _decode(ours, data, box, size), _decode(ref, data, box,
                                                            size)
        assert got[0] == want[0] == 0, box
        np.testing.assert_array_equal(got[1], want[1], err_msg=str(box))


def test_jpeg_bad_input_returns_the_same_errors(libs):
    ours, ref = libs
    data = _jpeg(1, 40, 50)
    png = io.BytesIO()
    Image.new("RGB", (8, 8)).save(png, "PNG")
    for bad in (b"", b"not a jpeg at all", png.getvalue(), data[:20]):
        assert _info(ours, bad) == _info(ref, bad) == (-1, None)
        assert _decode(ours, bad, (0, 0, 0, 0), 16)[0] == \
            _decode(ref, bad, (0, 0, 0, 0), 16)[0] == -1
    for box in ((30, 0, 20, 10), (0, 45, 10, 10), (-1, 0, 5, 5)):
        assert _decode(ours, data, box, 16)[0] == \
            _decode(ref, data, box, 16)[0] == -2


def test_pillow_libjpeg_build_gives_the_same_pixels(libs, tmp_path,
                                                    monkeypatch):
    """The build of a machine without /usr/include/jpeglib.h: Pillow's
    libjpeg-turbo through include/'s headers, the same pixels as the
    system libjpeg's library."""
    system = native.library_path()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "SYSTEM_HEADER", str(tmp_path / "none.h"))
    assert native.jpeg_route() == "pillow"
    path = native.build()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) != os.path.basename(system)
    lib = native.declare(ctypes.CDLL(path))
    for seed, (h, w) in enumerate([(300, 260), (57, 83), (480, 640)]):
        data = _jpeg(seed, h, w)
        for box in ((0, 0, 0, 0), (h // 4, w // 3, h // 2, w // 2)):
            got, want = _decode(lib, data, box, 112), _decode(libs[0], data,
                                                             box, 112)
            assert got[0] == want[0] == 0
            np.testing.assert_array_equal(got[1], want[1])


def _records(seed, n):
    rng = random.Random(seed)
    return [bytes(rng.getrandbits(8) for _ in range(rng.choice(
        [0, 1, 7, 300, 5000]))) for _ in range(n)]


def _scan(lib, path, verify):
    """tfr_scan's (offsets, lengths): a counting pass, then a filling one."""
    n = lib.tfr_scan(path.encode(), None, None, 0, int(verify))
    offsets, lengths = np.zeros(n, np.int64), np.zeros(n, np.int64)
    ptr = ctypes.POINTER(ctypes.c_int64)
    assert lib.tfr_scan(path.encode(), offsets.ctypes.data_as(ptr),
                        lengths.ctypes.data_as(ptr), n, int(verify)) == n
    return offsets, lengths


@pytest.mark.parametrize("verify", [False, True])
def test_tfrecord_scan_matches_jax_and_the_python_reader(tmp_path, libs,
                                                         verify):
    path = str(tmp_path / "x.tfrecord")
    payloads = _records(0, 12)
    tfrecord.write_records(path, payloads)
    offsets, lengths = _scan(libs[0], path, verify)
    assert tfrecord.count_records(path, verify=verify) == len(payloads)
    assert lengths.tolist() == [len(p) for p in payloads]
    with open(path, "rb") as f:
        blob = f.read()
    assert [blob[o:o + n] for o, n in zip(offsets, lengths)] == payloads
    assert list(tfrecord.read_records(path, verify=True)) == payloads
    ro, rl = _scan(libs[1], path, verify)
    np.testing.assert_array_equal(offsets, ro)
    np.testing.assert_array_equal(lengths, rl)


def test_masked_crc_matches_jax_and_the_python_crc(libs):
    for data in [b"", b"a", b"hello", bytes(range(256)) * 41] + _records(
            1, 6):
        want = tfrecord.masked_crc32c(data)
        assert libs[0].tfr_crc32c_masked(data, len(data)) == want
        assert libs[1].tfr_crc32c_masked(data, len(data)) == want


def test_tfrecord_scan_catches_corrupt_records(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    tfrecord.write_records(path, [b"abc" * 10, b"xyz" * 20])
    blob = bytearray(open(path, "rb").read())
    flipped = bytearray(blob)
    flipped[12 + 5] ^= 0xFF                 # a payload byte of record 0
    bad = str(tmp_path / "bad.tfrecord")
    with open(bad, "wb") as f:
        f.write(flipped)
    assert tfrecord.count_records(bad) == 2   # the CRC is read, not checked
    with pytest.raises(IOError, match="corrupt"):
        tfrecord.count_records(bad, verify=True)
    with pytest.raises(IOError, match="CRC"):
        list(tfrecord.read_records(bad, verify=True))
    truncated = str(tmp_path / "short.tfrecord")
    with open(truncated, "wb") as f:
        f.write(bytes(blob[:-10]))
    with pytest.raises(IOError, match="corrupt"):
        tfrecord.count_records(truncated, verify=True)
    # without verify the scanner seeks past the payload, as the JAX one
    # does: a truncated last record still counts (the Python reader raises)
    assert tfrecord.count_records(truncated) == jax_native.load().tfr_scan(
        truncated.encode(), None, None, 0, 0) == 2
    with pytest.raises(IOError, match="Truncated"):
        list(tfrecord.read_records(truncated))
    with pytest.raises(IOError, match="cannot read"):
        tfrecord.count_records(str(tmp_path / "missing.tfrecord"))


def test_native_wordpiece_matches_the_python_tokenizer():
    """ASCII text (control characters and punctuation included) in C++,
    non-ASCII text through the Python fallback: the Python tokenizer's
    ids, and the JAX package's."""
    ours = wordpiece.NativeWordPieceTokenizer(VOCAB)
    py = tokenizer.get_wordpiece(VOCAB)
    ref = jax_tokenizer.WordPieceTokenizer(VOCAB)
    rng = random.Random(0)
    alphabet = ([chr(i) for i in range(128)] + list("éÉñ東京ß—“” ")
                + list("the cat sat, on A mat. ") * 4)
    texts = CAPTIONS + ["x" * 150, "supercalifragilisticexpialidocious"]
    texts += ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 60)))
              for _ in range(2000)]
    for text in texts:
        assert ours.encode(text) == py.encode(text) == ref.encode(text), \
            repr(text)
    words = CAPTIONS[3].split()
    assert ours.encode_words(words) == py.encode_words(words)


def test_reference_native_wordpiece_keeps_del_the_port_does_not():
    """ROADMAP C: the C++ WordPiece (both packages' copy) keeps DEL (0x7f)
    inside a word, where the Python tokenizer drops it as a control
    character; the JAX wrapper returns the C++ ids, the port's sends text
    with DEL to the Python tokenizer."""
    ref = jax_wordpiece.NativeWordPieceTokenizer(VOCAB)
    ours = wordpiece.NativeWordPieceTokenizer(VOCAB)
    py = tokenizer.get_wordpiece(VOCAB)
    for text in ("a\x7fb", "cat\x7f", "\x7f", "two\x7f dogs"):
        assert ref.encode(text) != py.encode(text)   # the fault
        assert ours.encode(text) == py.encode(text)


def test_native_tokenizer_is_thread_safe():
    """8 threads, 2000 captions: each caption gets its own ids (a buffer
    per call), under a short switch interval."""
    tok = wordpiece.NativeWordPieceTokenizer(VOCAB)
    py = tokenizer.get_wordpiece(VOCAB)
    captions = [f"{c} {i}" for i, c in
                enumerate((CAPTIONS[:4] + CAPTIONS[-1:]) * 400)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(tok.encode, captions))
    finally:
        sys.setswitchinterval(interval)
    assert got == [py.encode(c) for c in captions]


class _Interleaved:
    """A library whose wp_encode lets another caller's encode run between
    this call's write and its read (one thread overtaking another)."""

    def __init__(self, lib, other):
        self._lib, self.other, self.inside = lib, other, False

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def wp_encode(self, *args):
        n = self._lib.wp_encode(*args)
        if not self.inside:
            self.inside = True
            try:
                self.other()
            finally:
                self.inside = False
        return n


def test_reference_shared_buffer_mixes_captions_the_port_does_not():
    """ROADMAP C: the JAX wrapper writes every encode into one buffer per
    tokenizer, so a call overtaken by another returns the other caption's
    ids; the port's buffer per call keeps each caption's own."""
    a, b = CAPTIONS[0], CAPTIONS[3]
    want = tokenizer.get_wordpiece(VOCAB).encode(a)
    ref = jax_wordpiece.NativeWordPieceTokenizer(VOCAB)
    ref._lib = _Interleaved(ref._lib, lambda: ref.encode(b))
    assert ref.encode(a) != want                       # the fault
    ours = wordpiece.NativeWordPieceTokenizer(VOCAB)
    ours._lib = _Interleaved(ours._lib, lambda: ours.encode(b))
    assert ours.encode(a) == want


def test_get_tokenizer_backends(monkeypatch):
    tokenizer.get_tokenizer.cache_clear()
    try:
        assert isinstance(tokenizer.get_tokenizer(VOCAB),
                          wordpiece.NativeWordPieceTokenizer)
        assert tokenizer.get_tokenizer(VOCAB, backend="python") is \
            tokenizer.get_wordpiece(VOCAB)
        with pytest.raises(ValueError, match="backend"):
            tokenizer.get_tokenizer(VOCAB, backend="rust")
        with pytest.raises(NotImplementedError, match="lower-case"):
            tokenizer.get_tokenizer(VOCAB, lower_case=False)
        tokenizer.get_tokenizer.cache_clear()

        def broken():
            raise RuntimeError("g++ failed")
        monkeypatch.setattr(native, "load", broken)
        assert tokenizer.get_tokenizer(VOCAB) is tokenizer.get_wordpiece(VOCAB)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tokenizer.get_tokenizer(VOCAB, backend="native")
    finally:
        tokenizer.get_tokenizer.cache_clear()


def test_build_is_hashed_outside_the_package_and_raises_with_gxx_output(
        tmp_path, monkeypatch):
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libclipa_native-")
    assert native.build_seconds == 0.0   # built once, then found by hash
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(native.__file__)))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXXFLAGS",
                        native.CXXFLAGS + ("-fno-such-option",))
    assert native.library_path() != path
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "no-such-option" in str(e.value)
    assert os.listdir(tmp_path) == []   # the temporary file is removed
