"""clipa_tpu_torch.pp.bpe_tokenizer against clipa_tpu.pp.bpe_tokenizer.

The repo holds no BPE merges file, so the tests write their own: the tiny
one of tests/test_bpe.py, and chip_smoke.py's ``_write_merges`` (48 894
letter n-gram merges: OpenAI's file's count, so ids run to 49 407), plain
and gzipped. Ids and decodes are compared exactly, on tests/test_bpe.py's
cases and on 2000 random strings.
"""

import gzip
import random

import numpy as np
import pytest

import chip_smoke
from clipa_tpu.pp import bpe_tokenizer as jax_bpe
from clipa_tpu_torch.pp import bpe_tokenizer as bpe

TINY_MERGES = ["#version: tiny",
               "c a", "t </w>", "ca t</w>", "d o", "g </w>", "do g</w>"]


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("bpe") / "merges.txt"
    p.write_text("\n".join(TINY_MERGES))
    return str(p)


@pytest.fixture(scope="module")
def full_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("bpe_full") / "merges.txt")
    chip_smoke._write_merges(p)
    return p


@pytest.fixture(scope="module")
def gz_path(full_path, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("bpe_gz") / "merges.txt.gz")
    with open(full_path, "rb") as src, gzip.open(p, "wb") as dst:
        dst.write(src.read())
    return p


def test_bytes_to_unicode_matches_jax():
    assert bpe.bytes_to_unicode() == jax_bpe.bytes_to_unicode()
    assert len(set(bpe.bytes_to_unicode().values())) == 256


@pytest.mark.parametrize("text", ["", "  A\tb  ", "&amp;lt;x&amp;gt;",
                                  " Café\n\n naïve "])
def test_cleaning_matches_jax(text):
    assert bpe.basic_clean(text) == jax_bpe.basic_clean(text)
    assert bpe.whitespace_clean(text) == jax_bpe.whitespace_clean(text)


def test_written_merges_give_the_openai_vocab(full_path, gz_path):
    """chip_smoke.py's merges file: 48 894 merges, every one a new token, so
    the vocab is the configs' 49 408 rows with <end_of_text> 49 407."""
    with open(full_path) as f:
        assert len(f.read().split("\n")) == 1 + chip_smoke.BPE_MERGES
    for path in (full_path, gz_path):
        tok = bpe.SimpleTokenizer(path)
        assert len(tok.encoder) == len(tok.decoder) == 49408
        assert (tok.sot, tok.eot) == (49406, 49407)
        assert tok.encoder == jax_bpe.SimpleTokenizer(path).encoder


@pytest.mark.parametrize("text", ["cat", "dog", "catdog", "cat dog cat",
                                  "  CAT\n\tdog ", "dog dog dog dog dog"])
def test_tiny_merges_match_jax(tiny_path, text):
    """tests/test_bpe.py's cases: multi-step merges, unknown words split into
    byte pieces, the decode round trip, lowercasing and clean-up."""
    ours, ref = bpe.SimpleTokenizer(tiny_path), jax_bpe.SimpleTokenizer(
        tiny_path)
    ids = ours.encode(text)
    assert ids == ref.encode(text)
    assert ours.decode(ids) == ref.decode(ids)
    for ctx in (8, 77):
        np.testing.assert_array_equal(ours([text, text.upper()], ctx),
                                      ref([text, text.upper()], ctx))


def test_tiny_merges_behave_as_test_bpe(tiny_path):
    tok = bpe.SimpleTokenizer(tiny_path, context_length=8)
    assert [tok.decoder[i] for i in tok.encode("cat dog")] == ["cat</w>",
                                                              "dog</w>"]
    assert tok.decode(tok.encode("cat dog cat")).strip() == "cat dog cat"
    out = tok(["cat", "dog dog dog dog dog dog dog dog dog"])
    assert out.shape == (2, 8) and out.dtype == np.int32
    assert (out[0, 0], out[0, 2], out[0, 3], out[1, -1]) == (
        tok.sot, tok.eot, 0, tok.eot)


def test_full_merges_match_jax_on_random_strings(gz_path):
    """2000 random strings of ASCII (control characters included), some
    non-ASCII characters and words, through the gzipped 48 894-merge file:
    the same ids, the same decodes, the same framed (B, 77) arrays."""
    rng = random.Random(0)
    alphabet = ([chr(i) for i in range(128)] + list("éÉñ東京ß—“” ")
                + list("the cat sat, on A mat. photo dogs 3 ") * 4)
    ours, ref = bpe.SimpleTokenizer(gz_path), jax_bpe.SimpleTokenizer(gz_path)
    texts = []
    for _ in range(2000):
        text = "".join(rng.choice(alphabet)
                       for _ in range(rng.randint(0, 60)))
        ids = ours.encode(text)
        assert ids == ref.encode(text), repr(text)
        assert ours.decode(ids) == ref.decode(ids), repr(text)
        texts.append(text)
    np.testing.assert_array_equal(ours(texts[:200]), ref(texts[:200]))


def test_seeded_captions_are_distinct_and_match_jax(gz_path):
    """chip_smoke.py's timed text requests: the same captions from the same
    seed, 4-20 words of 3-10 lowercase letters, nearly every word new to a
    tokenizer's word cache; the port's ids equal the JAX tokenizer's."""
    a = chip_smoke._seeded_captions(np.random.RandomState(3), 256)
    assert a == chip_smoke._seeded_captions(np.random.RandomState(3), 256)
    assert a != chip_smoke._seeded_captions(np.random.RandomState(4), 256)
    words = [w for c in a for w in c.split()]
    assert all(4 <= len(c.split()) <= 20 for c in a)
    assert all(3 <= len(w) <= 10 and w.isalpha() and w.islower()
               for w in words)
    assert len(set(words)) > 0.95 * len(words)
    ours, ref = bpe.SimpleTokenizer(gz_path), jax_bpe.SimpleTokenizer(gz_path)
    np.testing.assert_array_equal(ours(a), ref(a))
    assert len(ours.cache) > 0.95 * len(set(words))
