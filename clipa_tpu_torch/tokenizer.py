"""BERT WordPiece tokenization of captions, on the host.

The port's copy of the WordPiece stack of the JAX package
(``clipa_tpu/pp/tokenizer.py`` and the ``bert_tokenize`` op of
``clipa_tpu/pp/ops_text.py``), in pure Python:

  * basic tokenization: lower-casing, NFD accent stripping, CJK spacing,
    punctuation splitting; then greedy longest-match WordPiece with "##"
    continuations (:class:`WordPieceTokenizer`; ``encode_words`` for
    pre-split words);
  * :func:`bert_tokenize`: WordPiece ids truncated or zero-padded to
    ``max_len - 1`` behind ``[CLS]``.

:func:`get_tokenizer` picks the native C++ WordPiece of
``clipa_tpu_torch/native`` (same ids, ASCII text in C++) where its library
builds. Serving tokenizes captions here. The training pp ops
(``clipa_tpu_torch/pp/ops_text.py``: ``bert_tokenize``,
``custom_bert_tokenize`` and CLIPA's syntax-priority sampling,
``syntax_tokenize``) build on the same tokenizer.
"""

from __future__ import annotations

import functools
import re
import unicodedata
from typing import Iterable, List, Sequence

import numpy as np


def load_vocab(vocab_path: str) -> list[str]:
    with open(vocab_path, encoding="utf-8") as f:
        return f.read().split("\n")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even when unicode category says
    # otherwise ($, +, <, =, >, ^, `, |, ~), per the BERT spec.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


# ASCII text (most captions) takes a fast path with the same result: its
# control characters are the C0 set but tab, newline and return, and DEL;
# its punctuation is exactly the four ASCII punctuation ranges; lower-casing
# needs no accent stripping.
_ASCII_CONTROL = dict.fromkeys([*range(0, 9), 11, 12, *range(14, 32), 127])
_ASCII_TOKEN = re.compile(r"[^\s!-/:-@\[-`{-~]+|[!-/:-@\[-`{-~]")
# A longer word is one [UNK].
MAX_CHARS_PER_WORD = 100


def basic_tokenize(text: str) -> List[str]:
    """Whitespace/punctuation/CJK tokenization, lower-cased and de-accented."""
    if text.isascii():
        return _ASCII_TOKEN.findall(text.lower().translate(_ASCII_CONTROL))
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if ch.isspace():
            out_chars.append(" ")
        elif _is_cjk(cp):
            out_chars.extend((" ", ch, " "))
        else:
            out_chars.append(ch)
    text = "".join(out_chars)

    tokens: list[str] = []
    for word in text.split():
        word = unicodedata.normalize("NFD", word.lower())
        word = "".join(c for c in word if unicodedata.category(c) != "Mn")
        # split punctuation into standalone tokens
        current: list[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a fixed vocab (lower-cased
    input, as every CLIPA text tower's)."""

    def __init__(self, vocab: Sequence[str]):
        self.vocab_index = {tok: i for i, tok in enumerate(vocab)}
        self.unk_id = self.vocab_index["[UNK]"]
        self.cls_id = self.vocab_index.get("[CLS]")

    def tokenize_word(self, word: str) -> List[int]:
        if len(word) > MAX_CHARS_PER_WORD:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                idx = self.vocab_index.get(piece)
                if idx is not None:
                    cur = idx
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        """Text -> WordPiece ids (no special tokens added)."""
        ids: list[int] = []
        for word in basic_tokenize(text):
            ids.extend(self.tokenize_word(word))
        return ids

    def encode_words(self, words: Iterable[str]) -> List[List[int]]:
        """Pre-split words -> per-word WordPiece id lists (syntax-priority
        sampling selects words before it flattens them to ids). Each word
        still goes through basic tokenization: it may split into several
        pieces, e.g. "don't"."""
        return [self.encode(word) for word in words]


@functools.lru_cache(maxsize=8)
def get_wordpiece(vocab_path: str) -> WordPieceTokenizer:
    """The (cached) Python tokenizer of a vocab file."""
    return WordPieceTokenizer(load_vocab(vocab_path))


TOKENIZER_BACKENDS = ("auto", "native", "python")


@functools.lru_cache(maxsize=8)
def get_tokenizer(vocab_path: str, lower_case: bool = True,
                  backend: str = "auto") -> WordPieceTokenizer:
    """The (cached) tokenizer of a vocab file, as the JAX package's
    ``pp/tokenizer.get_tokenizer``: "auto" takes the native C++ WordPiece
    (``clipa_tpu_torch/native``) where its library builds and the Python
    one where it does not, "native" raises where it does not build,
    "python" never tries it. Both give the same ids. Lower-case only, as
    every CLIPA text tower."""
    if backend not in TOKENIZER_BACKENDS:
        raise ValueError(f"backend must be one of {TOKENIZER_BACKENDS}, got "
                         f"{backend!r}")
    if not lower_case:
        raise NotImplementedError("the port's WordPiece is lower-case only")
    if backend != "python":
        from clipa_tpu_torch.native import wordpiece as native_wp
        try:
            return native_wp.NativeWordPieceTokenizer(load_vocab(vocab_path))
        except (OSError, RuntimeError):
            if backend == "native":
                raise
    return get_wordpiece(vocab_path)


def _pad_cls(ids: List[int], max_len: int, cls_id: int) -> np.ndarray:
    """Truncate/zero-pad to max_len-1 and prepend [CLS]."""
    ids = list(ids[:max_len - 1])
    ids = ids + [0] * (max_len - 1 - len(ids))
    return np.asarray([cls_id] + ids, np.int32)


def bert_tokenize(text: str, tok: WordPieceTokenizer,
                  max_len: int) -> np.ndarray:
    """One caption -> (max_len,) int32: [CLS] and its first max_len-1
    WordPiece ids, zero-padded."""
    return _pad_cls(tok.encode(text), max_len, tok.cls_id)
