"""OpenAI CLIP BPE tokenizer (the 49408-vocab "SimpleTokenizer").

Port of ``clipa_tpu/pp/bpe_tokenizer.py``, line for line: the byte ->
unicode map, the CLIP word-splitting regex, lowercasing and html
unescaping, greedy lowest-rank BPE merges with "</w>" word endings, and
<start_of_text>/<end_of_text> framing to a fixed context length. CLIPA-v1's
model configs use it (vocab_size 49408; the v2/BigVision models use
WordPiece instead).

The merges data (``bpe_simple_vocab_16e6.txt.gz``, OpenAI's public
release, plain or gzipped) is read from a path: nothing is downloaded.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
from typing import List, Sequence

import numpy as np


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict:
    """Reversible byte -> printable-unicode map (GPT-2 convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP BPE tokenizer; pass the path to the public merges file."""

    _PATTERN = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[^\W\d_]+|\d|[^\s\w]+""", re.IGNORECASE)

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.context_length = context_length

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self._PATTERN.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length=None) -> np.ndarray:
        """texts -> (B, context_length) int32, sot/eot framed, 0-padded."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text)[:ctx - 2] + [self.eot]
            out[i, :len(toks)] = toks
        return out
