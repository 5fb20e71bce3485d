"""ctypes wrapper: native WordPiece with a per-string Python fallback.

Port of ``clipa_tpu/native/wordpiece.py``, with the interface of the port's
:class:`clipa_tpu_torch.tokenizer.WordPieceTokenizer`. The native path
handles ASCII text (most LAION captions); a string with non-ASCII bytes is
encoded by the Python tokenizer, whose NFD and CJK handling defines the
semantics, and so is one with DEL (0x7f): the C++ code keeps DEL inside a
word where the Python tokenizer drops it as a control character (the JAX
wrapper returns the C++ ids; ROADMAP C).

Each ``encode`` hands the library an output buffer of its own. (The JAX
wrapper writes every call into one buffer per tokenizer, so the pipeline's
threads read each other's ids; the port does not copy that.)
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Union

import numpy as np

from clipa_tpu_torch import native
from clipa_tpu_torch import tokenizer as py_tok


class NativeWordPieceTokenizer(py_tok.WordPieceTokenizer):
    """:class:`WordPieceTokenizer` whose ``encode`` runs in C++ for ASCII
    text (lower-cased, as every CLIPA text tower's)."""

    def __init__(self, vocab: Union[str, Sequence[str]]):
        if isinstance(vocab, str):
            vocab = py_tok.load_vocab(vocab)
        super().__init__(vocab)
        self._lib = native.load()
        blob = "\n".join(vocab).encode("utf-8")
        self._handle = self._lib.wp_create(blob, len(blob))

    def encode(self, text: str) -> List[int]:
        if "\x7f" in text:
            return super().encode(text)
        data = text.encode("utf-8", "replace")
        # every id consumes at least one byte of the text: len(data) slots
        # always suffice
        out = np.empty(max(len(data), 1), np.int32)
        n = self._lib.wp_encode(self._handle, data, len(data),
                                out.ctypes.data_as(
                                    ctypes.POINTER(ctypes.c_int32)),
                                len(out))
        if n < 0:   # -1: non-ASCII; -2: the buffer is too small
            return super().encode(text)
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.wp_destroy(self._handle)
            self._handle = None
