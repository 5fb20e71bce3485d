"""Text preprocessing ops: WordPiece tokenization + CLIPA token reduction.

Port of ``clipa_tpu/pp/ops_text.py`` on the port's WordPiece, through
``clipa_tpu_torch/tokenizer.get_tokenizer`` as the JAX ops go through
theirs: the native C++ WordPiece where its library builds, else the Python
one (the same ids). Reference semantics
(clipa_jax/transforms/bert_ops.py):
  * `bert_tokenize` — sample one caption (random if several), WordPiece,
    truncate/zero-pad to max_len-1, prepend [CLS].
  * `custom_bert_tokenize` — text-token reduction for short-text pretrain:
    mask_type 'first' (truncate), 'random' (uniform token sample via
    shuffle), 'block' (random contiguous window).
  * `noun_tokenize` / `syntax_tokenize` — syntax-priority sampling: keep
    nouns > adjectives > verbs > other. The reference tags with NLTK
    (bert_ops.py:64-88); without the NLTK corpora (offline hosts) we fall
    back to a deterministic suffix-heuristic tagger with the same priority
    classes. The tagger choice is the JAX package's: ``nltk.pos_tag`` where
    its tagger data is installed, else :func:`_heuristic_tags`.

Randomness: ops draw from the per-sample numpy Generator the input pipeline
plants under `sample["_rng"]` (deterministic given the pipeline seed),
falling back to a module-level generator.
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from clipa_tpu_torch.native.wordpiece import NativeWordPieceTokenizer
from clipa_tpu_torch.registry import InKeyOutKey, Registry
from clipa_tpu_torch.tokenizer import _pad_cls, basic_tokenize, get_tokenizer

_default_rng = np.random.default_rng(0)

# Captions the tokenize ops encoded, by the tokenizer they were built with
native_encodes = 0
python_encodes = 0
_route_lock = threading.Lock()


def _encode(tok, txt: str) -> List[int]:
    """tok.encode(txt), counted under its tokenizer's route."""
    global native_encodes, python_encodes
    with _route_lock:
        if isinstance(tok, NativeWordPieceTokenizer):
            native_encodes += 1
        else:
            python_encodes += 1
    return tok.encode(txt)


def _rng_of(sample) -> np.random.Generator:
    return sample.get("_rng", _default_rng) if isinstance(sample, dict) \
        else _default_rng


def _pick_caption(labels, sample_if_multi: bool, rng) -> str:
    """Flattens a str / bytes / list-of-str caption field and picks one."""
    if isinstance(labels, bytes):
        return labels.decode("utf-8", "replace")
    if isinstance(labels, str):
        return labels
    flat = np.asarray(labels).reshape(-1).tolist()
    flat = [x.decode("utf-8", "replace") if isinstance(x, bytes) else str(x)
            for x in flat]
    if not flat:
        return ""
    if sample_if_multi and len(flat) > 1:
        return flat[int(rng.integers(0, len(flat)))]
    return flat[0]


@Registry.register("preprocess_ops.bert_tokenize")
@InKeyOutKey(indefault="texts", outdefault="labels", with_data=True)
def get_bert_tokenize(vocab_path: str, max_len: int,
                      sample_if_multi: bool = True):
    tok = get_tokenizer(vocab_path)

    def _op(labels, sample=None):
        rng = _rng_of(sample)
        txt = _pick_caption(labels, sample_if_multi, rng)
        return _pad_cls(_encode(tok, txt), max_len, tok.cls_id)

    return _op


@Registry.register("preprocess_ops.hf_tokenize")
@InKeyOutKey(indefault="texts", outdefault="labels", with_data=True)
def get_hf_tokenize(tokenizer_path: str, max_len: int,
                    sample_if_multi: bool = True):
    """A HuggingFace tokenizer's ids (``transformers.AutoTokenizer`` of a
    local directory or a name in the local HF cache, imported when the op
    is built: the mT5 towers' SentencePiece), truncated to `max_len` with
    the tokenizer's own end token kept, padded with its pad id to
    `max_len`, int32. The port's own op, for the mT5 text towers
    (``configs/clipa_pretrain.py``'s ``txt``)."""
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(tokenizer_path)

    def _op(labels, sample=None):
        txt = _pick_caption(labels, sample_if_multi, _rng_of(sample))
        enc = tok(txt, padding="max_length", truncation=True,
                  max_length=max_len)
        return np.asarray(enc["input_ids"], np.int32)

    return _op


@Registry.register("preprocess_ops.custom_bert_tokenize")
@InKeyOutKey(indefault="texts", outdefault="labels", with_data=True)
def get_custom_bert_tokenize(vocab_path: str, max_len: int,
                             sample_if_multi: bool = True,
                             mask_type: str = "first", train: bool = True):
    tok = get_tokenizer(vocab_path)

    def _op(labels, sample=None):
        rng = _rng_of(sample)
        txt = _pick_caption(labels, sample_if_multi, rng)
        ids = _encode(tok, txt)
        keep = max_len - 1
        if train and len(ids) > keep:
            if mask_type == "first":
                ids = ids[:keep]
            elif mask_type == "random":
                # uniform token subsample; shuffle order like the reference
                # (tf.random.shuffle then take first keep).
                perm = rng.permutation(len(ids))[:keep]
                ids = [ids[i] for i in perm]
            elif mask_type == "block":
                start = int(rng.integers(0, len(ids) - keep + 1))
                ids = ids[start:start + keep]
            else:
                raise ValueError(f"Unknown mask_type {mask_type!r}")
        return _pad_cls(ids, max_len, tok.cls_id)

    return _op


# ---------------------------------------------------------------------------
# syntax-priority sampling
# ---------------------------------------------------------------------------

_PRIORITY = {"NN": 1, "JJ": 2, "VB": 3}


def _tag_priority(tag: str) -> int:
    for prefix, pri in _PRIORITY.items():
        if tag.startswith(prefix):
            return pri
    return 4


def _find_nltk_tagger():
    try:
        import nltk
        nltk.data.find("taggers/averaged_perceptron_tagger")
        return nltk.pos_tag
    except Exception:
        return None


@functools.lru_cache(maxsize=1)
def _nltk_tagger():
    """Returns nltk.pos_tag if its model data is installed, else None.

    nltk is imported on a thread of its own: its import keeps an ImportError
    (a default argument in nltk/parse/bllip.py) whose traceback pins every
    frame of the importing stack, and with them whatever the caller's frames
    hold (a served model's weights on the card, for one)."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        return pool.submit(_find_nltk_tagger).result()


_ADJ_SUFFIXES = ("ous", "ful", "ive", "able", "ible", "al", "ic", "ish",
                 "less", "ary", "ent", "est")
_VERB_SUFFIXES = ("ize", "ise", "ify")
_FUNCTION_WORDS = frozenset(
    "a an the and or but if of at by for with to from in on is are was were "
    "be been being am do does did not no this that these those it its as so "
    "than then there here he she they we you i his her their our your my "
    "who whom whose which what when where why how all any both each few "
    "more most other some such only own same s t can will just don should "
    "now very too also into over under again once during while about "
    "against between through after before above below up down out off "
    "near one two three four five six seven eight nine ten".split())
# Common caption adjectives that carry no adjectival suffix (colors, sizes,
# everyday qualities — the bulk of LAION/alt-text modifiers). A suffix-only
# guesser tags these NN (or worse, 'red' -> VB via '-ed'); the lexicon pins
# the frequent ones. Golden-anchored by tests/golden/syntax_corpus.json.
_ADJ_LEXICON = frozenset(
    "red blue green yellow black white brown pink purple orange grey gray "
    "golden silver big small large little tiny huge old new young tall "
    "short long high low hot cold warm cool dark light bright happy sad "
    "cute nice free best top fresh sweet modern classic vintage wooden "
    "empty full open clean dirty soft hard round flat deep wild early late "
    "pretty cozy sunny cloudy rainy".split())
# Nouns that suffix rules misfire on: gerund-form nouns (-ing), -ly nouns,
# -est/-able nouns.
_NOUN_LEXICON = frozenset(
    "drawing painting morning evening building wedding clothing lighting "
    "ceiling spring ring king thing something nothing everything "
    "family butterfly jelly lily belly assembly "
    "forest nest chest guest vest west harvest interest breakfast "
    "table cable vegetable".split())


def _heuristic_tags(words: List[str]) -> List[str]:
    """Suffix+lexicon POS guesser used when NLTK corpora are unavailable.

    Only the noun>adj>verb>other *priority classes* matter downstream, not
    exact Penn tags. Anchored by the golden corpus test
    (tests/golden/syntax_corpus.json): human-curated Penn classes for
    realistic caption vocabulary, the ground truth the reference's NLTK
    tagger approximates (clipa_jax/transforms/bert_ops.py:54-88 tags each
    word in isolation, so a per-word class table IS the semantics).
    """
    tags = []
    for w in words:
        lw = w.lower()
        if not lw.isalpha() or lw in _FUNCTION_WORDS:
            tags.append("X")
        elif lw in _NOUN_LEXICON:
            tags.append("NN")
        elif lw in _ADJ_LEXICON:
            tags.append("JJ")
        elif lw.endswith("ly"):
            tags.append("RB")
        # length guards: 'ring'/'king' are nouns, 'red'/'bed' aren't verbs
        elif (lw.endswith("ing") and len(lw) >= 6) or \
                (lw.endswith("ed") and len(lw) >= 5) or \
                lw.endswith(_VERB_SUFFIXES):
            tags.append("VB")
        elif lw.endswith(_ADJ_SUFFIXES):
            tags.append("JJ")
        else:
            tags.append("NN")
    return tags


def pos_priorities(words: List[str]) -> List[int]:
    """Per-word syntax priority (1 best = noun ... 4 = everything else)."""
    tagger = _nltk_tagger()
    if tagger is not None:
        tagged = tagger(words)
        return [_tag_priority(tag) for _, tag in tagged]
    return [_tag_priority(t) for t in _heuristic_tags(words)]


@Registry.register("preprocess_ops.syntax_tokenize")
@Registry.register("preprocess_ops.noun_tokenize")
@InKeyOutKey(indefault="texts", outdefault="labels", with_data=True)
def get_syntax_tokenize(vocab_path: str, max_len: int,
                        sample_if_multi: bool = True):
    """Keeps syntactically important words when the caption is too long.

    Word-level: tag words, stable-argsort by priority, keep the first
    max_len-1 selections in original word order, then WordPiece. (Reference:
    clipa_jax/transforms/bert_ops.py:211-254 and
    clipa_torch/open_clip/tokenizer.py syntax_mask_tokenize.)
    """
    tok = get_tokenizer(vocab_path)

    def _op(labels, sample=None):
        rng = _rng_of(sample)
        txt = _pick_caption(labels, sample_if_multi, rng)
        ids = _encode(tok, txt)
        keep = max_len - 1
        if len(ids) > keep:
            words = basic_tokenize(txt)
            pri = pos_priorities(words)
            order = np.argsort(pri, kind="stable")[:keep]
            chosen = sorted(order.tolist())
            word_ids = tok.encode_words([words[i] for i in chosen])
            ids = [i for ws in word_ids for i in ws]
        return _pad_cls(ids, max_len, tok.cls_id)

    return _op


@Registry.register("preprocess_ops.lower")
@InKeyOutKey(indefault="texts", outdefault="texts")
def get_lower():
    def _op(x):
        if isinstance(x, bytes):
            return x.decode("utf-8", "replace").lower()
        return str(x).lower()
    return _op


@Registry.register("preprocess_ops.clip_i1k_label_names")
@InKeyOutKey(indefault="label", outdefault="texts")
def get_clip_i1k_label_names():
    """Maps an ImageNet-1k integer label to its CLIP-paper class name
    (reference: clipa_jax/transforms/ops_text.py:32-40)."""
    from clipa_tpu_torch.evaluators import prompts
    names = prompts.get_class_names("imagenet2012")

    def _op(label):
        return names[int(np.asarray(label).reshape(-1)[0])]

    return _op
