"""Generic pp ops: key management, casting, shaping, one-hot, lookup.

Port of ``clipa_tpu/pp/ops_general.py``, on numpy samples.
"""

from __future__ import annotations

import numpy as np

from clipa_tpu_torch.registry import InKeyOutKey, Registry


@Registry.register("preprocess_ops.keep")
def get_keep(*keys):
    def _op(sample):
        return {k: v for k, v in sample.items()
                if k in keys or k.startswith("_")}
    return _op


@Registry.register("preprocess_ops.drop")
def get_drop(*keys):
    def _op(sample):
        return {k: v for k, v in sample.items() if k not in keys}
    return _op


@Registry.register("preprocess_ops.copy")
def get_copy(inkey: str, outkey: str):
    def _op(sample):
        sample[outkey] = sample[inkey]
        return sample
    return _op


@Registry.register("preprocess_ops.flatten")
def get_flatten():
    """Flattens nested dicts into slash-joined top-level keys."""
    def _flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out.update(_flat(v, key))
            else:
                out[key] = v
        return out

    return _flat


@Registry.register("preprocess_ops.squeeze")
@InKeyOutKey(indefault="image", outdefault="image")
def get_squeeze(axis=None):
    def _op(x):
        return np.squeeze(np.asarray(x), axis=axis)
    return _op


@Registry.register("preprocess_ops.onehot")
def get_onehot(depth: int, key: str = "labels", key_result: str = "labels",
               multi: bool = True, on: float = 1.0, off: float = 0.0):
    def _op(sample):
        labels = np.asarray(sample[key]).reshape(-1)
        out = np.full((depth,), off, np.float32)
        if multi:
            out[labels] = on
        else:
            oh = np.full((labels.size, depth), off, np.float32)
            oh[np.arange(labels.size), labels] = on
            out = oh.squeeze(0) if labels.size == 1 else oh
        sample[key_result] = out
        return sample
    return _op


@Registry.register("preprocess_ops.cast")
@InKeyOutKey(indefault="image", outdefault="image")
def get_cast(dtype: str):
    def _op(x):
        return np.asarray(x).astype(dtype)
    return _op


@Registry.register("preprocess_ops.pad_to_shape")
@InKeyOutKey(indefault="labels", outdefault="labels")
def get_pad_to_shape(shape, pad_value=0):
    def _op(x):
        x = np.asarray(x)
        pads = [(0, want - have) for want, have in zip(shape, x.shape)]
        return np.pad(x, pads, constant_values=pad_value)
    return _op


@Registry.register("preprocess_ops.lookup")
@InKeyOutKey(indefault="labels", outdefault="labels")
def get_lookup(mapping_path: str, npackage=None, sep=None):
    """Integer id -> value lookup from a text file (one entry per line)."""
    with open(mapping_path) as f:
        values = [line.rstrip("\n") for line in f]
    table = np.asarray([v.split(sep) if sep else v for v in values])

    def _op(idx):
        return table[np.asarray(idx)]
    return _op
