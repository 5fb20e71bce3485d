"""Flat-npz checkpoints.

Port of the flat-npz half of ``clipa_tpu/train/checkpoint.py``: npz files
whose keys are slash-joined parameter names, bf16 stored as ``V2`` void
bytes, written atomically (:func:`npsave`, :func:`save_params`) and read
(:func:`load_params`, with the ``file.npz:subtree`` syntax), on local paths;
and :func:`masked_init`, the trainer's cross-resolution initialization
(``config.masked_init``). Remote URLs (``gs://``), the async writer and
Orbax checkpoints are not ported yet.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Sequence

import numpy as np
import torch

from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import common


def npsave(data: dict, path: str) -> None:
    """Atomic np.savez of a flat {name: np.ndarray} dict: written to a
    temporary file beside `path`, then renamed over it."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".npz-TEMPORARY")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **data)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _to_np(x: torch.Tensor) -> np.ndarray:
    """A tensor as npz stores it: bf16 as its raw bytes in ``V2`` void
    (np.savez cannot store bf16; :func:`u.recover_dtype` reads it back)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def save_params(params: Any, path: str) -> None:
    """Saves a tree of tensors (nested dicts, or a flat dict of slash-joined
    names such as a train state's ``params``) as a flat npz, the format of
    the JAX package's ``save_checkpoint``."""
    npsave({name: _to_np(x) for name, x in u.tree_flatten_with_names(params)},
           path)


def npload(path: str) -> dict:
    """Reads an npz file into a flat {name: np.ndarray} dict."""
    with np.load(path, allow_pickle=False) as checkpoint:
        return {k: checkpoint[k] for k in checkpoint.files}


def load_checkpoint(path: str) -> dict:
    """Loads a flat npz into a nested dict of CPU tensors."""
    flat = npload(path)
    return u.recover_tree(list(flat),
                          [u.recover_dtype(v) for v in flat.values()])


def load_params(path: str) -> dict:
    """Loads params from `file.npz` or `file.npz:subtree/key`.

    Accepts checkpoints that are a bare params tree or a full train
    checkpoint containing a `params/` prefix. Returns a nested dict of CPU
    tensors (or one tensor, when the subtree key names a leaf).
    """
    key = None
    if ":" in path:
        path, _, key = path.rpartition(":")
    tree = load_checkpoint(path)
    if "params" in tree and isinstance(tree["params"], dict) and \
            (not key or key.split("/")[0] not in tree):
        tree = tree["params"]  # full train checkpoint: dig out the params
    if key:
        for part in key.split("/"):
            tree = tree[part]
    return tree


def masked_init(params: dict, path: str, dont_load: Sequence = ()) -> dict:
    """Initializes `params` in place from the checkpoint at `path`: the
    trainer's ``config.masked_init`` branch (clipa_tpu/train/loop.py). The
    checkpoint is merged into the parameters by
    :func:`common.merge_params` under `dont_load` (``config.masked_no_load``):
    every tensor is copied, except position embeddings of another length,
    which are resampled (the pretrain text tower's 8 positions to the
    fine-tune's 32), and what `dont_load` keeps at its init.

    params: {slash-joined JAX name: tensor}, a train state's ``params``.
    Returns `params`.
    """
    merged = common.merge_params(load_params(path),
                                 {n: p.detach() for n, p in params.items()},
                                 dont_load)
    flat = dict(u.tree_flatten_with_names(merged))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(flat[name])
    return params
