"""Flat-npz checkpoint reading.

Port of the loading half of ``clipa_tpu/train/checkpoint.py``: npz files
whose keys are slash-joined parameter names, bf16 stored as ``V2`` void
bytes, local paths or remote URLs (through ``clipa_tpu.pathio``), and the
``file.npz:subtree`` syntax. Saving, the async writer and Orbax checkpoints
belong to training and are not ported yet.
"""

from __future__ import annotations

import io

import numpy as np

from clipa_tpu import pathio
from clipa_tpu_torch import utils as u


def npload(path: str) -> dict:
    """Reads an npz file into a flat {name: np.ndarray} dict."""
    if pathio.is_remote(path):
        with pathio.open_file(path, "rb") as f:
            buf = io.BytesIO(f.read())
        checkpoint = np.load(buf, allow_pickle=False)
    else:
        checkpoint = np.load(path, allow_pickle=False)
    with checkpoint:
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
    if pathio.is_remote(path):
        # scheme contributes one ':'; a second one marks a subtree key.
        if path.count(":") > 1:
            path, _, key = path.rpartition(":")
    elif ":" in path:
        path, _, key = path.rpartition(":")
    tree = load_checkpoint(path)
    if "params" in tree and isinstance(tree["params"], dict) and \
            (not key or key.split("/")[0] not in tree):
        tree = tree["params"]  # full train checkpoint: dig out the params
    if key:
        for part in key.split("/"):
            tree = tree[part]
    return tree
