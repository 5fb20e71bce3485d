"""Flat-name helpers for parameter trees.

Port of the naming half of ``clipa_tpu/utils.py``. Parameters are addressed
by slash-joined names (``img/Transformer/encoderblock_0/LayerNorm_0/scale``);
npz checkpoints store them under those keys, and ``convert.py`` maps them to
``state_dict`` names. A tree here is a nested dict of arrays or tensors.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


def tree_flatten_with_names(tree: Any) -> list[tuple[str, Any]]:
    """Flattens nested dicts into (slash-joined name, leaf) pairs.

    Keys are visited in sorted order, the leaf order of
    ``jax.tree_util.tree_flatten`` on dicts.
    """
    out: list[tuple[str, Any]] = []

    def visit(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for key in sorted(node):
                visit(f"{prefix}/{key}" if prefix else str(key), node[key])
        else:
            out.append((prefix, node))

    visit("", tree)
    return out


def recover_tree(keys: Sequence[str], values: Sequence[Any]) -> dict:
    """Rebuilds a nested dict from slash-joined keys (npz -> tree)."""
    tree: dict = {}
    for key, value in zip(keys, values):
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def recover_dtype(a: np.ndarray) -> torch.Tensor:
    """npz array -> CPU tensor, recovering bfloat16 stored as 2-byte void.

    ``np.savez`` cannot store bf16, so the JAX package writes its raw bytes
    as ``V2`` (clipa_tpu/train/checkpoint.py); the bits are reinterpreted
    here without a round trip through another float type.
    """
    if a.dtype.type is np.void:
        if a.dtype.itemsize != 2:
            raise ValueError(f"Unknown dtype to recover: {a.dtype}")
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)
