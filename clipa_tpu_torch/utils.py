"""Flat-name helpers for parameter trees, and the entry points' device check.

Port of the naming, masking and scheduling half of ``clipa_tpu/utils.py``
(:func:`itstime` reads the process rank from ``torch.distributed``). Parameters
are addressed by slash-joined names
(``img/Transformer/encoderblock_0/LayerNorm_0/scale``); npz checkpoints store
them under those keys, ``convert.py`` maps them to ``state_dict`` names, and
the optimizer's regexes select them. A tree here is a nested dict of arrays
or tensors.
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Optional, Sequence, Union

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


def resolve_dtype(dtype: Any) -> Optional[torch.dtype]:
    """A dtype as configs give it ("bfloat16", "float32", a torch dtype or
    None) -> a torch dtype or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if str(dtype) not in names:
        raise ValueError(f"unknown dtype {dtype!r} (configs name bfloat16 "
                         f"or float32)")
    return names[str(dtype)]


def resolve_device(device: Any, what: str) -> torch.device:
    """`device` as a ``torch.device``; raises for a CUDA device when torch
    finds none. The port's entry points default to the card and take the CPU
    only when the caller names it: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device={str(device)!r}) needs a CUDA "
                           f"device and torch finds none; pass device='cpu' "
                           f"to run on the CPU")
    return device


def check_and_compile_patterns(patterns: Sequence[Union[str, re.Pattern]]
                               ) -> list[re.Pattern]:
    """Validates and compiles regex patterns (str or compiled)."""
    compiled = []
    for p in patterns:
        if isinstance(p, str):
            compiled.append(re.compile(p))
        elif isinstance(p, re.Pattern):
            compiled.append(p)
        else:
            raise TypeError(f"Pattern must be str or re.Pattern, got "
                            f"{type(p)}")
    return compiled


def make_mask_trees(names: Iterable[str],
                    patterns: Sequence[Union[str, re.Pattern]]
                    ) -> list[dict[str, bool]]:
    """One {name: matched} mask per pattern over flat parameter names.

    Port of ``clipa_tpu.utils.make_mask_trees`` on flat names instead of a
    pytree: each name is claimed by the FIRST pattern that ``fullmatch``-es
    it, so a name is True in at most one mask. With the JAX names of
    ``convert.to_jax_names`` the masks equal the JAX package's leaf for leaf:

    ===================================  ==========================  =======
    pattern (first match wins)           name                        mask
    ===================================  ==========================  =======
    ``.*/kernel$``                       ``img/head/kernel``         True
    ``.*/kernel$``                       ``txt/Embed_0/embedding``   False
    ``.*/kernel$``                       ``img/encoder_norm/scale``  False
    ``img/.*``, then ``.*``              ``img/cls``                 first
    ===================================  ==========================  =======
    """
    compiled = check_and_compile_patterns(patterns)
    masks: list[dict[str, bool]] = [{} for _ in compiled]
    for name in names:
        hit = False
        for pat, mask in zip(compiled, masks):
            mask[name] = not hit and bool(pat.fullmatch(name))
            hit = hit or mask[name]
    return masks


def process_index() -> int:
    """This process's rank: ``torch.distributed``'s when it is initialized,
    else 0."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The number of processes: ``torch.distributed``'s world size when it
    is initialized, else 1."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def itstime(step: int, every_n: int | None, total_steps: int,
            host: int | None = None, last: bool = True,
            first: bool = True) -> bool:
    """Scheduling predicate: is `step` a multiple of every_n / first / last?
    With `host`, only on the process of that rank."""
    if every_n is None or every_n <= 0:
        return False
    if host is not None and process_index() != host:
        return False
    is_last = last and step == total_steps
    is_first = first and step == 1
    return is_first or is_last or step % every_n == 0
