"""Cross-model utilities: checkpoint<->init parameter merging.

Port of ``clipa_tpu/models/common.py``: parameters are matched by flat
name; ``dont_load`` regexes (fullmatch) keep the init value; position
embeddings whose shape changed, or that ``dont_load`` excludes, are
bilinearly resampled from the checkpoint's (the cross-resolution
``masked_init`` path of CLIPA's unmask-tuning).
"""

from __future__ import annotations

import logging
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from clipa_tpu_torch import utils as u

log = logging.getLogger(__name__)


def merge_params(loaded: Any, inited: Any, dont_load: Sequence = ()) -> Any:
    """Makes `loaded` match `inited`'s structure, keeping init where told to.

    Both are trees of tensors (nested dicts, or flat dicts of slash-joined
    names). Returns a nested dict. Raises if a parameter exists on only one
    side and no `dont_load` regex covers it.
    """
    if inited is None:
        return loaded

    patterns = u.check_and_compile_patterns(dont_load)

    def should_merge(name: str) -> bool:
        return not any(p.fullmatch(name) for p in patterns)

    loaded_flat = dict(u.tree_flatten_with_names(loaded))
    inited_flat = dict(u.tree_flatten_with_names(inited))

    merged = {}
    for name, init_val in inited_flat.items():
        if name in loaded_flat and should_merge(name) \
                and loaded_flat[name].shape == init_val.shape:
            merged[name] = loaded_flat[name]
        elif name.endswith("pos_embedding") and name in loaded_flat:
            # Resolution changed (unmask-tuning) or posemb excluded: resample.
            log.info("Resampling %s from %s to %s", name,
                     tuple(loaded_flat[name].shape), tuple(init_val.shape))
            merged[name] = _resample_posemb_any(loaded_flat[name], init_val)
        else:
            log.info("Using init value for %s", name)
            merged[name] = init_val

    not_in_loaded = {k for k in inited_flat.keys() - loaded_flat.keys()
                     if should_merge(k)}
    not_in_inited = {k for k in loaded_flat.keys() - inited_flat.keys()
                     if should_merge(k)}
    if not_in_loaded or not_in_inited:
        raise ValueError(
            "Parameter mismatch not covered by dont_load.\n"
            f"In model but not checkpoint: {sorted(not_in_loaded)}\n"
            f"In checkpoint but not model: {sorted(not_in_inited)}")

    return u.recover_tree(list(merged.keys()), list(merged.values()))


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, size, "bilinear")`` over the leading axes of an
    (h, w, C) or (n, C) array, C kept: half-pixel centres, and antialiased
    where an axis shrinks, as JAX's resize is. Computed in fp32."""
    if x.dim() == 2:   # (n, C): a grid of height 1
        return resize_bilinear(x[None], (1, size[0]))[0]
    h, w, c = x.shape
    grid = x.float().permute(2, 0, 1)[None]
    out = F.interpolate(grid, size=tuple(size), mode="bilinear",
                        align_corners=False,
                        antialias=size[0] < h or size[1] < w)
    return out[0].permute(1, 2, 0)


def _resample_posemb_any(old: torch.Tensor,
                         new_template: torch.Tensor) -> torch.Tensor:
    """Resamples a (1, N, C) posemb; 2D grid-aware when N-1 is a square."""
    if old.shape == new_template.shape:
        return old
    l_old, l_new = old.shape[1], new_template.shape[1]
    g_old, g_new = int((l_old - 1) ** 0.5), int((l_new - 1) ** 0.5)
    if g_old * g_old + 1 == l_old and g_new * g_new + 1 == l_new:
        # cls row passes through; the grid part is resized bilinearly.
        cls_row, grid = old[:, :1], old[:, 1:]
        grid = resize_bilinear(grid.reshape(g_old, g_old, -1),
                               (g_new, g_new))
        return torch.cat([cls_row.float(), grid.reshape(1, l_new - 1, -1)],
                         dim=1).to(new_template.dtype)
    if old.shape[0] != new_template.shape[0] \
            or old.shape[2] != new_template.shape[2]:
        raise ValueError(f"cannot resample a posemb of shape "
                         f"{tuple(old.shape)} to {tuple(new_template.shape)}:"
                         f" only the token axis may change")
    return resize_bilinear(old[0], (l_new,))[None].to(new_template.dtype)
