"""Prompt templates and class names for zero-shot evaluation.

Port of ``clipa_tpu/evaluators/prompts.py``, with its own copy of the data
file (the ``clip_i1k_label_names`` pp op reads the class names here).

Data (80 CLIP-paper prompt templates, IN-1K class names, IN-A/R label sets)
lives in data/clip_eval_data.json — public CLIP-paper evaluation constants
(Radford et al. 2021). Canonicalization matches the reference
(clipa_jax/evaluators/proj/image_text/prompt_engineering.py:97-130):
underscores to spaces, punctuation stripped (optionally keeping one exact
string), lowercase, whitespace collapsed.
"""

from __future__ import annotations

import functools
import json
import os
import re
import string
from typing import Optional, Sequence


@functools.lru_cache(maxsize=1)
def _data() -> dict:
    path = os.path.join(os.path.dirname(__file__), "data",
                        "clip_eval_data.json")
    with open(path) as f:
        return json.load(f)


def canonicalize(text: str, *,
                 keep_punctuation_exact_string: Optional[str] = None) -> str:
    text = text.replace("_", " ")
    table = str.maketrans("", "", string.punctuation)
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(table)
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(table)
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


def get_class_names(dataset_name: str = "imagenet2012",
                    source=None, do_canonicalize: bool = True) -> list[str]:
    """Class names for a dataset (or an explicit list via `source`)."""
    if source is not None and not isinstance(source, str):
        names = list(source)
    else:
        key = {
            "imagenet2012": "imagenet_class_names",
            "imagenet": "imagenet_class_names",
            "imagenet_a": "imagenet_class_names",
            "imagenet_r": "imagenet_class_names",
            "imagenet_v2": "imagenet_class_names",
        }.get(dataset_name)
        if key is None:
            raise KeyError(f"No class names for {dataset_name!r}; pass an "
                           f"explicit class_names list in the eval config.")
        names = list(_data()[key])
    if do_canonicalize:
        names = [canonicalize(n, keep_punctuation_exact_string=",")
                 for n in names]
    return names


def get_label_subset(dataset_name: str) -> Optional[list[int]]:
    """IN-A / IN-R evaluate on 200-class label subsets."""
    key = {"imagenet_a": "imagenet_a_labelset",
           "imagenet_r": "imagenet_r_labelset"}.get(dataset_name)
    return list(_data()[key]) if key else None


def get_prompt_templates(name: str = "clip_paper",
                         do_canonicalize: bool = True) -> list[str]:
    if name == "class_name_only":
        templates = ["{}"]
    else:
        templates = list(_data()[{
            "clip_paper": "clip_paper_prompt_templates",
            "clip_best": "clip_best_prompt_templates",
        }[name]])
    if do_canonicalize:
        templates = [canonicalize(t, keep_punctuation_exact_string="{}")
                     for t in templates]
    return templates
