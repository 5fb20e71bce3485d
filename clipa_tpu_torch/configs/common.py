"""Shared config helpers for CLIPA experiments (a copy of
``clipa_tpu/configs/common.py``)."""

from __future__ import annotations

import os

from clipa_tpu_torch.config import ConfigDict


def default_vocab_path() -> str:
    """The shipped 30522-entry BERT uncased WordPiece vocab, which all
    CLIPA-v2 text towers tokenize with. Resolves relative to the repo root
    so configs work from any working directory; falls back to the plain
    relative path if the tree moved."""
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "data", "vocab.txt")
    return here if os.path.exists(here) else "data/vocab.txt"


# Image variant -> the dimension of the shared embedding space.
EMBED_DIM = {"Ti": 192, "S": 384, "B": 512, "L": 768, "H": 1024,
             "g": 1280, "G": 1280, "e": 1664}


def two_towers_model(img_variant: str, txt_variant: str, *,
                     pool_type: str = "tok", posemb: str = "sincos2d",
                     text_pool: str = "last", vocab_size: int = 32000,
                     dtype: str = "bfloat16", remat: str = "none",
                     img_head: bool = True) -> ConfigDict:
    dim = EMBED_DIM[img_variant.split("/")[0]]
    return ConfigDict(
        image_model="vit",
        text_model="text_transformer",
        image=ConfigDict(variant=img_variant, pool_type=pool_type,
                         posemb=posemb, remat_policy=remat),
        text=ConfigDict(variant=txt_variant, pool_type=text_pool,
                        vocab_size=vocab_size),
        out_dim=(dim if img_head else None, dim),
        temperature_init=1 / 0.07,
        dtype=dtype,
    )


def adam_config(lr: float, wd: float, warmup_steps: int, total_epochs=None,
                total_examples=None, *, b1=0.9, b2=0.95,
                mu_dtype="bfloat16") -> ConfigDict:
    c = ConfigDict(
        optax_name="scale_by_adam",
        optax=ConfigDict(mu_dtype=mu_dtype, b1=b1, b2=b2),
        lr=lr,
        wd=wd,
        schedule=[(".*", dict(decay_type="cosine",
                              warmup_steps=warmup_steps))],
        grad_clip_norm=1.0,
    )
    if total_epochs is not None:
        c.total_epochs = total_epochs
    if total_examples is not None:
        c.total_examples = total_examples
    return c


def disclf_eval(res: int, tokenizer_pp: str, *, dataset="imagenet2012",
                data_dir="", split="validation", log_steps=2000,
                prefix="z/0shot/") -> ConfigDict:
    """Zero-shot discriminative-classifier evaluator config.

    pp_img decodes first and ends on uint8: the trainer's predict fn
    normalizes uint8 on the device with the train step's statistics
    (``train.step.make_predict_fn``). The JAX package's copy has no
    ``decode`` and fails on the encoded JPEG bytes that a tfrecord
    ImageNet split yields (``resize_small`` gets bytes, not an image);
    ``decode`` passes an already-decoded array through, so the prefix
    changes nothing for decoded inputs.
    """
    return ConfigDict(
        type="zeroshot_classifier",
        dataset_names=[dataset],
        split=split,
        data_dir=data_dir,
        pp_img=(f'decode|resize_small({res}, method="bilinear")|'
                f'central_crop({res})'),
        pp_txt=tokenizer_pp,
        log_steps=log_steps,
        prefix=prefix,
    )
