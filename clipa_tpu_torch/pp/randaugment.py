"""RandAugment (timm-compatible policy) on PIL/numpy.

Port of ``clipa_tpu/pp/randaugment.py``: ``randaug(num_layers, magnitude)``
applies that many ops drawn uniformly from 16 PIL ops, each at a noisy
magnitude (level in [0, 30]; timm ``rand-m9-n2`` == ``randaug(2, 9)``).
Every draw comes from the sample's ``_rng``, in the JAX op's order: per
layer the gate, the magnitude noise, the op, then the op's sign and
enhancement draws.
"""

from __future__ import annotations

import numpy as np

from clipa_tpu_torch.registry import InKeyOutKey, Registry

_MAX_LEVEL = 30.0


def _pil_mods():
    from PIL import Image, ImageEnhance, ImageOps
    return Image, ImageEnhance, ImageOps


def _affine(img, matrix):
    Image, _, _ = _pil_mods()
    return img.transform(img.size, Image.Transform.AFFINE, matrix,
                         resample=Image.Resampling.BILINEAR, fillcolor=(128,) * 3)


def _enhance_factor(level: float) -> float:
    # symmetric around 1.0: 0.1 .. 1.9
    return 1.0 + 0.9 * (level / _MAX_LEVEL) * (1 if level >= 0 else -1)


def _make_ops():
    Image, ImageEnhance, ImageOps = _pil_mods()

    def identity(img, level, rng):
        return img

    def autocontrast(img, level, rng):
        return ImageOps.autocontrast(img)

    def equalize(img, level, rng):
        return ImageOps.equalize(img)

    def invert(img, level, rng):
        return ImageOps.invert(img)

    def rotate(img, level, rng):
        deg = 30.0 * level / _MAX_LEVEL * _sign(rng)
        return img.rotate(deg, resample=Image.Resampling.BILINEAR,
                          fillcolor=(128,) * 3)

    def posterize(img, level, rng):
        bits = 8 - int(4 * level / _MAX_LEVEL)
        return ImageOps.posterize(img, max(1, bits))

    def solarize(img, level, rng):
        thresh = int(256 - 256 * level / _MAX_LEVEL)
        return ImageOps.solarize(img, max(0, thresh))

    def solarize_add(img, level, rng):
        add = int(110 * level / _MAX_LEVEL)
        arr = np.asarray(img).astype(np.int32)
        arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
        return Image.fromarray(arr.astype(np.uint8))

    def color(img, level, rng):
        return ImageEnhance.Color(img).enhance(
            _rand_enhance(level, rng))

    def contrast(img, level, rng):
        return ImageEnhance.Contrast(img).enhance(_rand_enhance(level, rng))

    def brightness(img, level, rng):
        return ImageEnhance.Brightness(img).enhance(_rand_enhance(level, rng))

    def sharpness(img, level, rng):
        return ImageEnhance.Sharpness(img).enhance(_rand_enhance(level, rng))

    def shear_x(img, level, rng):
        s = 0.3 * level / _MAX_LEVEL * _sign(rng)
        return _affine(img, (1, s, 0, 0, 1, 0))

    def shear_y(img, level, rng):
        s = 0.3 * level / _MAX_LEVEL * _sign(rng)
        return _affine(img, (1, 0, 0, s, 1, 0))

    def translate_x(img, level, rng):
        t = 0.45 * level / _MAX_LEVEL * img.size[0] * _sign(rng)
        return _affine(img, (1, 0, t, 0, 1, 0))

    def translate_y(img, level, rng):
        t = 0.45 * level / _MAX_LEVEL * img.size[1] * _sign(rng)
        return _affine(img, (1, 0, 0, 0, 1, t))

    return [identity, autocontrast, equalize, invert, rotate, posterize,
            solarize, solarize_add, color, contrast, brightness, sharpness,
            shear_x, shear_y, translate_x, translate_y]


def _sign(rng) -> float:
    return 1.0 if rng.random() < 0.5 else -1.0


def _rand_enhance(level: float, rng) -> float:
    mag = 0.9 * level / _MAX_LEVEL * _sign(rng)
    return max(0.1, 1.0 + mag)


@Registry.register("preprocess_ops.randaug")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_randaug(num_layers: int = 2, magnitude: int = 10,
                magnitude_std: float = 0.5, prob: float = 1.0):
    """timm-style RandAugment: num_layers random ops at +-noisy magnitude."""
    Image, _, _ = _pil_mods()
    ops = _make_ops()

    def _op(image, sample=None):
        rng = sample.get("_rng", np.random.default_rng(0)) \
            if isinstance(sample, dict) else np.random.default_rng(0)
        img = Image.fromarray(np.asarray(image, np.uint8))
        for _ in range(num_layers):
            if rng.random() > prob:
                continue
            level = magnitude
            if magnitude_std > 0:
                level = rng.normal(magnitude, magnitude_std)
            level = float(np.clip(level, 0, _MAX_LEVEL))
            fn = ops[int(rng.integers(0, len(ops)))]
            img = fn(img, level, rng)
        return np.asarray(img)

    return _op


@Registry.register("preprocess_ops.randaug_timm", replace=True)
def get_randaug_timm(*args, **kw):
    return get_randaug(*args, **kw)
