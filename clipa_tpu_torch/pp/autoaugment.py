"""AutoAugment policies (v0 / test) and Cutout on PIL/numpy.

Port of ``clipa_tpu/pp/autoaugment.py``: the published AutoAugment-paper
policy tables (arXiv:1805.09501) with the TF-Models level mapping (level in
[0, 10], cutout_const 100, translate_const 250, enhancement factor
level/10*1.8+0.1), run with PIL's ops on the host. Every draw comes from
the sample's ``_rng``, in the JAX op's order: the sub-policy, then per op
its probability, its sign and (Cutout) its centre.
"""

from __future__ import annotations

import numpy as np

from clipa_tpu_torch.registry import InKeyOutKey, Registry

_MAX_LEVEL = 10.0
_CUTOUT_CONST = 100
_TRANSLATE_CONST = 250
_REPLACE = (128, 128, 128)

# (op, probability, magnitude) pairs; each sub-policy applied sequentially.
# Published AutoAugment-paper policy (reference autoaugment.py:54-86).
POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateY", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]

POLICY_TEST = [
    [("TranslateX", 1.0, 4), ("Equalize", 1.0, 10)],
]

POLICIES = {"v0": POLICY_V0, "test": POLICY_TEST}


def _pil_mods():
    from PIL import Image, ImageEnhance, ImageOps
    return Image, ImageEnhance, ImageOps


def _affine(img, matrix):
    Image, _, _ = _pil_mods()
    return img.transform(img.size, Image.Transform.AFFINE, matrix,
                         resample=Image.Resampling.BILINEAR,
                         fillcolor=_REPLACE)


def _enhance_factor(level: float) -> float:
    return level / _MAX_LEVEL * 1.8 + 0.1


def cutout(img, pad_size: int, rng, replace=_REPLACE):
    """(2*pad_size)^2 patch of `replace` at a uniform center (clipped at the
    borders), per reference autoaugment.py:140-186."""
    arr = np.array(img)
    h, w = arr.shape[:2]
    cy = int(rng.integers(0, h))
    cx = int(rng.integers(0, w))
    y0, y1 = max(0, cy - pad_size), min(h, cy + pad_size)
    x0, x1 = max(0, cx - pad_size), min(w, cx + pad_size)
    arr[y0:y1, x0:x1] = np.asarray(replace, arr.dtype)
    from PIL import Image
    return Image.fromarray(arr)


def _apply_op(img, name: str, level: float, rng):
    Image, ImageEnhance, ImageOps = _pil_mods()
    sign = 1.0 if rng.random() < 0.5 else -1.0
    if name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if name == "Equalize":
        return ImageOps.equalize(img)
    if name == "Invert":
        return ImageOps.invert(img)
    if name == "Rotate":
        deg = level / _MAX_LEVEL * 30.0 * sign
        return img.rotate(deg, resample=Image.Resampling.BILINEAR,
                          fillcolor=_REPLACE)
    if name == "Posterize":
        # TF arg is bits *kept reduced to* int(level/10*4) — i.e. keep that
        # many top bits (reference :235-238 with :543). At low magnitude the
        # TF op gets bits=0 and zeroes the image; PIL's posterize requires
        # bits>=1, so reproduce bits=0 explicitly for exact parity.
        bits = int(level / _MAX_LEVEL * 4)
        if bits <= 0:
            return Image.fromarray(np.zeros_like(np.asarray(img)))
        return ImageOps.posterize(img, bits)
    if name == "Solarize":
        # invert pixels >= threshold; TF threshold grows with level (:544).
        return ImageOps.solarize(img, min(255, int(level / _MAX_LEVEL * 256)))
    if name == "SolarizeAdd":
        add = int(level / _MAX_LEVEL * 110)
        arr = np.asarray(img).astype(np.int32)
        arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
        return Image.fromarray(arr.astype(np.uint8))
    if name == "Color":
        return ImageEnhance.Color(img).enhance(_enhance_factor(level))
    if name == "Contrast":
        return ImageEnhance.Contrast(img).enhance(_enhance_factor(level))
    if name == "Brightness":
        return ImageEnhance.Brightness(img).enhance(_enhance_factor(level))
    if name == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(_enhance_factor(level))
    if name == "ShearX":
        return _affine(img, (1, level / _MAX_LEVEL * 0.3 * sign, 0, 0, 1, 0))
    if name == "ShearY":
        return _affine(img, (1, 0, 0, level / _MAX_LEVEL * 0.3 * sign, 1, 0))
    if name == "TranslateX":
        t = level / _MAX_LEVEL * _TRANSLATE_CONST * sign
        return _affine(img, (1, 0, t, 0, 1, 0))
    if name == "TranslateY":
        t = level / _MAX_LEVEL * _TRANSLATE_CONST * sign
        return _affine(img, (1, 0, 0, 0, 1, t))
    if name == "Cutout":
        return cutout(img, int(level / _MAX_LEVEL * _CUTOUT_CONST), rng)
    raise ValueError(f"Unknown AutoAugment op: {name}")


def distort_image_with_autoaugment(image: np.ndarray, policy: str,
                                   rng) -> np.ndarray:
    """Applies one uniformly-chosen sub-policy of `policy` to a uint8 HWC
    image (reference autoaugment.py:712-738)."""
    from PIL import Image
    subs = POLICIES[policy]
    sub = subs[int(rng.integers(0, len(subs)))]
    img = Image.fromarray(np.asarray(image, np.uint8))
    for name, prob, mag in sub:
        if rng.random() <= prob:
            img = _apply_op(img, name, float(mag), rng)
    return np.asarray(img)


@Registry.register("preprocess_ops.autoaug")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_autoaug(policy: str = "v0"):
    """pp op: `autoaug(policy="v0")` — AutoAugment on a uint8 image."""
    if policy not in POLICIES:
        raise ValueError(
            f"Invalid policy {policy!r}; available: {sorted(POLICIES)}")

    def _op(image, sample=None):
        rng = sample.get("_rng", np.random.default_rng(0)) \
            if isinstance(sample, dict) else np.random.default_rng(0)
        return distort_image_with_autoaugment(image, policy, rng)

    return _op


@Registry.register("preprocess_ops.cutout")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_cutout(pad_size: int = 8):
    """pp op: standalone Cutout (reference autoaugment.py:140-186)."""
    def _op(image, sample=None):
        from PIL import Image
        rng = sample.get("_rng", np.random.default_rng(0)) \
            if isinstance(sample, dict) else np.random.default_rng(0)
        img = Image.fromarray(np.asarray(image, np.uint8))
        return np.asarray(cutout(img, pad_size, rng))
    return _op
