"""Heavy augmentation ops: SimCLR color jitter/grayscale, RandomErasing,
mixup/cutmix, color jitter and 3-Augment.

Port of ``clipa_tpu/pp/augment.py``, numpy only: the same ops draw from
the pipeline's per-sample RNG in the same order with the same calls, so
an augmented sample equals the JAX package's byte for byte.
`simclr_jitter_gray(jitter_strength=0.4)` is in every CLIPA pre-training
pp string.
"""

from __future__ import annotations

import numpy as np

from clipa_tpu_torch.registry import InKeyOutKey, Registry

_default_rng = np.random.default_rng(0)


def _rng_of(sample):
    return sample.get("_rng", _default_rng) if isinstance(sample, dict) \
        else _default_rng


# ---------------------------------------------------------------------------
# SimCLR color jitter + random grayscale
# ---------------------------------------------------------------------------

_GRAY_W = np.asarray([0.299, 0.587, 0.114], np.float32)


def _blend(a, b, factor):
    return a * factor + b * (1.0 - factor)


def _adjust_brightness(img, factor):
    return img * factor


def _adjust_contrast(img, factor):
    mean = (img @ _GRAY_W).mean()
    return _blend(img, mean, factor)


def _adjust_saturation(img, factor):
    gray = (img @ _GRAY_W)[..., None]
    return _blend(img, gray, factor)


def _adjust_hue(img, delta):
    """Hue rotation via the YIQ color space (matrix-only, no per-pixel HSV)."""
    t_yiq = np.asarray([[0.299, 0.587, 0.114],
                        [0.596, -0.274, -0.322],
                        [0.211, -0.523, 0.312]], np.float32)
    t_rgb = np.linalg.inv(t_yiq).astype(np.float32)
    c, s = np.cos(delta * 2 * np.pi), np.sin(delta * 2 * np.pi)
    rot = np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    m = t_rgb @ rot @ t_yiq
    return img @ m.T


@Registry.register("preprocess_ops.simclr_jitter_gray")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_simclr_jitter_gray(jitter_strength: float = 0.4,
                           jitter_prob: float = 0.8,
                           gray_prob: float = 0.2):
    """SimCLR augmentation: random color jitter then random grayscale.

    Jitter factors follow SimCLR: brightness/contrast/saturation in
    [1 - 0.8s, 1 + 0.8s], hue in [-0.2s, 0.2s], applied in random order.
    """
    b = c = s_ = 0.8 * jitter_strength
    h = 0.2 * jitter_strength

    def _op(image, sample=None):
        rng = _rng_of(sample)
        img = np.asarray(image, np.float32)
        scale = 255.0 if img.max() > 1.5 else 1.0
        img = img / scale
        if rng.random() < jitter_prob:
            ops = [
                lambda x: _adjust_brightness(
                    x, rng.uniform(max(0, 1 - b), 1 + b)),
                lambda x: _adjust_contrast(
                    x, rng.uniform(max(0, 1 - c), 1 + c)),
                lambda x: _adjust_saturation(
                    x, rng.uniform(max(0, 1 - s_), 1 + s_)),
                lambda x: _adjust_hue(x, rng.uniform(-h, h)),
            ]
            for i in rng.permutation(4):
                img = np.clip(ops[i](img), 0.0, 1.0)
        if rng.random() < gray_prob:
            img = np.repeat((img @ _GRAY_W)[..., None], 3, axis=-1)
        img = img * scale
        return img.astype(np.uint8) if scale == 255.0 else img

    return _op


@Registry.register("preprocess_ops.random_grayscale")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_random_grayscale(prob: float = 0.2):
    def _op(image, sample=None):
        rng = _rng_of(sample)
        if rng.random() >= prob:
            return image
        img = np.asarray(image, np.float32)
        gray = np.repeat((img @ _GRAY_W)[..., None], 3, axis=-1)
        return gray.astype(np.asarray(image).dtype)
    return _op


# ---------------------------------------------------------------------------
# RandomErasing (timm semantics)
# ---------------------------------------------------------------------------

@Registry.register("preprocess_ops.random_erase")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_random_erase(prob: float = 0.25, min_area: float = 0.02,
                     max_area: float = 1 / 3, min_aspect: float = 0.3,
                     max_count: int = 1):
    def _op(image, sample=None):
        rng = _rng_of(sample)
        if rng.random() >= prob:
            return image
        img = np.array(image, copy=True)
        ih, iw = img.shape[:2]
        for _ in range(int(rng.integers(1, max_count + 1))):
            for _ in range(10):
                area = rng.uniform(min_area, max_area) * ih * iw
                aspect = np.exp(rng.uniform(np.log(min_aspect),
                                            np.log(1 / min_aspect)))
                eh = int(round(np.sqrt(area * aspect)))
                ew = int(round(np.sqrt(area / aspect)))
                if eh < ih and ew < iw:
                    top = int(rng.integers(0, ih - eh + 1))
                    left = int(rng.integers(0, iw - ew + 1))
                    noise = rng.normal(0, 1, (eh, ew, img.shape[-1]))
                    if img.dtype == np.uint8:
                        noise = np.clip(noise * 64 + 128, 0, 255)
                    img[top:top + eh, left:left + ew] = noise.astype(img.dtype)
                    break
        return img
    return _op


# ---------------------------------------------------------------------------
# Batch-level mixup / cutmix
# ---------------------------------------------------------------------------

def mixup_cutmix(batch: dict, rng: np.random.Generator, *,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 label_smoothing: float = 0.0, key: str = "image",
                 label_key: str = "labels") -> dict:
    """Applies mixup or cutmix to a batched sample dict.

    If the batch carries float one-hot labels under `label_key`, they are
    mixed in place (timm semantics: `lam * y + (1-lam) * y[perm]`, with
    optional label smoothing) and the batch is returned ready for any
    softmax/sigmoid loss. Otherwise ("labels" are token ids or absent)
    ("mix_lam", "mix_perm") are attached for loss-side mixing.

    Equivalent capability to the reference's MixupAndCutmix
    (clipa_jax/transforms/mixup.py), as a batch transform over numpy.
    """
    if prob < 1.0 and rng.random() >= prob:
        return batch
    imgs = np.asarray(batch[key], np.float32)
    n = imgs.shape[0]
    perm = rng.permutation(n)
    use_cutmix = rng.random() < switch_prob
    if use_cutmix:
        lam = float(rng.beta(cutmix_alpha, cutmix_alpha))
        ih, iw = imgs.shape[1:3]
        cut = np.sqrt(1 - lam)
        ch, cw = int(ih * cut), int(iw * cut)
        cy = int(rng.integers(0, ih + 1))
        cx = int(rng.integers(0, iw + 1))
        y0, y1 = np.clip(cy - ch // 2, 0, ih), np.clip(cy + ch // 2, 0, ih)
        x0, x1 = np.clip(cx - cw // 2, 0, iw), np.clip(cx + cw // 2, 0, iw)
        mixed = imgs.copy()
        mixed[:, y0:y1, x0:x1] = imgs[perm][:, y0:y1, x0:x1]
        lam = 1 - (y1 - y0) * (x1 - x0) / (ih * iw)
    else:
        lam = float(rng.beta(mixup_alpha, mixup_alpha))
        mixed = lam * imgs + (1 - lam) * imgs[perm]
    out = dict(batch)
    out[key] = mixed.astype(np.asarray(batch[key]).dtype)
    labels = batch.get(label_key)
    if labels is not None and np.issubdtype(np.asarray(labels).dtype,
                                            np.floating):
        y = np.asarray(labels, np.float32)
        if label_smoothing:
            ncls = y.shape[-1]
            y = y * (1 - label_smoothing) + label_smoothing / ncls
        out[label_key] = lam * y + (1 - lam) * y[perm]
    else:
        # batch-shaped so the device-put path can shard them like any other
        # per-example field (rank-0 arrays cannot take a batch PartitionSpec)
        out["mix_lam"] = np.full((n,), lam, np.float32)
        out["mix_perm"] = perm.astype(np.int32)
    return out


def make_mixup_fn(seed: int = 0, **kw) -> "callable":
    """Batch-level transform for `pipeline.make_for_train(batch_fn=...)`.

    Built by the trainer from `config.input.mixup = dict(...)` — the wiring
    the reference does with `mix_fn` in
    clipa_jax/datasets/input_pipeline.py:38,64-65.

    For classification-style objectives (one-hot float labels) only: mixing
    images while token-id captions stay unmixed breaks the contrastive
    pairing InfoNCE depends on — which is why every reference CLIP config
    ships `use_mixup = False` (e.g. model_b/64_32_pre_training.py:155).
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x4D49]))
    return lambda batch: mixup_cutmix(batch, rng, **kw)


# ---------------------------------------------------------------------------
# color jitter (torchvision semantics) and 3-Augment (DeiT-III)
# ---------------------------------------------------------------------------

@Registry.register("preprocess_ops.color_jitter")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_color_jitter(brightness: float = 0.4, contrast: float = 0.4,
                     saturation: float = 0.4, hue: float = 0.0,
                     prob: float = 1.0):
    """torchvision-style ColorJitter (random order, each factor uniform)."""
    def _op(image, sample=None):
        rng = _rng_of(sample)
        if rng.random() >= prob:
            return image
        img = np.asarray(image, np.float32)
        scale = 255.0 if img.max() > 1.5 else 1.0
        img = img / scale
        ops = []
        if brightness:
            ops.append(lambda x: _adjust_brightness(
                x, rng.uniform(max(0, 1 - brightness), 1 + brightness)))
        if contrast:
            ops.append(lambda x: _adjust_contrast(
                x, rng.uniform(max(0, 1 - contrast), 1 + contrast)))
        if saturation:
            ops.append(lambda x: _adjust_saturation(
                x, rng.uniform(max(0, 1 - saturation), 1 + saturation)))
        if hue:
            ops.append(lambda x: _adjust_hue(x, rng.uniform(-hue, hue)))
        for i in rng.permutation(len(ops)):
            img = np.clip(ops[i](img), 0, 1)
        img = img * scale
        return img.astype(np.uint8) if scale == 255.0 else img
    return _op


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur (reflect padding), float HWC in [0,1]."""
    radius = max(1, int(3 * sigma))
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img, ((radius, radius), (0, 0), (0, 0)), mode="reflect")
    img = sum(k[i] * pad[i:i + img.shape[0]] for i in range(len(k)))
    pad = np.pad(img, ((0, 0), (radius, radius), (0, 0)), mode="reflect")
    img = sum(k[i] * pad[:, i:i + img.shape[1]] for i in range(len(k)))
    return img


@Registry.register("preprocess_ops.three_augment")
@Registry.register("preprocess_ops.three_aug")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_three_augment(jitter_strength: float = 0.3):
    """DeiT-III 3-Augment: one of {grayscale, solarize, blur} + color jitter.

    Capability parity with the reference's three_aug.py.
    """
    def _op(image, sample=None):
        rng = _rng_of(sample)
        img = np.asarray(image, np.float32)
        scale = 255.0 if img.max() > 1.5 else 1.0
        img = img / scale
        choice = int(rng.integers(0, 3))
        if choice == 0:  # grayscale
            img = np.repeat((img @ _GRAY_W)[..., None], 3, axis=-1)
        elif choice == 1:  # solarize
            img = np.where(img < 0.5, img, 1.0 - img)
        else:  # gaussian blur
            img = _gaussian_blur(img, sigma=float(rng.uniform(0.1, 2.0)))
        # color jitter (brightness/contrast/saturation at fixed strength)
        s = jitter_strength
        img = np.clip(_adjust_brightness(img, rng.uniform(1 - s, 1 + s)), 0, 1)
        img = np.clip(_adjust_contrast(img, rng.uniform(1 - s, 1 + s)), 0, 1)
        img = np.clip(_adjust_saturation(img, rng.uniform(1 - s, 1 + s)), 0, 1)
        img = img * scale
        return img.astype(np.uint8) if scale == 255.0 else img
    return _op
