"""Image preprocessing ops (host side).

Port of ``clipa_tpu/pp/ops_image.py``: decode, resize, resize_small,
central_crop, random_crop, inception_crop, decode_jpeg_and_inception_crop,
flip_lr, value_range, vgg_value_range, openai_value_range. Images flow as
HWC uint8 numpy arrays and stay uint8 until the device (normalization runs
there: ``clipa_tpu_torch/ops/preprocess.py``).

The JAX package resizes through PIL. The port resizes with :func:`_resize_np`,
a numpy port of Pillow's uint8 resampling (``libImaging/Resample.c`` for
bilinear, bicubic, lanczos and box; the affine transform with nearest
sampling, ``libImaging/Geometry.c``, for nearest), bit-exact against
``PIL.Image.resize``, so that the port needs no PIL where images arrive
decoded. PIL is imported only where JPEG bytes must be decoded (``decode``,
and the bytes branch of ``decode_jpeg_and_inception_crop``); without it
those branches raise ``ImportError``.

The bytes branch of ``decode_jpeg_and_inception_crop`` first takes the
native library's fused libjpeg decode, crop and resize
(``clipa_tpu_torch/native``, as the JAX op takes ``clipa_tpu/native``), with
the crop box drawn from the sample's RNG in the same order; where the
library is missing, or refuses the bytes, that sample takes the PIL route.
:data:`native_decodes` and :data:`pil_decodes` count the samples of each
route since import (a run sets them to 0 and reads them back).
"""

from __future__ import annotations

import ctypes
import functools
import io
import math
import threading
from typing import Optional

import numpy as np

from clipa_tpu_torch.registry import InKeyOutKey, Registry

_default_rng = np.random.default_rng(0)


def _rng_of(sample) -> np.random.Generator:
    return sample.get("_rng", _default_rng) if isinstance(sample, dict) \
        else _default_rng


# JPEG bytes decoded by decode_jpeg_and_inception_crop, by route
native_decodes = 0
pil_decodes = 0
_route_lock = threading.Lock()


def _count_decode(native: bool) -> None:
    global native_decodes, pil_decodes
    with _route_lock:
        if native:
            native_decodes += 1
        else:
            pil_decodes += 1


def _native_lib():
    """The C++ decode library, or None (PIL route)."""
    from clipa_tpu_torch import native
    return native.load() if native.available() else None


def _native_decode_crop(lib, data: bytes, rng, size: int, area_min,
                        area_max) -> Optional[np.ndarray]:
    """Fused libjpeg decode, crop and resize of JPEG `data` to (size, size,
    3) uint8, the box drawn from `rng` as the PIL route draws it; None
    where the library refuses the bytes (the caller takes the PIL route)."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    top, left, ch, cw = _sample_inception_box(rng, h.value, w.value,
                                              area_min, area_max)
    out = np.empty((size, size, 3), np.uint8)
    ret = lib.jpeg_decode_crop_resize(
        data, len(data), top, left, ch, cw, size, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if ret == 0 else None


def _pil(op: str):
    """PIL's Image module, for decoding bytes; raises ImportError naming
    the op where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"pp op {op!r} got encoded image bytes and needs "
                          f"PIL to decode them; PIL is not installed (pass "
                          f"decoded uint8 arrays instead)") from e
    return Image


# ---------------------------------------------------------------------------
# Pillow's resampling, in numpy
# ---------------------------------------------------------------------------

def _box_filter(x):
    return 1.0 if -0.5 < x <= 0.5 else 0.0


def _bilinear_filter(x):
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic_filter(x, a=-0.5):
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x):
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos_filter(x):
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


# method -> (filter, support), as Pillow's BOX/BILINEAR/BICUBIC/LANCZOS
_FILTERS = {
    "bilinear": (_bilinear_filter, 1.0),
    "bicubic": (_bicubic_filter, 2.0),
    "lanczos": (_lanczos_filter, 3.0),
    "area": (_box_filter, 0.5),
}
_METHODS = (*_FILTERS, "nearest")
_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=4096)
def _coeffs(in_size: int, out_size: int, method: str):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``: for
    each output index its first input index and fixed-point weights
    (int32, (out_size, ksize); zero past each window). Cached: the arrays
    are read-only.

    The weights are built in double, in Pillow's order of operations
    (Python floats are C doubles; the sums run left to right, never through
    ``sum``, which compensates), normalized to sum to 1, and rounded half
    away from zero to 22 fraction bits. A downscale widens the support by
    the scale."""
    filt, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    starts = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    one = float(1 << _PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        weights = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in weights:
            ww += w
        for x, w in enumerate(weights):
            if ww != 0.0:
                w /= ww
            kk[xx, x] = int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
        starts[xx] = xmin
    starts.flags.writeable = kk.flags.writeable = False
    return starts, kk


def _resample_axis(img: np.ndarray, axis: int, out_size: int,
                   method: str) -> np.ndarray:
    """One pass of Pillow's separable resample along `axis` (0: rows,
    vertical; 1: columns, horizontal) of an (H, W, C) uint8 image: int32
    sums of pixels x weights from 1 << 21, tap by tap in Pillow's order (so
    each partial sum is Pillow's), shifted and clipped to uint8."""
    starts, kk = _coeffs(img.shape[axis], out_size, method)
    idx = np.minimum(starts[:, None] + np.arange(kk.shape[1]),
                     img.shape[axis] - 1)   # weights are 0 past the window
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0))
    rest = src.shape[1:]
    src = src.reshape(src.shape[0], -1)   # long inner loops for numpy
    acc = np.full((out_size, src.shape[1]), 1 << (_PRECISION_BITS - 1),
                  np.int32)
    for j in range(idx.shape[1]):
        acc += src[idx[:, j]] * kk[:, j, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out.reshape((out_size,) + rest), 0, axis)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's nearest resize (an affine scale, ``ImagingScaleAffine``):
    the source index of each output index, the position accumulated in
    double from half a step; -1 where it falls outside (Pillow leaves that
    pixel 0)."""
    step = in_size / out_size
    pos = step * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):
        i = -1 if pos < 0.0 else int(pos)
        idx[x] = i if i < in_size else -1
        pos += step
    return idx


def _resize_pillow(img: np.ndarray, h: int, w: int,
                   method: str) -> np.ndarray:
    """``PIL.Image.resize((w, h), method)`` of an (H, W, C) uint8 image."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img.copy()
    if method == "nearest":
        rows, cols = _nearest_index(ih, h), _nearest_index(iw, w)
        out = img[np.maximum(rows, 0)][:, np.maximum(cols, 0)]
        out[rows < 0] = 0
        out[:, cols < 0] = 0
        return out
    # horizontal pass first, over a uint8 intermediate, as Pillow runs it
    if w != iw:
        img = _resample_axis(img, 1, w, method)
    if h != ih:
        img = _resample_axis(img, 0, h, method)
    return np.ascontiguousarray(img)


def _resize_np(img: np.ndarray, h: int, w: int, method: str) -> np.ndarray:
    """Resizes an HW or HWC (3 channels) image to (h, w) as the JAX package
    does (through ``PIL.Image.resize``), bit for bit. Non-uint8 input is
    clipped to [0, 255] and cast to uint8 first, as its ``_to_pil`` does."""
    if method not in _METHODS:
        raise KeyError(method)
    if h < 1 or w < 1:
        raise ValueError(f"height and width must be > 0, got {(h, w)}")
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        return _resize_pillow(arr[..., None], h, w, method)[..., 0]
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"resize takes HW or HWC (3 channels) images, got "
                         f"shape {arr.shape}")
    return _resize_pillow(arr, h, w, method)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@Registry.register("preprocess_ops.decode")
@InKeyOutKey(indefault="image", outdefault="image")
def get_decode(channels: int = 3):
    def _op(data):
        if isinstance(data, np.ndarray) and data.ndim == 3:
            return data  # already decoded
        img = _pil("decode").open(io.BytesIO(bytes(data)))
        img = img.convert("RGB" if channels == 3 else "L")
        return np.asarray(img)

    return _op


@Registry.register("preprocess_ops.resize")
@InKeyOutKey(indefault="image", outdefault="image")
def get_resize(size, method: str = "bilinear", antialias: bool = True):
    del antialias  # Pillow's resampling filters are inherently antialiased
    h, w = (size, size) if isinstance(size, int) else size

    def _op(image):
        return _resize_np(image, h, w, method)

    return _op


@Registry.register("preprocess_ops.resize_small")
@InKeyOutKey(indefault="image", outdefault="image")
def get_resize_small(smaller_size: int, method: str = "bilinear",
                     antialias: bool = True):
    """Resizes so the shorter side equals smaller_size (aspect preserved)."""
    del antialias

    def _op(image):
        ih, iw = np.asarray(image).shape[:2]
        ratio = smaller_size / min(ih, iw)
        h, w = round(ih * ratio), round(iw * ratio)
        return _resize_np(image, h, w, method)

    return _op


@Registry.register("preprocess_ops.central_crop")
@InKeyOutKey(indefault="image", outdefault="image")
def get_central_crop(crop_size):
    h, w = (crop_size, crop_size) if isinstance(crop_size, int) else crop_size

    def _op(image):
        image = np.asarray(image)
        ih, iw = image.shape[:2]
        top, left = (ih - h) // 2, (iw - w) // 2
        return image[top:top + h, left:left + w]

    return _op


@Registry.register("preprocess_ops.random_crop")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_random_crop(crop_size):
    h, w = (crop_size, crop_size) if isinstance(crop_size, int) else crop_size

    def _op(image, sample=None):
        rng = _rng_of(sample)
        image = np.asarray(image)
        ih, iw = image.shape[:2]
        top = int(rng.integers(0, ih - h + 1))
        left = int(rng.integers(0, iw - w + 1))
        return image[top:top + h, left:left + w]

    return _op


def _sample_inception_box(rng, ih: int, iw: int, area_min: float,
                          area_max: float, max_attempts: int = 10,
                          ratio_min: float = 3 / 4, ratio_max: float = 4 / 3):
    """Samples an aspect/area-jittered crop box (Szegedy et al. style)."""
    area = ih * iw
    for _ in range(max_attempts):
        target_area = rng.uniform(area_min / 100, area_max / 100) * area
        aspect = np.exp(rng.uniform(np.log(ratio_min), np.log(ratio_max)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= iw and ch <= ih:
            top = int(rng.integers(0, ih - ch + 1))
            left = int(rng.integers(0, iw - cw + 1))
            return top, left, ch, cw
    # fallback: central square
    s = min(ih, iw)
    return (ih - s) // 2, (iw - s) // 2, s, s


@Registry.register("preprocess_ops.inception_crop")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_inception_crop(size: Optional[int] = None, area_min: int = 5,
                       area_max: int = 100, method: str = "bilinear",
                       antialias: bool = True):
    del antialias

    def _op(image, sample=None):
        rng = _rng_of(sample)
        image = np.asarray(image)
        ih, iw = image.shape[:2]
        top, left, ch, cw = _sample_inception_box(rng, ih, iw, area_min,
                                                  area_max)
        crop = image[top:top + ch, left:left + cw]
        if size is not None:
            crop = _resize_np(crop, size, size, method)
        return crop

    return _op


@Registry.register("preprocess_ops.decode_jpeg_and_inception_crop")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_decode_jpeg_and_inception_crop(size: Optional[int] = None,
                                       area_min: int = 5, area_max: int = 100,
                                       method: str = "bilinear",
                                       antialias: bool = True):
    """Fused decode+crop: crop box from the header, draft-scaled decode.

    libjpeg can decode at 1/2, 1/4, 1/8 DCT scale nearly for free; when the
    final target is small (CLIPA pretrains at 64-112px) this skips most of
    the inverse DCT and colour conversion. JPEG bytes take the native
    library where it builds (the JAX op's route), else PIL; decoded arrays
    take the plain inception crop (and need no PIL).
    """
    del antialias
    native_lib = _native_lib() if size is not None else None

    def _op(data, sample=None):
        rng = _rng_of(sample)
        if isinstance(data, np.ndarray) and data.ndim == 3:
            # Already decoded; degrade to plain inception crop.
            ih, iw = data.shape[:2]
            top, left, ch, cw = _sample_inception_box(rng, ih, iw, area_min,
                                                      area_max)
            crop = data[top:top + ch, left:left + cw]
            return _resize_np(crop, size, size, method) if size else crop

        if native_lib is not None:
            out = _native_decode_crop(native_lib, bytes(data), rng, size,
                                      area_min, area_max)
            if out is not None:
                _count_decode(native=True)
                return out

        Image = _pil("decode_jpeg_and_inception_crop")
        _count_decode(native=False)
        img = Image.open(io.BytesIO(bytes(data)))  # header only (lazy)
        iw, ih = img.size
        top, left, ch, cw = _sample_inception_box(rng, ih, iw, area_min,
                                                  area_max)
        if size is not None and ch >= 2 * size and cw >= 2 * size:
            # Ask libjpeg for the smallest DCT scale that still oversamples
            # the target; draft() mutates the decoder before full decode.
            img.draft("RGB", (max(1, iw * size // cw),
                              max(1, ih * size // ch)))
            sx = img.size[0] / iw
            sy = img.size[1] / ih
            top, left = int(top * sy), int(left * sx)
            ch, cw = max(1, int(ch * sy)), max(1, int(cw * sx))
        img = img.convert("RGB")
        crop = np.asarray(img.crop((left, top, left + cw, top + ch)))
        return _resize_np(crop, size, size, method) if size else crop

    return _op


@Registry.register("preprocess_ops.flip_lr")
@InKeyOutKey(indefault="image", outdefault="image", with_data=True)
def get_flip_lr():
    def _op(image, sample=None):
        rng = _rng_of(sample)
        image = np.asarray(image)
        return image[:, ::-1] if rng.random() < 0.5 else image

    return _op


@Registry.register("preprocess_ops.value_range")
@InKeyOutKey(indefault="image", outdefault="image")
def get_value_range(vmin: float = -1.0, vmax: float = 1.0,
                    in_min: float = 0.0, in_max: float = 255.0,
                    clip_values: bool = False):
    def _op(image):
        image = np.asarray(image, np.float32)
        image = (image - in_min) / (in_max - in_min)
        image = vmin + image * (vmax - vmin)
        if clip_values:
            image = np.clip(image, vmin, vmax)
        return image

    return _op


# ImageNet channel stats in the 0..255 domain (CLIPA's training value range).
VGG_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
VGG_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def _mean_std_op(mean, std):
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def _op(image):
        return (np.asarray(image, np.float32) - mean) / std

    return _op


@Registry.register("preprocess_ops.vgg_value_range")
@InKeyOutKey(indefault="image", outdefault="image")
def get_vgg_value_range(mean=VGG_MEAN, std=VGG_STD):
    return _mean_std_op(mean, std)


# OpenAI CLIP channel stats (0..255 domain), the normalization of the
# non-BigVision open_clip model configs.
OPENAI_MEAN = (0.48145466 * 255, 0.4578275 * 255, 0.40821073 * 255)
OPENAI_STD = (0.26862954 * 255, 0.26130258 * 255, 0.27577711 * 255)


@Registry.register("preprocess_ops.openai_value_range")
@InKeyOutKey(indefault="image", outdefault="image")
def get_openai_value_range(mean=OPENAI_MEAN, std=OPENAI_STD):
    return _mean_std_op(mean, std)
