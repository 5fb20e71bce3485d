"""On-device input preprocessing.

Port of ``clipa_tpu/ops/preprocess.py``: uint8 images travel to the device
(a quarter of the fp32 bytes) and are normalized there.
"""

from __future__ import annotations

import torch

# ImageNet channel statistics scaled to the uint8 range (the
# "vgg_value_range" convention CLIPA trains with).
IMAGENET_MEAN_255 = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD_255 = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def normalize_uint8(images: torch.Tensor, mean=IMAGENET_MEAN_255,
                    std=IMAGENET_STD_255,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized float, on the images' device."""
    mean = torch.tensor(mean, dtype=dtype, device=images.device)
    inv_std = 1.0 / torch.tensor(std, dtype=dtype, device=images.device)
    return (images.to(dtype) - mean) * inv_std
