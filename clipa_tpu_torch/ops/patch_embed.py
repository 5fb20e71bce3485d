"""Fused uint8 -> normalized patch embeddings: CUDA kernel and plain version.

Port of ``clipa_tpu/ops/patch_embed.py``. The per-channel normalization is
folded into the stem's weights,

  norm(x) @ K = x @ (inv_std * K) + (bias - mean * inv_std @ K),

so no normalized float image is materialized. Two routes, as in the JAX
package:

  * ``impl="auto"`` / ``"xla"``: patchify the uint8 image, one fp32
    ``torch.matmul`` with the folded weights (the product the JAX package
    leaves to XLA);
  * ``impl="pallas"``: the hand-written kernel ``csrc/patch_embed.cu`` on
    a CUDA tensor, which reads the (B, H, W, 3) uint8 image itself and runs
    the fp32 GEMM at any width that is a multiple of 4 (other widths raise);
    on a CPU tensor its plain version, the same folded product. The
    reference gates its Pallas route on ``width % 128 == 0``, a TPU lane
    alignment; the CUDA kernel has no such limit, so no CUDA tensor gives
    way to the plain version.

:func:`fold_normalization` stays plain PyTorch on every device: it is tiny,
and it sits outside the Pallas kernel in JAX too.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from clipa_tpu_torch.ops import cuda_build
from clipa_tpu_torch.ops.preprocess import IMAGENET_MEAN_255, IMAGENET_STD_255

_SOURCE = "patch_embed.cu"
_ENTRY = "clipa_patch_embed"
_OUT_DTYPES = (torch.bfloat16, torch.float32)

# Kernel vs plain version, |kernel - plain| <= RTOL[out] * |plain| +
# SCALE_RTOL * max|plain|. Both sum the same fp32 products in another order:
# a few fp32 ulps of the largest partial sum over K <= 768 terms, far below
# SCALE_RTOL of the output's scale. bf16 outputs round that fp32 value once:
# where the two fp32 sums straddle a rounding boundary they land one bf16
# ulp apart, at most 2^-7 of the value.
SCALE_RTOL = 1e-4
RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def errors(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max abs error, within tolerance) of a kernel output against its
    plain version, by the tolerance above for out's dtype."""
    out, ref32 = out.float(), ref.float()
    err = (out - ref32).abs()
    limit = RTOL[ref.dtype] * ref32.abs() + SCALE_RTOL * ref32.abs().max()
    ok = bool(torch.isfinite(out).all() and (err <= limit).all())
    return err.max().item(), ok


def fold_normalization(kernel: torch.Tensor, mean=IMAGENET_MEAN_255,
                       std=IMAGENET_STD_255):
    """Returns (scaled_kernel, bias_shift), both fp32, folding (x-mean)/std
    into a GEMM.

    kernel: (p, p, 3, width) conv weights or (p*p*3, width) matrix.
    """
    k = kernel
    if k.dim() == 4:
        k = k.reshape(-1, k.shape[-1])
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32, device=k.device)
    mean = torch.tensor(mean, dtype=torch.float32, device=k.device)
    n_pix = k.shape[0] // 3
    inv_full = inv_std.repeat(n_pix)[:, None]          # (p*p*3, 1)
    mean_full = mean.repeat(n_pix)
    k = k.float()
    return k * inv_full, -(mean_full * inv_full[:, 0]) @ k


def patch_embed_plain(images: torch.Tensor, k_scaled: torch.Tensor,
                      full_bias: torch.Tensor, patch: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: (B, H, W, 3)
    uint8 -> (B, L, width), fp32 patch rows times the folded fp32 weights,
    plus the folded bias, rounded once to `out_dtype`."""
    b, h, w, _ = images.shape
    x = images.float().reshape(b, h // patch, patch, w // patch, patch, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, (h // patch) * (w // patch), patch * patch * 3)
    return (x @ k_scaled + full_bias).to(out_dtype)


def fused_patch_embed(images: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      mean=IMAGENET_MEAN_255, std=IMAGENET_STD_255,
                      out_dtype: torch.dtype = torch.bfloat16,
                      impl: str = "auto") -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, L, width) normalized patch embeddings.

    kernel: (p, p, 3, width) stem weights (conv layout); bias: optional
    (width,). ``impl="pallas"`` takes the CUDA kernel for a CUDA tensor
    (width a multiple of 4, else ValueError); a CPU tensor runs the plain
    version.
    """
    if kernel.dim() != 4:
        raise ValueError("pass conv-layout (p, p, 3, width) weights")
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    p = kernel.shape[0]
    b, h, w, _ = images.shape
    width = kernel.shape[-1]
    if h % p or w % p:
        raise ValueError(f"image {h}x{w} not divisible by patch {p}")
    k_scaled, bias_shift = fold_normalization(kernel, mean, std)
    full_bias = bias_shift if bias is None else bias_shift + bias.float()
    if impl != "pallas" or not _uses_kernel(images):
        return patch_embed_plain(images, k_scaled, full_bias, p, out_dtype)
    if width % 4:
        raise ValueError(f"the patch embed kernel takes widths that are "
                         f"multiples of 4, got {width}")
    out = _launch(images, k_scaled.contiguous(), full_bias.contiguous(), p,
                  out_dtype)
    fused_patch_embed.launches += 1
    return out.reshape(b, (h // p) * (w // p), width)


# Kernel launches (a plain counter: callers reset it to 0 and read it back to
# prove a run went through the kernel).
fused_patch_embed.launches = 0


def _uses_kernel(x: torch.Tensor) -> bool:
    """Whether x goes to the CUDA kernel (True) or to the plain version
    (False, CPU tensors); any other device raises."""
    if x.device.type == "cpu":
        return False
    if not x.is_cuda:
        raise ValueError(f"fused_patch_embed runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    return True


def library() -> ctypes.CDLL:
    """The kernel's library, built at first use: (images, w, bias, out,
    batch, height, width, patch, n, out_bf16, stream)."""
    return cuda_build.load_entries(
        _SOURCE, [_ENTRY],
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _launch(images, w, bias, patch, out_dtype):
    b, h, wd, c = images.shape
    n = w.shape[1]
    if images.dtype != torch.uint8 or c != 3 or not images.is_contiguous():
        raise ValueError("the kernel takes contiguous (B, H, W, 3) uint8 "
                         "images")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} (the kernel writes bfloat16 "
                        f"or float32)")
    for name, x in (("weights", w), ("bias", bias)):
        if x.device != images.device:
            raise ValueError(f"{name} on {x.device}, expected "
                             f"{images.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((b * (h // patch) * (wd // patch), n), dtype=out_dtype,
                      device=images.device)
    lib = library()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.clipa_patch_embed(
            images.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, wd, patch, n, int(out_dtype == torch.bfloat16), stream)
    cuda_build.raise_on(err, lib, "patch embed kernel")
    return out
