"""Fused uint8 -> normalized patch embeddings: CUDA kernel and plain version.

Port of ``clipa_tpu/ops/patch_embed.py``. The per-channel normalization is
folded into the stem's weights,

  norm(x) @ K = x @ (inv_std * K) + (bias - mean * inv_std @ K),

so no normalized float image is materialized. Two routes, as in the JAX
package:

  * ``impl="auto"`` / ``"xla"``: patchify the uint8 image, one fp32
    ``torch.matmul`` with the folded weights (the product the JAX package
    leaves to XLA);
  * ``impl="pallas"``: the hand-written kernels of ``csrc/patch_embed.cu``
    on a CUDA tensor: a kernel that splits the folded weights into a bf16
    high part and its bf16 remainder (:func:`split_weights` is its plain
    version), a patchify kernel that cuts the (B, H, W, 3) uint8 image
    into uint8 patch rows, then a GEMM that runs the product on the tensor
    cores as two bf16 products, the patch rows (exact in bf16) times each
    part, summed in fp32, at any width that is a
    multiple of 4 (other widths raise), under :func:`patch_plan`'s launch;
    on a CPU tensor its plain version, the folded fp32 product. The
    reference gates its Pallas route on ``width % 128 == 0``, a TPU lane
    alignment; the CUDA kernel has no such limit, so no CUDA tensor gives
    way to the plain version.

:func:`fold_normalization` stays plain PyTorch on every device: it is tiny,
and it sits outside the Pallas kernel in JAX too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from clipa_tpu_torch.ops import cuda_build
from clipa_tpu_torch.ops.flash_attention import SMEM_LIMIT
from clipa_tpu_torch.ops.preprocess import IMAGENET_MEAN_255, IMAGENET_STD_255

_SOURCE = "patch_embed.cu"
_ENTRY = "clipa_patch_embed"
_OUT_DTYPES = (torch.bfloat16, torch.float32)

# Kernel vs plain version, |kernel - plain| <= RTOL[out] * |plain| +
# SCALE_RTOL * max|plain|. Both are fp32 sums of K <= 768 products of the
# same pixels, in another order, and the kernel's weights are hi + lo, two
# bf16 values whose sum misses the fp32 weight by at most 2^-16 of it
# (round to nearest: 2^-18). So the kernel's sum differs from the plain one
# by a few fp32 ulps of the largest partial sum plus at most 2^-16 of
# sum_k |x w| (measured with the pixels' full 0..255 range: 2e-5 against the
# ~5e-4 that SCALE_RTOL allows at the stem's scale). bf16 outputs round that
# fp32 value once: where the two fp32 sums straddle a rounding boundary they
# land one bf16 ulp apart, at most 2^-7 of the value.
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
    inv_full, shift_full = _fold_constants(
        k.shape[0] // 3, tuple(map(float, mean)), tuple(map(float, std)),
        k.device)
    k = k.float()
    return k * inv_full[:, None], shift_full @ k


@functools.lru_cache(maxsize=None)
def _fold_constants(n_pix: int, mean: tuple, std: tuple,
                    device: torch.device):
    """The fold's per-row fp32 constants on `device`: 1 / std and -mean /
    std (as -(mean * (1 / std))), each repeated over n_pix pixels (p*p*3,).
    Built once per (pixels, statistics, device): a host-to-device copy of
    the statistics on every call would wait for the card."""
    with torch.inference_mode(False):
        inv_full = (1.0 / torch.tensor(std, dtype=torch.float32)).repeat(
            n_pix)
        mean_full = torch.tensor(mean, dtype=torch.float32).repeat(n_pix)
        return inv_full.to(device), (-(mean_full * inv_full)).to(device)


class PatchPlan(NamedTuple):
    """The kernels' launch, as their C entry takes it: the GEMM's `bm` x
    `bn` output tiles (three consumer warpgroups of 64 rows; persistent
    blocks walk them),
    `bk` k per stage of a `stages`-deep ring, the k loop over `k_pad` (3
    p^2 rounded up to bk), a (`grid_n` column tiles, `grid_m` row tiles)
    grid and `smem` bytes of shared memory per block; the patchify
    kernel's `patchify_smem` bytes (one patch-row group's p image rows)."""
    bm: int
    bn: int
    bk: int
    stages: int
    k_pad: int
    grid_n: int
    grid_m: int
    smem: int
    patchify_smem: int


# csrc/patch_embed.cu kBM, kBN, kBK, kStages, kXStages: one layout
_TILE_M, _TILE_N, _TILE_K, _STAGES, _X_STAGES = 192, 128, 64, 3, 4


@functools.lru_cache(maxsize=None)
def patch_plan(rows: int, n: int, patch: int, width: int) -> PatchPlan:
    """The kernels' launch for `rows` patch rows of width `n` from images
    `width` pixels wide at patch size `patch` (a pure function, cached):
    192 x 128 tiles, 64 k per stage, a three-stage ring whose stages each
    hold a bf16 A tile (192 x 64) and the hi and lo weight tiles (128 x 64
    each), a four-tile ring of uint8 patch rows (192 x 64), three
    mbarriers per stage and two per patch-row tile, and 1024 bytes to align
    the rings for the 128-byte swizzle; the patchify kernel's p image rows
    of 3 width bytes, rounded up to 16.
    Raises where those do not fit an H100 block (images past some 5500
    pixels wide at p = 14)."""
    stage = (_TILE_M + 2 * _TILE_N) * _TILE_K * 2
    patchify = -(-3 * patch * width // 16) * 16
    if patchify > SMEM_LIMIT:
        raise ValueError(f"{patch} rows of a {width} pixel image exceed a "
                         f"block's {SMEM_LIMIT} bytes of shared memory")
    return PatchPlan(_TILE_M, _TILE_N, _TILE_K, _STAGES,
                     -(-3 * patch * patch // _TILE_K) * _TILE_K,
                     -(-n // _TILE_N), -(-rows // _TILE_M),
                     _STAGES * (stage + 3 * 8)
                     + _X_STAGES * (_TILE_M * _TILE_K + 2 * 8) + 1024,
                     patchify)


def split_weights(w: torch.Tensor, k_pad: int) -> torch.Tensor:
    """The GEMM's weight operand, in plain PyTorch (the split kernel of
    csrc/patch_embed.cu computes it bit for bit on the card): (K, N) fp32
    -> (2, N, k_pad) bf16, hi = bf16(w) and lo = bf16(w - hi), each
    transposed so that row j holds column j of w (the K-major B operand of
    the tensor-core product), zero for k >= K. hi + lo misses w by at most
    2^-16 of |w|."""
    k, n = w.shape
    w = w.float()
    hi = w.to(torch.bfloat16)
    lo = (w - hi).to(torch.bfloat16)    # w - float(hi), exact in fp32
    out = torch.empty((2, n, k_pad), dtype=torch.bfloat16, device=w.device)
    out[:, :, :k] = torch.stack((hi, lo)).transpose(1, 2)
    out[:, :, k:] = 0
    return out


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
    """The kernels' library, built at first use: (images, x, w, w_split,
    bias, out, batch, height, width, patch, n, k_pad, out_bf16, bm, bn, bk,
    stages, grid_n, grid_m, smem, patchify_smem, stream)."""
    return cuda_build.load_entries(
        _SOURCE, [_ENTRY],
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p])


def _launch(images, w, bias, patch, out_dtype,
            plan: Optional[PatchPlan] = None):
    """Runs the kernels on the folded fp32 weights `w` (K, n), contiguous,
    and bias. `plan`: patch_plan's by default."""
    b, h, wd, c = images.shape
    n = w.shape[1]
    if images.dtype != torch.uint8 or c != 3 or not images.is_contiguous():
        raise ValueError("the kernel takes contiguous (B, H, W, 3) uint8 "
                         "images")
    if (w.dtype != torch.float32 or not w.is_contiguous()
            or w.shape[0] != 3 * patch * patch):
        raise ValueError(f"the kernel takes contiguous fp32 ({3 * patch ** 2}"
                         f", width) weights, got {w.dtype} {tuple(w.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} (the kernel writes bfloat16 "
                        f"or float32)")
    for name, x in (("weights", w), ("bias", bias)):
        if x.device != images.device:
            raise ValueError(f"{name} on {x.device}, expected "
                             f"{images.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    rows = b * (h // patch) * (wd // patch)
    plan = plan or patch_plan(rows, n, patch, wd)
    # the scratch between the kernels: the weights' hi and lo parts (the
    # split's output) and the uint8 patch rows (the patchify kernel's),
    # both the GEMM's input
    w_split = torch.empty((2, n, plan.k_pad), dtype=torch.bfloat16,
                          device=images.device)
    x = torch.empty((rows, plan.k_pad), dtype=torch.uint8,
                    device=images.device)
    out = torch.empty((rows, n), dtype=out_dtype, device=images.device)
    lib = library()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.clipa_patch_embed(
            images.data_ptr(), x.data_ptr(), w.data_ptr(),
            w_split.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, wd,
            patch, n, plan.k_pad,
            int(out_dtype == torch.bfloat16), plan.bm, plan.bn, plan.bk,
            plan.stages, plan.grid_n, plan.grid_m, plan.smem,
            plan.patchify_smem, stream)
    cuda_build.raise_on(err, lib, "patch embed kernel")
    return out
