"""The port's fused uint8 patch embed against clipa_tpu.ops.patch_embed.

Inputs come from numpy seeds and go through both packages:
``clipa_tpu.ops.patch_embed.fused_patch_embed`` with ``impl="xla"`` and with
``impl="pallas"`` (the Pallas kernel in interpret mode on the CPU), and the
port's ``fused_patch_embed`` with the same impl (on a CPU tensor the
``pallas`` route runs the kernel's plain version). Shapes: p = 16 at width
128, and p = 14 at width 256, where K = 3 * 14^2 = 588 is not a multiple of
16 (the CUDA kernel's K-tail).

Tolerances: fp32 outputs rtol/atol 1e-4 (the same fp32 products summed in
another order); bf16 outputs within one bf16 ulp of the output's scale
(the two fp32 sums may round to neighbouring bf16 values);
``fold_normalization`` 1e-6: the scaled weights are the same fp32 products,
the bias shift a sum of 3p^2 terms in another order (1e-6 of the sum of
their magnitudes).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu.ops import patch_embed as jax_pe
from clipa_tpu_torch.ops import patch_embed as pe

SHAPES = [(16, 128, 32, 48), (14, 256, 28, 42)]   # p, width, H, W


def _operands(p, width, h, w, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8)
    kernel = (rng.randn(p, p, 3, width) * 0.02).astype(np.float32)
    bias = rng.randn(width).astype(np.float32)
    return images, kernel, bias


def _bf16_ulp(ref):
    scale = float(np.abs(ref).max())
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("p,width,h,w", SHAPES)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_port_matches_jax(p, width, h, w, impl, with_bias, out):
    images, kernel, bias = _operands(p, width, h, w)
    jax_out = np.asarray(jax_pe.fused_patch_embed(
        jnp.asarray(images), jnp.asarray(kernel),
        bias=jnp.asarray(bias) if with_bias else None,
        out_dtype=getattr(jnp, out), impl=impl).astype(jnp.float32))
    got = pe.fused_patch_embed(
        torch.from_numpy(images), torch.from_numpy(kernel),
        bias=torch.from_numpy(bias) if with_bias else None,
        out_dtype=getattr(torch, out), impl=impl)
    assert got.dtype == getattr(torch, out)
    assert got.shape == (2, (h // p) * (w // p), width)
    got = got.float().numpy()
    if out == "float32":
        np.testing.assert_allclose(got, jax_out, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - jax_out).max() <= _bf16_ulp(jax_out)


@pytest.mark.parametrize("layout", ["conv", "matrix"])
def test_fold_normalization_matches_jax(layout):
    _, kernel, _ = _operands(14, 256, 28, 28, seed=1)
    if layout == "matrix":
        kernel = kernel.reshape(-1, kernel.shape[-1])
    want_k, want_shift = jax_pe.fold_normalization(jnp.asarray(kernel))
    got_k, got_shift = pe.fold_normalization(torch.from_numpy(kernel))
    assert got_k.dtype == got_shift.dtype == torch.float32
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=1e-6,
                               atol=1e-6)
    # the shift sums 3p^2 terms of either sign in another order: 1e-6 of
    # the sum of their magnitudes
    mean = np.tile(np.asarray(pe.IMAGENET_MEAN_255, np.float32), 196)
    std = np.tile(np.asarray(pe.IMAGENET_STD_255, np.float32), 196)
    scale = (mean / std) @ np.abs(kernel.reshape(588, -1))
    assert (np.abs(got_shift.numpy() - np.asarray(want_shift))
            <= 1e-6 * scale).all()


def test_plain_version_is_normalize_then_patchify_then_matmul():
    """The folded product equals the unfolded one: normalize in fp32, cut
    patches, multiply by the conv weights, add the bias."""
    images, kernel, bias = _operands(14, 256, 28, 42, seed=2)
    x = torch.from_numpy(images).float()
    mean = torch.tensor(pe.IMAGENET_MEAN_255)
    std = torch.tensor(pe.IMAGENET_STD_255)
    x = ((x - mean) / std).reshape(2, 2, 14, 3, 14, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(2, 6, 588)
    want = x @ torch.from_numpy(kernel).reshape(588, 256) \
        + torch.from_numpy(bias)
    k_scaled, shift = pe.fold_normalization(torch.from_numpy(kernel))
    got = pe.patch_embed_plain(torch.from_numpy(images), k_scaled,
                               shift + torch.from_numpy(bias), 14,
                               torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["not divisible", "2-D weights"])
def test_same_value_errors_as_jax(case):
    images, kernel, _ = _operands(16, 128, 32, 32)
    if case == "not divisible":
        images = images[:, :30]
    else:
        kernel = kernel.reshape(-1, 128)
    for impl in ("xla", "pallas"):
        with pytest.raises(ValueError):
            jax_pe.fused_patch_embed(jnp.asarray(images), jnp.asarray(kernel),
                                     impl=impl)
        with pytest.raises(ValueError):
            pe.fused_patch_embed(torch.from_numpy(images),
                                 torch.from_numpy(kernel), impl=impl)


@pytest.mark.parametrize("width", [96, 128])
def test_cpu_tensors_and_the_width_gate_never_launch(monkeypatch, width):
    """On a CPU tensor ``impl="pallas"`` runs the folded product: bit for
    bit the ``xla`` route, no launch, and what the JAX package's pallas
    route computes, at width 128 and at width 96 (where the JAX package's
    gate gives way to XLA)."""
    images, kernel, bias = _operands(16, width, 32, 32, seed=3)

    def launch(*a, **kw):
        raise AssertionError("the kernel was launched")

    monkeypatch.setattr(pe, "_launch", launch)
    pe.fused_patch_embed.launches = 0
    args = (torch.from_numpy(images), torch.from_numpy(kernel),
            torch.from_numpy(bias))
    got = pe.fused_patch_embed(*args, out_dtype=torch.float32,
                               impl="pallas")
    assert torch.equal(got, pe.fused_patch_embed(
        *args, out_dtype=torch.float32, impl="xla"))
    assert pe.fused_patch_embed.launches == 0
    want = np.asarray(jax_pe.fused_patch_embed(
        jnp.asarray(images), jnp.asarray(kernel), bias=jnp.asarray(bias),
        out_dtype=jnp.float32, impl="pallas"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", [96, 128, 192])
def test_kernel_route_takes_every_width_the_kernel_takes(monkeypatch, width):
    """A tensor bound for the kernel (CUDA, here stood in for) launches it
    at every width that is a multiple of 4, 128 or not: no width gate, no
    plain version in its place."""
    images, kernel, bias = _operands(16, width, 32, 32, seed=4)
    seen = []

    def launch(images, w, full_bias, p, out_dtype):
        seen.append(w.shape)
        return pe.patch_embed_plain(images, w, full_bias, p, out_dtype) \
            .reshape(-1, w.shape[1])

    monkeypatch.setattr(pe, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(pe, "_launch", launch)
    monkeypatch.setattr(pe.fused_patch_embed, "launches", 0)
    args = (torch.from_numpy(images), torch.from_numpy(kernel),
            torch.from_numpy(bias))
    got = pe.fused_patch_embed(*args, out_dtype=torch.float32, impl="pallas")
    assert seen == [(768, width)] and pe.fused_patch_embed.launches == 1
    assert got.shape == (2, 4, width)
    assert torch.equal(got, pe.fused_patch_embed(
        *args, out_dtype=torch.float32, impl="xla"))


def test_kernel_route_refuses_widths_it_cannot_take(monkeypatch):
    images, kernel, _ = _operands(16, 6, 32, 32)
    monkeypatch.setattr(pe, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(pe, "_launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="multiples of 4"):
        pe.fused_patch_embed(torch.from_numpy(images),
                             torch.from_numpy(kernel), impl="pallas")
    # the plain routes take any width
    assert pe.fused_patch_embed(torch.from_numpy(images),
                                torch.from_numpy(kernel),
                                impl="xla").shape == (2, 4, 6)


def test_other_devices_and_impls_raise():
    images, kernel, _ = _operands(16, 128, 32, 32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pe.fused_patch_embed(torch.from_numpy(images).to("meta"),
                             torch.from_numpy(kernel).to("meta"),
                             impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        pe.fused_patch_embed(torch.from_numpy(images),
                             torch.from_numpy(kernel), impl="mosaic")


def test_kernel_tolerance_helper():
    ref = torch.tensor([1.0, -2.0, 0.5])
    assert pe.errors(ref.clone(), ref) == (0.0, True)
    assert not pe.errors(ref + 1e-2, ref)[1]
    near = (ref * (1 + 2.0 ** -7)).to(torch.bfloat16)   # one bf16 ulp up
    err, ok = pe.errors(near, ref.to(torch.bfloat16))
    assert ok and err > 0
    two_up = (ref * (1 + 2.0 ** -6)).to(torch.bfloat16)
    assert not pe.errors(two_up, ref.to(torch.bfloat16))[1]
    assert not pe.errors(torch.tensor([1.0, float("nan"), 0.5]), ref)[1]


# --- the tensor-core route of the CUDA kernel, emulated on the CPU ---------

# chip_smoke.py's PATCH_CASES geometries (side, p, width) at a small batch:
# L/16 @112, H/14 @224 (K = 588) and Ti/16 @224 (width 192: the JAX
# package's Pallas gate gives way to XLA there)
KERNEL_CASES = [(112, 16, 1024), (224, 14, 1280), (224, 16, 192)]


def _stem(side, p, width, seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (1, side, side, 3)).astype(np.uint8)
    kernel = (rng.randn(p, p, 3, width) * 0.02).astype(np.float32)
    bias = rng.randn(width).astype(np.float32)
    return images, kernel, bias


@pytest.mark.parametrize("side,p,width", KERNEL_CASES)
def test_split_weights_reconstruct_the_folded_weights(side, p, width):
    """hi + lo gives the folded fp32 weights to 2^-16 of each (in float64,
    where their sum is exact); hi alone does not; both are zero past K in
    the (2, width, k_pad) K-major layout the kernel's TMA reads."""
    _, kernel, _ = _stem(side, p, width, seed=5)
    w, _ = pe.fold_normalization(torch.from_numpy(kernel))
    k = 3 * p * p
    plan = pe.patch_plan((side // p) ** 2, width, p, side)
    split = pe.split_weights(w, plan.k_pad)
    assert split.dtype == torch.bfloat16
    assert split.shape == (2, width, plan.k_pad) and split.is_contiguous()
    hi, lo = (x.double().t() for x in split)
    assert not hi[k:].any() and not lo[k:].any()
    w64 = w.double()
    assert ((hi[:k] + lo[:k] - w64).abs() <= 2.0 ** -16 * w64.abs()).all()
    assert not ((hi[:k] - w64).abs() <= 2.0 ** -16 * w64.abs()).all()


def _emulated(images, w, full_bias, p, out_dtype, terms):
    """The kernel's arithmetic in fp32 on the CPU: the image (exact in bf16)
    times each bf16 part of the split weights in `terms` (0: hi, 1: lo),
    summed in fp32 with the bias, rounded once."""
    k = w.shape[0]
    split = pe.split_weights(w, -(-k // 64) * 64)
    zero = torch.zeros_like(full_bias)
    acc = sum(pe.patch_embed_plain(images, split[t, :, :k].float().t(), zero,
                                   p, torch.float32) for t in terms)
    return (acc + full_bias).to(out_dtype)


@pytest.mark.parametrize("side,p,width", KERNEL_CASES)
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_hi_plus_lo_meets_the_kernel_tolerance_against_jax(side, p, width,
                                                           out):
    """x.hi + x.lo in fp32 is within patch_embed.errors of the JAX
    package's fused_patch_embed(impl="pallas") (its Pallas kernel in
    interpret mode, or XLA where its gate gives way) at the three phase-9
    geometries, in both output types; x.hi alone is not (fp32 outputs:
    its 2^-9 weight error is some 20 times the tolerance)."""
    images, kernel, bias = _stem(side, p, width, seed=6)
    ref = np.array(jax_pe.fused_patch_embed(
        jnp.asarray(images), jnp.asarray(kernel), bias=jnp.asarray(bias),
        out_dtype=getattr(jnp, out), impl="pallas").astype(jnp.float32))
    ref = torch.from_numpy(ref).to(getattr(torch, out))
    w, shift = pe.fold_normalization(torch.from_numpy(kernel))
    full = shift + torch.from_numpy(bias)
    x = torch.from_numpy(images)
    got = _emulated(x, w, full, p, getattr(torch, out), (0, 1))
    err, ok = pe.errors(got, ref)
    assert ok, err
    if out == "float32":
        err_hi, ok_hi = pe.errors(_emulated(x, w, full, p, torch.float32,
                                            (0,)), ref)
        assert not ok_hi and err_hi > 10 * err


@pytest.mark.parametrize("b,side,p,width", [
    (384, 112, 16, 1024), (256, 224, 14, 1280), (64, 224, 16, 192),
    (5, 48, 16, 256), (3, 64, 16, 100), (1, 28, 14, 4), (2, 70, 14, 128),
    (1, 1344, 14, 256), (1, 96, 32, 768), (2, 40, 8, 128)])
def test_patch_plan_covers_every_tile_once_and_fits(b, side, p, width):
    """patch_plan's GEMM grid covers each output row and column once (no
    block wholly past the edge), its k loop reaches K in whole stages, and
    the shared memory of both kernels (the GEMM's ring, per stage a bf16 A
    tile and the hi and lo weight tiles and three mbarriers, its ring of
    four uint8 patch-row tiles with two mbarriers each, 1024 bytes of
    alignment; the patchify kernel's p image rows of 3 * side bytes,
    rounded up to 16) fits an H100 block's 227 KB; the plan is pure and
    cached."""
    from clipa_tpu_torch.ops.flash_attention import SMEM_LIMIT
    rows, k = b * (side // p) ** 2, 3 * p * p
    plan = pe.patch_plan(rows, width, p, side)
    assert plan is pe.patch_plan(rows, width, p, side)
    for n, tile, grid in ((rows, plan.bm, plan.grid_m),
                          (width, plan.bn, plan.grid_n)):
        owners = [0] * n
        for t in range(grid):
            for i in range(t * tile, min((t + 1) * tile, n)):
                owners[i] += 1
        assert owners == [1] * n
        assert (grid - 1) * tile < n
    assert plan.grid_m <= 65535
    assert plan.k_pad % plan.bk == 0 and 0 <= plan.k_pad - k < plan.bk
    stage = (plan.bm + 2 * plan.bn) * plan.bk * 2
    assert plan.smem == (plan.stages * (stage + 3 * 8)
                         + 4 * (plan.bm * plan.bk + 2 * 8) + 1024)
    assert plan.patchify_smem == -(-3 * p * side // 16) * 16
    assert max(plan.smem, plan.patchify_smem) <= SMEM_LIMIT


def test_patch_plan_refuses_rows_past_shared_memory():
    """The patchify kernel holds one patch-row group's p image rows: past
    a block's shared memory (p = 14 rows of a 5600 pixel image) there is
    no plan."""
    with pytest.raises(ValueError, match="shared memory"):
        pe.patch_plan(400 ** 2, 128, 14, 5600)


def test_kernel_launch_hands_the_entry_the_plan_and_the_split(monkeypatch):
    """With a stand-in library, _launch hands the C entry the images, a
    (rows, k_pad) uint8 scratch for the patch rows, the folded fp32
    weights and a (2, width, k_pad) bf16 scratch for their split, the
    dimensions, patch_plan's numbers and the output type, and allocates
    the (rows, width) output."""
    images, kernel, bias = _operands(14, 256, 28, 42)
    images = torch.from_numpy(images)
    w, shift = pe.fold_normalization(torch.from_numpy(kernel))
    seen, made, real_empty = {}, [], torch.empty

    class Lib:
        def clipa_patch_embed(self, *args):
            seen["args"] = args
            return 0

    monkeypatch.setattr(pe, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(
        real_empty(*a, **k)) or made[-1])
    out = pe._launch(images, w, shift, 14, torch.float32)
    plan = pe.patch_plan(2 * 2 * 3, 256, 14, 42)
    split, x, _ = made
    assert out is made[2]
    assert out.shape == (12, 256) and out.dtype == torch.float32
    assert split.shape == (2, 256, plan.k_pad)
    assert split.dtype == torch.bfloat16
    assert x.shape == (12, plan.k_pad) and x.dtype == torch.uint8
    assert seen["args"][:6] == (images.data_ptr(), x.data_ptr(),
                                w.data_ptr(), split.data_ptr(),
                                shift.data_ptr(), out.data_ptr())
    assert seen["args"][6:] == (2, 28, 42, 14, 256, plan.k_pad, 0, plan.bm,
                                plan.bn, plan.bk, plan.stages, plan.grid_n,
                                plan.grid_m, plan.smem, plan.patchify_smem,
                                7)
