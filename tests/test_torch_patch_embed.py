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
