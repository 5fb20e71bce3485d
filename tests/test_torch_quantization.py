"""The port's int8 matmuls and the towers' ``quant`` / ``stream`` options
against ``clipa_tpu``.

  * ``_quantize``: the int8 codes and the scales of the same fp32 inputs
    equal the JAX package's exactly (half-to-even rounding in both).
  * ``int8_dot_general`` in both modes (high-precision backward, and
    ``int8_full``'s int8 backward), on 2-D and 3-D operands and kernels
    (one and two contraction dims): outputs rtol 1e-6; gradients of the
    int8 backward rtol 1e-6, of the fp32 backward rtol 1e-5 (summation
    order) of each tensor's largest element.
  * ``quant_dot``'s modes, and its refusal of an unknown one.
  * The smoke two-towers (Ti towers of depth 2, fp32) with both towers at
    ``quant="int8"`` and ``"int8_full"``, from one flat parameter dict
    (the JAX model's init, through ``convert.load_jax_params``): at least
    3 of the 4 rows of each embedding within 1e-5 of its largest element,
    and every row within 1e-2 (a code of an activation rounds the other way
    where the two packages' fp32 activations differ in the last bit and sit
    on a rounding boundary: one image row here), below the 0.02 at most
    that int8 moves the port's own embeddings from ``quant=None``; the
    parameter names and shapes equal the unquantized model's.
  * ``stream="ref3d"``: the towers' residual stream stays (B, L, D), the
    image tower's attention gets 3-D operands and still runs the fused
    path; embeddings and every gradient equal the flat stream's (rtol
    1e-5 of each tensor's largest element).
  * ``int8_mm`` on the card (marked ``cuda``): ``torch._int_mm`` on
    zero-padded operands at shapes cuBLASLt refuses as they are equals the
    int32 product of the codes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu.config import load_config as jax_load_config
from clipa_tpu.models import get_model_module as jax_model_module
from clipa_tpu.ops import quantization as jq
from clipa_tpu_torch import convert, optim
from clipa_tpu_torch.config import load_config
from clipa_tpu_torch.ops import attention, block_attention
from clipa_tpu_torch.ops import quantization as q
from clipa_tpu_torch.train import step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = "configs/smoke.py:steps=2,batch=8"

# (x shape, w shape, contraction dims)
SHAPES = [((4, 5, 16), (16, 24), 1), ((6, 3, 8), (3, 8, 10), 2),
          ((7, 16), (16, 4, 8), 1), ((33, 40), (40, 12), 1)]


def _operands(xs, ws, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.02).astype(np.float32)
    return x, w


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


@pytest.mark.parametrize("xs,ws,n", SHAPES)
def test_codes_and_scales_are_the_jax_packages(xs, ws, n):
    x, w = _operands(xs, ws)
    for a, axes in ((x, tuple(range(x.ndim - n, x.ndim))),
                    (w, tuple(range(n)))):
        jq_codes, j_scale = jq._quantize(jnp.asarray(a), axes)
        codes, scale = q._quantize(torch.tensor(a), axes)
        assert codes.dtype == torch.int8
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jq_codes))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    # half to even: 2.5 and -0.5 codes of a scale of 1
    ties = torch.tensor([[127.0, 2.5, -0.5, 1.5]])
    np.testing.assert_array_equal(q._quantize(ties, (1,))[0].numpy(),
                                  [[127, 2, 0, 2]])


@pytest.mark.parametrize("quant_bwd", [False, True])
@pytest.mark.parametrize("xs,ws,n", SHAPES)
def test_int8_dot_general_matches_jax(xs, ws, n, quant_bwd):
    x, w = _operands(xs, ws, 1)
    want, vjp = jax.vjp(lambda a, b: jq.int8_dot_general(a, b, n, quant_bwd),
                        jnp.asarray(x), jnp.asarray(w))
    g = np.random.default_rng(2).standard_normal(want.shape).astype(
        np.float32)
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = q.int8_dot_general(tx, tw, n, quant_bwd)
    got.backward(torch.tensor(g))
    assert got.dtype == torch.float32
    _close(got.detach(), want, 1e-6)
    grad_tol = 1e-6 if quant_bwd else 1e-5
    _close(tx.grad, want_dx, grad_tol)
    _close(tw.grad, want_dw, grad_tol)


@pytest.mark.parametrize("mode", [None, "none", "bf16", "int8", "int8_full"])
def test_quant_dot_modes_match_jax(mode):
    x, w = _operands((3, 5, 16), (16, 24), 3)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = jq.quant_dot(jnp.asarray(x, jdtype), jnp.asarray(w),
                            quant=mode)
        got = q.quant_dot(torch.tensor(x).to(dtype), torch.tensor(w),
                          quant=mode)
        assert got.dtype == dtype
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        _close(got.float(), np.asarray(want, np.float32), tol)
    with pytest.raises(ValueError, match="int4"):
        q.quant_dot(torch.tensor(x), torch.tensor(w), quant="int4")


def test_int8_matmul_and_the_plain_product():
    x, w = _operands((9, 20), (20, 7), 4)
    got = q.int8_matmul(torch.tensor(x), torch.tensor(w))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq.int8_matmul(jnp.asarray(x),
                                               jnp.asarray(w))))
    a = torch.randint(-127, 128, (5, 13), dtype=torch.int8)
    b = torch.randint(-127, 128, (13, 6), dtype=torch.int8)
    assert torch.equal(q.int8_mm(a, b), a.int() @ b.int())
    with pytest.raises(TypeError, match="int8"):
        q.int8_mm(a.float(), b)


def _smoke_pair(quant=None, stream="flat"):
    """The JAX and the port's smoke two-towers at `quant` / `stream`, with
    one set of parameters (the JAX init)."""
    jconfig = jax_load_config(os.path.join(REPO, "clipa_tpu", SMOKE))
    config = load_config(os.path.join(REPO, "clipa_tpu_torch", SMOKE))
    for c in (jconfig, config):
        c.model.dtype = "float32"
        for tower in ("image", "text"):
            c.model[tower].update(quant=quant, stream=stream)
    jmodel = jax_model_module("two_towers").Model(**dict(jconfig.model))
    img, txt = (tuple(s) for s in jconfig.init_shapes)
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         jnp.zeros(img, jnp.float32),
                         jnp.zeros(txt, jnp.int32), train=False)["params"]
    model = step.create_model(config, device="cpu")
    convert.load_jax_params(model, jax.device_get(params))
    return jmodel, params, model.eval(), config


def _inputs(config, seed=0):
    rng = np.random.default_rng(seed)
    img, txt = (tuple(s) for s in config.init_shapes)
    images = rng.standard_normal((4,) + img[1:]).astype(np.float32)
    labels = rng.integers(1, 18, (4,) + txt[1:]).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("quant", ["int8", "int8_full"])
def test_quantized_two_towers_match_the_jax_model(quant):
    jmodel, params, model, config = _smoke_pair(quant)
    images, labels = _inputs(config)
    jz = jmodel.apply({"params": params}, jnp.asarray(images),
                      jnp.asarray(labels), train=False)
    with torch.no_grad():
        z = model(torch.tensor(images), torch.tensor(labels))
        plain = _smoke_pair(None)[2](torch.tensor(images),
                                     torch.tensor(labels))
    for i in range(2):
        want = np.asarray(jz[i])
        rows = np.abs(z[i].numpy() - want).max(axis=1) / np.abs(want).max()
        assert (rows < 1e-5).sum() >= 3, rows   # a code flip moves a row
        assert rows.max() < 1e-2, rows
        diff = float((z[i] - plain[i]).abs().max())
        assert 0 < diff < 0.02, diff   # int8 changes the numbers, a little
    assert {n: tuple(p.shape) for n, p in optim.named_parameters(
        model).items()} == {n: tuple(p.shape) for n, p in
                            optim.named_parameters(_smoke_pair()[2]).items()}


def test_ref3d_stream_matches_the_flat_stream(monkeypatch):
    """The smoke towers at 32 px have L = 5 image tokens: the attention
    dispatch is forced to the fused path (plain versions on the CPU) to see
    which operands reach it."""
    seen = []
    fused = block_attention.fused_attention

    def spy(q_, k, v, num_heads, seq_len, *a, **kw):
        seen.append((q_.dim(), seq_len))
        return fused(q_, k, v, num_heads, seq_len, *a, **kw)

    monkeypatch.setattr(block_attention, "fused_attention", spy)
    monkeypatch.setattr(attention, "_FUSED_MIN_SEQ", 5)
    out = {}
    for stream in ("flat", "ref3d"):
        _, _, model, config = _smoke_pair(None, stream)
        model.train()
        images, labels = _inputs(config, 1)
        zimg, ztxt, _ = model(torch.tensor(images), torch.tensor(labels))
        (zimg.square().sum() + (zimg * ztxt).sum()).backward()
        out[stream] = (zimg.detach(), ztxt.detach(), {
            n: p.grad.clone() for n, p in
            optim.named_parameters(model).items() if p.grad is not None})
        blocks = model.img.Transformer
        assert blocks.stream == stream
    # the image tower's 2 blocks reach the fused path in both streams; the
    # flat stream hands it (B*L, D) rows, ref3d's multi_head_attention
    # flattens its (B, L, D) operands first, with the same sequence length
    assert [s for s in seen if s[1] == 5] == [(2, 5)] * 4
    for a, b in zip(out["flat"][:2], out["ref3d"][:2]):
        _close(b, a, 1e-5)
    assert set(out["flat"][2]) == set(out["ref3d"][2])
    assert len(out["flat"][2]) > 30
    for name, g in out["flat"][2].items():
        _close(out["ref3d"][2][name], g, 1e-5)


def test_unknown_quant_and_stream_are_refused():
    config = load_config(os.path.join(REPO, "clipa_tpu_torch", SMOKE))
    config.model.image.update(stream="3d")
    with pytest.raises(ValueError, match="stream"):
        step.create_model(config, device="cpu")
    config = load_config(os.path.join(REPO, "clipa_tpu_torch", SMOKE))
    config.model.text.update(quant="int4")
    with pytest.raises(ValueError, match="int4"):
        step.create_model(config, device="cpu")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA device: torch._int_mm is cuBLASLt")
@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (16, 8, 8), (17, 13, 5),
                                   (24, 64, 48), (257, 1024, 3072)])
def test_int_mm_padding_on_the_card(m, k, n):
    gen = torch.Generator().manual_seed(m * k * n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen)
    got = q.int8_mm(a.cuda(), b.cuda())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), a.int() @ b.int())
