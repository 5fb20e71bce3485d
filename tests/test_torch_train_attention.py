"""Attention gradients of clipa_tpu_torch against the JAX package.

The port's plain backward (``block_attention.attention_plain_bwd``) is held
against the VJPs of the Pallas kernels themselves, run in interpret mode on
the CPU as tests/test_block_attention.py runs them:
``fused_attention_2d_b`` (K6, biased flat rows), ``fused_attention_2d`` (K4)
and the per-sample ``fused_attention`` (K2, with several q-tiles at L = 577
so its fp32 dK/dV accumulation across q-tiles runs).

Tolerances: fp32 2e-5 relative to each gradient's largest element (JAX
under default_matmul_precision("highest"); only the fp32 summation order
differs, and gradients are sums of terms of both signs, so the scale is the
tensor's, not the element's). bf16: ``block_attention.BWD_RTOL`` (1e-2) on
the same scale plus the element's own: both round dS*scale, P and the
outputs to bf16, and a few-ulp fp32 difference can move one rounding to the
neighbouring bf16 value, about one bf16 ulp (2^-8) of the largest term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu.ops import attention as jax_attention
from clipa_tpu.ops import block_attention as jax_block
from clipa_tpu_torch.ops import attention, block_attention

F32_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch's
    intra-op pool from oversubscribing the cores the JAX tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, l, h, hd, seed, q_scale=1.0):
    rng = np.random.RandomState(seed)
    d = h * hd
    q, k, v, do = (rng.randn(b * l, d).astype(np.float32) for _ in range(4))
    biases = tuple((0.5 * rng.randn(d)).astype(np.float32) for _ in range(3))
    return q * q_scale, k, v, do, biases


def _close(out, ref, rtol, what, scale=None):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max() if scale is None else scale
    err = np.abs(out - ref)
    limit = rtol * (np.abs(ref) + scale)
    assert (err <= limit).all(), (
        f"{what}: max err {err.max():.3e} (max |ref| {scale:.3e}, "
        f"rtol {rtol})")


def _jax_vjp(fn, primals, do, dtype):
    """VJP of fn at primals (numpy fp32 arrays cast to dtype)."""
    with jax.default_matmul_precision("highest"):
        args = [jnp.asarray(a, dtype) for a in primals]
        _, vjp = jax.vjp(fn, *args)
        grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_bwd(primals, do, h, l, bias, exact, dtype):
    t = [torch.from_numpy(a).to(dtype) for a in primals]
    tdo = torch.from_numpy(do).to(dtype)
    biases = tuple(t[3:]) if bias else None
    grads = block_attention.attention_plain_bwd(*t[:3], tdo, h, l, biases,
                                                exact)
    return [g.float().numpy() for g in grads if g is not None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,hd,exact,q_scale", [
    (4, 50, 4, 16, False, 1.0),    # 112px length (the pretrain path)
    (8, 37, 2, 16, False, 1.0),    # ragged length, G = 4 Pallas plan
    (2, 40, 4, 16, False, 40.0),   # clip mode past the clip: the mask bites
    (2, 40, 4, 16, True, 40.0),    # exact mode at logits >> 70
])
def test_plain_bwd_matches_biased_2d_kernel_vjp(b, l, h, hd, exact, q_scale,
                                                dtype):
    """K6: dq, dk, dv and the fp32 bias grads."""
    q, k, v, do, biases = _inputs(b, l, h, hd, seed=l + hd, q_scale=q_scale)
    primals = (q, k, v, *biases)
    ref = _jax_vjp(lambda q, k, v, bq, bk, bv: jax_block.fused_attention_2d_b(
        q, k, v, bq, bk, bv, h, l, exact), primals, do, jnp.dtype(dtype))
    out = _torch_bwd(primals, do, h, l, True, exact,
                     getattr(torch, dtype))
    rtol = F32_RTOL if dtype == "float32" else block_attention.BWD_RTOL
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        _close(o, r, rtol, name)
    # A bias grad is a column sum over B*L rows (dbk is exactly 0 in exact
    # arithmetic: the rows of dS sum to 0), so its scale is the column's sum
    # of magnitudes.
    for name, o, r, g in zip(("dbq", "dbk", "dbv"), out[3:], ref[3:],
                             ref[:3]):
        _close(o, r, rtol, name, scale=np.abs(g).sum(0).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_unbiased_2d_kernel_vjp(dtype):
    """K4: no bias, G = 8 flat plan."""
    b, l, h, hd = 8, 37, 2, 16
    q, k, v, do, _ = _inputs(b, l, h, hd, seed=3)
    ref = _jax_vjp(lambda q, k, v: jax_block.fused_attention_2d(
        q, k, v, h, l), (q, k, v), do, jnp.dtype(dtype))
    out = _torch_bwd((q, k, v), do, h, l, False, False,
                     getattr(torch, dtype))
    rtol = F32_RTOL if dtype == "float32" else block_attention.BWD_RTOL
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        _close(o, r, rtol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,exact", [(577, False), (257, True), (37, False),
                                     (180, False), (346, False)])
def test_plain_bwd_matches_per_sample_kernel_vjp(l, exact, dtype):
    """K2 over (B, L, D). At L = 577 its plan has two q-tiles (bq = 512), so
    dK/dV accumulate in fp32 across q-tiles and the rows past L are
    zeroed. L = 180 and 346 are the H/14 unmask-tuning lengths (224 px at
    mask 0.3, 336 px at mask 0.4), where the port's bwd_plan takes its long
    scheme."""
    b, h, hd = 1, 2, 16
    d = h * hd
    if l == 577:
        plan = jax_block._plan(b, l, d, h, bwd=True)
        assert plan is not None and -(-l // plan[1]) > 1
    q, k, v, do, _ = _inputs(b, l, h, hd, seed=l)
    ref = _jax_vjp(lambda q, k, v: jax_block.fused_attention(
        q.reshape(b, l, d), k.reshape(b, l, d), v.reshape(b, l, d), h,
        exact).reshape(b * l, d), (q, k, v), do, jnp.dtype(dtype))
    out = _torch_bwd((q, k, v), do, h, l, False, exact,
                     getattr(torch, dtype))
    rtol = F32_RTOL if dtype == "float32" else block_attention.BWD_RTOL
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        _close(o, r, rtol, name)


@pytest.mark.parametrize("b,res,mask_ratio", [(64, 224, 0.3),
                                              (16, 336, 0.4)])
def test_auto_takes_the_fused_kernels_at_the_h14_finetune_shapes(
        b, res, mask_ratio):
    """The H/14 unmask-tuning stages of configs/clipa_finetune.py keep 1 +
    int(grid^2 (1 - mask_ratio)) image tokens: 180 at 224 px and mask 0.3,
    346 at 336 px and mask 0.4. There the JAX package's fused plan fits,
    so `auto` takes the fused kernels in both packages, and the port's
    backward takes its long scheme."""
    grid = res // 14
    l = 1 + int(grid * grid * (1 - mask_ratio))
    assert l == {224: 180, 336: 346}[res]
    assert jax_block._plan(b, l, 1280, 16, bwd=False) is not None
    assert attention._auto(b, l, 1280, 16, None, True) == "fused"
    assert block_attention.bwd_plan(l, 80).scheme == block_attention.BWD_LONG


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_scale", [1.0, 40.0])
def test_reference_exact_backward_fallback(monkeypatch, q_scale, dtype):
    """Where the reference's backward VMEM plan fails while its forward plan
    fits (ViT-bigG-14 @336 unmasked), its VJP takes the gradient of
    ``_xla_reference``: the exact softmax's, with no clip-grad mask. A
    lowered ``_VMEM_BUDGET_BWD`` puts a small shape there. The port keeps
    the clip-consistent gradient (``attention_plain_bwd``) at every shape:
    below the clip the two agree up to rounding; past it (q x 40) they
    differ, and the port's equals ``attention_plain_bwd``."""
    b, l, h, hd = 2, 40, 4, 16
    d = h * hd
    monkeypatch.setattr(jax_block, "_VMEM_BUDGET_BWD", 1)
    assert jax_block._plan(b, l, d, h, bwd=True) is None
    assert jax_block._plan(b, l, d, h, bwd=False) is not None
    q, k, v, do, _ = _inputs(b, l, h, hd, seed=41, q_scale=q_scale)
    ref = _jax_vjp(lambda q, k, v: jax_block.fused_attention(
        q.reshape(b, l, d), k.reshape(b, l, d), v.reshape(b, l, d),
        h).reshape(b * l, d), (q, k, v), do, jnp.dtype(dtype))
    tdtype = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(tdtype).requires_grad_()
              for a in (q, k, v)]
    tdo = torch.from_numpy(do).to(tdtype)
    block_attention.fused_attention(*leaves, h, l).backward(tdo)
    port = [x.grad.float().numpy() for x in leaves]
    clip_consistent = _torch_bwd((q, k, v), do, h, l, False, False, tdtype)
    for name, g, c in zip(("dq", "dk", "dv"), port, clip_consistent):
        np.testing.assert_array_equal(g, c, err_msg=name)
    rtol = F32_RTOL if dtype == "float32" else block_attention.BWD_RTOL
    if q_scale == 1.0:
        for name, g, r in zip(("dq", "dk", "dv"), port, ref):
            _close(g, r, rtol, name)
    else:   # the clip-grad mask bites: dq and dk leave the exact gradient
        for g, r in zip(port[:2], ref[:2]):
            assert np.abs(g - r).max() > 0.1 * np.abs(r).max()


def test_clip_grad_mask_bites_past_the_clip():
    """At q x 40 most scores pass the clip: the plain backward zeroes their
    d(logit), boundary included, which autograd of the clamp does not."""
    q, k, v, do, _ = _inputs(2, 40, 4, 16, seed=40, q_scale=40.0)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    clipped = block_attention.attention_plain_bwd(*t, 4, 40)
    exact = block_attention.attention_plain_bwd(*t, 4, 40, exact=True)
    assert (clipped[0] - exact[0]).abs().max() > 1e-3
    # a score exactly at the clip: its gradient is 0 (JAX excludes it too)
    b, l, h, hd = 1, 2, 1, 8
    qq = torch.zeros(b * l, h * hd)
    kk = torch.zeros(b * l, h * hd)
    qq[0, 0] = 70.0 * hd ** 0.5
    kk[0, 0] = 1.0
    dd = torch.ones(b * l, h * hd)
    vv = torch.arange(b * l * h * hd, dtype=torch.float32).reshape(b * l, -1)
    dq, dk, _, *_ = block_attention.attention_plain_bwd(qq, kk, vv, dd, h, l)
    ref = _jax_vjp(lambda q, k, v: jax_block.fused_attention(
        q.reshape(b, l, -1), k.reshape(b, l, -1), v.reshape(b, l, -1),
        h).reshape(b * l, -1), (qq.numpy(), kk.numpy(), vv.numpy()),
        dd.numpy(), jnp.float32)
    np.testing.assert_allclose(dq.numpy(), ref[0], atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), ref[1], atol=1e-5)
    assert dq[0, 0] == 0.0


def test_plain_bwd_is_the_gradient_of_the_plain_forward():
    """Below the clip the Pallas-style backward is the true gradient of
    attention_plain (fp32, autograd through the forward as a check)."""
    q, k, v, do, biases = _inputs(3, 37, 4, 16, seed=9)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, *biases)]
    out = block_attention.attention_plain(*t[:3], 4, 37, t[3:])
    out.backward(torch.from_numpy(do))
    grads = block_attention.attention_plain_bwd(
        *(x.detach() for x in t[:3]), torch.from_numpy(do), 4, 37,
        tuple(x.detach() for x in t[3:]))
    for x, g, s in zip(t, grads, (None,) * 3 + tuple(
            np.abs(x.grad.numpy()).sum(0).max() for x in t[:3])):
        _close(g.numpy(), x.grad.numpy(), 1e-5, "autograd", scale=s)


def _stand_in_kernels(monkeypatch):
    """Makes CPU tensors take the kernel branch, with launches that do what
    the CUDA ones do: write the result into a fresh tensor that has no
    autograd history (the ctypes call)."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, num_heads, seq_len, biases, exact):
        calls["fwd"] += 1
        with torch.no_grad():
            return block_attention.attention_plain(q, k, v, num_heads,
                                                   seq_len, biases, exact)

    def bwd(q, k, v, do, num_heads, seq_len, biases, exact):
        calls["bwd"] += 1
        with torch.no_grad():
            return block_attention.attention_plain_bwd(
                q, k, v, do, num_heads, seq_len, biases, exact)

    monkeypatch.setattr(block_attention, "_uses_kernel", lambda x: True,
                        raising=False)
    monkeypatch.setattr(block_attention, "_launch", fwd)
    monkeypatch.setattr(block_attention, "_launch_bwd", bwd, raising=False)
    return calls


def test_gradients_reach_inputs_through_the_kernel_branch(monkeypatch):
    """The kernel writes its output through ctypes into a tensor of its own:
    without an autograd.Function around it, the output is detached and q, k,
    v and the biases get no gradient. With the kernel branch forced (and its
    launches standing in on the CPU), the gradients must reach every input
    and equal the plain backward's."""
    calls = _stand_in_kernels(monkeypatch)
    q, k, v, do, biases = _inputs(2, 50, 4, 16, seed=21)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v,
                                                              *biases)]
    fwd0 = block_attention.fused_attention.launches
    out = block_attention.fused_attention(*leaves[:3], 4, 50,
                                          tuple(leaves[3:]))
    assert calls["fwd"] == 1, "the kernel branch was not taken"
    assert out.requires_grad
    # .sum() hands the backward a stride-0 gradient: made contiguous there
    (out * torch.from_numpy(do)).sum().backward()
    assert calls["bwd"] == 1
    assert block_attention.fused_attention.launches == fwd0 + 1
    want = block_attention.attention_plain_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, do)), 4, 50,
        tuple(torch.from_numpy(b) for b in biases))
    for name, x, g in zip(("q", "k", "v", "bq", "bk", "bv"), leaves, want):
        assert x.grad is not None, f"no gradient reached {name}"
        torch.testing.assert_close(x.grad, g, rtol=0, atol=0)


def test_sum_backward_hands_a_contiguous_gradient(monkeypatch):
    calls = _stand_in_kernels(monkeypatch)
    seen = []

    def bwd(q, k, v, do, *rest):
        seen.append(do.is_contiguous())
        return block_attention.attention_plain_bwd(q, k, v, do, *rest)

    monkeypatch.setattr(block_attention, "_launch_bwd", bwd)
    x = torch.randn(2 * 40, 64, requires_grad=True)
    block_attention.fused_attention(x, x, x, 4, 40).sum().backward()
    assert seen == [True] and calls["fwd"] == 1 and x.grad is not None


@pytest.mark.parametrize("impl", ["auto", "plain", "fused_exact"])
def test_multi_head_attention_grads_go_through_the_function(impl):
    """The fused and plain impls differentiate through FusedAttentionFn with
    the Pallas-style backward, on flat and packed operands alike."""
    b, l, h, hd = 2, 37, 4, 16
    q, k, v, do, biases = _inputs(b, l, h, hd, seed=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v,
                                                              *biases)]
    out = attention.multi_head_attention(*leaves[:3], h, impl=impl,
                                         seq_len=l,
                                         qkv_biases=tuple(leaves[3:]))
    out.backward(torch.from_numpy(do))
    want = block_attention.attention_plain_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, do)), h, l,
        tuple(torch.from_numpy(x) for x in biases),
        exact=impl == "fused_exact")
    for x, g in zip(leaves, want):
        torch.testing.assert_close(x.grad, g, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_einsum_path_grads_match_xla_attention(causal):
    """The text tower's path (L < 33): autograd through the einsum + fp32
    softmax against jax.vjp of clipa_tpu's _xla_attention."""
    b, l, h, hd = 3, 8, 4, 16
    d = h * hd
    q, k, v, do, _ = _inputs(b, l, h, hd, seed=8)
    q, k, v, do = (a.reshape(b, l, d) for a in (q, k, v, do))
    mask = np.tril(np.ones((l, l), bool))[None, None] if causal else None

    def jax_fn(q, k, v):
        return jax_attention._xla_attention(
            q.reshape(b, l, h, hd), k.reshape(b, l, h, hd),
            v.reshape(b, l, h, hd),
            None if mask is None else jnp.asarray(mask)).reshape(b, l, d)

    ref = _jax_vjp(jax_fn, (q, k, v), do, jnp.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention.multi_head_attention(
        *leaves, h, mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    for name, x, r in zip("qkv", leaves, ref):
        _close(x.grad.numpy(), r, F32_RTOL, f"d{name}")


def test_bwd_wrapper_refusals_on_the_cpu():
    x = torch.zeros(2 * 40, 64)
    before = block_attention.fused_attention_bwd.launches
    with pytest.raises(ValueError, match="do has shape"):
        block_attention.fused_attention_bwd(x, x, x, x[:1], 4, 40)
    with pytest.raises(ValueError, match="seq_len"):
        block_attention.fused_attention_bwd(x, x, x, x, 4, 30)
    grads = block_attention.fused_attention_bwd(x, x, x, x, 4, 40)
    assert grads[3:] == (None, None, None)
    assert block_attention.fused_attention_bwd.launches == before
