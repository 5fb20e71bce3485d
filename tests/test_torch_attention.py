"""clipa_tpu_torch attention vs the JAX package's kernels and dispatch.

The port's plain version of the fused attention kernel is held against the
JAX Pallas kernels themselves (``block_attention.fused_attention`` and
``fused_attention_2d_b``, run in interpret mode on the CPU, as
tests/test_block_attention.py runs them) on the same numpy inputs, in fp32
under jax.default_matmul_precision("highest"). Tolerance 2e-5: the two
differ only in fp32 summation order and, in clip mode, in when the softmax
normalizes (deferred here).

The CUDA kernel itself is checked against the plain version by
tests/test_torch_cuda.py on a card (and by chip_smoke.py at the service's
shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu.ops import attention as jax_attention
from clipa_tpu.ops import block_attention as jax_block
from clipa_tpu_torch.ops import attention, block_attention

ATOL = 2e-5


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
    q, k, v = (rng.randn(b * l, d).astype(np.float32) for _ in range(3))
    biases = tuple(rng.randn(d).astype(np.float32) for _ in range(3))
    return q * q_scale, k, v, biases


def _jax(fn, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("b,l,h,hd,bias,exact,q_scale", [
    (2, 50, 4, 16, True, False, 1.0),     # 112px length, biased (K5)
    (8, 50, 4, 16, True, False, 1.0),     # ... with a G=4 Pallas plan
    (4, 37, 2, 16, False, False, 1.0),    # odd length, no bias (K1)
    (2, 257, 2, 40, False, False, 1.0),   # 224px length, hd % 16 != 0
    (2, 40, 4, 16, False, False, 40.0),   # clip mode past the clip (K1)
    (2, 40, 4, 16, True, False, 40.0),    # ... bias-fused (K5)
    (2, 40, 4, 16, False, True, 40.0),    # exact mode at logits >> 70
    (2, 40, 4, 16, True, True, 40.0),     # exact mode, bias-fused
])
def test_plain_matches_pallas_kernels(b, l, h, hd, bias, exact, q_scale):
    q, k, v, biases = _inputs(b, l, h, hd, seed=l + hd, q_scale=q_scale)
    d = h * hd
    if bias:
        ref = _jax(lambda q, k, v, bq, bk, bv: jax_block.fused_attention_2d_b(
            q, k, v, bq, bk, bv, h, l, exact), q, k, v, *biases)
    else:
        ref = _jax(lambda q, k, v: jax_block.fused_attention(
            q.reshape(b, l, d), k.reshape(b, l, d), v.reshape(b, l, d), h,
            exact).reshape(b * l, d), q, k, v)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = tuple(torch.from_numpy(a) for a in biases) if bias else None
    out = block_attention.attention_plain(*t, h, l, tb, exact).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)


def test_plain_matches_fused2d_unbiased_kernel():
    b, l, h, hd = 8, 37, 2, 16   # G=8: the 2D Pallas kernel runs (K3)
    q, k, v, _ = _inputs(b, l, h, hd, seed=3)
    ref = _jax(lambda q, k, v: jax_block.fused_attention_2d(q, k, v, h, l),
               q, k, v)
    out = block_attention.attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), h, l).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)


def test_clip_mode_deviates_where_logits_pass_the_clip():
    """The clipped softmax really differs from the exact one at huge
    logits, so the exact-mode case above is not vacuous."""
    q, k, v, _ = _inputs(2, 40, 4, 16, seed=7, q_scale=40.0)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    clipped = block_attention.attention_plain(*t, 4, 40, exact=False)
    exact = block_attention.attention_plain(*t, 4, 40, exact=True)
    assert (clipped - exact).abs().max() > 1e-3


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    q, k, v, biases = _inputs(2, 37, 4, 16, seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tb = tuple(torch.from_numpy(a) for a in biases)
    before = block_attention.fused_attention.launches
    out = block_attention.fused_attention(*t, 4, 37, tb)
    assert block_attention.fused_attention.launches == before
    torch.testing.assert_close(
        out, block_attention.attention_plain(*t, 4, 37, tb), rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["3d", "2d"])
@pytest.mark.parametrize("l", [37, 12])   # fused (plain) branch / einsum
def test_multi_head_attention_matches_jax(layout, l):
    b, h, hd = 2, 4, 16
    d = h * hd
    q, k, v, biases = _inputs(b, l, h, hd, seed=l)
    if layout == "3d":
        q, k, v = (a.reshape(b, l, d) for a in (q, k, v))
    ref = _jax(lambda q, k, v, bq, bk, bv: jax_attention.multi_head_attention(
        q, k, v, h, seq_len=l if layout == "2d" else None,
        qkv_biases=(bq, bk, bv)), q, k, v, *biases)
    out = attention.multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), h,
        seq_len=l if layout == "2d" else None,
        qkv_biases=tuple(torch.from_numpy(a) for a in biases))
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=ATOL)


def test_masked_attention_takes_the_einsum_path():
    b, l, h, hd = 2, 40, 4, 16
    d = h * hd
    q, k, v, _ = _inputs(b, l, h, hd, seed=11)
    q, k, v = (a.reshape(b, l, d) for a in (q, k, v))
    mask = np.tril(np.ones((l, l), bool))[None, None]
    ref = _jax(lambda q, k, v, m: jax_attention.multi_head_attention(
        q, k, v, h, mask=m), q, k, v, mask)
    out = attention.multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), h,
        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=ATOL)


def test_fused_exact_impl_matches_jax_exact_kernel():
    b, l, h, hd = 2, 40, 4, 16
    d = h * hd
    q, k, v, _ = _inputs(b, l, h, hd, seed=5, q_scale=40.0)
    q, k, v = (a.reshape(b, l, d) for a in (q, k, v))
    ref = _jax(lambda q, k, v: jax_block.fused_attention(q, k, v, h, True),
               q, k, v)
    out = attention.multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), h, impl="fused_exact")
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=ATOL)


def test_dispatch_refusals():
    x = torch.zeros(2, 40, 64)
    mask = torch.ones(1, 1, 40, 40, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="unmasked"):
        attention.multi_head_attention(x, x, x, 4, mask=mask, impl="pallas")
    with pytest.raises(ValueError, match="mask"):
        attention.multi_head_attention(x, x, x, 4, mask=mask, impl="fused")
    with pytest.raises(ValueError, match="head_dim 12"):
        # not a multiple of 8: the kernel would refuse it, so the CPU
        # wrapper refuses it too
        y = torch.zeros(2, 40, 48)
        attention.multi_head_attention(y, y, y, 4, impl="fused")
    with pytest.raises(ValueError, match="k has shape"):
        attention.multi_head_attention(x, x[:, :37], x[:, :37], 4,
                                       impl="fused")
    with pytest.raises(ValueError, match="seq_len"):
        attention.multi_head_attention(x[0], x[0], x[0], 4)
    assert not block_attention.eligible(48, 4, None)
    assert block_attention.eligible(1280, 16, None)     # H/14: hd 80
    assert not block_attention.eligible(16 * 136, 16, None)  # hd > 128
