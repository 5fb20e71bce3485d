"""clipa_tpu_torch on a CUDA device: the kernels against their plain versions.

These tests need a card (a CUDA kernel has no CPU mode) and skip without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The tolerances are the kernels' stated ones (``block_attention.KERNEL_ATOL``
and ``KERNEL_RTOL``, and ``flash_attention.tolerance``, for the forwards:
about one bf16 ulp for bf16 operands, 2e-5 for the flash kernels' fp32
ones, and ``flash_attention.LSE_ATOL`` on the flash forward's LSE;
``bwd_errors`` of either module for the backwards: 1e-2 resp. 2e-5 of each
gradient's scale), the reference the plain versions in fp32 from the same
operands with TF32 off. The fused kernels take bf16 only and refuse fp32
operands; ``auto`` sends fp32 attention on the card to the flash kernels,
held there to the flash fp32 tolerances against the fused path's plain
versions. The deferred backward is held to the backward's tolerance
against its plain twin and against the normalized kernel; the patch embed
to ``patch_embed.errors`` (1e-4 of the output's scale for fp32 outputs,
one bf16 ulp for bf16 ones), which its two bf16 tensor-core products (the
weights' hi and lo parts) meet.
"""

import json
import math

import numpy as np
import pytest
import torch

from clipa_tpu_torch.ops import attention, block_attention, flash_attention
from clipa_tpu_torch.serving import EmbeddingService


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# The shapes chip_smoke.py checks: H/14 @224 (the K1 path), L/16 @112 (K5),
# the unbiased flat kernel (K3), both softmax modes past the clip (q scaled
# by 40: logits >> 70); plus head dims 40 (zero-padded to 48) and 128, and
# H/14 @336 (L = 577). Then the forward's strip, chunk and ring boundaries
# (L = 33 ... 577 at hd 64: 16-row strips, 16-key chunks, 128-key tiles, a
# ring that holds every key up to 272 rows, the two-stage ring at 577), in
# clip mode with bias and exact mode without; and head dims 8 ... 128 at
# L = 257 (three key tiles, the last one ragged; hd 8, 40 and 88 are padded
# to the next multiple of 16), in both modes, with and without bias (bf16:
# the kernels take no other dtype).
CASES = [
    (8, 257, 1280, 16, True, False, 1.0),
    (8, 50, 1024, 16, True, False, 1.0),
    (4, 37, 256, 4, False, False, 1.0),
    (2, 40, 256, 4, False, False, 40.0),
    (8, 257, 1280, 16, True, False, 40.0),
    (2, 40, 256, 4, False, True, 40.0),
    (2, 40, 256, 4, True, True, 40.0),
    (2, 257, 80, 2, True, True, 1.0),
    (3, 65, 1024, 8, False, False, 1.0),
    (1, 577, 1280, 16, True, False, 1.0),
    # the HF-text / timm towers' shapes: D = 512 with 8 heads (the
    # vit_medium tower at L = 257, and L = 256), D = 768 with 12 heads (the
    # LiT BERT text tower at L = 64, the B/32 image tower at L = 50)
    (8, 256, 512, 8, True, False, 1.0),
    (8, 257, 512, 8, True, False, 1.0),
    (8, 64, 768, 12, True, False, 1.0),
    (8, 50, 768, 12, True, False, 1.0),
    *((2, n, 256, 4, bias, not bias, 1.0)
      for n in (33, 48, 49, 63, 64, 65, 129, 255, 256, 257, 272, 273, 577)
      for bias in (True, False)),
    *((2, 257, 2 * hd, 2, bias, exact, 1.0)
      for hd in (8, 40, 64, 80, 88, 104, 112, 128)
      for bias in (True, False) for exact in (False, True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,h,bias,exact,q_scale", CASES)
def test_kernel_matches_plain(cuda, b, l, d, h, bias, exact, q_scale):
    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(0)

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device=cuda, generator=gen)
                * scale).to(dtype)

    q, k, v = mk(b * l, d, scale=q_scale), mk(b * l, d), mk(b * l, d)
    biases = (mk(d), mk(d), mk(d)) if bias else None
    before = block_attention.fused_attention.launches
    out = block_attention.fused_attention(q, k, v, h, l, biases, exact)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    ref = block_attention.attention_plain(q, k, v, h, l, biases, exact)
    assert block_attention.fused_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=block_attention.KERNEL_ATOL,
                               rtol=block_attention.KERNEL_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
def test_kernel_is_bit_identical_over_two_calls(cuda, exact):
    """No atomics: every sum of the forward runs in a fixed order, so two
    calls on the same inputs give the same output bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, l, d, h = 8, 257, 1280, 16
    q, k, v = (torch.randn(b * l, d, device=cuda, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    biases = tuple(torch.randn(d, device=cuda, generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
    first = block_attention.fused_attention(q, k, v, h, l, biases, exact)
    second = block_attention.fused_attention(q, k, v, h, l, biases, exact)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,h", [(8, 257, 1280, 16), (16, 50, 1024, 16),
                                     (8, 138, 1024, 16), (2, 577, 1280, 16)])
def test_kernel_other_plans_match_plain(cuda, b, l, d, h):
    """Every split and ring that fwd_plan weighs computes the same function
    (tools/flash_bench.py --plans times them), in both modes; a plan whose
    shared-memory size is not the kernel's own layout's, or whose ring is
    one stage short of every key, is refused."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(b * l, d, device=cuda, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    biases = tuple(torch.randn(d, device=cuda, generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
    atol, rtol = block_attention.KERNEL_ATOL, block_attention.KERNEL_RTOL
    hd = d // h
    for exact in (False, True):
        ref = block_attention.attention_plain(q, k, v, h, l, biases, exact)
        for plan in block_attention.fwd_candidates(l, hd):
            out = block_attention._launch(q, k, v, h, l, biases, exact,
                                          plan=plan)
            torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                       rtol=rtol, msg=lambda m: f"{plan}: {m}")
    plan = block_attention.fwd_plan(l, hd)
    for bad in (plan._replace(smem=plan.smem + 16),
                plan._replace(stages=1) if l > 128 else
                plan._replace(warps=plan.warps - 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            block_attention._launch(q, k, v, h, l, biases, False, plan=bad)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2 * 40, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        block_attention.fused_attention(x.half(), x.half(), x.half(), 4, 40)
    with pytest.raises(TypeError, match="all bfloat16"):
        block_attention.fused_attention(x.float(), x, x, 4, 40)
    with pytest.raises(TypeError, match="all bfloat16"):
        block_attention.fused_attention(x, x, x.float(), 4, 40)
    with pytest.raises(ValueError, match="head_dim"):
        block_attention.fused_attention(x[:, :60], x[:, :60], x[:, :60],
                                        5, 40)
    with pytest.raises(ValueError, match="seq_len"):
        block_attention.fused_attention(x, x, x, 4, 30)
    transposed = torch.zeros(64, 2 * 40, device=cuda,
                             dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match="contiguous"):
        block_attention.fused_attention(transposed, x, x, 4, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_service_goes_through_the_kernel(cuda, tmp_path, precision):
    cfg = {
        "embed_dim": 32,
        "vision_cfg": {"image_size": 48, "layers": 2, "width": 64,
                       "head_width": 16, "patch_size": 8,
                       "gelu_approximate": "tanh", "ln_pre": False,
                       "pool_style": "big_vision_gap"},
        "text_cfg": {"context_length": 8, "vocab_size": 30522, "width": 64,
                     "heads": 4, "layers": 2, "bert_tokenizer": True,
                     "pool_style": "big_vision_last",
                     "attention_mask": False},
    }
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    svc = EmbeddingService(str(path), device=cuda, buckets=(4, 8),
                           num_workers=0, precision=precision)
    plain = EmbeddingService(str(path), device=cuda, buckets=(4, 8),
                             num_workers=0, precision=precision,
                             attn_impl="plain")
    imgs = np.random.RandomState(6).randint(0, 256, (11, 48, 48, 3),
                                            np.uint8)
    block_attention.fused_attention.launches = 0
    flash_attention.flash_attention.launches = 0
    z = svc.embed_images(imgs)                  # chunks of 8 and 4
    # 2 layers x 2 chunks; fp32 on the card takes the flash kernels
    fused, flash = (4, 0) if precision == "bfloat16" else (0, 4)
    assert block_attention.fused_attention.launches == fused
    assert flash_attention.flash_attention.launches == flash
    zp = plain.embed_images(imgs)
    assert block_attention.fused_attention.launches == fused
    assert flash_attention.flash_attention.launches == flash
    assert np.isfinite(z).all() and z.shape == (11, 32)
    if precision == "float32":   # the CPU parity tolerance on unit rows
        np.testing.assert_allclose(z, zp, atol=1e-4, rtol=0)
    else:
        assert ((z * zp).sum(1)).min() >= 0.999


# The backward at the shapes chip_smoke.py checks: the pretrain shape (K6),
# H/14 @224 (several q-tiles, hd 80: K2's function), L = 577 unbiased
# (K4/K2), clip mode past the clip with and without bias, exact mode; plus
# small ragged ones (L = 37 and 65 across tile edges, hd 40 zero-padded).
# Then H/14 @84 (L = 37, hd 80) and the fine-tune `auto` route (L = 138);
# both softmax modes with and without bias, at and past the clip; the H/14
# fine-tune shapes (L = 180 at 224 px, mask 0.3; L = 346 at 336 px, mask
# 0.4; the long scheme), clip mode with bias and the exact form without;
# and the 16-row chunk, 64-row tile, 128-row ring-tile and scheme
# boundaries at hd 8, 72, 80 and 128 (whole-head up to L = 16
# BWD_MAX_CHUNKS, the long scheme past it), clip mode with bias and exact
# mode without, in turns.
BWD_BOUNDARIES = (15, 16, 17, 33, 37, 48, 49, 50, 63, 64, 65, 138, 257, 577,
                  145, 160, 161, 176, 180, 192, 193, 346, 352, 353)
BWD_CASES = [
    (384, 50, 1024, 16, True, False, 1.0),
    (8, 257, 1280, 16, True, False, 1.0),
    (2, 577, 1024, 16, False, False, 1.0),
    (8, 50, 1024, 16, True, False, 40.0),
    (2, 40, 256, 4, False, False, 40.0),
    (2, 40, 256, 4, True, True, 40.0),
    (3, 37, 80, 2, True, False, 1.0),
    (2, 65, 256, 8, False, True, 1.0),
    (1, 129, 512, 4, True, False, 1.0),
    (16, 37, 1280, 16, True, False, 1.0),
    (8, 138, 1024, 16, True, False, 1.0),
    (4, 50, 256, 4, True, True, 1.0),
    (4, 50, 256, 4, False, False, 1.0),
    (4, 50, 256, 4, False, True, 40.0),
    (4, 37, 320, 4, True, False, 40.0),
    (64, 180, 1280, 16, True, False, 1.0),
    (16, 346, 1280, 16, True, False, 1.0),
    (64, 180, 1280, 16, False, True, 1.0),
    (16, 346, 1280, 16, False, True, 1.0),
    # the HF-text / timm towers' shapes (the long scheme at L = 256, 257;
    # the whole-head scheme at L = 64, 50)
    (8, 256, 512, 8, True, False, 1.0),
    (8, 257, 512, 8, True, False, 1.0),
    (8, 64, 768, 12, True, False, 1.0),
    (8, 50, 768, 12, True, False, 1.0),
    *((2, n, 2 * hd, 2, i % 2 == 0, i % 2 == 1, 1.0)
      for hd in (8, 72, 80, 128) for i, n in enumerate(BWD_BOUNDARIES)),
]


def _bwd_operands(cuda, dtype, b, l, d, bias, q_scale, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device=cuda, generator=gen)
                * scale).to(dtype)

    q, k, v, do = mk(b * l, d, scale=q_scale), mk(b * l, d), mk(b * l, d), \
        mk(b * l, d)
    biases = (mk(d), mk(d), mk(d)) if bias else None
    return q, k, v, do, biases


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,h,bias,exact,q_scale", BWD_CASES)
def test_bwd_kernel_matches_plain(cuda, b, l, d, h, bias, exact, q_scale):
    q, k, v, do, biases = _bwd_operands(cuda, torch.bfloat16, b, l, d, bias,
                                        q_scale)
    before = block_attention.fused_attention_bwd.launches
    grads = block_attention.fused_attention_bwd(q, k, v, do, h, l, biases,
                                                exact)
    torch.cuda.synchronize()
    ref = block_attention.attention_plain_bwd(q, k, v, do, h, l, biases,
                                              exact)
    for g, r in zip(grads, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and g.shape == r.shape
    assert block_attention.fused_attention_bwd.launches == before + 1
    errors = block_attention.bwd_errors(grads, ref)
    assert len(errors) == (6 if bias else 3)
    assert all(ok for _, ok in errors), errors


@pytest.mark.cuda
def test_bwd_wrapper_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2 * 40, 64, device=cuda, dtype=torch.bfloat16)
    bwd = block_attention.fused_attention_bwd
    with pytest.raises(TypeError, match="bfloat16"):
        bwd(x, x, x, x.half(), 4, 40)
    with pytest.raises(TypeError, match="all bfloat16"):
        bwd(x.float(), x.float(), x.float(), x, 4, 40)
    with pytest.raises(TypeError, match="all bfloat16"):
        bwd(x.float(), x.float(), x.float(), x.float(), 4, 40)
    with pytest.raises(ValueError, match="do has shape"):
        bwd(x, x, x, x[:40], 4, 40)
    with pytest.raises(ValueError, match="head_dim"):
        bwd(x[:, :60], x[:, :60], x[:, :60], x[:, :60], 5, 40)
    transposed = torch.zeros(64, 2 * 40, device=cuda,
                             dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match="contiguous"):
        bwd(x, x, x, transposed, 4, 40)
    with pytest.raises(ValueError, match="on cpu"):
        bwd(x, x, x, x, 4, 40, (x[0].cpu(), x[0], x[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,h", [(16, 50, 1024, 16), (16, 37, 1280, 16),
                                     (4, 138, 1024, 16), (4, 17, 256, 2),
                                     (4, 180, 1280, 16), (2, 346, 1280, 16),
                                     (1, 577, 2048, 16)])
def test_bwd_every_plan_matches_plain_and_repeats(cuda, b, l, d, h):
    """Every scheme that bwd_candidates offers (whole-head, each long plan:
    every block split and ring) computes the same function in both modes,
    and each gives bit-identical outputs over two calls (no atomics); the
    deferred entry takes the whole-head plan too (its deferred form: the
    deferred function, twice bit for bit); a plan whose sizes are not the
    kernel's own layout's, whose warps do not fit its strips, whose scheme
    is unknown (0 or 3), or that asks the deferred entry for the long
    scheme is refused."""
    q, k, v, do, biases = _bwd_operands(cuda, torch.bfloat16, b, l, d, True,
                                        1.0, seed=13)
    hd = d // h
    for exact in (False, True):
        ref = block_attention.attention_plain_bwd(q, k, v, do, h, l, biases,
                                                  exact)
        for plan in block_attention.bwd_candidates(l, hd):
            first = block_attention._launch_bwd(q, k, v, do, h, l, biases,
                                                exact, plan=plan)
            second = block_attention._launch_bwd(q, k, v, do, h, l, biases,
                                                 exact, plan=plan)
            torch.cuda.synchronize()
            errors = block_attention.bwd_errors(first, ref)
            assert all(ok for _, ok in errors), (plan, errors)
            assert all(torch.equal(x, y) for x, y in zip(first, second)), plan
    for plan in block_attention.bwd_candidates(l, hd):
        bad = [plan._replace(smem=plan.smem + 16),
               plan._replace(warps=plan.warps + 1),
               plan._replace(scheme=0), plan._replace(scheme=3)]
        if plan.scheme == block_attention.BWD_LONG:
            bad += [plan._replace(smem_dkv=plan.smem_dkv + 16),
                    plan._replace(stages=block_attention.BWD_MAX_STAGES + 1)]
        for p in bad:
            with pytest.raises(RuntimeError, match="launch failed"):
                block_attention._launch_bwd(q, k, v, do, h, l, biases, False,
                                            plan=p)
        if plan.scheme == block_attention.BWD_WHOLE:
            ref = block_attention.attention_plain_bwd(q, k, v, do, h, l,
                                                      biases, defer=True)
            first, second = (block_attention._launch_bwd(
                q, k, v, do, h, l, biases, False, plan=plan,
                entry=block_attention._BWD_DEFERRED_ENTRY) for _ in "ab")
            torch.cuda.synchronize()
            errors = block_attention.bwd_errors(first, ref)
            assert all(ok for _, ok in errors), (plan, errors)
            assert all(torch.equal(x, y) for x, y in zip(first, second))
            continue
        with pytest.raises(RuntimeError, match="launch failed"):
            block_attention._launch_bwd(
                q, k, v, do, h, l, biases, False, plan=plan,
                entry=block_attention._BWD_DEFERRED_ENTRY)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,h", [(64, 50, 1024, 16), (64, 37, 1280, 16),
                                     (8, 138, 1024, 16), (8, 180, 1280, 16),
                                     (2, 346, 1280, 16)])
def test_bwd_bias_add_is_one_rounding(cuda, b, l, d, h):
    """The kernel adds the q/k/v biases in shared memory with bf16x2 adds;
    the function rounds the fp32 sum once. The two agree bit for bit: with
    the biases the kernel's dq, dk and dv equal, bit for bit, its outputs
    for the operands biased beforehand by PyTorch (fp32 add, one rounding)
    and no biases, under every plan."""
    q, k, v, do, (bq, bk, bv) = _bwd_operands(cuda, torch.bfloat16, b, l, d,
                                              True, 1.0, seed=17)
    for plan in block_attention.bwd_candidates(l, d // h):
        for exact in (False, True):
            biased = block_attention._launch_bwd(q, k, v, do, h, l,
                                                 (bq, bk, bv), exact,
                                                 plan=plan)
            added = block_attention._launch_bwd(q + bq, k + bk, v + bv, do,
                                                h, l, None, exact, plan=plan)
            torch.cuda.synchronize()
            for x, y in zip(biased[:3], added[:3]):
                assert torch.equal(x, y), (plan, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
def test_gradients_through_the_kernels_equal_the_plain_path(cuda, bias):
    """FusedAttentionFn on the card: the kernel path's gradients reach q, k,
    v and the biases and match the plain path's (the same autograd.Function
    with plain=True)."""
    b, l, d, h = 16, 50, 256, 4
    ops = _bwd_operands(cuda, torch.bfloat16, b, l, d, bias, 1.0, seed=3)
    do = ops[3]
    leaves = [x for x in (*ops[:3], *(ops[4] or ()))]

    def grads(plain):
        xs = [x.detach().clone().requires_grad_() for x in leaves]
        out = block_attention.fused_attention(
            *xs[:3], h, l, tuple(xs[3:]) if bias else None, plain=plain)
        (out.float() * do.float()).sum().backward()
        return [x.grad for x in xs]

    fwd0 = block_attention.fused_attention.launches
    bwd0 = block_attention.fused_attention_bwd.launches
    kernel = grads(False)
    assert block_attention.fused_attention.launches == fwd0 + 1
    assert block_attention.fused_attention_bwd.launches == bwd0 + 1
    plain = grads(True)
    assert block_attention.fused_attention_bwd.launches == bwd0 + 1
    assert all(g is not None for g in kernel)
    padded = plain[:3] + (plain[3:] if bias else [None] * 3)
    errors = block_attention.bwd_errors(kernel + [None] * (6 - len(kernel)),
                                        padded)
    assert all(ok for _, ok in errors), errors


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
def test_fp32_attention_on_the_card_takes_the_flash_kernels(cuda, bias):
    """The fused kernels take bf16 only: on fp32 CUDA operands the three
    fused entries raise TypeError and launch nothing. `auto` sends such
    attention (H/14 @224) to the flash kernels' fp32 twins, one launch each
    way, whose output and gradients, bias grads included, agree with the
    fused path's plain versions within the flash fp32 tolerances."""
    b, l, d, h = 8, 257, 1280, 16
    q, k, v, do, biases = _bwd_operands(cuda, torch.float32, b, l, d, bias,
                                        1.0, seed=7)
    fused = (block_attention.fused_attention,
             block_attention.fused_attention_bwd,
             block_attention.fused_attention_bwd_deferred)
    before = [f.launches for f in fused]
    with pytest.raises(TypeError, match="all bfloat16"):
        block_attention.fused_attention(q, k, v, h, l, biases)
    for bwd in fused[1:]:
        with pytest.raises(TypeError, match="all bfloat16"):
            bwd(q, k, v, do, h, l, biases)

    def run(impl):
        xs = [x.detach().clone().requires_grad_()
              for x in (q, k, v, *(biases or ()))]
        out = attention.multi_head_attention(
            *xs[:3], h, impl=impl, seq_len=l,
            qkv_biases=tuple(xs[3:]) if bias else None)
        (out * do).sum().backward()
        return out.detach(), [x.grad for x in xs]

    flash0 = (flash_attention.flash_attention.launches,
              flash_attention.flash_attention_bwd.launches)
    out, grads = run("auto")
    assert (flash_attention.flash_attention.launches,
            flash_attention.flash_attention_bwd.launches) == (
                flash0[0] + 1, flash0[1] + 1)
    assert [f.launches for f in fused] == before
    ref, ref_grads = run("plain")
    atol, rtol = flash_attention.tolerance(torch.float32)
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    errors = flash_attention.bwd_errors(grads[:3], ref_grads[:3],
                                        torch.float32)
    assert all(ok for _, ok in errors), errors
    for g, r, x in zip(grads[3:], ref_grads[3:], ref_grads[:3]):
        # a bias grad is a column sum: scaled by the column sums of |dx|
        scale = x.abs().sum(dim=0)
        assert ((g - r).abs() <= flash_attention.BWD_F32_RTOL
                * (r.abs() + scale)).all()


@pytest.mark.cuda
def test_tiny_training_step_on_the_card(cuda):
    """A Ti/16 two-tower model of depth 2 at 96 px (L = 37: the kernels'
    path) trains on the card: every step launches each kernel once per image
    layer and none for the 8-token text tower, the measurements are finite,
    and 10 steps on one batch lower the loss."""
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.train import step

    config = clipa_pretrain.get_config(
        "img=Ti/16,res=96,token_len=8,batchsize=16")
    config.model.image.update(depth=2)
    config.model.text.update(depth=2)
    config.schedule = [(".*", dict(decay_type="const"))]
    config.lr = 1e-4
    model = step.create_model(config, device=cuda)
    state = step.init_train_state(
        model, config, torch.Generator(device=cuda).manual_seed(0), cuda)
    tx, _ = optim.make(config, model, sched_kw=dict(total_steps=10))
    update = step.make_update_fn(model, tx, config, total_steps=10)
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.randint(
        0, 255, (16, 96, 96, 3), dtype=np.uint8)).to(cuda),
        "labels": torch.from_numpy(rng.randint(
            0, 32000, (16, 8)).astype(np.int32)).to(cuda)}
    losses = []
    for _ in range(10):
        block_attention.fused_attention.launches = 0
        block_attention.fused_attention_bwd.launches = 0
        state, meas = update(state, batch)
        torch.cuda.synchronize()
        assert block_attention.fused_attention.launches == 2
        assert block_attention.fused_attention_bwd.launches == 2
        assert all(bool(torch.isfinite(v)) for v in meas.values())
        losses.append(float(meas["training_loss"]))
    assert losses[-1] < 0.9 * losses[0], losses


# The flash kernels (K7/K8) at the shapes chip_smoke.py checks: the
# unmask-tuning shape (L/16 @224, mask 0.3: L = 138, hd 64), H/14 @224 and
# @336 masked (hd 80), G/14 at 448 px (L = 1025, hd 104: the auto route),
# cross-attention, logits far past 70 (q x 40: exact, no clip); plus hd 112
# (e/14), hd 128, hd 16 and a single query row (a pooling probe); the tile
# boundaries of the 16-row strips, the 16-key chunks and the 128-key tiles
# (L = 15 ... 257: the fused backward up to its shared-memory limit, the
# split one past it), head dims that are multiples of 8 but not of 16 (the
# zero-filled half chunk), and cross-attention with more queries than keys.
# (b, lq, lk, h, hd, q_scale)
FLASH_CASES = [
    (16, 138, 138, 16, 64, 1.0),
    (8, 180, 180, 16, 80, 1.0),
    (4, 346, 346, 16, 80, 1.0),
    (2, 1025, 1025, 16, 104, 1.0),
    (8, 77, 257, 16, 64, 1.0),
    (8, 138, 138, 16, 64, 40.0),
    (2, 50, 50, 16, 112, 1.0),
    (2, 129, 129, 8, 128, 1.0),
    (3, 1, 37, 2, 16, 1.0),
    *((2, n, n, 4, 64, 1.0)
      for n in (15, 16, 17, 63, 64, 65, 127, 128, 129, 143, 144, 145, 257)),
    (2, 138, 138, 4, 8, 1.0),
    (2, 138, 138, 4, 24, 1.0),
    (2, 180, 180, 4, 72, 1.0),
    (2, 138, 138, 4, 120, 1.0),
    (4, 300, 45, 4, 64, 1.0),
]


def _flash_operands(cuda, dtype, b, lq, lk, h, hd, q_scale, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def mk(l, scale=1.0):
        return (torch.randn(b, l, h, hd, device=cuda, generator=gen)
                * scale).to(dtype)

    return mk(lq, q_scale), mk(lk), mk(lk), mk(lq)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,lq,lk,h,hd,q_scale", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, b, lq, lk, h, hd, q_scale, dtype):
    if dtype == torch.float32:
        b = 1   # the scalar fp32 twins are slow; the same tiles
    q, k, v, do = _flash_operands(cuda, dtype, b, lq, lk, h, hd, q_scale)
    fwd0 = flash_attention.flash_attention.launches
    bwd0 = flash_attention.flash_attention_bwd.launches
    out, lse = flash_attention._launch(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention.flash_plain_fwd(q, k, v)
    atol, rtol = flash_attention.tolerance(dtype)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=flash_attention.LSE_ATOL,
                               rtol=0)
    # the backward from the same residuals
    grads = flash_attention.flash_attention_bwd(q, k, v, ref, ref_lse, do)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bwd.launches == bwd0 + 1
    assert flash_attention.flash_attention.launches == fwd0
    want = flash_attention.flash_plain_bwd(q, k, v, ref, ref_lse, do)
    for g, r in zip(grads, want):
        assert g.dtype == r.dtype and g.shape == r.shape
    errors = flash_attention.bwd_errors(grads, want, dtype)
    assert all(ok for _, ok in errors), errors


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,hd", [
    (16, 138, 138, 16, 64),     # the fused backward
    (2, 346, 346, 16, 80),      # the split backward (dq, then dk/dv)
])
def test_flash_bwd_is_bit_identical_over_two_calls(cuda, b, lq, lk, h, hd):
    """No atomics: every sum of the backward runs in a fixed order, so two
    calls on the same inputs give the same dq, dk and dv bit for bit."""
    q, k, v, do = _flash_operands(cuda, torch.bfloat16, b, lq, lk, h, hd,
                                  1.0, seed=7)
    out, lse = flash_attention._launch(q, k, v)
    first = flash_attention.flash_attention_bwd(q, k, v, out, lse, do)
    second = flash_attention.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,hd", [(16, 138, 16, 64), (8, 180, 16, 80)])
def test_flash_other_plans_match_plain(cuda, b, l, h, hd):
    """Every forward split that launch_plan weighs, and the split backward
    where it fuses, compute the same function (tools/flash_bench.py --plans
    times them); a plan whose shared-memory size is not the kernel's own
    layout's is refused."""
    q, k, v, do = _flash_operands(cuda, torch.bfloat16, b, l, l, h, hd, 1.0)
    ref, ref_lse = flash_attention.flash_plain_fwd(q, k, v)
    atol, rtol = flash_attention.tolerance(torch.bfloat16)
    for plan in flash_attention.fwd_candidates(l, l, hd):
        out, lse = flash_attention._launch(q, k, v, plan=plan)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, ref_lse,
                                   atol=flash_attention.LSE_ATOL, rtol=0)
    assert len(flash_attention.launch_plan(l, l, hd).bwd) == 1
    split = flash_attention.bwd_split_plan(l, l, hd)
    grads = flash_attention._launch_bwd(q, k, v, ref, ref_lse, do,
                                        plan=split)
    want = flash_attention.flash_plain_bwd(q, k, v, ref, ref_lse, do)
    errors = flash_attention.bwd_errors(grads, want, torch.bfloat16)
    assert all(ok for _, ok in errors), errors
    fwd = flash_attention.launch_plan(l, l, hd).fwd
    with pytest.raises(RuntimeError, match="launch failed"):
        flash_attention._launch(q, k, v,
                                plan=fwd._replace(smem=fwd.smem + 16))
    (fused,) = flash_attention.launch_plan(l, l, hd).bwd
    with pytest.raises(RuntimeError, match="launch failed"):
        flash_attention._launch_bwd(q, k, v, ref, ref_lse, do, plan=(
            fused._replace(smem=fused.smem - 16),))


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2, 40, 4, 64, device=cuda, dtype=torch.bfloat16)
    fa = flash_attention.flash_attention
    with pytest.raises(TypeError, match="bfloat16"):
        fa(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="float32"):
        fa(x.float(), x, x)
    with pytest.raises(ValueError, match="head_dim"):
        fa(x[..., :60], x[..., :60], x[..., :60])
    wide = torch.zeros(2, 40, 1, 136, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 128"):
        fa(wide, wide, wide)
    with pytest.raises(ValueError, match="contiguous"):
        fa(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(NotImplementedError, match="unmasked"):
        fa(x, x, x, mask=torch.ones(2, 1, 40, 40, dtype=torch.bool,
                                    device=cuda))


@pytest.mark.cuda
def test_flash_kernels_refuse_head_dims_past_128(cuda):
    """hd 136: the plain versions take it on the card too (plain=True), as
    on the CPU; a CUDA tensor that would reach a kernel raises with the
    kernel's limit in the message, and nothing is launched."""
    q, k, v, do = _flash_operands(cuda, torch.bfloat16, 2, 40, 40, 2, 136,
                                  1.0)
    fwd0 = flash_attention.flash_attention.launches
    bwd0 = flash_attention.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="at most 128"):
        flash_attention.flash_attention(q, k, v)
    out, lse = flash_attention.flash_plain_fwd(q, k, v)
    with pytest.raises(ValueError, match="at most 128"):
        flash_attention.flash_attention_bwd(q, k, v, out, lse, do)
    plain = flash_attention.flash_attention(q, k, v, plain=True)
    assert torch.equal(plain, out)
    assert flash_attention.flash_attention.launches == fwd0
    assert flash_attention.flash_attention_bwd.launches == bwd0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_gradients_through_the_flash_kernels_equal_the_plain_path(cuda,
                                                                  dtype):
    """FlashAttentionFn on the card: the kernel path's gradients reach q, k
    and v and match the plain path's (the same Function, plain=True)."""
    q, k, v, do = _flash_operands(cuda, dtype, 4, 138, 138, 4, 64, 1.0,
                                  seed=3)

    def grads(plain):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention.flash_attention(*xs, plain=plain)
        (out.float() * do.float()).sum().backward()
        return [x.grad for x in xs]

    fwd0 = flash_attention.flash_attention.launches
    bwd0 = flash_attention.flash_attention_bwd.launches
    kernel = grads(False)
    assert flash_attention.flash_attention.launches == fwd0 + 1
    assert flash_attention.flash_attention_bwd.launches == bwd0 + 1
    plain = grads(True)
    assert flash_attention.flash_attention_bwd.launches == bwd0 + 1
    errors = flash_attention.bwd_errors(kernel, plain, dtype)
    assert all(ok for _, ok in errors), errors


@pytest.mark.cuda
def test_tiny_finetune_step_goes_through_the_flash_kernels(cuda):
    """A Ti/16 two-tower model of depth 2 at 64 px on the unmask-tuning
    config (mask 0.3, remat "minimal", the image tower on the flash route):
    every step launches the flash forward twice per image layer (the
    forward and remat's recompute) and its backward once, the fused kernels
    never and nothing for the 8-token text tower; 10 steps lower the
    loss."""
    from clipa_tpu_torch.configs import clipa_finetune
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.train import step

    config = clipa_finetune.get_config(
        "img=Ti/16,res=64,token_len=8,batchsize=16,mask_ratio=0.3")
    config.model.image.update(depth=2, attn_impl="pallas")
    config.model.text.update(depth=2)
    config.schedule = [(".*", dict(decay_type="const"))]
    config.lr = 1e-4
    model = step.create_model(config, device=cuda)
    state = step.init_train_state(
        model, config, torch.Generator(device=cuda).manual_seed(0), cuda)
    tx, _ = optim.make(config, model, sched_kw=dict(total_steps=10))
    update = step.make_update_fn(model, tx, config, total_steps=10)
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.randint(
        0, 255, (16, 64, 64, 3), dtype=np.uint8)).to(cuda),
        "labels": torch.from_numpy(rng.randint(
            0, 32000, (16, 8)).astype(np.int32)).to(cuda)}
    losses = []
    for _ in range(10):
        flash_attention.flash_attention.launches = 0
        flash_attention.flash_attention_bwd.launches = 0
        block_attention.fused_attention.launches = 0
        block_attention.fused_attention_bwd.launches = 0
        state, meas = update(state, batch)
        torch.cuda.synchronize()
        assert flash_attention.flash_attention.launches == 2 * 2
        assert flash_attention.flash_attention_bwd.launches == 2
        assert block_attention.fused_attention.launches == 0
        assert block_attention.fused_attention_bwd.launches == 0
        assert all(bool(torch.isfinite(v)) for v in meas.values())
        losses.append(float(meas["training_loss"]))
    assert losses[-1] < 0.9 * losses[0], losses


# --- the deferred-normalization backward (attn_sweep's variant) ------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,h,bias,exact,q_scale", BWD_CASES)
def test_deferred_bwd_kernel_matches_plain_and_normalized(
        cuda, b, l, d, h, bias, exact, q_scale):
    """The deferred backward under bwd_deferred_plan at BWD_CASES up to
    L = 144 (the whole-head scheme's deferred form, L = 50 among them):
    within the backward's tolerance of its plain twin and of the normalized
    kernel, one launch per call, and bit-identical over two calls. Past
    L = 144 (L = 180 among them) it is refused before any launch."""
    q, k, v, do, biases = _bwd_operands(cuda, torch.bfloat16, b, l, d, bias,
                                        q_scale, seed=5)
    before = block_attention.fused_attention_bwd_deferred.launches
    if l > 144:
        with pytest.raises(ValueError, match="deferred backward takes"):
            block_attention.fused_attention_bwd_deferred(q, k, v, do, h, l,
                                                         biases, exact)
        assert block_attention.fused_attention_bwd_deferred.launches == before
        return
    plan = block_attention.bwd_deferred_plan(l, d // h)
    assert plan.scheme == block_attention.BWD_WHOLE
    grads = block_attention.fused_attention_bwd_deferred(q, k, v, do, h, l,
                                                         biases, exact)
    torch.cuda.synchronize()
    assert block_attention.fused_attention_bwd_deferred.launches == before + 1
    again = block_attention.fused_attention_bwd_deferred(q, k, v, do, h, l,
                                                         biases, exact)
    assert all(torch.equal(x, y) for x, y in zip(grads, again)
               if x is not None)
    plain = block_attention.attention_plain_bwd(q, k, v, do, h, l, biases,
                                                exact, defer=True)
    errors = block_attention.bwd_errors(grads, plain)
    assert all(ok for _, ok in errors), errors
    normalized = block_attention.fused_attention_bwd(q, k, v, do, h, l,
                                                     biases, exact)
    errors = block_attention.bwd_errors(grads, normalized)
    assert all(ok for _, ok in errors), errors


@pytest.mark.cuda
def test_deferred_bwd_refuses_fp32(cuda):
    x = torch.zeros(2 * 40, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        block_attention.fused_attention_bwd_deferred(x, x, x, x, 4, 40)


# --- the uint8 patch embed (K9) ---------------------------------------------

# p = 16 at L/16's width, p = 14 at H/14's (K = 588: the k loop pads to
# 640), a non-square image, Ti/16's width 192 (a half-empty 128-column
# tile), and width 100 (a multiple of 4, not of 8) at p = 14. No case's row
# count is a multiple of the GEMM's 192-row tile: (2, 224, 224, 14) has 512
# rows and (2, 224, 224, 16) 392, so their last row tile is ragged behind
# whole ones; the others fit in one ragged tile.
PATCH_CASES = [(3, 112, 112, 16, 1024), (2, 224, 224, 14, 1280),
               (5, 48, 80, 16, 256), (2, 224, 224, 16, 192),
               (3, 56, 70, 14, 100)]


def _patch_operands(cuda, b, hh, ww, p, width, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    images = torch.randint(0, 256, (b, hh, ww, 3), generator=gen,
                           device=cuda, dtype=torch.uint8)
    kernel = torch.randn(p, p, 3, width, generator=gen, device=cuda) * 0.02
    bias = torch.randn(width, generator=gen, device=cuda)
    return images, kernel, bias


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b,hh,ww,p,width", PATCH_CASES)
def test_patch_embed_kernel_matches_plain(cuda, b, hh, ww, p, width,
                                          with_bias, out_dtype):
    from clipa_tpu_torch.ops import patch_embed
    images, kernel, bias = _patch_operands(cuda, b, hh, ww, p, width)
    bias = bias if with_bias else None
    before = patch_embed.fused_patch_embed.launches
    out = patch_embed.fused_patch_embed(images, kernel, bias,
                                        out_dtype=out_dtype, impl="pallas")
    torch.cuda.synchronize()
    assert patch_embed.fused_patch_embed.launches == before + 1
    ref = patch_embed.fused_patch_embed(images, kernel, bias,
                                        out_dtype=out_dtype, impl="xla")
    assert patch_embed.fused_patch_embed.launches == before + 1
    assert out.shape == ref.shape == (b, (hh // p) * (ww // p), width)
    assert out.dtype == out_dtype
    err, ok = patch_embed.errors(out, ref)
    assert ok, err
    # no split-K, no atomics: a second call agrees bit for bit
    assert torch.equal(out, patch_embed.fused_patch_embed(
        images, kernel, bias, out_dtype=out_dtype, impl="pallas"))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [16, 14, 7])
@pytest.mark.parametrize("offset", [0, 2, 1])
def test_patch_embed_kernel_every_image_load_width(cuda, p, offset):
    """The patchify kernel reads each patch-row group's image rows with
    16-byte loads where they are aligned (offset 0 at p = 16: 96 px rows
    of 288 bytes), else byte by byte (p = 14's 252-byte rows, or an image
    that starts `offset` bytes into its buffer), and gathers them into
    patch rows by byte pairs (p even) or bytes (the GEMM's input); every
    route within patch_embed.errors of the plain version."""
    from clipa_tpu_torch.ops import patch_embed
    images, kernel, bias = _patch_operands(cuda, 2, 4 * p, 6 * p, p, 256,
                                           seed=1)
    buf = torch.empty(images.numel() + 8, dtype=torch.uint8, device=cuda)
    shifted = buf[offset:offset + images.numel()].view(images.shape)
    shifted.copy_(images)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 == offset
    out = patch_embed.fused_patch_embed(shifted, kernel, bias,
                                        out_dtype=torch.float32,
                                        impl="pallas")
    ref = patch_embed.fused_patch_embed(images, kernel, bias,
                                        out_dtype=torch.float32, impl="xla")
    err, ok = patch_embed.errors(out, ref)
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("p,width", [(14, 100), (16, 1024), (14, 1280)])
def test_patch_embed_split_kernel_matches_split_weights(cuda, monkeypatch, p,
                                                        width):
    """The entry's split kernel writes split_weights' (2, width, k_pad) bf16
    hi and lo parts bit for bit, zeros past K included (the scratch starts
    as NaN): a width that leaves a part-filled 32-column tile and K = 588,
    which leaves a part-filled 32-row tile."""
    from clipa_tpu_torch.ops import patch_embed
    images, kernel, _ = _patch_operands(cuda, 2, 2 * p, 3 * p, p, width)
    w, shift = patch_embed.fold_normalization(kernel)
    made, real_empty = [], torch.empty

    def empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        made.append(out.fill_(float("nan")) if out.is_floating_point()
                    else out)
        return out

    monkeypatch.setattr(torch, "empty", empty)
    patch_embed._launch(images, w, shift, p, torch.float32)
    monkeypatch.undo()
    split = made[0]
    assert split.dtype == torch.bfloat16
    assert torch.equal(split, patch_embed.split_weights(
        w, split.shape[2]))


@pytest.mark.cuda
def test_patch_embed_entry_refuses_other_plans(cuda):
    """The C entry takes patch_plan's launch and no other: each field of
    the plan off by a step is refused (cudaErrorInvalidValue)."""
    from clipa_tpu_torch.ops import patch_embed
    images, kernel, bias = _patch_operands(cuda, 2, 32, 32, 16, 128)
    w, shift = patch_embed.fold_normalization(kernel)
    plan = patch_embed.patch_plan(8, 128, 16, 32)
    patch_embed._launch(images, w, shift, 16, torch.bfloat16, plan=plan)
    for field in plan._fields:
        bad = plan._replace(**{field: getattr(plan, field) + 16})
        with pytest.raises(RuntimeError, match="launch failed"):
            patch_embed._launch(images, w, shift, 16, torch.bfloat16,
                                plan=bad)


@pytest.mark.cuda
def test_patch_embed_width_gate_and_refusals(cuda):
    """No width gate on the card: width 96 (not a multiple of 128, where
    the reference's Pallas route gives way to XLA) launches the kernel;
    a width the kernel cannot take raises, as do the wrong images."""
    from clipa_tpu_torch.ops import patch_embed
    images, kernel, bias = _patch_operands(cuda, 2, 32, 32, 16, 96)
    before = patch_embed.fused_patch_embed.launches
    out = patch_embed.fused_patch_embed(images, kernel, bias, impl="pallas")
    assert patch_embed.fused_patch_embed.launches == before + 1
    err, ok = patch_embed.errors(out, patch_embed.fused_patch_embed(
        images, kernel, bias, impl="xla"))
    assert ok, err
    images, kernel, bias = _patch_operands(cuda, 2, 32, 32, 16, 6)
    with pytest.raises(ValueError, match="multiples of 4"):
        patch_embed.fused_patch_embed(images, kernel, bias, impl="pallas")
    assert patch_embed.fused_patch_embed.launches == before + 1
    images, kernel, _ = _patch_operands(cuda, 2, 32, 32, 16, 128)
    with pytest.raises(ValueError, match="uint8"):
        patch_embed.fused_patch_embed(images.float(), kernel, impl="pallas")
    with pytest.raises(ValueError, match="uint8"):
        patch_embed.fused_patch_embed(images.transpose(1, 2), kernel,
                                      impl="pallas")
    with pytest.raises(TypeError, match="out_dtype"):
        patch_embed.fused_patch_embed(images, kernel, out_dtype=torch.half,
                                      impl="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("n_prefetch", [0, 2])
def test_input_pipeline_delivers_the_host_batches_on_the_card(cuda,
                                                              n_prefetch):
    """start_input_pipeline's batches on the card (pinned memory, copies on
    a side stream that the consumer's stream waits on) equal the host
    batches, read on the consumer's stream while the producer runs ahead."""
    from clipa_tpu_torch.data import pipeline
    rng = np.random.default_rng(0)
    host = [{"image": rng.integers(0, 256, (64, 112, 112, 3), np.uint8),
             "labels": rng.integers(0, 32000, (64, 8)).astype(np.int32)}
            for _ in range(6)]
    got = pipeline.start_input_pipeline(iter(host), cuda,
                                        n_prefetch=n_prefetch)
    for want, batch in zip(host, got):
        assert set(batch) == set(want)
        for key, t in batch.items():
            assert t.device.type == "cuda"
            # work on the consumer's stream, as a train step would
            seen = (t.to(torch.int64) * 1).cpu().numpy()
            np.testing.assert_array_equal(seen, want[key], err_msg=key)
    got.close()


# The fused Adam kernel (csrc/fused_adam.cu) against the optimizer's chain
# run eagerly on the same card, bit for bit. Leaves of 1 element, odd
# lengths, lengths that are no multiple of 4 or 8, more than one chunk
# (65536) with a ragged tail, and one of more than 2^24 elements; names that
# hit a frozen group, lr_mults, lwd (Ti/16: 12 blocks) and the wd masks
# (kernels at 0.2, cls at 0, the rest none).
ADAM_SHAPES = {
    "img/embedding/kernel": (4, 4, 3, 8),
    "img/cls": (1, 1, 8),
    "img/Transformer/encoderblock_0/LayerNorm_0/scale": (7,),
    "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel": (9, 13),
    "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/bias": (13,),
    "img/Transformer/encoderblock_1/MlpBlock_0/Dense_1/kernel": (4100, 4100),
    "img/Transformer/encoderblock_11/MlpBlock_0/Dense_1/bias": (2 * 65536
                                                                + 5,),
    "img/head/kernel": (8, 4),
    "txt/Embed_0/embedding": (10, 12),
    "txt/pos_embedding": (1, 3, 8),
    "t": (1,),
}
# a gradient handed over as a view at an odd offset (the scalar path)
ADAM_UNALIGNED = "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/bias"
# gradients handed over as strided views (a conv stem's HWIO weight used
# as OIHW: its gradient is a permuted view), copied by the wrapper
ADAM_STRIDED = {"img/embedding/kernel": (3, 2, 1, 0),
                "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel":
                    (1, 0)}

ADAM_CASES = [("scale_by_adam", mu, "float32", clip)
              for mu in ("bfloat16", "float32")
              for clip in (None, 0.5, 1e9)] + [
    ("scale_by_fused_adam", mu, nu, clip)
    for mu in ("bfloat16", "float32") for nu in ("bfloat16", "float32")
    for clip in (None, 0.5, 1e9)]


def _adam_config(name, mu, nu, clip):
    from clipa_tpu_torch.config import ConfigDict
    optax = dict(b1=0.9, b2=0.95, mu_dtype=mu)
    if name == "scale_by_fused_adam":
        optax["nu_dtype"] = nu
    return ConfigDict(
        lr=1e-2, wd=0.2, optax_name=name, optax=optax, grad_clip_norm=clip,
        wd_mults=[(".*/kernel$", 1.0), ("img/cls", 0.0)],
        schedule=[("img/head/.*", None),
                  ("txt/.*", dict(decay_type="linear", warmup_steps=1)),
                  (".*", dict(decay_type="cosine"))],
        lr_mults=[("img/Transformer/encoderblock_0/.*", 2.0)], lwd=0.8,
        model=ConfigDict(image=ConfigDict(variant="Ti/16")))


def _bits(t):
    ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(ints)


def _assert_same_state(got, want, got_updates=None, want_updates=None):
    for name, p in want.params.items():
        assert torch.equal(_bits(got.params[name]), _bits(p)), name
    for key in ("mu", "nu"):
        mine = getattr(got, key)
        for name, m in getattr(want, key).items():
            assert mine[name].dtype == m.dtype, (key, name)
            assert torch.equal(_bits(mine[name]), _bits(m)), (key, name)
    if want_updates is not None:
        assert set(got_updates) == set(want_updates)
        for name, x in want_updates.items():
            assert got_updates[name].dtype == torch.float32, name
            assert torch.equal(_bits(got_updates[name]), _bits(x)), name
    assert got.count == want.count


def _adam_grads(cuda, gen):
    grads = {}
    for name, shape in ADAM_SHAPES.items():
        g = torch.randn(shape, device=cuda, generator=gen)
        if name in ADAM_STRIDED:
            order = ADAM_STRIDED[name]
            g = g.permute(order).contiguous().permute(order)
            assert not g.is_contiguous()
        if name == ADAM_UNALIGNED:
            g = torch.cat([g.new_zeros(1), g.reshape(-1)])[1:].view(shape)
        grads[name] = g
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("name,mu,nu,clip", ADAM_CASES)
def test_fused_adam_matches_the_chain_bit_for_bit(cuda, name, mu, nu, clip):
    """Three steps of the kernel against three of the eager chain on the
    same card: parameters, moments and the returned updates bit for bit
    (updates asked for on steps 1 and 3, not on step 2); then a fresh
    optimizer loads the kernel's state_dict and one more step of each
    agrees."""
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.ops import fused_adam

    config = _adam_config(name, mu, nu, clip)
    gen = torch.Generator(device=cuda).manual_seed(3)
    start = {n: torch.randn(s, device=cuda, generator=gen)
             for n, s in ADAM_SHAPES.items()}
    sched_kw = dict(total_steps=10)
    kernel, _ = optim.make(config, {n: p.clone() for n, p in start.items()},
                           sched_kw=sched_kw)
    chain, _ = optim.make(config, {n: p.clone() for n, p in start.items()},
                          sched_kw=sched_kw)
    assert kernel.fused == (name == "scale_by_fused_adam")
    for k in range(3):
        grads = _adam_grads(cuda, gen)
        kernel.return_updates = k != 1
        before = fused_adam.fused_adam_step.launches
        got = kernel.update(grads)
        kernel.apply(got)
        assert fused_adam.fused_adam_step.launches == before + 1
        want = chain.chain_update(grads)
        optim.apply_updates(chain.params, want)
        torch.cuda.synchronize()
        if k == 1:
            assert got == {}
            _assert_same_state(kernel, chain)
        else:
            _assert_same_state(kernel, chain, got, want)
        if clip is not None:   # engaged at 0.5, not at 1e9
            norm = float(torch.sqrt(sum(g.square().sum()
                                        for g in grads.values())))
            assert (norm > clip) == (clip == 0.5)
    # the frozen head never moved
    assert torch.equal(kernel.params["img/head/kernel"],
                       start["img/head/kernel"])
    resumed, _ = optim.make(config, {n: p.clone() for n, p in
                                     kernel.params.items()},
                            sched_kw=sched_kw)
    resumed.load_state_dict(kernel.state_dict())
    grads = _adam_grads(cuda, gen)
    resumed.apply(resumed.update(grads))
    optim.apply_updates(chain.params, chain.chain_update(grads))
    torch.cuda.synchronize()
    _assert_same_state(resumed, chain)


@pytest.mark.cuda
def test_fused_adam_refuses_what_it_cannot_take(cuda):
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.ops import fused_adam
    config = _adam_config("scale_by_adam", "bfloat16", "float32", None)
    params = {n: torch.zeros(s, device=cuda) for n, s in ADAM_SHAPES.items()}
    params["img/embedding/kernel"] = torch.zeros(
        8, 3, 4, 4, device=cuda).permute(2, 3, 1, 0)
    with pytest.raises(ValueError, match="not contiguous"):
        optim.make(config, params, sched_kw=dict(total_steps=10))
    for dtype in (torch.float64, torch.bfloat16):   # fp32 masters only
        params["img/embedding/kernel"] = torch.zeros(4, 4, 3, 8, device=cuda,
                                                     dtype=dtype)
        with pytest.raises(TypeError, match=str(dtype).split(".")[1]):
            optim.make(config, params, sched_kw=dict(total_steps=10))
    params["img/embedding/kernel"] = torch.zeros(4, 4, 3, 8, device=cuda)
    tx, _ = optim.make(config, params, sched_kw=dict(total_steps=10))
    mu = tx.mu["txt/pos_embedding"]     # one launch: one dtype per moment
    tx.mu["txt/pos_embedding"] = mu.float()
    with pytest.raises(TypeError, match="bfloat16"):
        fused_adam.AdamTables(tx)
    tx.mu["txt/pos_embedding"] = mu
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    grads["txt/Embed_0/embedding"] = torch.zeros(12, 10, device=cuda)
    with pytest.raises(ValueError, match="expected"):
        tx.update(grads)
    grads["txt/Embed_0/embedding"] = torch.zeros(10, 12, device=cuda,
                                                 dtype=torch.float16)
    with pytest.raises(TypeError, match="takes torch.float32"):
        tx.update(grads)


# A leaf table past 2^31 elements (2.149e9, mT5-XL's 512M-element ids
# table among them, as in the mt5-xl-ViT-H-14 step): its chunk table's
# offsets and the updates buffer's leaf offsets pass what 32 bits hold.
ADAM_LARGE_SHAPES = {
    "txt/word_embeddings/embedding": (250112, 2048),
    "txt/block_0_wi0/kernel": (262144, 2048),
    "txt/block_0_wi1/kernel": (262144, 2048),
    "txt/block_0_wo/kernel": (262144, 2048),
    "img/Transformer/encoderblock_3/MlpBlock_0/Dense_0/kernel": (65536, 400),
    "img/Transformer/encoderblock_3/MlpBlock_0/Dense_0/bias": (2 * 65536
                                                               + 5,),
    "txt/final_norm/scale": (7,),
    "t": (1,),
}


def _seeded(shape, cuda, *key):
    seed = int(np.random.SeedSequence(list(key)).generate_state(1)[0])
    return torch.randn(shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(seed))


@pytest.mark.cuda
def test_fused_adam_matches_the_chain_past_2_to_the_31_elements(cuda):
    """Two steps of the kernel over the whole table (one launch each, the
    updates written) against the eager chain run leaf by leaf from the
    same seeded parameters and gradients (no clip, so no leaf depends on
    another): parameters, moments and updates bit for bit. Needs some 40
    GB of the card."""
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.ops import fused_adam
    config = _adam_config("scale_by_adam", "bfloat16", "float32", None)
    names = list(ADAM_LARGE_SHAPES)
    assert sum(math.prod(s) for s in ADAM_LARGE_SHAPES.values()) > 2 ** 31
    sched_kw = dict(total_steps=10)
    kernel, _ = optim.make(config, {
        n: _seeded(s, cuda, i) for i, (n, s) in
        enumerate(ADAM_LARGE_SHAPES.items())}, sched_kw=sched_kw)
    got = []
    for k in range(2):
        grads = {n: _seeded(ADAM_LARGE_SHAPES[n], cuda, 100 + k, i)
                 for i, n in enumerate(names)}
        kernel.return_updates = True
        before = fused_adam.fused_adam_step.launches
        got.append(kernel.update(grads))
        assert fused_adam.fused_adam_step.launches == before + 1
        del grads
    torch.cuda.synchronize()
    for i, (n, s) in enumerate(ADAM_LARGE_SHAPES.items()):
        chain, _ = optim.make(config, {n: _seeded(s, cuda, i)},
                              sched_kw=sched_kw)
        for k in range(2):
            want = chain.chain_update({n: _seeded(s, cuda, 100 + k, i)})
            optim.apply_updates(chain.params, want)
            assert torch.equal(_bits(got[k][n]), _bits(want[n])), (n, k)
            del want
        assert torch.equal(_bits(kernel.params[n]), _bits(chain.params[n])), n
        for key in ("mu", "nu"):
            assert torch.equal(_bits(getattr(kernel, key)[n]),
                               _bits(getattr(chain, key)[n])), (key, n)
        del chain


@pytest.mark.cuda
def test_training_step_goes_through_the_fused_adam_kernel(cuda):
    """A small two-towers step on the card makes one fused Adam launch per
    step, and writes the updates only on the steps whose l2_updates is
    due (the first and every second here)."""
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.ops import fused_adam
    from clipa_tpu_torch.train import step

    config = clipa_pretrain.get_config(
        "img=Ti/16,res=96,token_len=8,batchsize=16")
    config.model.image.update(depth=2)
    config.model.text.update(depth=2)
    config.schedule = [(".*", dict(decay_type="const"))]
    config.log_training_steps = 2
    model = step.create_model(config, device=cuda)
    state = step.init_train_state(
        model, config, torch.Generator(device=cuda).manual_seed(0), cuda)
    tx, _ = optim.make(config, model, sched_kw=dict(total_steps=10))
    update = step.make_update_fn(model, tx, config, total_steps=10)
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.randint(
        0, 255, (16, 96, 96, 3), dtype=np.uint8)).to(cuda),
        "labels": torch.from_numpy(rng.randint(
            0, 32000, (16, 8)).astype(np.int32)).to(cuda)}
    for k in range(4):
        before = fused_adam.fused_adam_step.launches
        state, meas = update(state, batch)
        torch.cuda.synchronize()
        assert fused_adam.fused_adam_step.launches == before + 1
        due = k == 0 or (k + 1) % 2 == 0
        assert tx.return_updates == due
        assert (float(meas["l2_updates"]) > 0) == due, k


@pytest.mark.cuda
def test_fused_adam_under_param_shards_on_an_nccl_group(cuda):
    """make_update_fn over an NCCL mesh of one process with ParamShards and
    the clip set: reduce_gradients hands the optimizer views into one flat
    buffer at arbitrary offsets (some not 16-byte aligned: the kernel's
    scalar path) and the clip takes FSDP's sqsum. One launch per step, and
    the parameters and moments bit for bit those of the chain run from the
    same state on the same gradients. (At world 1 FSDP shards no leaf; a
    shard is a contiguous clone, the layout of any parameter.)"""
    import socket
    import torch.distributed as dist
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch.ops import fused_adam
    from clipa_tpu_torch.parallel import mesh as mesh_lib
    from clipa_tpu_torch.train import step

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        config = clipa_pretrain.get_config(
            "img=Ti/16,res=96,token_len=8,batchsize=16")
        config.model.image.update(depth=2)
        config.model.text.update(depth=2)
        config.schedule = [(".*", dict(decay_type="const"))]
        config.grad_clip_norm = 1e-3      # engaged: the norm is larger
        config.temperature_clamp = False  # the step's, not the optimizer's
        mesh = mesh_lib.create_mesh(1)
        model = step.create_model(config, device=cuda)
        state = step.init_train_state(
            model, config, torch.Generator(device=cuda).manual_seed(0), cuda,
            mesh=mesh)
        shards = state["shards"]
        sched_kw = dict(total_steps=10)
        tx, _ = optim.make(config, state["params"], sched_kw=sched_kw,
                           sqsum=shards.sqsum)
        chain, _ = optim.make(config, {n: p.detach().clone() for n, p in
                                       state["params"].items()},
                              sched_kw=sched_kw, sqsum=shards.sqsum)
        update = step.make_update_fn(model, tx, config, total_steps=10,
                                     mesh=mesh)
        seen, unaligned = {}, []
        kernel_update = tx.update

        def spy(grads):
            seen.clear()
            seen.update({n: g.clone() for n, g in grads.items()})
            unaligned.append(sum(g.data_ptr() % 16 != 0
                                 for g in grads.values()))
            return kernel_update(grads)

        tx.update = spy
        rng = np.random.RandomState(0)
        batch = {"image": torch.from_numpy(rng.randint(
            0, 255, (16, 96, 96, 3), dtype=np.uint8)).to(cuda),
            "labels": torch.from_numpy(rng.randint(
                0, 32000, (16, 8)).astype(np.int32)).to(cuda)}
        for _ in range(3):
            before = fused_adam.fused_adam_step.launches
            state, _ = update(state, batch)
            torch.cuda.synchronize()
            assert fused_adam.fused_adam_step.launches == before + 1
            norm = torch.sqrt(shards.sqsum(seen))
            assert float(norm) > config.grad_clip_norm
            optim.apply_updates(chain.params, chain.chain_update(seen))
            torch.cuda.synchronize()
            _assert_same_state(tx, chain)
        assert min(unaligned) > 0, unaligned
    finally:
        dist.destroy_process_group()


# --- the LayerNorm kernels (csrc/layer_norm.cu) -----------------------------
# Held against the cast chain layers.LayerNorm runs for every other input
# (cast to fp32, fp32 layer_norm, cast back; autograd's backward of it) and
# against the float64 LayerNorm of the same bf16 input: the output within
# one bf16 ulp of the chain's beyond the floor that the two sums' orders
# allow (tools/layer_norm_bench.forward_floor: the kernel's own stated fp32
# error bound plus the chain's measured distance from float64), and within
# half an ulp of the float64 value beyond the kernel's bound (its one
# rounding); dx within one bf16 ulp of its row's scale, dweight and dbias
# within 1e-5 of theirs. The main path's shapes: H/14 @84 (1024 x 37 rows),
# @224 masked (256 x 180) and served (256 x 257), each 1280 wide, and the
# text tower's 256 x 32 x 1024, on three seeds of two input distributions
# (this file's, whose rows' spreads run from 0.3 to 3.3, and the bench's);
# then widths across both layouts (a warp a row to 2048, a block a row past
# it), ragged in the warp's last step, with row counts that leave blocks
# part full.
LN_MAIN_SHAPES = [(37888, 1280), (46080, 1280), (65792, 1280), (8192, 1024)]
LN_WIDTH_SHAPES = [(1001, 8), (333, 96), (515, 384), (77, 640), (64, 768),
                   (129, 1408), (31, 1664), (45, 2048), (19, 2056),
                   (130, 3072), (64, 4096), (7, 8192)]


def _ln_operands(cuda, rows, d, seed=0, dist="spread"):
    """(x, weight, bias, dy): `dist` "spread" draws each row's spread from
    0.3 to 3.3 about an offset; "bench" is tools/layer_norm_bench's."""
    if dist == "bench":
        from clipa_tpu_torch.tools import layer_norm_bench
        x, dy, w, b = layer_norm_bench.operands(rows, d, seed, cuda)
        return x, w, b, dy
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(rows, d, device=cuda, generator=gen)
         * torch.rand(rows, 1, device=cuda, generator=gen).mul(3).add(0.3)
         + torch.randn(rows, 1, device=cuda, generator=gen)).bfloat16()
    w = 1 + 0.3 * torch.randn(d, device=cuda, generator=gen)
    b = 0.2 * torch.randn(d, device=cuda, generator=gen)
    dy = torch.randn(rows, d, device=cuda, generator=gen).bfloat16()
    return x, w, b, dy


def _ln_grads(fn, x, w, b, dy):
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    y = fn(x, w, b)
    return (y.detach(), *torch.autograd.grad(y, (x, w, b), dy))


def _ln_chain(x, w, b, eps=1e-6):
    return torch.nn.functional.layer_norm(x.float(), x.shape[-1:], w, b,
                                          eps).to(x.dtype)


def _ln_check(cuda, rows, d, seed=None, dist="spread"):
    from clipa_tpu_torch.ops import layer_norm as ln
    from clipa_tpu_torch.tools import layer_norm_bench as lnb
    x, w, b, dy = _ln_operands(cuda, rows, d,
                               rows + d if seed is None else seed, dist)
    want = _ln_grads(_ln_chain, x, w, b, dy)
    before = dict(ln.layer_norm.launches)
    got = _ln_grads(lambda *a: ln.layer_norm(*a, 1e-6), x, w, b, dy)
    again = _ln_grads(lambda *a: ln.layer_norm(*a, 1e-6), x, w, b, dy)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == {"forward": before["forward"] + 2,
                                      "backward": before["backward"] + 2}
    y, dx, dw, db = got
    assert y.dtype == dx.dtype == torch.bfloat16
    assert dw.dtype == db.dtype == torch.float32
    with torch.no_grad():
        chain32 = torch.nn.functional.layer_norm(x.float(), (d,), w, b,
                                                 1e-6)
        fwd = lnb.forward_ulps(y, chain32, x, w, b, 1e-6)
    assert fwd["y_ulps"] <= 1 and fwd["y_exact_ulps"] <= 0.5, fwd
    assert lnb.dx_ulps(dx, want[1]) <= 1
    for g, ref in ((dw, want[2]), (db, want[3])):
        err = float((g - ref).abs().max()) / float(ref.abs().max())
        assert err <= 1e-5, err
    for a, c in zip(got, again):
        assert torch.equal(_bits(a), _bits(c))
    # without autograd: the forward alone, no statistics, the same output
    with torch.no_grad():
        assert torch.equal(ln.layer_norm(x, w, b, 1e-6), y)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dist", ["spread", "bench"])
@pytest.mark.parametrize("rows,d", LN_MAIN_SHAPES)
def test_layer_norm_kernels_match_the_cast_chain(cuda, rows, d, dist, seed):
    """The kernels at the main path's shapes against the chain and the
    float64 LayerNorm; two backward calls bit for bit."""
    _ln_check(cuda, rows, d, seed, dist)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", LN_WIDTH_SHAPES)
def test_layer_norm_kernels_take_every_width(cuda, rows, d):
    """Widths of every tower (ConvNeXt, Swin, ViT-g and bigG, the patch
    merges) and the layouts' edges against the chain; 3-D input and a
    strided one too."""
    from clipa_tpu_torch.ops import layer_norm as ln
    _ln_check(cuda, rows, d)
    x, w, b, dy = _ln_operands(cuda, 2 * rows, d, seed=d)
    x3 = x.view(2, rows, d)
    assert torch.equal(ln.layer_norm(x3, w, b, 1e-6),
                       ln.layer_norm(x, w, b, 1e-6).view(2, rows, d))
    xt = x.view(rows, 2, d).transpose(0, 1)
    assert torch.equal(ln.layer_norm(xt, w, b, 1e-6),
                       ln.layer_norm(xt.contiguous(), w, b, 1e-6))


@pytest.mark.cuda
def test_layer_norm_kernels_on_no_rows(cuda):
    """An empty batch: an empty output, zero parameter gradients, no
    launch."""
    from clipa_tpu_torch.ops import layer_norm as ln
    x, w, b, dy = _ln_operands(cuda, 0, 64)
    before = dict(ln.layer_norm.launches)
    y, dx, dw, db = _ln_grads(lambda *a: ln.layer_norm(*a, 1e-6), x, w, b,
                              dy)
    assert y.shape == dx.shape == (0, 64)
    assert not dw.any() and not db.any()
    assert ln.layer_norm.launches == before


@pytest.mark.cuda
def test_layer_norm_wrapper_refuses_what_it_cannot_take(cuda):
    from clipa_tpu_torch.ops import layer_norm as ln
    x, w, b, _ = _ln_operands(cuda, 4, 64)
    refused = "layer_norm kernels take a bf16 CUDA x"
    with pytest.raises(ValueError, match=refused):
        ln.layer_norm(x.float(), w, b, 1e-6)
    with pytest.raises(ValueError, match=refused):
        ln.layer_norm(x, w.bfloat16(), b, 1e-6)
    with pytest.raises(ValueError, match=refused):
        ln.layer_norm(x[:, :60], w[:60], b[:60], 1e-6)
    with pytest.raises(ValueError, match="weight torch.float32 .64,. on cpu"):
        ln.layer_norm(x, w.cpu(), b, 1e-6)
    with pytest.raises(ValueError, match=refused):
        ln.layer_norm(x.cpu(), w.cpu(), b.cpu(), 1e-6)


def _layer_norm_census(model, run):
    """Runs `run()` with a count of every layers.LayerNorm module's calls
    and of the cast chain's fp32 layer_norm calls: (calls by module name,
    every module's name, the chain's calls, the kernels' launches)."""
    from clipa_tpu_torch.models import layers
    from clipa_tpu_torch.ops import layer_norm as ln
    calls, chain = {}, []
    norms = [name for name, m in model.named_modules()
             if isinstance(m, layers.LayerNorm)]
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: calls.__setitem__(
            name, calls.get(name, 0) + 1))
        for name, m in model.named_modules() if name in norms]
    plain_layer_norm = torch.nn.functional.layer_norm

    def spy(*args, **kwargs):
        chain.append(args[0].dtype)
        return plain_layer_norm(*args, **kwargs)

    ln.layer_norm.launches = {"forward": 0, "backward": 0}
    torch.nn.functional.layer_norm = spy
    try:
        run()
        torch.cuda.synchronize()
    finally:
        torch.nn.functional.layer_norm = plain_layer_norm
        for h in hooks:
            h.remove()
    return calls, norms, chain, dict(ln.layer_norm.launches)


# Every training cell's route at a small batch: (port config, image blocks
# whose encoder recomputes them under remat "minimal")
LN_CELL_STEPS = [
    ("clipa_pretrain.py:img=H/14,res=84,token_len=8,batchsize=8", 32),
    ("clipa_finetune.py:img=H/14,res=224,token_len=32,mask_ratio=0.3,"
     "batchsize=8", 32),
    ("clipa_finetune.py:img=H/14,res=336,token_len=32,mask_ratio=0.4,"
     "batchsize=4", 32),
    ("clipa_pretrain.py:img=L/16,res=112,token_len=8,batchsize=8", 0),
    ("clipa_pretrain.py:img=H/14,res=84,token_len=32,batchsize=4,"
     "txt=mt5-xl", 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,rematted_blocks", LN_CELL_STEPS)
def test_cell_steps_run_every_layer_norm_through_the_kernels(
        cuda, spec, rematted_blocks):
    """Two steps of each training cell's config (the H/14 pre-training,
    unmask-tuning at 224 and 336 px, L/16 pre-training and the mT5 model's
    image tower): the forward kernel runs once per LayerNorm call, remat's
    recomputes included (each rematted block's two norms twice), the
    backward once per LayerNorm module, and the cast chain's fp32
    layer_norm never (the mT5 tower's norms are RMSNorms, not this
    layer)."""
    import clipa_tpu_torch
    import os
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.train import step

    config = load_config(os.path.join(
        os.path.dirname(clipa_tpu_torch.__file__), "configs", spec))
    config.schedule = [(".*", dict(decay_type="const"))]
    model = step.create_model(config, device=cuda)
    state = step.init_train_state(
        model, config, torch.Generator(device=cuda).manual_seed(0), cuda)
    tx, _ = optim.make(config, model, sched_kw=dict(total_steps=10))
    update = step.make_update_fn(model, tx, config, total_steps=10)
    b, res = config.input.batch_size, config.init_shapes[0][1]
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.randint(
        0, 255, (b, res, res, 3), dtype=np.uint8)).to(cuda),
        "labels": torch.from_numpy(rng.randint(
            2, 32000, (b, config.init_shapes[1][1])).astype(
                np.int32)).to(cuda)}
    out = {}
    for _ in range(2):
        def one_step():
            out["state"], out["meas"] = update(out.get("state", state),
                                               batch)
        calls, norms, chain, launches = _layer_norm_census(model, one_step)
        assert not chain, chain
        assert norms and set(calls) == set(norms)
        rematted = [n for n in norms if ".encoderblock_" in n and (
            model.get_submodule(n.split(".encoderblock_")[0]).remat_policy
            not in (None, "none"))]
        assert len(rematted) == 2 * rematted_blocks
        assert all(calls[n] == (2 if n in rematted else 1) for n in norms)
        assert launches == {"forward": sum(calls.values()),
                            "backward": len(norms)}
        assert all(bool(torch.isfinite(v)) for v in out["meas"].values())


@pytest.mark.cuda
def test_service_runs_every_layer_norm_through_the_kernels(cuda):
    """The embedding cell's route (ViT-H-14-CL32-GAP-BigVision in bf16,
    chunks of 256 at 224 px): one forward launch per LayerNorm call, no
    backward, the cast chain never; the embeddings within the cosine the
    fused attention's service test holds against the plain path."""
    from clipa_tpu_torch.ops import layer_norm as ln
    svc = EmbeddingService("ViT-H-14-CL32-GAP-BigVision", None,
                           image_size=224, precision="bfloat16",
                           num_workers=0, device=cuda)
    imgs = np.random.RandomState(3).randint(0, 256, (300, 224, 224, 3),
                                            np.uint8)
    out = {}
    calls, norms, chain, launches = _layer_norm_census(
        svc.clip.model.img, lambda: out.setdefault(
            "z", svc.embed_images(imgs)))
    assert not chain, chain
    assert set(calls) == set(norms) and len(norms) == 2 * 32 + 1
    assert all(c == 2 for c in calls.values())        # chunks of 256 and 44
    assert launches == {"forward": sum(calls.values()), "backward": 0}
    assert np.isfinite(out["z"]).all() and out["z"].shape == (300, 1024)
