"""clipa_tpu_torch on a CUDA device: the kernels against their plain versions.

These tests need a card (a CUDA kernel has no CPU mode) and skip without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The tolerances are the kernels' stated ones (``block_attention.tolerance``
and ``flash_attention.tolerance`` for the forwards: about one bf16 ulp for
bf16 operands, 2e-5 for fp32 ones, and ``flash_attention.LSE_ATOL`` on the
flash forward's LSE; ``bwd_errors`` of either module for the backwards:
1e-2 resp. 2e-5 of each gradient's scale), the reference the plain versions
in fp32 from the same operands with TF32 off. The deferred backward is
held to the backward's tolerance against its plain twin and against the
normalized kernel; the patch embed to ``patch_embed.errors`` (1e-4 of the
output's scale for fp32 outputs, one bf16 ulp for bf16 ones).
"""

import json

import numpy as np
import pytest
import torch

from clipa_tpu_torch.ops import block_attention, flash_attention
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
# to the next multiple of 16), in both modes, with and without bias. Each
# in bf16 (the tensor-core kernel) and in fp32 (its scalar twin, the
# service at precision float32).
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
    *((2, n, 256, 4, bias, not bias, 1.0)
      for n in (33, 48, 49, 63, 64, 65, 129, 255, 256, 257, 272, 273, 577)
      for bias in (True, False)),
    *((2, 257, 2 * hd, 2, bias, exact, 1.0)
      for hd in (8, 40, 64, 80, 88, 104, 112, 128)
      for bias in (True, False) for exact in (False, True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,l,d,h,bias,exact,q_scale", CASES)
def test_kernel_matches_plain(cuda, b, l, d, h, bias, exact, q_scale,
                              dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device=cuda, generator=gen)
                * scale).to(dtype)

    q, k, v = mk(b * l, d, scale=q_scale), mk(b * l, d), mk(b * l, d)
    biases = (mk(d), mk(d), mk(d)) if bias else None
    before = block_attention.fused_attention.launches
    out = block_attention.fused_attention(q, k, v, h, l, biases, exact)
    torch.cuda.synchronize()
    assert block_attention.fused_attention.launches == before + 1
    assert out.dtype == dtype
    ref = block_attention.attention_plain(q, k, v, h, l, biases, exact)
    atol, rtol = block_attention.tolerance(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


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
    atol, rtol = block_attention.tolerance(torch.bfloat16)
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
    with pytest.raises(TypeError, match="all float32"):
        block_attention.fused_attention(x.float(), x, x, 4, 40)
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
    z = svc.embed_images(imgs)                  # chunks of 8 and 4
    assert block_attention.fused_attention.launches == 2 * 2
    zp = plain.embed_images(imgs)
    assert block_attention.fused_attention.launches == 2 * 2
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,l,d,h,bias,exact,q_scale", BWD_CASES)
def test_bwd_kernel_matches_plain(cuda, b, l, d, h, bias, exact, q_scale,
                                  dtype):
    if dtype == torch.float32 and b * l > 4096:
        b = max(1, 4096 // l)   # the scalar fp32 twin is slow; same tiles
    q, k, v, do, biases = _bwd_operands(cuda, dtype, b, l, d, bias, q_scale)
    before = block_attention.fused_attention_bwd.launches
    grads = block_attention.fused_attention_bwd(q, k, v, do, h, l, biases,
                                                exact)
    torch.cuda.synchronize()
    assert block_attention.fused_attention_bwd.launches == before + 1
    ref = block_attention.attention_plain_bwd(q, k, v, do, h, l, biases,
                                              exact)
    for g, r in zip(grads, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == r.dtype and g.shape == r.shape
    errors = block_attention.bwd_errors(grads, ref, dtype)
    assert len(errors) == (6 if bias else 3)
    assert all(ok for _, ok in errors), errors


@pytest.mark.cuda
def test_bwd_wrapper_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2 * 40, 64, device=cuda, dtype=torch.bfloat16)
    bwd = block_attention.fused_attention_bwd
    with pytest.raises(TypeError, match="bfloat16"):
        bwd(x, x, x, x.half(), 4, 40)
    with pytest.raises(TypeError, match="all float32"):
        bwd(x.float(), x.float(), x.float(), x, 4, 40)
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
    and each gives bit-identical outputs over two calls (no atomics); a
    plan whose sizes are not the kernel's own layout's, whose warps do not
    fit its strips, whose scheme is unknown, that asks the deferred entry
    for another scheme than the split one, or the normalized entry for the
    split one is refused."""
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
            errors = block_attention.bwd_errors(first, ref, torch.bfloat16)
            assert all(ok for _, ok in errors), (plan, errors)
            assert all(torch.equal(x, y) for x, y in zip(first, second)), plan
    for plan in block_attention.bwd_candidates(l, hd):
        bad = [plan._replace(smem=plan.smem + 16),
               plan._replace(warps=plan.warps + 1),
               plan._replace(scheme=3)]
        if plan.scheme == block_attention.BWD_LONG:
            bad += [plan._replace(smem_dkv=plan.smem_dkv + 16),
                    plan._replace(stages=block_attention.BWD_MAX_STAGES + 1)]
        for p in bad:
            with pytest.raises(RuntimeError, match="launch failed"):
                block_attention._launch_bwd(q, k, v, do, h, l, biases, False,
                                            plan=p)
        with pytest.raises(RuntimeError, match="launch failed"):
            block_attention._launch_bwd(
                q, k, v, do, h, l, biases, False, plan=plan,
                entry=block_attention._BWD_DEFERRED_ENTRY)
    with pytest.raises(RuntimeError, match="launch failed"):
        block_attention._launch_bwd(
            q, k, v, do, h, l, biases, False,
            plan=block_attention.bwd_split_plan(l, hd))


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("bias", [True, False])
def test_gradients_through_the_kernels_equal_the_plain_path(cuda, dtype,
                                                            bias):
    """FusedAttentionFn on the card: the kernel path's gradients reach q, k,
    v and the biases and match the plain path's (the same autograd.Function
    with plain=True)."""
    b, l, d, h = 16, 50, 256, 4
    ops = _bwd_operands(cuda, dtype, b, l, d, bias, 1.0, seed=3)
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
                                        padded, dtype)
    assert all(ok for _, ok in errors), errors


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
    q, k, v, do, biases = _bwd_operands(cuda, torch.bfloat16, b, l, d, bias,
                                        q_scale, seed=5)
    before = block_attention.fused_attention_bwd_deferred.launches
    grads = block_attention.fused_attention_bwd_deferred(q, k, v, do, h, l,
                                                         biases, exact)
    torch.cuda.synchronize()
    assert block_attention.fused_attention_bwd_deferred.launches == before + 1
    plain = block_attention.attention_plain_bwd(q, k, v, do, h, l, biases,
                                                exact, defer=True)
    errors = block_attention.bwd_errors(grads, plain, torch.bfloat16)
    assert all(ok for _, ok in errors), errors
    normalized = block_attention.fused_attention_bwd(q, k, v, do, h, l,
                                                     biases, exact)
    errors = block_attention.bwd_errors(grads, normalized, torch.bfloat16)
    assert all(ok for _, ok in errors), errors


@pytest.mark.cuda
def test_deferred_bwd_refuses_fp32(cuda):
    x = torch.zeros(2 * 40, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        block_attention.fused_attention_bwd_deferred(x, x, x, x, 4, 40)


# --- the uint8 patch embed (K9) ---------------------------------------------

# p = 16 at L/16's width, p = 14 at H/14's (K = 588, the K-tail), a batch
# whose row count is not a multiple of the 128-row tile, and a non-square
# image.
PATCH_CASES = [(3, 112, 112, 16, 1024), (2, 224, 224, 14, 1280),
               (5, 48, 80, 16, 256)]


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
