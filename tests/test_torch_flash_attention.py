"""The port's flash attention (K7/K8) against clipa_tpu's, on the CPU.

The plain versions (``flash_plain_fwd`` / ``flash_plain_bwd``, what the
kernels are held against on the card) are compared with
``clipa_tpu.ops.flash_attention.flash_attention`` and its ``jax.vjp``, the
Pallas kernels run in interpret mode as tests/test_flash_attention.py runs
them, on the same numpy inputs.

Tolerances. fp32: 2e-5 of each output's largest element (JAX under
default_matmul_precision("highest"): only the fp32 summation order
differs). bf16: ``flash_attention.BWD_RTOL`` (1e-2) of the element plus the
output's largest element, for O and the gradients alike: both round p, ds
and the outputs to bf16 at the same places, and a few-ulp fp32 difference
can move one rounding to the neighbouring bf16 value, about one bf16 ulp
(2^-8) of the largest term. LSE (fp32 in both): 1e-4 absolute, summation
order over at most 257 terms at |LSE| up to ~100.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu.ops import attention as jax_attention
from clipa_tpu.ops import block_attention as jax_block
from clipa_tpu.ops import flash_attention as jax_flash
from clipa_tpu_torch.ops import attention, cuda_build, flash_attention

F32_RTOL = 2e-5
LSE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch's
    intra-op pool from oversubscribing the cores the JAX tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, lq, lk, h, hd, seed, q_scale=1.0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, h, hd).astype(np.float32) * q_scale
    k, v = (rng.randn(b, lk, h, hd).astype(np.float32) for _ in range(2))
    do = rng.randn(b, lq, h, hd).astype(np.float32)
    return q, k, v, do


def _close(out, ref, rtol, what):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out - ref)
    limit = rtol * (np.abs(ref) + np.abs(ref).max())
    assert (err <= limit).all(), (
        f"{what}: max err {err.max():.3e} (max |ref| "
        f"{np.abs(ref).max():.3e}, rtol {rtol})")


def _jax_flash(q, k, v, do, dtype):
    """JAX's flash attention in `dtype`: (out, lse (B, H, Lq), grads)."""
    jd = jnp.dtype(dtype)
    args = [jnp.asarray(x, jd) for x in (q, k, v)]
    b, lq, h, _ = q.shape
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(lambda *a: jax_flash.flash_attention(*a), *args)
        grads = vjp(jnp.asarray(do, jd))
        _, lse = jax_flash._flash_apply(*args, 128, 128)
    lse = np.asarray(lse)[:, 0, :lq].reshape(b, h, lq)
    f32 = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return f32(out), lse, [f32(g) for g in grads]


def _torch(x, dtype):
    """A numpy array rounded to `dtype` the way JAX rounds it."""
    return torch.from_numpy(np.array(
        jnp.asarray(x, jnp.dtype(dtype)).astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,lq,lk,h,hd,q_scale", [
    (2, 128, 128, 2, 64, 1.0),     # aligned: one 128-key tile
    (2, 138, 138, 2, 64, 1.0),     # L/16 @224 with mask 0.3: ragged
    (1, 200, 200, 2, 80, 1.0),     # ragged, hd 80
    (2, 77, 257, 2, 64, 1.0),      # cross-attention, 3 key tiles
    (1, 138, 138, 2, 64, 40.0),    # logits far past 70: exact softmax
])
def test_plain_matches_jax_flash(b, lq, lk, h, hd, q_scale, dtype):
    q, k, v, do = _inputs(b, lq, lk, h, hd, seed=lq + hd, q_scale=q_scale)
    ref, ref_lse, ref_grads = _jax_flash(q, k, v, do, dtype)
    tq, tk, tv, tdo = (_torch(x, dtype) for x in (q, k, v, do))
    out, lse = flash_attention.flash_plain_fwd(tq, tk, tv)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, lq)
    rtol = F32_RTOL if dtype == "float32" else flash_attention.BWD_RTOL
    _close(out.float().numpy(), ref, rtol, "out")
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=LSE_ATOL)
    grads = flash_attention.flash_plain_bwd(tq, tk, tv, out, lse, tdo)
    for name, g, r, x in zip(("dq", "dk", "dv"), grads, ref_grads,
                             (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
        _close(g.float().numpy(), r, rtol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_takes_head_dims_past_the_kernels_limit(dtype):
    """The JAX flash kernel takes any head dim that is a multiple of 8; so
    do the plain versions, on the CPU, through the public wrapper and its
    autograd: hd 136 (one past the kernels' 128) against the Pallas kernels
    in interpret mode. Only a CUDA tensor is refused there (the card
    tests)."""
    b, l, h, hd = 1, 40, 2, 136
    assert hd > flash_attention.MAX_HEAD_DIM
    q, k, v, do = _inputs(b, l, l, h, hd, seed=136)
    ref, ref_lse, ref_grads = _jax_flash(q, k, v, do, dtype)
    leaves = [_torch(x, dtype).requires_grad_() for x in (q, k, v)]
    out = flash_attention.flash_attention(*leaves)
    out.backward(_torch(do, dtype))
    rtol = F32_RTOL if dtype == "float32" else flash_attention.BWD_RTOL
    _close(out.detach().float().numpy(), ref, rtol, "out")
    _, lse = flash_attention.flash_plain_fwd(*(x.detach() for x in leaves))
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=LSE_ATOL)
    for name, x, r in zip(("dq", "dk", "dv"), leaves, ref_grads):
        _close(x.grad.float().numpy(), r, rtol, name)


def test_plain_bwd_is_the_gradient_of_the_plain_forward():
    """In fp32 the Pallas backward is the exact gradient: autograd through
    the plain forward agrees with the plain backward."""
    q, k, v, do = (torch.from_numpy(a).double().float()
                   for a in _inputs(2, 70, 150, 2, 16, seed=3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention.flash_plain_fwd(*leaves)
    (out * do).sum().backward()
    grads = flash_attention.flash_plain_bwd(q, k, v, out.detach(),
                                            lse.detach(), do)
    for x, g in zip(leaves, grads):
        _close(g.numpy(), x.grad.numpy(), 1e-5, "autograd")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_head_attention_pallas_matches_jax(dtype):
    """The towers' impl="pallas" on flat (B*L, D) operands with biases: the
    biases added in the operand dtype, heads split, flash attention, in the
    JAX order (its 2D fallback, then dot_product_attention)."""
    b, l, h, hd = 2, 138, 2, 32
    d = h * hd
    rng = np.random.RandomState(11)
    q, k, v, do = (rng.randn(b * l, d).astype(np.float32) for _ in range(4))
    biases = [(0.5 * rng.randn(d)).astype(np.float32) for _ in range(3)]
    jd = jnp.dtype(dtype)

    def f(q, k, v, bq, bk, bv):
        return jax_attention.multi_head_attention(
            q, k, v, h, impl="pallas", seq_len=l, qkv_biases=(bq, bk, bv))

    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)),
                           *(jnp.asarray(x) for x in biases))
        ref_grads = vjp(jnp.asarray(do, jd))
    leaves = [_torch(x, dtype).requires_grad_() for x in (q, k, v)]
    bleaves = [torch.from_numpy(x).requires_grad_() for x in biases]
    out = attention.multi_head_attention(*leaves, h, impl="pallas",
                                         seq_len=l, qkv_biases=bleaves)
    assert out.shape == (b * l, d) and out.dtype == leaves[0].dtype
    (out.float() * _torch(do, dtype).float()).sum().backward()
    rtol = F32_RTOL if dtype == "float32" else flash_attention.BWD_RTOL
    _close(out.detach().float().numpy(),
           np.asarray(ref.astype(jnp.float32)), rtol, "out")
    ref_grads = [np.asarray(r.astype(jnp.float32)) for r in ref_grads]
    for name, x, r in zip(("q", "k", "v"), leaves, ref_grads):
        _close(x.grad.float().numpy(), r, rtol, name)
    # A bias grad is a column sum of B*L rows of the operand's grad, which
    # both round elementwise: its scale is the largest column sum of
    # magnitudes. dbk is 0 in exact arithmetic (softmax is shift-invariant
    # per row): both sides hold rounding noise within that scale.
    for name, x, r, g in zip(("bq", "bk", "bv"), bleaves, ref_grads[3:],
                             ref_grads[:3]):
        scale = np.abs(g).sum(axis=0).max()
        err = np.abs(x.grad.numpy() - r).max()
        assert err <= rtol * scale, f"{name}: {err:.3e} vs scale {scale:.3e}"


def test_auto_route_matches_the_jax_plan():
    """The routing predicate is a copy of the JAX fused forward's VMEM plan
    test: it holds over a grid of shapes, and `auto` takes the flash kernel
    exactly where the JAX package does."""
    for b in (1, 2, 3, 8, 16, 128, 256):
        for l in (33, 50, 138, 257, 577, 1025, 2049):
            for d, h in ((256, 4), (768, 12), (1024, 16), (1280, 16),
                         (1664, 16), (1792, 16), (2048, 8)):
                want = jax_block._plan(b, l, d, h, bwd=False) is not None
                assert attention._fused_plan_fits(b, l, d, h) == want, (
                    b, l, d, h)
    # the unmask-tuning tower (the fused kernels), ViT-G/14 at 448 px (the
    # JAX plan fails: flash), a text tower, cross-attention past 1024
    assert attention._auto(128, 138, 1024, 16, None, True) == "fused"
    assert attention._fused_plan_fits(2, 1025, 1664, 16) is False
    assert attention._auto(2, 1025, 1664, 16, None, True) == "pallas"
    assert attention._auto(128, 32, 768, 12, None, True) == "einsum"
    assert attention._auto(2, 1024, 1024, 16, None, False) == "pallas"
    mask = torch.ones(1, 1, 1025, 1025, dtype=torch.bool)
    assert attention._auto(2, 1025, 1664, 16, mask, True) == "einsum"
    assert attention._auto(2, 1025, 16 * 136, 16, None, True) == "einsum"


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on CUDA: the route runs without a
    card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,card,impl,want", [
    (torch.bfloat16, True, "auto", "fused"),
    (torch.float32, True, "auto", "pallas"),
    (torch.float32, False, "auto", "fused"),
    (torch.float32, True, "fused", "fused"),
])
def test_auto_sends_fp32_on_the_card_to_the_flash_kernels(
        monkeypatch, dtype, card, impl, want):
    """The fused kernels take bf16 only: where `auto` takes them, fp32 CUDA
    operands go to the flash kernels (their fp32 twins) instead. CPU
    operands and an explicit choice keep their route (the fused wrapper
    refuses fp32 on the card itself)."""
    seen = []
    monkeypatch.setattr(attention.block_attention, "fused_attention",
                        lambda q, *a, **kw: seen.append("fused") or q)
    monkeypatch.setattr(flash_attention, "flash_attention",
                        lambda q, *a, **kw: seen.append("pallas") or q)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 50, 256, generator=gen).to(dtype)
               for _ in range(3))
    if card:
        q, k, v = (x.as_subclass(_FakeCuda) for x in (q, k, v))
    out = attention.multi_head_attention(q, k, v, 4, impl=impl)
    assert seen == [want] and out.shape == q.shape


@pytest.mark.parametrize("impl,lq", [("auto", 40), ("auto", 1024),
                                     ("pallas", 40), ("pallas_plain", 40),
                                     ("einsum", 40)])
def test_dot_product_attention_paths_agree(impl, lq):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, lq, 60, 2, 16, 5))
    out = attention.dot_product_attention(q, k, v, impl=impl)
    ref = attention._einsum_attention(q, k, v, None)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=2e-5)


def _stand_in_kernels(monkeypatch):
    """Makes CPU tensors take the kernel branch, with launches that do what
    the CUDA ones do: results in fresh tensors with no autograd history."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v):
        calls["fwd"] += 1
        with torch.no_grad():
            return flash_attention.flash_plain_fwd(q, k, v)

    def bwd(q, k, v, out, lse, do):
        calls["bwd"] += 1
        with torch.no_grad():
            return flash_attention.flash_plain_bwd(q, k, v, out, lse, do)

    monkeypatch.setattr(flash_attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(flash_attention, "_launch", fwd)
    monkeypatch.setattr(flash_attention, "_launch_bwd", bwd)
    return calls


def test_gradients_reach_inputs_through_the_kernel_branch(monkeypatch):
    """The kernels write through ctypes into tensors of their own: only the
    autograd.Function carries gradients to q, k and v. With the kernel
    branch forced (stand-in launches on the CPU) they must reach every input
    and equal the plain backward's; the launches are counted."""
    calls = _stand_in_kernels(monkeypatch)
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(2, 50, 90, 4, 16, seed=21))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd0 = flash_attention.flash_attention.launches
    bwd0 = flash_attention.flash_attention_bwd.launches
    out = flash_attention.flash_attention(*leaves)
    assert calls["fwd"] == 1 and out.requires_grad
    # .sum() hands the backward a stride-0 gradient: made contiguous there
    (out * do).sum().backward()
    assert calls["bwd"] == 1
    assert flash_attention.flash_attention.launches == fwd0 + 1
    assert flash_attention.flash_attention_bwd.launches == bwd0 + 1
    ref_out, lse = flash_attention.flash_plain_fwd(q, k, v)
    want = flash_attention.flash_plain_bwd(q, k, v, ref_out, lse, do)
    for name, x, g in zip(("q", "k", "v"), leaves, want):
        assert x.grad is not None, f"no gradient reached {name}"
        torch.testing.assert_close(x.grad, g, rtol=0, atol=0)
    # the plain choice never takes the kernel branch
    flash_attention.flash_attention(*leaves, plain=True).sum().backward()
    assert calls == {"fwd": 1, "bwd": 1}


def test_flash_refusals_on_the_cpu():
    x = torch.zeros(2, 40, 4, 16)
    fa = flash_attention.flash_attention
    with pytest.raises(NotImplementedError, match="unmasked"):
        fa(x, x, x, mask=torch.ones(2, 1, 40, 40, dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple of 8"):
        fa(x[..., :12], x[..., :12], x[..., :12])
    with pytest.raises(ValueError, match="block_k"):
        fa(x, x, x, block_k=64)
    with pytest.raises(ValueError, match="k has shape"):
        fa(x, x[:, :, :2], x[:, :, :2])
    with pytest.raises(ValueError, match="v has shape"):
        fa(x, x, x[:, :30])
    with pytest.raises(ValueError, match="lse"):
        flash_attention.flash_attention_bwd(x, x, x, x, torch.zeros(2, 4), x)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.dot_product_attention(x, x, x, impl="fused")


def test_library_path_hashes_the_included_header(tmp_path, monkeypatch):
    """An edited csrc header must rebuild every source that includes it:
    the library path hashes the source and its quoted includes."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sources == ["flash_attention_bwd.cu", "flash_attention_fwd.cu",
                       "fused_adam.cu", "fused_attention_bwd.cu",
                       "fused_attention_fwd.cu", "layer_norm.cu",
                       "patch_embed.cu"]
    # include no csrc header
    alone = ["fused_adam.cu", "layer_norm.cu", "patch_embed.cu"]
    attention = [s for s in sources if s not in alone]
    before = {s: cuda_build.library_path(s) for s in sources}
    for s in attention:
        assert cuda_build._sources(s) == [s, "attention_common.cuh"]
    for s in alone:
        assert cuda_build._sources(s) == [s]
    header = csrc / "attention_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: cuda_build.library_path(s) for s in sources}
    assert all(before[s] != after[s] for s in attention)
    assert all(before[s] == after[s] for s in alone)
    # a source's own edit moves only its own library
    src = csrc / "flash_attention_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {s: cuda_build.library_path(s) for s in sources}
    assert [s for s in sources if again[s] != after[s]] == [
        "flash_attention_fwd.cu"]


# launch_plan: the lengths of chip_smoke.py phase 6 and the strip, chunk and
# tile boundaries; (lq, lk)
PLAN_LENGTHS = [(138, 138), (180, 180), (346, 346), (1025, 1025), (77, 257),
                (300, 45), (1, 37)] + [(n, n) for n in (
                    15, 16, 17, 63, 64, 65, 127, 128, 129, 143, 144, 145,
                    257)]


def _strips_of(plan, strips):
    """Each 16-row strip's owners under `plan`: one block's warp per strip
    (a grid plan), or one warp of the single block (the fused backward,
    whose warps stride over the strips)."""
    owners = [0] * strips
    for bx in range(plan.blocks):
        first, end = flash_attention.strip_range(strips, plan.blocks, bx)
        assert 1 <= end - first <= plan.warps
        for s in range(first, end):
            owners[s] += 1
    return owners


@pytest.mark.parametrize("hd", [8, 64, 80, 104, 128])
@pytest.mark.parametrize("lq,lk", PLAN_LENGTHS)
def test_launch_plan_covers_every_row_once(lq, lk, hd):
    plan = flash_attention.launch_plan(lq, lk, hd)
    qs, ks = -(-lq // 16), -(-lk // 16)
    assert _strips_of(plan.fwd, qs) == [1] * qs
    assert plan.fwd.stages == 0
    if len(plan.bwd) == 1:   # the fused backward: every strip of both
        (fused,) = plan.bwd
        assert fused.blocks == 1 and fused.stages in (1, 2)
        assert fused.warps <= max(qs, ks)
    else:                    # the split one: dq over queries, dk/dv keys
        dq, dkv = plan.bwd
        assert _strips_of(dq, qs) == [1] * qs
        assert _strips_of(dkv, ks) == [1] * ks
    max_warps = 12 if -(-hd // 16) * 16 <= 80 else 8
    for p in (plan.fwd, *plan.bwd):
        assert 1 <= p.warps <= max_warps


@pytest.mark.parametrize("hd", [64, 80, 104, 128])
def test_launch_plan_idles_no_warp_at_the_unmask_tuning_length(hd):
    """L = 138: 9 strips. Every forward block has a strip for each of its
    warps, and every warp of the fused backward owns a key strip and a
    query strip: one each up to hd 80 (12-warp blocks), one or two above
    (8-warp blocks)."""
    plan = flash_attention.launch_plan(138, 138, hd)
    for bx in range(plan.fwd.blocks):
        first, end = flash_attention.strip_range(9, plan.fwd.blocks, bx)
        assert end - first == plan.fwd.warps
    (fused,) = plan.bwd
    assert fused.warps == (9 if hd <= 80 else 5)
    if hd == 64:   # the fine-tune shape: 3 blocks of 3 warps
        assert plan.fwd[:2] == (3, 3)


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_launch_plan_fits_shared_memory(hd):
    """Every planned block stays within an H100 block's 227 KB, for every
    head dim the kernels take, at every phase-6 and boundary length: the
    plan, each forward split it weighs and the split backward. (The CUDA
    launchers refuse a size that is not their layout's, so the card tests
    hold these sizes against the sources.)"""
    for lq, lk in PLAN_LENGTHS:
        plan = flash_attention.launch_plan(lq, lk, hd)
        for p in (plan.fwd, *plan.bwd,
                  *flash_attention.fwd_candidates(lq, lk, hd),
                  *flash_attention.bwd_split_plan(lq, lk, hd)):
            assert 0 < p.smem <= flash_attention.SMEM_LIMIT


@pytest.mark.parametrize("hd", [8, 64, 80, 104, 128])
@pytest.mark.parametrize("lq,lk", PLAN_LENGTHS)
def test_fwd_plan_is_its_best_candidate(lq, lk, hd):
    """The forward's plan is one of fwd_candidates, each of which covers
    every query strip once with the fewest blocks of its width; the split
    backward's plan is the one launch_plan gives where nothing fuses."""
    cands = flash_attention.fwd_candidates(lq, lk, hd)
    plan = flash_attention.launch_plan(lq, lk, hd)
    assert plan.fwd in cands
    strips = -(-lq // 16)
    assert len({c.warps for c in cands}) == len(cands)
    for c in cands:
        assert c.blocks == -(-strips // c.warps)
        assert _strips_of(c, strips) == [1] * strips
    if len(plan.bwd) == 2:
        assert plan.bwd == flash_attention.bwd_split_plan(lq, lk, hd)


@pytest.mark.parametrize("dtype,lq,lk", [
    (torch.bfloat16, 138, 138), (torch.bfloat16, 346, 346),
    (torch.bfloat16, 40, 90), (torch.float32, 138, 138)])
def test_launches_pass_the_plan_to_the_entry_points(monkeypatch, dtype, lq,
                                                    lk):
    """_launch and _launch_bwd hand the bf16 entry points launch_plan's
    numbers after the dimensions (forward: warps, blocks, smem; backward:
    stages, then warps, blocks and smem of the fused kernel and zeros, or of
    the dq and the dk/dv kernel) and the fp32 twins none. The backward's
    fp32 delta scratch, where the split scheme or the fp32 twins need one,
    is a fresh (B, H, Lq) buffer on the operands' device, distinct from the
    outputs; the fused kernel gets a null pointer."""
    seen = []
    monkeypatch.setattr(flash_attention, "fwd_library", lambda: "fwd")
    monkeypatch.setattr(flash_attention, "bwd_library", lambda: "bwd")
    monkeypatch.setattr(flash_attention, "_call",
                        lambda lib, entry, like, what, *args:
                        seen.append((lib, entry, args)))
    made = []
    empty_like = torch.empty_like
    monkeypatch.setattr(flash_attention.torch, "empty_like",
                        lambda x, **kw: made.append(empty_like(x, **kw))
                        or made[-1])
    b, h, hd = 2, 4, 64
    q, do = (torch.zeros(b, lq, h, hd, dtype=dtype) for _ in range(2))
    k, v = (torch.zeros(b, lk, h, hd, dtype=dtype) for _ in range(2))
    out, lse = flash_attention._launch(q, k, v)
    dq, dk, dv = flash_attention._launch_bwd(q, k, v, out, lse, do)
    (lib_f, entry_f, args_f), (lib_b, entry_b, args_b) = seen
    assert (lib_f, entry_f) == ("fwd", flash_attention._ENTRY[dtype])
    assert (lib_b, entry_b) == ("bwd", flash_attention._BWD_ENTRY[dtype])
    dims = (b, lq, lk, h, hd)
    plan = flash_attention.launch_plan(lq, lk, hd)
    fused = dtype == torch.bfloat16 and len(plan.bwd) == 1
    if dtype == torch.float32:
        assert args_f[5:] == dims and args_b[10:] == dims
    else:
        f = plan.fwd
        assert args_f[5:] == dims + (f.warps, f.blocks, f.smem)
        if fused:
            (p,) = plan.bwd
            want = (p.stages, p.warps, 1, p.smem, 0, 0, 0)
        else:
            p, r = plan.bwd
            want = (0, p.warps, p.blocks, p.smem, r.warps, r.blocks, r.smem)
        assert args_b[10:] == dims + want
    assert args_f[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr())
    assert args_b[6:9] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if fused:
        assert args_b[9] is None
        return
    (delta,) = [x for x in made if x.data_ptr() == args_b[9]]
    assert delta.shape == (b, h, lq) and delta.dtype == torch.float32
    assert delta.device == q.device
    assert args_b[9] not in (lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                             dv.data_ptr())


def test_launches_take_another_plan(monkeypatch):
    """A plan handed to _launch or _launch_bwd (the bench's probes) reaches
    the entry points in place of launch_plan's: a forward split and the
    split backward at a length where the plan fuses."""
    seen = []
    monkeypatch.setattr(flash_attention, "fwd_library", lambda: "fwd")
    monkeypatch.setattr(flash_attention, "bwd_library", lambda: "bwd")
    monkeypatch.setattr(flash_attention, "_call",
                        lambda lib, entry, like, what, *args:
                        seen.append(args))
    b, l, h, hd = 2, 138, 4, 64
    q, k, v, do = (torch.zeros(b, l, h, hd, dtype=torch.bfloat16)
                   for _ in range(4))
    fwd = flash_attention.fwd_candidates(l, l, hd)[0]
    assert fwd != flash_attention.launch_plan(l, l, hd).fwd
    assert len(flash_attention.launch_plan(l, l, hd).bwd) == 1
    p, r = flash_attention.bwd_split_plan(l, l, hd)
    out, lse = flash_attention._launch(q, k, v, plan=fwd)
    flash_attention._launch_bwd(q, k, v, out, lse, do, plan=(p, r))
    args_f, args_b = seen
    assert args_f[10:] == (fwd.warps, fwd.blocks, fwd.smem)
    assert args_b[15:] == (0, p.warps, p.blocks, p.smem, r.warps, r.blocks,
                           r.smem)
    assert args_b[9] is not None
