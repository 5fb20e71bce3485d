"""Fused multi-head self-attention: CUDA kernels and plain versions.

Port of ``clipa_tpu/ops/block_attention.py``. The three Pallas forwards
there (``_fwd_kernel`` over (B, L, D), ``_fwd2d_kernel`` and
``_fwd2d_bias_kernel`` over flat (B*L, D) rows) compute one function, and
so do the three backwards (``_bwd_kernel``, ``_bwd2d_kernel``,
``_bwd2d_bias_kernel``). On Hopper one hand-written kernel family serves
each direction: ``csrc/fused_attention_fwd.cu`` (:func:`fused_attention`)
and ``csrc/fused_attention_bwd.cu`` (:func:`fused_attention_bwd`). The TPU
kernels' VMEM plans, sample groups and block-diagonal masks suited Mosaic
only. The bf16 forward spreads the 16-row query strips of a (sample, head)
over the blocks of :func:`fwd_plan`; the bf16 backward takes the scheme of
:func:`bwd_plan`: one (sample, head) per work item of a persistent kernel
up to L = 16 * BWD_MAX_CHUNKS, else the long scheme, two kernels whose
16-row strips spread over blocks as the forward's do, the other operands
streaming through a ring (PR 2's split pair serves the deferred variant
alone). bf16 operands go through the tensor cores;
fp32 operands (the service at precision float32, the fp32 smoke configs)
through scalar fp32 twins in the same sources.

:class:`FusedAttentionFn` ties the two directions into autograd, on every
device: the kernels for CUDA tensors, the plain versions for CPU tensors
and for ``plain=True``.

:func:`attention_plain` and :func:`attention_plain_bwd` are the same
functions in plain PyTorch: what the wrappers run for a tensor on the CPU
(the tests), and what the kernels are held against on the card. They
reproduce the Pallas math, not autograd's:

  * fp32 scores from the operand dtype, the scale applied to the fp32
    scores;
  * ``exp(clip(s, +-70))`` with no row max (``_EXP_CLIP``), or the row-max
    form when ``exact``;
  * forward: deferred normalization O = (E.V) / rowsum(E), E cast to the
    operand dtype before the product;
  * backward: P recomputed and normalized in fp32, dS = P*(dP - rowsum(dP*P))
    zeroed where |s| >= 70 in clip mode (``_clip_grad_mask``), dS*scale and
    P rounded to the operand dtype before the three products, bias grads
    the fp32 column sums of dq/dk/dv taken before those are rounded;
  * per-sample attention only: row i belongs to sample i // seq_len.

:func:`fused_attention_bwd_deferred` is the backward variant that
``clipa_tpu/tools/attn_sweep.py`` times beside the landed one: the same
gradients with the softmax's 1/denom folded into dO's rows
(``attention_plain_bwd(..., defer=True)``; bf16 kernel only).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from clipa_tpu_torch.ops import cuda_build
from clipa_tpu_torch.ops.flash_attention import (SM_SMEM, SMEM_LIMIT,
                                                  SMEM_PER_BLOCK, KernelPlan,
                                                  _max_warps, _round16)

# fp32 exp stays finite for |s| <= 87; see clipa_tpu/ops/block_attention.py
# for why the clip is 70 and what the clipped softmax gives up.
_EXP_CLIP = 70.0

# The kernels' limits: head_dim a multiple of 8 (16-byte row chunks) up to
# 128 (the largest register tile they instantiate).
MAX_HEAD_DIM = 128

# Forward kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.
# bf16 operands: both round E to bf16 and the output to bf16, so what remains
# is the fp32 summation order, the hardware exp, and in exact mode the online
# row max (E rounded against the running max, not the final one). Each moves
# an output by well under one bf16 ulp before the last rounding, which can
# then land one ulp (2^-8 relative) apart.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 1e-2
# fp32 operands: nothing is rounded to a narrower type, so only the fp32
# summation order and exp's last bits differ (a few fp32 ulps over <= 577
# keys); the same 2e-5 the plain version is held to against Pallas.
KERNEL_F32_ATOL = 2e-5
KERNEL_F32_RTOL = 2e-5

# Backward kernel vs plain backward, per output x in (dq, dk, dv, dbq, dbk,
# dbv): |kernel - plain| <= BWD_RTOL * (|plain| + max|plain|). Gradients are
# sums of terms of either sign, so an element can be far smaller than its
# terms; the absolute part is scaled by the tensor's largest element. bf16:
# dS*scale and P are rounded to bf16 in both, and an fp32 difference of a
# few ulps (summation order, hardware exp) can round one of them to the
# neighbouring bf16 value; the outputs are then rounded to bf16 once more:
# about one bf16 ulp (2^-8) of the largest term. fp32: summation order only.
BWD_RTOL = 1e-2
BWD_F32_RTOL = 2e-5

# Operand dtype -> the C entry points of the two sources.
_ENTRY = {torch.bfloat16: "clipa_fused_attention_fwd",
          torch.float32: "clipa_fused_attention_fwd_f32"}
_BWD_ENTRY = {torch.bfloat16: "clipa_fused_attention_bwd",
              torch.float32: "clipa_fused_attention_bwd_f32"}
# The deferred-normalization variant of the bf16 backward (same arguments).
_BWD_DEFERRED_ENTRY = "clipa_fused_attention_bwd_deferred"

_SOURCE = "fused_attention_fwd.cu"
_BWD_SOURCE = "fused_attention_bwd.cu"

# The bf16 backward's schemes (BwdPlan.scheme; csrc/fused_attention_bwd.cu
# kSplit, kWhole, kLong).
BWD_SPLIT, BWD_WHOLE, BWD_LONG = 0, 1, 2
# The split scheme: rows per tile (one block per tile) and warps per block
# (kTile, kWarps).
_BWD_TILE = 64
_BWD_SPLIT_WARPS = 4
# The whole-head scheme's largest sequence, in 16-row chunks (kMaxChunks).
BWD_MAX_CHUNKS = 9
# The long scheme's ring tiles and deepest ring (kRingTile, kMaxStages).
BWD_RING_TILE = 128
BWD_MAX_STAGES = 8
# fp32 row statistics per (row, head) that each scheme's dk/dv kernel reads
# (split: m, r, delta; long: lse2, delta; whole-head: none).
_BWD_STAT_ROWS = {BWD_SPLIT: 3, BWD_WHOLE: 0, BWD_LONG: 2}

# The bf16 forward's key tiles, and the deepest ring its launcher takes
# (csrc/fused_attention_fwd.cu kBlockK, kMaxStages).
FWD_BLOCK_K = 128
FWD_MAX_STAGES = 8


def _ring_rows(seq_len: int, stages: int) -> int:
    """Rows of each of the forward's K and V rings: `stages` key tiles, or
    every key (rounded up to a 16-row chunk) where fewer suffice."""
    return min(stages * FWD_BLOCK_K, _round16(seq_len))


def fwd_candidates(seq_len: int, hd: int) -> list[KernelPlan]:
    """The bf16 forward's launches that fwd_plan weighs, as KernelPlans
    (warps, blocks, smem, stages). For each block width up to
    _max_warps(hd), the fewest blocks of it over the ceil(L / 16) query
    strips of a (sample, head) (so no warp idles where the strips divide
    evenly); for each, a ring that holds every key (stages = the key tiles,
    at most FWD_MAX_STAGES) and, past two tiles, a two-stage ring; where
    the block fits in shared memory: its Q strips, then the K and V
    rings."""
    row = (_round16(hd) + 8) * 2          # one padded bf16 row, bytes
    strips = _round16(seq_len) // 16
    tiles = -(-seq_len // FWD_BLOCK_K)
    rings = {min(tiles, FWD_MAX_STAGES), 2} if tiles > 1 else {1}
    plans = []
    for blocks in sorted({-(-strips // w)
                          for w in range(1, _max_warps(hd) + 1)}):
        warps = -(-strips // blocks)
        for stages in sorted(rings):
            smem = (warps * 16 + 2 * _ring_rows(seq_len, stages)) * row
            if smem <= SMEM_LIMIT:
                plans.append(KernelPlan(warps, blocks, smem, stages))
    return plans


@functools.lru_cache(maxsize=None)
def fwd_plan(seq_len: int, hd: int) -> KernelPlan:
    """The bf16 forward's launch at one shape (a pure function, cached),
    whose numbers the CUDA entry point takes and checks against its own
    layout: of fwd_candidates, the one that keeps the most warps with a
    strip resident on an SM (the kernel's launch bound lets the register
    file hold _max_warps(hd) of its warps; the shared memory holds SM_SMEM
    // (smem + SMEM_PER_BLOCK) of its blocks), then the one with the fewest
    blocks (each block copies and biases all of K and V), then the deepest
    ring (every tile in flight, no refill barrier)."""
    strips, max_warps = _round16(seq_len) // 16, _max_warps(hd)

    def rank(p: KernelPlan):
        per_sm = min(max_warps // p.warps,
                     SM_SMEM // (p.smem + SMEM_PER_BLOCK))
        return per_sm * strips / p.blocks, -p.blocks, p.stages

    return max(fwd_candidates(seq_len, hd), key=rank)


class BwdPlan(NamedTuple):
    """The bf16 backward's launch, as the C entry takes it. `scheme`
    BWD_WHOLE: one persistent kernel whose blocks hold one (sample, head)
    item in shared memory, `warps` one per 16-row chunk of L, `blocks` 1,
    `stages` 0, `smem` its bytes per block, `smem_dkv` 0. BWD_LONG: a dq
    kernel and a dk/dv kernel, each `blocks` blocks of `warps` warps per
    (sample, head) over the 16-row strips, the other operands through a
    ring of `stages` 128-row tiles, `smem` and `smem_dkv` their bytes per
    block. BWD_SPLIT: PR 2's dq and dk/dv kernels, `warps` 4 per 64-row
    tile, `blocks` the tiles, `stages` 0: the deferred variant's only
    scheme, which the normalized entry refuses."""
    scheme: int
    warps: int
    blocks: int
    stages: int
    smem: int
    smem_dkv: int


def _whole_smem(seq_len: int, hd: int) -> int:
    """The whole-head kernel's bytes per block: the item's Q and dO, then a
    region that holds K and V and, once they are dead, bf16(P) and dsb
    ([query][key]); then the fp32 column sums of dq, dk and dv per warp."""
    lp, hdp = _round16(seq_len), _round16(hd)
    stage = 2 * lp * (hdp + 8) + 2 * lp * max(hdp + 8, lp + 8)
    return stage * 2 + 3 * (lp // 16) * hdp * 4


def bwd_split_plan(seq_len: int, hd: int) -> BwdPlan:
    """The split scheme's launch: per block four 64-row bf16 tiles, the
    warps' fp32 column sums and 64 fp32 row values (dq kernel) or three
    row statistics (dk/dv kernel). The deferred variant's only scheme."""
    hdp = _round16(hd)
    tiles = 4 * _BWD_TILE * (hdp + 8) * 2
    return BwdPlan(BWD_SPLIT, _BWD_SPLIT_WARPS, -(-seq_len // _BWD_TILE), 0,
                   tiles + (_BWD_SPLIT_WARPS * hdp + _BWD_TILE) * 4,
                   tiles + (3 * _BWD_TILE + _BWD_SPLIT_WARPS * hdp) * 4)


def _long_smem(seq_len: int, hd: int, warps: int,
               stages: int) -> tuple[int, int]:
    """The long scheme's bytes per block of each kernel: the block's two
    16-row strip operands and the two rings (`stages` 128-row tiles, or
    every row where fewer suffice), bf16 rows of round16(hd) + 8; then the
    dq kernel's per-warp fp32 column sums of dq, and the dk/dv kernel's
    ring of fp32 row statistics (lse2, delta) and column sums of dk and
    dv."""
    hdp = _round16(hd)
    ring = min(stages * BWD_RING_TILE, _round16(seq_len))
    rows = (2 * warps * 16 + 2 * ring) * (hdp + 8) * 2
    return (rows + warps * hdp * 4,
            rows + (2 * ring + 2 * warps * hdp) * 4)


def bwd_long_candidates(seq_len: int, hd: int) -> list[BwdPlan]:
    """The long scheme's launches at one shape: for each block width up to
    _max_warps(hd), the fewest blocks of it over the ceil(L / 16) strips of
    a (sample, head), and for each a ring that holds every row (stages =
    the 128-row tiles, at most BWD_MAX_STAGES) and, past two tiles, a
    two-stage ring; where both kernels fit in shared memory."""
    strips = _round16(seq_len) // 16
    tiles = -(-seq_len // BWD_RING_TILE)
    rings = {min(tiles, BWD_MAX_STAGES), 2} if tiles > 1 else {1}
    plans = []
    for blocks in sorted({-(-strips // w)
                          for w in range(1, _max_warps(hd) + 1)}):
        warps = -(-strips // blocks)
        for stages in sorted(rings):
            smem, smem_dkv = _long_smem(seq_len, hd, warps, stages)
            if max(smem, smem_dkv) <= SMEM_LIMIT:
                plans.append(BwdPlan(BWD_LONG, warps, blocks, stages, smem,
                                     smem_dkv))
    return plans


def bwd_candidates(seq_len: int, hd: int) -> list[BwdPlan]:
    """The bf16 (normalized) backward's launches at one shape: the
    whole-head scheme, where L has at most BWD_MAX_CHUNKS 16-row chunks and
    the block fits in shared memory, then the long scheme's."""
    chunks = _round16(seq_len) // 16
    smem = _whole_smem(seq_len, hd)
    whole = ([BwdPlan(BWD_WHOLE, chunks, 1, 0, smem, 0)]
             if chunks <= BWD_MAX_CHUNKS and smem <= SMEM_LIMIT else [])
    return whole + bwd_long_candidates(seq_len, hd)


@functools.lru_cache(maxsize=None)
def bwd_plan(seq_len: int, hd: int) -> BwdPlan:
    """The bf16 backward's launch at one shape (a pure function, cached),
    whose numbers the CUDA entry point takes and checks against its own
    layouts: the whole-head scheme wherever bwd_candidates offers it (it
    forms S and dP once, the long scheme three times), else of the long
    scheme's, as fwd_plan ranks the forward's, the one that keeps the most
    warps with a strip resident on an SM (the shared memory holds SM_SMEM
    // (the larger kernel's smem + SMEM_PER_BLOCK) blocks), then the one
    with the most blocks resident on an SM (one block's copies and
    barriers overlap another's products: at L = 180, hd 80, two blocks of
    6 warps beat one of 12, PERF.md section 6), then the fewest blocks
    (each copies and biases all of the streamed operands), then the
    deepest ring. Raises where no plan fits."""
    cands = bwd_candidates(seq_len, hd)
    if not cands:
        raise ValueError(f"no backward plan fits L = {seq_len}, head_dim "
                         f"{hd} in {SMEM_LIMIT} bytes of shared memory")
    if cands[0].scheme == BWD_WHOLE:
        return cands[0]
    strips, max_warps = _round16(seq_len) // 16, _max_warps(hd)

    def rank(p: BwdPlan):
        per_sm = min(max_warps // p.warps, SM_SMEM // (
            max(p.smem, p.smem_dkv) + SMEM_PER_BLOCK))
        return per_sm * strips / p.blocks, per_sm, -p.blocks, p.stages

    return max(cands, key=rank)


def tolerance(dtype: torch.dtype) -> tuple[float, float]:
    """(atol, rtol) of the forward kernel against :func:`attention_plain`."""
    if dtype == torch.float32:
        return KERNEL_F32_ATOL, KERNEL_F32_RTOL
    return KERNEL_ATOL, KERNEL_RTOL


def bwd_tolerance(dtype: torch.dtype) -> float:
    """rtol of the backward kernel against :func:`attention_plain_bwd`:
    |kernel - plain| <= rtol * (|plain| + scale), per output."""
    return BWD_F32_RTOL if dtype == torch.float32 else BWD_RTOL


def bwd_errors(grads, ref, dtype: torch.dtype) -> list[tuple[float, bool]]:
    """(max abs error, within tolerance) of each present output of a
    backward against the reference `ref` (same order: dq, dk, dv, dbq, dbk,
    dbv). The scale of dq/dk/dv is the tensor's largest element; a bias
    grad is a column sum over B*L rows (dbk is 0 in exact arithmetic: the
    rows of dS sum to 0), so its scale is the largest column sum of
    magnitudes of the matching reference grad."""
    rtol = bwd_tolerance(dtype)
    out = []
    for i, (g, r) in enumerate(zip(grads, ref)):
        if r is None:
            continue
        g, r = g.float(), r.float()
        if i < 3:
            scale = r.abs().max()
        else:
            scale = ref[i - 3].float().abs().sum(dim=0).max()
        err = (g - r).abs()
        ok = bool(torch.isfinite(g).all()
                  and (err <= rtol * (r.abs() + scale)).all())
        out.append((err.max().item(), ok))
    return out


def _head_error(d_model: int, num_heads: int) -> Optional[str]:
    """Why the kernel cannot take this width and head count, or None."""
    if num_heads <= 0 or d_model % num_heads:
        return f"width {d_model} not divisible by {num_heads} heads"
    hd = d_model // num_heads
    if hd % 8 or hd > MAX_HEAD_DIM:
        return (f"head_dim {hd} unsupported by the kernel (needs a multiple "
                f"of 8 up to {MAX_HEAD_DIM})")
    return None


def eligible(d_model: int, num_heads: int, mask) -> bool:
    """Whether the fused path takes these operands (the kernel's limits)."""
    return mask is None and _head_error(d_model, num_heads) is None


def _heads(x: torch.Tensor, b: int, seq_len: int, num_heads: int):
    """(B*L, D) -> (B, H, L, hd) in fp32."""
    return x.reshape(b, seq_len, num_heads, -1).transpose(1, 2).float()


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, hd) -> (B*L, D)."""
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b * l, h * hd)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, seq_len: int,
                    biases: Optional[Sequence[torch.Tensor]] = None,
                    exact: bool = False) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, on any device.

    q, k, v: (B*L, D) with L = seq_len; biases: optional three (D,) tensors
    added to q/k/v in the operand dtype (one rounding). Returns (B*L, D) in
    q's dtype.
    """
    rows, d = q.shape
    hd = d // num_heads
    b = rows // seq_len
    if biases is not None:
        bq, bk, bv = biases
        q, k, v = q + bq, k + bk, v + bv

    def heads(x):
        return _heads(x, b, seq_len, num_heads)

    s = heads(q) @ heads(k).transpose(-1, -2) * (hd ** -0.5)
    if exact:
        e = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    else:
        e = s.clamp_(-_EXP_CLIP, _EXP_CLIP).exp_()
    r = e.sum(dim=-1, keepdim=True)
    o = (e.to(q.dtype).float() @ heads(v)) / r
    return _flat(o.to(q.dtype))


def attention_plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, num_heads: int, seq_len: int,
                        biases: Optional[Sequence[torch.Tensor]] = None,
                        exact: bool = False, defer: bool = False):
    """The backward kernel's function in plain PyTorch, on any device.

    The Pallas backward (``_bwd2d_bias_kernel``, ``_call_bwd_2d_b``), not
    autograd's: see the module docstring. Returns (dq, dk, dv, dbq, dbk,
    dbv); dq/dk/dv in q's dtype, the bias grads in the biases' dtype (None
    without biases).

    `defer`: the deferred-normalization form (the deferred kernel's plain
    twin): with e = exp(clip(s)) (or exp(s - rowmax)) and denom = rowsum(e),
    dohn = do / denom rounded to the operand dtype, dphat = dohn . v,
    dS = e * (dphat - rowsum(dphat * e) / denom), e and dS * scale rounded
    before the products, dv = e^T . dohn. The same gradient as the default
    form up to where the roundings fall. (The reference's deferred kernel,
    ``attn_sweep.py`` make_bwd_bias(defer=True), omits the row-sum term's
    1/denom, which makes its dq and dk wrong.)
    """
    rows, d = q.shape
    hd = d // num_heads
    b = rows // seq_len
    dtype = q.dtype
    scale = hd ** -0.5
    if biases is not None:
        bq, bk, bv = biases
        q, k, v = q + bq, k + bk, v + bv
    qh, kh, vh, doh = (_heads(x, b, seq_len, num_heads) for x in (q, k, v, do))

    s = qh @ kh.transpose(-1, -2) * scale
    if exact:
        e = (s - s.amax(dim=-1, keepdim=True)).exp()
    else:
        e = s.clamp(-_EXP_CLIP, _EXP_CLIP).exp()
    denom = e.sum(dim=-1, keepdim=True)
    if defer:
        doh = (doh / denom).to(dtype).float()   # dohn
        dp = doh @ vh.transpose(-1, -2)         # dphat
        ds = e * (dp - (dp * e).sum(dim=-1, keepdim=True) / denom)
        p = e
    else:
        p = e / denom
        dp = doh @ vh.transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if not exact:
        # d(clip)/ds is 0 where the clip saturates, boundary included
        ds = torch.where(s.abs() >= _EXP_CLIP, 0.0, ds)
    dsb = (ds * scale).to(dtype).float()
    pb = p.to(dtype).float()
    dq = _flat(dsb @ kh)
    dk = _flat(dsb.transpose(-1, -2) @ qh)
    dv = _flat(pb.transpose(-1, -2) @ doh)
    dbias = (None, None, None)
    if biases is not None:
        dbias = tuple(g.sum(dim=0).to(bias.dtype)
                      for g, bias in zip((dq, dk, dv), biases))
    return (dq.to(dtype), dk.to(dtype), dv.to(dtype), *dbias)


def _uses_kernel(x: torch.Tensor) -> bool:
    """Whether a tensor on x's device goes to the CUDA kernel (True) or to
    the plain version (False, CPU tensors); any other device raises."""
    if x.device.type == "cpu":
        return False
    if not x.is_cuda:
        raise ValueError(f"fused attention runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return True


class FusedAttentionFn(torch.autograd.Function):
    """Fused attention with its backward, for autograd.

    ``apply(q, k, v, bq, bk, bv, num_heads, seq_len, exact, plain)``; the
    biases may be None (all three). The kernels run for CUDA tensors, the
    plain versions for CPU tensors and whenever `plain` is set. The forward
    saves only (q, k, v, bq, bk, bv), as the JAX custom VJP does: the
    backward recomputes the scores and the softmax statistics.
    """

    @staticmethod
    def forward(ctx, q, k, v, bq, bk, bv, num_heads, seq_len, exact, plain):
        biases = None if bq is None else (bq, bk, bv)
        if plain or not _uses_kernel(q):
            out = attention_plain(q, k, v, num_heads, seq_len, biases, exact)
        else:
            out = _launch(q, k, v, num_heads, seq_len, biases, exact)
            fused_attention.launches += 1
        ctx.save_for_backward(q, k, v, bq, bk, bv)
        ctx.attrs = (num_heads, seq_len, exact, plain)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bq, bk, bv = ctx.saved_tensors
        num_heads, seq_len, exact, plain = ctx.attrs
        biases = None if bq is None else (bq, bk, bv)
        # a .sum().backward() hands in a stride-0 gradient
        do = do.contiguous()
        bwd = attention_plain_bwd if plain else fused_attention_bwd
        grads = bwd(q, k, v, do, num_heads, seq_len, biases, exact)
        return (*grads, None, None, None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, seq_len: int,
                    biases: Optional[Sequence[torch.Tensor]] = None,
                    exact: bool = False, plain: bool = False) -> torch.Tensor:
    """Multi-head self-attention over flat (B*L, D) rows, differentiable.

    On a CUDA tensor this launches the CUDA kernels (bf16 or fp32 operands)
    in both directions; on a CPU tensor, or with `plain`, it runs the plain
    versions. On either device it raises on a shape the kernel does not
    take. `biases`: optional (bq, bk, bv), each (D,), added inside the
    kernel. `exact` selects the row-max softmax.
    """
    _check_shapes(q, k, v, num_heads, seq_len, biases)
    bq, bk, bv = biases if biases is not None else (None, None, None)
    return FusedAttentionFn.apply(q, k, v, bq, bk, bv, num_heads, seq_len,
                                  exact, plain)


# Forward kernel launches (a plain counter: callers reset it to 0 and read it
# back to prove a run went through the kernel).
fused_attention.launches = 0


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, num_heads: int, seq_len: int,
                        biases: Optional[Sequence[torch.Tensor]] = None,
                        exact: bool = False):
    """The backward of :func:`fused_attention`: (dq, dk, dv, dbq, dbk, dbv).

    On a CUDA tensor this launches ``csrc/fused_attention_bwd.cu``; on a CPU
    tensor it runs :func:`attention_plain_bwd`. The bias grads are None
    without biases.
    """
    _check_shapes(q, k, v, num_heads, seq_len, biases, do)
    if not _uses_kernel(q):
        return attention_plain_bwd(q, k, v, do, num_heads, seq_len, biases,
                                   exact)
    grads = _launch_bwd(q, k, v, do, num_heads, seq_len, biases, exact)
    fused_attention_bwd.launches += 1
    return grads


# Backward kernel launches (one per call; counted like the forward's).
fused_attention_bwd.launches = 0


def fused_attention_bwd_deferred(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 num_heads: int, seq_len: int,
                                 biases: Optional[Sequence[torch.Tensor]]
                                 = None, exact: bool = False):
    """:func:`fused_attention_bwd` in the deferred-normalization form:
    (dq, dk, dv, dbq, dbk, dbv).

    On a CUDA tensor this launches the variant ``kDefer`` of
    ``csrc/fused_attention_bwd.cu`` (bf16 operands only: the fp32 scalar
    twin has no deferred form and this raises); on a CPU tensor it runs
    ``attention_plain_bwd(..., defer=True)``.
    """
    _check_shapes(q, k, v, num_heads, seq_len, biases, do)
    if not _uses_kernel(q):
        return attention_plain_bwd(q, k, v, do, num_heads, seq_len, biases,
                                   exact, defer=True)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the deferred backward kernel takes bfloat16 "
                        f"operands, got {q.dtype}")
    grads = _launch_bwd(q, k, v, do, num_heads, seq_len, biases, exact,
                        entry=_BWD_DEFERRED_ENTRY)
    fused_attention_bwd_deferred.launches += 1
    return grads


# Deferred backward kernel launches (counted like the others).
fused_attention_bwd_deferred.launches = 0


def _check_shapes(q, k, v, num_heads, seq_len, biases, do=None) -> None:
    """The kernels' limits, for every device (the one place they live);
    `do`: the backward's output gradient, shaped as q."""
    if q.dim() != 2:
        raise ValueError(f"expected flat (B*L, D) operands, got {q.shape}")
    rows, d = q.shape
    error = _head_error(d, num_heads)
    if error:
        raise ValueError(error)
    if seq_len <= 0 or rows % seq_len:
        raise ValueError(f"{rows} rows are not a multiple of seq_len "
                         f"{seq_len}")
    if rows // seq_len > 65535 or num_heads > 65535:
        raise ValueError("batch and num_heads must be at most 65535")
    named = [("k", k, (rows, d)), ("v", v, (rows, d))]
    if do is not None:
        named.append(("do", do, (rows, d)))
    if biases is not None:
        named += [(n, b, (d,)) for n, b in zip(("bq", "bk", "bv"), biases)]
    for name, x, shape in named:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")


def _check_memory(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    if x.device != like.device:
        raise ValueError(f"{name} on {x.device}, expected {like.device}")
    if x.dtype not in _ENTRY or x.dtype != like.dtype:
        raise TypeError(f"{name} is {x.dtype}; the CUDA kernel takes q, k, "
                        f"v and biases all bfloat16 or all float32")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _bias_pointers(biases, like) -> list:
    ptrs = [None, None, None]
    if biases is not None:
        for i, (name, b) in enumerate(zip(("bq", "bk", "bv"), biases)):
            _check_memory(name, b, like)
            ptrs[i] = b.data_ptr()
    return ptrs


def _args(n_ptrs: int, n_ints: int = 4) -> list:
    """An entry's argument types: (n_ptrs pointers, batch, seq, num_heads,
    head_dim, [plan ints], scale, exact, stream)."""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _library(source: str, entries: dict, n_ptrs: int) -> ctypes.CDLL:
    """Loads `source`, typing its entries as _args(n_ptrs)."""
    return cuda_build.load_entries(source, entries.values(), _args(n_ptrs))


def fwd_library() -> ctypes.CDLL:
    """The forward's library: the fp32 twin typed as _args(7), the bf16
    entry with the plan's four ints (warps, blocks, smem, stages) after
    the dimensions."""
    lib = _library(_SOURCE, {torch.float32: _ENTRY[torch.float32]}, 7)
    bf16 = getattr(lib, _ENTRY[torch.bfloat16])
    if bf16.argtypes is None:
        bf16.restype = ctypes.c_int
        bf16.argtypes = _args(7, 8)
    return lib


def bwd_library() -> ctypes.CDLL:
    """The backward's library: the fp32 twin typed as _args(13), the bf16
    entries (normalized and deferred) with the plan's six ints (scheme,
    warps, blocks, stages, smem, smem_dkv) after the dimensions."""
    lib = _library(_BWD_SOURCE, {torch.float32: _BWD_ENTRY[torch.float32]},
                   13)
    for entry in (_BWD_ENTRY[torch.bfloat16], _BWD_DEFERRED_ENTRY):
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = _args(13, 10)
    return lib


def _call(lib: ctypes.CDLL, entry: str, like: torch.Tensor, what: str,
          *args) -> None:
    """Calls `entry` of `lib` with `args` and the current stream of
    `like`'s device; raises if the launch failed."""
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    cuda_build.raise_on(err, lib, what)


def _launch(q, k, v, num_heads, seq_len, biases, exact,
            plan: Optional[KernelPlan] = None):
    """Runs the forward kernel. `plan`: the bf16 kernel's launch, fwd_plan's
    by default (tools/flash_bench.py times the others)."""
    rows, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_memory(name, x, q)
    ptrs = _bias_pointers(biases, q)
    hd = d // num_heads
    out = torch.empty_like(q)
    args = ()   # the fp32 twin takes no plan
    if q.dtype == torch.bfloat16:
        args = tuple(plan or fwd_plan(seq_len, hd))
    _call(fwd_library(), _ENTRY[q.dtype], q, "fused attention kernel",
          q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, out.data_ptr(),
          rows // seq_len, seq_len, num_heads, hd, *args, hd ** -0.5,
          int(bool(exact)))
    return out


def _bwd_scratch(q: torch.Tensor, num_heads: int, seq_len: int, bias: bool,
                 plan: Optional[BwdPlan]):
    """The backward's scratch and bias-grad output: (stats, partial,
    dbias), each None where the launch takes none. `plan`: the bf16
    launch, None for the fp32 twin. stats: the fp32 row statistics per
    (row, head) that the scheme's dk/dv kernel reads (the fp32 twin: the
    softmax max, sum and rowsum(dP*P)); partial: with biases on the bf16
    kernels, the fp32 column sums of dq, dk and dv per (sample, block)
    before rounding; dbias: with biases, their fp32 column sums rounded
    once to the biases' type."""
    rows, d = q.shape
    # a scheme the wrapper does not know gets the most; the entry refuses it
    n_stats = 3 if plan is None else _BWD_STAT_ROWS.get(plan.scheme, 3)
    stats = partial = dbias = None
    if n_stats:
        stats = torch.empty((n_stats, rows * num_heads), dtype=torch.float32,
                            device=q.device)
    if bias:
        dbias = torch.empty((3, d), dtype=q.dtype, device=q.device)
        if plan is not None:
            partial = torch.empty((3, rows // seq_len * plan.blocks, d),
                                  dtype=torch.float32, device=q.device)
    return stats, partial, dbias


def _launch_bwd(q, k, v, do, num_heads, seq_len, biases, exact, entry=None,
                plan: Optional[BwdPlan] = None):
    """Runs the backward kernels. `plan`: the bf16 kernels' launch,
    bwd_plan's by default (the deferred entry: bwd_split_plan's;
    tools/flash_bench.py times the others)."""
    rows, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_memory(name, x, q)
    ptrs = _bias_pointers(biases, q)
    batch, hd = rows // seq_len, d // num_heads
    if q.dtype != torch.bfloat16:
        plan = None   # the fp32 twin takes no plan
    elif plan is None:
        plan = (bwd_split_plan(seq_len, hd) if entry == _BWD_DEFERRED_ENTRY
                else bwd_plan(seq_len, hd))
    grads = torch.empty((3, rows, d), dtype=q.dtype, device=q.device)
    stats, partial, dbias = _bwd_scratch(q, num_heads, seq_len,
                                         biases is not None, plan)
    _call(bwd_library(), entry or _BWD_ENTRY[q.dtype], q,
          "fused attention backward kernel",
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *ptrs,
          grads[0].data_ptr(), grads[1].data_ptr(), grads[2].data_ptr(),
          *(None if x is None else x.data_ptr()
            for x in (stats, partial, dbias)),
          batch, seq_len, num_heads, hd, *(plan or ()), hd ** -0.5,
          int(bool(exact)))
    if dbias is None:
        return (*grads.unbind(0), None, None, None)
    return (*grads.unbind(0), *dbias.unbind(0))
