"""The fused attention's launch plans (``block_attention.fwd_plan`` and
``bwd_plan``), on the CPU.

The forward (``csrc/fused_attention_fwd.cu``) spreads the 16-row query
strips of each (sample, head) over ``blocks`` blocks of ``warps`` warps and
streams K and V through a ring of ``stages`` 128-key tiles; the backward
(``csrc/fused_attention_bwd.cu``) takes one (sample, head) per work item of
a persistent kernel, one warp per 16-row strip (the whole-head scheme,
L <= 144), or two kernels whose strips spread over blocks as the forward's
do, the other operands through a ring of 128-row tiles (the long scheme,
past 144); the deferred variant takes the whole-head scheme's deferred
form and no longer L (``bwd_deferred_plan``). The kernels take bf16
operands and refuse any other dtype before a launch.
Their entry points take the plans' numbers and refuse a shared-memory size
that is not their layout's (the card tests hold the two together). Here:
the plans cover every strip once, idle no warp at the image towers'
lengths where the strips allow it, fit an H100 block's shared memory, and
reach the entry points through the wrappers (fp32 operands none).
"""

import pytest
import torch

from clipa_tpu_torch.ops import block_attention, flash_attention

# the image towers' lengths (L/16 @112, @224 with mask 0.3, H/14 @224,
# @336) and the strip, chunk and tile boundaries around them
LENGTHS = [50, 138, 257, 577, 33, 48, 49, 63, 64, 65, 127, 128, 129, 255,
           256, 272, 273, 384, 385]


def _owners(plan, strips):
    owners = [0] * strips
    for bx in range(plan.blocks):
        first, end = flash_attention.strip_range(strips, plan.blocks, bx)
        assert 1 <= end - first <= plan.warps
        for s in range(first, end):
            owners[s] += 1
    return owners


@pytest.mark.parametrize("hd", [8, 64, 80, 104, 128])
@pytest.mark.parametrize("l", LENGTHS)
def test_fwd_plan_covers_every_strip_once(l, hd):
    plan = block_attention.fwd_plan(l, hd)
    strips = -(-l // 16)
    tiles = -(-l // block_attention.FWD_BLOCK_K)
    assert _owners(plan, strips) == [1] * strips
    assert 1 <= plan.warps <= (12 if -(-hd // 16) * 16 <= 80 else 8)
    # a ring of two or more tiles, or one that holds every key
    assert 1 <= plan.stages <= block_attention.FWD_MAX_STAGES
    assert plan.stages >= 2 or tiles == 1
    assert plan in block_attention.fwd_candidates(l, hd)


def test_fwd_plan_at_the_main_path_lengths():
    """L = 50 (pretrain, hd 64) and 138 (fine-tune `auto`, hd 64): every
    warp of every block owns a strip. L = 257 (serving, hd 80): its 17
    strips are a prime count, so blocks of at most 12 warps leave one warp
    idle per (sample, head), and no more: 3 blocks of 6, every key in the
    ring (272 rows, three tiles in flight, no refill barrier)."""
    for l, warps, blocks in ((50, 4, 1), (138, 3, 3)):
        plan = block_attention.fwd_plan(l, 64)
        assert plan[:2] == (warps, blocks)
        strips = -(-l // 16)
        assert warps * blocks == strips
        for bx in range(blocks):
            first, end = flash_attention.strip_range(strips, blocks, bx)
            assert end - first == warps
    plan = block_attention.fwd_plan(257, 80)
    assert plan == (6, 3, (6 * 16 + 2 * 272) * (80 + 8) * 2, 3)
    assert plan.warps * plan.blocks - 17 == 1
    # past what the ring can hold at two blocks per SM: two stages
    assert block_attention.fwd_plan(577, 80).stages == 2


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_fwd_plan_fits_shared_memory(hd):
    """Every candidate at every length from 33 to 577 stays within an H100
    block's 227 KB, and its size is the kernel's layout: the Q strips, then
    the K and V rings of min(stages x 128, round16(L)) rows, (round16(hd) +
    8) bf16 each."""
    row = (-(-hd // 16) * 16 + 8) * 2
    for l in range(33, 578):
        cands = block_attention.fwd_candidates(l, hd)
        assert cands
        for p in cands:
            ring = min(p.stages * 128, -(-l // 16) * 16)
            assert p.smem == (p.warps * 16 + 2 * ring) * row
            assert 0 < p.smem <= flash_attention.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias,exact", [(True, False), (False, True)])
def test_plan_reaches_the_entry_point(monkeypatch, dtype, bias, exact):
    """With stand-in launches (the entry point recorded, not called), the
    public wrapper on the kernel branch hands the entry fwd_plan's (warps,
    blocks, smem, stages) after the dimensions, then the scale and the
    mode, and a plan given to _launch replaces fwd_plan's; fp32 operands
    are refused there (TypeError) before they reach the entry, and count
    no launch."""
    seen = []
    monkeypatch.setattr(block_attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(block_attention, "fwd_library", lambda: "fwd")
    monkeypatch.setattr(block_attention, "_call",
                        lambda lib, entry, like, what, *args:
                        seen.append((lib, entry, args)))
    b, l, h, hd = 2, 257, 4, 80
    d = h * hd
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b * l, d, generator=gen).to(dtype)
               for _ in range(3))
    biases = tuple(torch.randn(d, generator=gen).to(dtype)
                   for _ in range(3)) if bias else None
    before = block_attention.fused_attention.launches
    if dtype == torch.float32:
        with pytest.raises(TypeError, match="q is torch.float32; the CUDA "
                           "kernels take q, k, v, do and biases all bfloat16"):
            block_attention.fused_attention(q, k, v, h, l, biases, exact)
        assert seen == []
        assert block_attention.fused_attention.launches == before
        return
    out = block_attention.fused_attention(q, k, v, h, l, biases, exact)
    assert block_attention.fused_attention.launches == before + 1
    ((lib, entry, args),) = seen
    assert (lib, entry) == ("fwd", block_attention._ENTRY)
    ptrs = [None] * 3 if biases is None else [x.data_ptr() for x in biases]
    assert list(args[:7]) == [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              *ptrs, out.data_ptr()]
    plan = tuple(block_attention.fwd_plan(l, hd))
    assert args[7:] == (b, l, h, hd, *plan, hd ** -0.5, int(exact))
    other = block_attention.fwd_candidates(l, hd)[0]
    assert other != block_attention.fwd_plan(l, hd)
    block_attention._launch(q, k, v, h, l, biases, exact, plan=other)
    assert seen[-1][2][11:15] == tuple(other)


# --- the backward's launch plan (block_attention.bwd_plan) -----------------

# the pretrain lengths (L/16 @112: 50; H/14 @84: 37), the fine-tune `auto`
# route's 138, the H/14 fine-tune lengths (180 at 224 px, mask 0.3; 346 at
# 336 px, mask 0.4), the serving lengths, and the 16-row chunk, 64-row,
# 144-row scheme and 128-row ring-tile boundaries around them
BWD_LENGTHS = [15, 16, 17, 33, 37, 48, 49, 50, 63, 64, 65, 138, 257, 577,
               144, 145, 180, 256, 346, 385]


def _bwd_owners(plan, seq_len):
    """How often each 16-row strip is owned, by the kernels' rule: the
    whole-head scheme's warp w owns query strip w (phase 1) and key strip w
    (phase 2) of its item; the long scheme's block x of `blocks`, warp w,
    owns strip strip_range(...).x + w while below its end (dq kernel over
    query strips, dk/dv kernel over key strips alike)."""
    strips = -(-seq_len // 16)
    owners = [0] * strips
    if plan.scheme == block_attention.BWD_WHOLE:
        for w in range(plan.warps):
            owners[w] += 1
    else:
        assert plan.scheme == block_attention.BWD_LONG
        for bx in range(plan.blocks):
            first, end = flash_attention.strip_range(strips, plan.blocks, bx)
            assert 1 <= end - first <= plan.warps
            for s in range(first, end):
                owners[s] += 1
    return owners


@pytest.mark.parametrize("hd", [8, 64, 80, 104, 128])
@pytest.mark.parametrize("l", BWD_LENGTHS)
def test_bwd_plan_covers_every_strip_once(l, hd):
    plan = block_attention.bwd_plan(l, hd)
    strips = -(-l // 16)
    assert plan in block_attention.bwd_candidates(l, hd)
    for p in block_attention.bwd_candidates(l, hd):
        assert _bwd_owners(p, l) == [1] * strips
        if p.scheme == block_attention.BWD_WHOLE:
            # one warp per strip, one block per item, no ring, no dk/dv size
            assert p.warps == strips <= block_attention.BWD_MAX_CHUNKS
            assert (p.blocks, p.stages, p.smem_dkv) == (1, 0, 0)
        else:
            assert p.scheme == block_attention.BWD_LONG
            assert p in block_attention.bwd_long_candidates(l, hd)
    # the whole-head scheme wherever it is offered, else the long scheme
    first = block_attention.bwd_candidates(l, hd)[0]
    if first.scheme == block_attention.BWD_WHOLE:
        assert plan == first
    else:
        assert plan.scheme == block_attention.BWD_LONG


def test_bwd_plan_at_the_main_path_lengths():
    """The pretrain shapes take the whole-head scheme: L = 50 at hd 64
    (L/16 @112, four warps) and L = 37 at hd 80 (H/14 @84, three); past
    BWD_MAX_CHUNKS chunks (the serving length 257) the long scheme. At the
    H/14 fine-tune lengths: L = 180 (224 px, mask 0.3) two blocks of 6
    warps per (sample, head), two resident per SM, every key in the ring
    (192 rows: no refill barrier); L = 346 (336 px, mask 0.4) two blocks of
    11 warps, the ring of every key (352 rows, three tiles)."""
    for l, hd, warps in ((50, 64, 4), (37, 80, 3)):
        plan = block_attention.bwd_plan(l, hd)
        assert plan.scheme == block_attention.BWD_WHOLE
        assert plan.warps == warps
    assert block_attention.bwd_plan(138, 64).scheme == \
        block_attention.BWD_WHOLE
    assert block_attention.bwd_plan(257, 80).scheme == \
        block_attention.BWD_LONG
    assert block_attention.bwd_plan(
        16 * block_attention.BWD_MAX_CHUNKS + 1, 64).scheme == \
        block_attention.BWD_LONG
    assert block_attention.bwd_plan(180, 80)[:4] == (2, 6, 2, 2)
    assert block_attention.bwd_plan(346, 80)[:4] == (2, 11, 2, 3)


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_bwd_plan_fits_shared_memory(hd):
    """Every candidate at every length from 1 to 577 stays within an H100
    block's 227 KB; the whole-head block (round16(L) rows of Q, dO and (K
    and V, then P and dsb), then the warps' column sums) is offered at
    every length of at most BWD_MAX_CHUNKS chunks and grows with L."""
    last = 0
    for l in range(1, 578):
        cands = block_attention.bwd_candidates(l, hd)
        whole = [p for p in cands if p.scheme == block_attention.BWD_WHOLE]
        fits = -(-l // 16) <= block_attention.BWD_MAX_CHUNKS
        assert len(whole) == int(fits), (l, hd)
        if whole:
            assert whole[0].smem >= last
            last = whole[0].smem
        for p in cands:
            assert 0 < p.smem <= flash_attention.SMEM_LIMIT
            assert 0 <= p.smem_dkv <= flash_attention.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l", [50, 180, 257, 346])
@pytest.mark.parametrize("bias,exact", [(True, False), (False, True)])
def test_bwd_plan_reaches_the_entry_point(monkeypatch, dtype, l, bias,
                                          exact):
    """With stand-in launches (the entry point recorded, not called), the
    public backward on the kernel branch hands the entry bwd_plan's
    (scheme, warps, blocks, stages, smem, smem_dkv) after the dimensions,
    then the scale and the mode; the row statistics scratch
    only to the long scheme, the bias-grad partials and dbias only with
    biases; the deferred entry takes bwd_deferred_plan's (the whole-head
    scheme at L = 50, no statistics) and refuses L past 144 before any
    launch, and a plan given to _launch_bwd replaces bwd_plan's. fp32
    operands are refused by both entries (TypeError) before they reach
    one, and count no launch."""
    seen = []
    monkeypatch.setattr(block_attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(block_attention, "bwd_library", lambda: "bwd")
    monkeypatch.setattr(block_attention, "_call",
                        lambda lib, entry, like, what, *args:
                        seen.append((lib, entry, args)))
    b, h, hd = 2, 4, 64
    d = h * hd
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(b * l, d, generator=gen).to(dtype)
                   for _ in range(4))
    biases = tuple(torch.randn(d, generator=gen).to(dtype)
                   for _ in range(3)) if bias else None
    before = block_attention.fused_attention_bwd.launches
    deferred0 = block_attention.fused_attention_bwd_deferred.launches
    if dtype == torch.float32:
        for bwd in (block_attention.fused_attention_bwd,
                    block_attention.fused_attention_bwd_deferred):
            with pytest.raises(TypeError, match="q is torch.float32; the "
                               "CUDA kernels take q, k, v, do and biases all "
                               "bfloat16"):
                bwd(q, k, v, do, h, l, biases, exact)
        assert seen == []
        assert block_attention.fused_attention_bwd.launches == before
        assert block_attention.fused_attention_bwd_deferred.launches == \
            deferred0
        return
    grads = block_attention.fused_attention_bwd(q, k, v, do, h, l, biases,
                                                exact)
    assert block_attention.fused_attention_bwd.launches == before + 1
    ((lib, entry, args),) = seen
    assert (lib, entry) == ("bwd", block_attention._BWD_ENTRY)
    ptrs = [None] * 3 if biases is None else [x.data_ptr() for x in biases]
    assert list(args[:7]) == [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), *ptrs]
    stats, partial, dbias = args[10:13]
    plan = block_attention.bwd_plan(l, hd)
    assert plan.scheme == (block_attention.BWD_WHOLE if l <= 144
                           else block_attention.BWD_LONG)
    assert (stats is not None) == (plan.scheme == block_attention.BWD_LONG)
    assert (partial is not None) == bias
    assert (dbias is not None) == bias
    assert args[13:] == (b, l, h, hd, *plan, hd ** -0.5, int(exact))
    if l > 144:
        with pytest.raises(ValueError, match="deferred backward takes"):
            block_attention.fused_attention_bwd_deferred(q, k, v, do, h, l,
                                                         biases, exact)
        assert len(seen) == 1
        assert block_attention.fused_attention_bwd_deferred.launches == \
            deferred0
    else:
        block_attention.fused_attention_bwd_deferred(q, k, v, do, h, l,
                                                     biases, exact)
        assert seen[-1][1] == block_attention._BWD_DEFERRED_ENTRY
        deferred = block_attention.bwd_deferred_plan(l, hd)
        assert deferred == plan
        assert seen[-1][2][17:23] == tuple(deferred)
        assert seen[-1][2][10] is None   # the whole-head scheme: no stats
        assert block_attention.fused_attention_bwd_deferred.launches == \
            deferred0 + 1
    for other in block_attention.bwd_candidates(l, hd):
        block_attention._launch_bwd(q, k, v, do, h, l, biases, exact,
                                    plan=other)
        assert seen[-1][2][17:23] == tuple(other)
        assert (seen[-1][2][10] is None) == (
            other.scheme == block_attention.BWD_WHOLE)


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_bwd_plan_takes_the_long_scheme_past_144(hd):
    """bwd_plan gives the whole-head scheme at every L up to 16 x
    BWD_MAX_CHUNKS = 144 and the long scheme at every L from 145 to 577 (the
    longest CLIPA image tower: H/14 and L/14 at 336 px unmasked)."""
    for l in range(1, 578):
        plan = block_attention.bwd_plan(l, hd)
        want = (block_attention.BWD_WHOLE if l <= 16 * block_attention
                .BWD_MAX_CHUNKS else block_attention.BWD_LONG)
        assert plan.scheme == want, (l, hd, plan)


@pytest.mark.parametrize("hd", [8, 64, 72, 80, 104, 128])
def test_bwd_long_plans_cover_every_strip_once_and_fit(hd):
    """Every long-scheme candidate at every length from 1 to 577: its
    blocks cover each 16-row strip once (both kernels spread the strips
    alike), no block wider than _max_warps(hd) warps; its ring two or more
    128-row tiles, or one that holds every row; and its two kernels'
    shared memory the layout's (the strips' two operands and the two rings
    in bf16 rows of round16(hd) + 8, then the dq kernel's per-warp column
    sums, the dk/dv kernel's ring statistics and two sets of column sums),
    within an H100 block's 227 KB."""
    hdp = -(-hd // 16) * 16
    row = (hdp + 8) * 2
    max_warps = 12 if hdp <= 80 else 8
    for l in range(1, 578):
        strips, tiles = -(-l // 16), -(-l // 128)
        cands = block_attention.bwd_long_candidates(l, hd)
        assert cands, (l, hd)
        for p in cands:
            assert p.scheme == block_attention.BWD_LONG
            assert _bwd_owners(p, l) == [1] * strips
            assert 1 <= p.warps <= max_warps
            assert 1 <= p.stages <= block_attention.BWD_MAX_STAGES
            assert p.stages >= 2 or tiles == 1
            ring = min(p.stages * 128, strips * 16)
            strip_rows = (2 * p.warps * 16 + 2 * ring) * row
            assert p.smem == strip_rows + p.warps * hdp * 4
            assert p.smem_dkv == strip_rows + (2 * ring
                                               + 2 * p.warps * hdp) * 4
            assert max(p.smem, p.smem_dkv) <= flash_attention.SMEM_LIMIT


@pytest.mark.parametrize("l,scheme", [(50, 1), (180, 2), (346, 2), (144, 1)])
@pytest.mark.parametrize("bias", [True, False])
def test_bwd_scratch_follows_the_plan(l, scheme, bias):
    """The scratch the wrapper hands the entry point: the long scheme's
    dk/dv kernel reads two fp32 statistics per (row, head) (lse2, delta),
    the whole-head scheme none (L = 144: its last length); with biases, one
    fp32 partial column sum of each of dq, dk and dv per (sample, block) of
    the plan, and the three bias grads."""
    b, h, hd = 3, 4, 80
    q = torch.zeros(b * l, h * hd, dtype=torch.bfloat16)
    plan = block_attention.bwd_plan(l, hd)
    assert plan.scheme == scheme
    stats, partial, dbias = block_attention._bwd_scratch(q, h, l, bias, plan)
    n_stats = {1: 0, 2: 2}[scheme]
    assert (stats is None) == (n_stats == 0)
    if stats is not None:
        assert stats.shape == (n_stats, b * l * h)
        assert stats.dtype == torch.float32
    assert (partial is None) == (not bias)
    if bias:
        assert partial.shape == (3, b * plan.blocks, h * hd)
        assert partial.dtype == torch.float32
        assert dbias.shape == (3, h * hd) and dbias.dtype == q.dtype


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_bwd_deferred_plan_is_whole_head_to_144_then_refused(hd):
    """The deferred entry's plan: at every L up to 16 x BWD_MAX_CHUNKS =
    144 the whole-head scheme, the same launch as the normalized entry's
    (its deferred form shares the layout), every strip covered once, within
    an H100 block's 227 KB; pure and cached. From 145 to 577 it raises:
    the entry takes no other scheme."""
    for l in range(1, 578):
        if l > 16 * block_attention.BWD_MAX_CHUNKS:
            with pytest.raises(ValueError, match=f"got L = {l} "):
                block_attention.bwd_deferred_plan(l, hd)
            continue
        plan = block_attention.bwd_deferred_plan(l, hd)
        assert plan is block_attention.bwd_deferred_plan(l, hd)
        assert plan.scheme == block_attention.BWD_WHOLE
        assert plan == block_attention.bwd_plan(l, hd)
        assert _bwd_owners(plan, l) == [1] * -(-l // 16)
        assert 0 < plan.smem <= flash_attention.SMEM_LIMIT
        assert plan.smem_dkv == 0


def test_bwd_deferred_plan_at_the_sweep_shape():
    """tools/attn_sweep.py's shape (L = 50, hd 64): four warps of the
    whole-head scheme, one (sample, head) per block, no ring, the block's
    Q and dO, K and V (then bf16(e) and dsb) and three sets of column sums
    in 39936 bytes."""
    plan = block_attention.bwd_deferred_plan(50, 64)
    assert plan == block_attention.BwdPlan(block_attention.BWD_WHOLE, 4, 1,
                                           0, 39936, 0)
