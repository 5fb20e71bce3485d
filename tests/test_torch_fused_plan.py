"""The fused attention's launch plans (``block_attention.fwd_plan`` and
``bwd_plan``), on the CPU.

The bf16 forward (``csrc/fused_attention_fwd.cu``) spreads the 16-row query
strips of each (sample, head) over ``blocks`` blocks of ``warps`` warps and
streams K and V through a ring of ``stages`` 128-key tiles; the bf16
backward (``csrc/fused_attention_bwd.cu``) takes one (sample, head) per
work item of a persistent kernel, one warp per 16-row strip (the
whole-head scheme), or two kernels over 64-row tiles (the split scheme).
Their entry points take the plans' numbers and refuse a shared-memory size
that is not their layout's (the card tests hold the two together). Here:
the plans cover every strip once, idle no warp at the image towers'
lengths where the strips allow it, fit an H100 block's shared memory, and
reach the entry points through the wrappers.
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
    public wrapper on the kernel branch hands the bf16 entry fwd_plan's
    (warps, blocks, smem, stages) after the dimensions, then the scale and
    the mode, and the fp32 twin no plan; a plan given to _launch replaces
    fwd_plan's."""
    seen = []
    monkeypatch.setattr(block_attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(block_attention, "fwd_library", lambda: "fwd")
    monkeypatch.setattr(block_attention, "_call",
                        lambda lib, entry, like, what, *args:
                        seen.append((lib, entry, args)))
    b, l, h, hd = 2, 257, 4, 80
    d = h * hd
    q, k, v = (torch.zeros(b * l, d, dtype=dtype) for _ in range(3))
    biases = tuple(torch.zeros(d, dtype=dtype) for _ in range(3)) \
        if bias else None
    before = block_attention.fused_attention.launches
    out = block_attention.fused_attention(q, k, v, h, l, biases, exact)
    assert block_attention.fused_attention.launches == before + 1
    ((lib, entry, args),) = seen
    assert (lib, entry) == ("fwd", block_attention._ENTRY[dtype])
    ptrs = [None] * 3 if biases is None else [x.data_ptr() for x in biases]
    assert list(args[:7]) == [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              *ptrs, out.data_ptr()]
    plan = tuple(block_attention.fwd_plan(l, hd)) \
        if dtype == torch.bfloat16 else ()
    assert args[7:] == (b, l, h, hd, *plan, hd ** -0.5, int(exact))
    if dtype == torch.bfloat16:
        other = block_attention.fwd_candidates(l, hd)[0]
        assert other != block_attention.fwd_plan(l, hd)
        block_attention._launch(q, k, v, h, l, biases, exact, plan=other)
        assert seen[-1][2][11:15] == tuple(other)


# --- the backward's launch plan (block_attention.bwd_plan) -----------------

# the pretrain lengths (L/16 @112: 50; H/14 @84: 37), the fine-tune `auto`
# route's 138, the serving lengths, and the 16-row chunk and 64-row tile
# boundaries around them
BWD_LENGTHS = [15, 16, 17, 33, 37, 48, 49, 50, 63, 64, 65, 138, 257, 577]


def _bwd_owners(plan, seq_len):
    """How often each 16-row strip is owned, by the kernels' rule: the
    whole-head scheme's warp w owns query strip w (phase 1) and key strip w
    (phase 2) of its item; the split scheme's block x of ceil(L / 64), warp
    w, owns strip 4 x + w where that is below ceil(L / 16) (dq kernel over
    query strips, dk/dv kernel over key strips alike)."""
    strips = -(-seq_len // 16)
    owners = [0] * strips
    if plan.whole:
        for w in range(plan.warps):
            owners[w] += 1
    else:
        for x in range(-(-seq_len // 64)):
            for w in range(plan.warps):
                if 4 * x + w < strips:
                    owners[4 * x + w] += 1
    return owners


@pytest.mark.parametrize("hd", [8, 64, 80, 104, 128])
@pytest.mark.parametrize("l", BWD_LENGTHS)
def test_bwd_plan_covers_every_strip_once(l, hd):
    plan = block_attention.bwd_plan(l, hd)
    strips = -(-l // 16)
    assert plan in block_attention.bwd_candidates(l, hd)
    for p in block_attention.bwd_candidates(l, hd):
        assert _bwd_owners(p, l) == [1] * strips
        if p.whole:
            # one warp per strip, no dk/dv size
            assert p.warps == strips <= block_attention.BWD_MAX_CHUNKS
            assert p.whole == 1 and p.smem_dkv == 0
        else:
            assert p == block_attention.bwd_split_plan(l, hd)
    # the split scheme, the deferred variant's only one, is always there
    assert block_attention.bwd_candidates(l, hd)[-1].whole == 0
    # the whole-head scheme wherever it is offered
    assert plan == block_attention.bwd_candidates(l, hd)[0]


def test_bwd_plan_at_the_main_path_lengths():
    """The pretrain shapes take the whole-head scheme: L = 50 at hd 64
    (L/16 @112, four warps) and L = 37 at hd 80 (H/14 @84, three); past
    BWD_MAX_CHUNKS chunks (the serving length 257) only the split scheme
    is left."""
    for l, hd, warps in ((50, 64, 4), (37, 80, 3)):
        plan = block_attention.bwd_plan(l, hd)
        assert plan.whole == 1 and plan.warps == warps
    assert block_attention.bwd_plan(138, 64).whole == 1
    assert block_attention.bwd_plan(257, 80).whole == 0
    assert block_attention.bwd_plan(
        16 * block_attention.BWD_MAX_CHUNKS + 1, 64).whole == 0


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_bwd_plan_fits_shared_memory(hd):
    """Every candidate at every length from 1 to 577 stays within an H100
    block's 227 KB; the whole-head block (round16(L) rows of Q, dO and (K
    and V, then P and dsb), then the warps' column sums) is offered at
    every length of at most BWD_MAX_CHUNKS chunks and grows with L; the
    split scheme's size does not depend on L."""
    split = block_attention.bwd_split_plan(1, hd)
    last = 0
    for l in range(1, 578):
        cands = block_attention.bwd_candidates(l, hd)
        assert cands[-1] == split
        whole = [p for p in cands if p.whole]
        fits = -(-l // 16) <= block_attention.BWD_MAX_CHUNKS
        assert len(whole) == int(fits), (l, hd)
        if whole:
            assert whole[0].smem >= last
            last = whole[0].smem
        for p in cands:
            assert 0 < p.smem <= flash_attention.SMEM_LIMIT
            assert 0 <= p.smem_dkv <= flash_attention.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l", [50, 257])
@pytest.mark.parametrize("bias,exact", [(True, False), (False, True)])
def test_bwd_plan_reaches_the_entry_point(monkeypatch, dtype, l, bias,
                                          exact):
    """With stand-in launches (the entry point recorded, not called), the
    public backward on the kernel branch hands the bf16 entry bwd_plan's
    (whole, warps, smem, smem_dkv) after the dimensions, then the scale
    and the mode, and the fp32 twin no plan; the row statistics scratch
    only to the split scheme (and the fp32 twin), the bias-grad partials
    and dbias only with biases; the deferred entry takes the split plan,
    and a plan given to _launch_bwd replaces bwd_plan's."""
    seen = []
    monkeypatch.setattr(block_attention, "_uses_kernel", lambda x: True)
    monkeypatch.setattr(block_attention, "bwd_library", lambda: "bwd")
    monkeypatch.setattr(block_attention, "_call",
                        lambda lib, entry, like, what, *args:
                        seen.append((lib, entry, args)))
    b, h, hd = 2, 4, 64
    d = h * hd
    q, k, v, do = (torch.zeros(b * l, d, dtype=dtype) for _ in range(4))
    biases = tuple(torch.zeros(d, dtype=dtype) for _ in range(3)) \
        if bias else None
    before = block_attention.fused_attention_bwd.launches
    block_attention.fused_attention_bwd(q, k, v, do, h, l, biases, exact)
    assert block_attention.fused_attention_bwd.launches == before + 1
    ((lib, entry, args),) = seen
    assert (lib, entry) == ("bwd", block_attention._BWD_ENTRY[dtype])
    ptrs = [None] * 3 if biases is None else [x.data_ptr() for x in biases]
    assert list(args[:7]) == [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), *ptrs]
    stats, partial, dbias = args[10:13]
    plan = block_attention.bwd_plan(l, hd)
    split = dtype == torch.float32 or not plan.whole
    assert (stats is not None) == split
    assert (partial is not None) == (bias and dtype == torch.bfloat16)
    assert (dbias is not None) == bias
    want = tuple(plan) if dtype == torch.bfloat16 else ()
    assert args[13:] == (b, l, h, hd, *want, hd ** -0.5, int(exact))
    if dtype == torch.float32:
        return
    block_attention.fused_attention_bwd_deferred(q, k, v, do, h, l, biases,
                                                 exact)
    assert seen[-1][1] == block_attention._BWD_DEFERRED_ENTRY
    assert seen[-1][2][17:21] == tuple(block_attention.bwd_split_plan(l, hd))
    assert seen[-1][2][10] is not None   # the split scheme's statistics
    for other in block_attention.bwd_candidates(l, hd):
        block_attention._launch_bwd(q, k, v, do, h, l, biases, exact,
                                    plan=other)
        assert seen[-1][2][17:21] == tuple(other)
        assert (seen[-1][2][10] is None) == bool(other.whole)
