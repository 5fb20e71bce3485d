"""The fused attention forward's launch plan (``block_attention.fwd_plan``),
on the CPU.

The bf16 kernel (``csrc/fused_attention_fwd.cu``) spreads the 16-row query
strips of each (sample, head) over ``blocks`` blocks of ``warps`` warps and
streams K and V through a ring of ``stages`` 128-key tiles; its entry point
takes the plan's numbers and refuses a shared-memory size that is not its
layout's (the card tests hold the two together). Here: the plan covers
every strip once, idles no warp at the image towers' lengths where the
strips allow it, fits an H100 block's shared memory, and reaches the entry
point through the wrapper.
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
