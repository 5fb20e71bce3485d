"""The frozen arithmetic: FLOP counts, roofline bounds, the trace's union
of intervals."""

import os

import pytest
import torch

from perfbench import flops, harness, roofline, trace

CONFIGS = os.path.join(harness.ROOT, "perfbench", "configs")
H14 = harness.load_json(os.path.join(CONFIGS, "clipa_v2_h14.json"))
L16 = harness.load_json(os.path.join(CONFIGS, "clipa_l16.json"))


def test_encoder_by_hand():
    # one block, L 2, D 4, M 8: 8*2*16 + 4*2*4*8 + 4*4*4 = 256+256+64
    assert flops.encoder(2, 4, 1, 8) == 576.0


def test_cells_by_hand():
    # H/14 @84: 36 patches, 37 tokens; per block 8*37*1280^2 +
    # 4*37*1280*5120 + 4*37^2*1280
    block = 8 * 37 * 1280 ** 2 + 4 * 37 * 1280 * 5120 + 4 * 37 ** 2 * 1280
    img = 2 * 36 * 588 * 1280 + 32 * block + 2 * 1280 * 1024
    assert flops.image_forward(H14, 84) == img
    txt_block = 8 * 8 * 1024 ** 2 + 4 * 8 * 1024 * 4096 + 4 * 64 * 1024
    txt = 24 * txt_block + 2 * 1024 * 1024
    assert flops.text_forward(H14, 8) == txt
    per_pair = flops.train_step_per_pair(H14, 84, 8, 1024)
    assert per_pair == 3 * (img + txt + 2 * 1024 * 1024)
    assert 155e9 < per_pair < 156e9          # 155 GFLOP a pair
    # H/14 @224 serving: 256 patches, 257 tokens: 334 GFLOP an image
    assert 334e9 < flops.image_forward(H14, 224) < 335e9
    # L/16 @112: 49 patches, 50 tokens
    block = 8 * 50 * 1024 ** 2 + 4 * 50 * 1024 * 4096 + 4 * 50 ** 2 * 1024
    assert flops.image_forward(L16, 112) == (
        2 * 49 * 768 * 1024 + 24 * block + 2 * 1024 * 768)


def test_masking_counts_kept_tokens_only():
    full = flops.image_forward(H14, 224)
    masked = flops.image_forward(H14, 224, mask_ratio=0.3)
    kept = int(256 * 0.7)
    block = (8 * (kept + 1) * 1280 ** 2 + 4 * (kept + 1) * 1280 * 5120
             + 4 * (kept + 1) ** 2 * 1280)
    assert masked == 2 * kept * 588 * 1280 + 32 * block + 2 * 1280 * 1024
    assert masked < full


@pytest.mark.parametrize("variant,res,tokens", [("Ti/16", 32, 8),
                                                ("S/16", 48, 16)])
def test_against_the_ports_flop_counter(variant, res, tokens):
    """perfbench/flops.py against the port's FlopCounterMode count of the
    forward (tools/flops.py) at tiny sizes."""
    from clipa_tpu_torch.models import two_towers, text, vit
    from clipa_tpu_torch.tools import flops as port_flops
    v, t = vit.decode_variant(variant), text.decode_variant(variant[:2]
                                                              .rstrip("/"))
    kw = dict(image={"variant": variant, "pool_type": "gap",
                     "posemb": "sincos2d", "image_size": (res, res)},
              text={"variant": variant.split("/")[0], "pool_type": "last",
                    "vocab_size": 32000, "context_length": tokens},
              out_dim=96, temperature_init=1 / 0.07)
    with torch.device("meta"):
        model = two_towers.Model(**kw)
    got = port_flops.analyze(model, (1, res, res, 3), (1, tokens))
    cfg = {"image": {"width": v["width"], "depth": v["depth"],
                     "mlp_dim": v["mlp_dim"], "patch_size": 16},
           "text": {"width": t["width"], "depth": t["depth"],
                    "mlp_dim": t["mlp_dim"]}, "embed_dim": 96}
    mine = flops.image_forward(cfg, res) + flops.text_forward(cfg, tokens)
    assert mine == pytest.approx(got["fwd_gflops"] * 1e9, rel=1e-9)


def _reader(name):
    return harness.load_module(os.path.join(
        harness.ROOT, "perfbench", "metrics", name + ".py"), "r_" + name)


@pytest.mark.parametrize("shape", [(1024, 37, 1280), (384, 50, 1024),
                                   (256, 257, 1280), (8, 577, 64)])
@pytest.mark.parametrize("slow", [1.0, 1.5])
def test_a_kernel_at_its_bound_reads_100(shape, slow):
    """The attention readers read 100% where every launch took exactly its
    bound, and less where the kernels took longer: never above 100."""
    b, l, d = shape
    fwd = roofline.bound_s(*roofline.attention_fwd(b, l, d)) * 1e6 * slow
    bwd = roofline.bound_s(*roofline.attention_bwd(b, l, d)) * 1e6 * slow
    kernels, t = [], 0.0
    for _ in range(3):
        kernels += [("fused_attention_fwd_kernel", t, t + fwd),
                    ("fused_attention_fwd_kernel", t + fwd, t + 2 * fwd),
                    ("sm90_gemm", t, t + 9.0),
                    ("fused_attention_bwd_whole", t + 2 * fwd,
                     t + 2 * fwd + bwd)]
        t += 2 * fwd + bwd
    run = {"kind": "train", "trace": {"kernels": kernels},
           "launches": {"fused_attention": 6, "fused_attention_bwd": 3},
           "attention": {"batch": b, "seq": l, "width": d}}
    share = _reader("attn_roofline.train").read(run)
    assert share == pytest.approx(100.0 / slow, rel=1e-9)
    run = {"kind": "embed", "trace": {"kernels": kernels[:2]},
           "launches": {"fused_attention": 2},
           "attention": {"batch": b, "seq": l, "width": d}}
    assert _reader("attn_roofline.embed").read(run) == pytest.approx(
        100.0 / slow, rel=1e-9)


def test_readers_with_nothing_to_read():
    for name in ("attn_roofline.train", "attn_roofline.embed",
                 "train.idle_share", "embed.idle_share", "train.mfu",
                 "embed.mfu", "train.peak_gib"):
        assert _reader(name).read({"kind": "train", "trace": None,
                                   "launches": {}}) is None, name


def test_mfu_and_idle():
    # 3 steps of 1024 pairs traced, 1.5 s busy; untraced 1500 pairs/s:
    # 0.4883 s busy per step of 0.6827 s
    run = {"kind": "train", "flops_per_item": 155e9, "rate": 1500.0,
           "traced_items": 3072,
           "trace": {"busy_s": 1.5, "window_s": 3.0, "kernels": []}}
    assert _reader("train.mfu").read(run) == pytest.approx(
        100 * 155e9 * 1500 / 989e12)
    assert _reader("train.idle_share").read(run) == pytest.approx(
        100 * (1 - 1.5 / 3072 * 1500))
    assert _reader("embed.idle_share").read(run) is None


def test_bytes_count_each_operand_once():
    nbytes, fl = roofline.attention_fwd(2, 3, 8, bias=True)
    assert nbytes == 2 * (4 * 2 * 3 * 8 + 3 * 8)
    assert fl == 4 * 2 * 9 * 8
    nbytes, fl = roofline.attention_bwd(2, 3, 8, bias=False)
    assert nbytes == 2 * 7 * 2 * 3 * 8 and fl == 10 * 2 * 9 * 8


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 12)]
    assert trace.union_us(iv) == 3 + 1 + 2
    assert trace.union_us([]) == 0
    assert trace.gaps(iv, -1, 13) == [(-1, 0), (3, 5), (6, 10), (12, 13)]


def test_families():
    assert trace.family("fused_attention_fwd_kernel<1>") == "attention kernel"
    assert trace.family("attention_bwd_long") == "attention bwd kernel"
    assert trace.family("sm90_xmma_gemm_bf16") == "gemm"
    assert trace.family("vectorized_layer_norm_kernel") == "layernorm"
    assert trace.family("Memcpy HtoD (Pinned -> Device)") == (
        "host<->device copy")
    assert trace.family("something else") == "other"
