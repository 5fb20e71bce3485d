"""clipa_tpu_torch on a CUDA device: the kernel against its plain version.

These tests need a card (a CUDA kernel has no CPU mode) and skip without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The tolerance is the kernel's stated one (``block_attention.tolerance``:
about one bf16 ulp for bf16 operands, 2e-5 for fp32 ones), the reference the
plain version in fp32 from the same operands with TF32 off.
"""

import json

import numpy as np
import pytest
import torch

from clipa_tpu_torch.ops import block_attention
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
# H/14 @336 (L = 577). Each in bf16 (the tensor-core kernel) and in fp32
# (its scalar twin, the service at precision float32).
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
