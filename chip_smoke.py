"""Smoke run of the PyTorch/CUDA port (clipa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the embedding service end to end at the full width and depth of
ViT-H-14-CL32-GAP-BigVision (seeded random weights: no CLIPA checkpoint is
in the repository), through the hand-written attention kernel:

  1. the card, torch/CUDA versions, and the kernel built from
     clipa_tpu_torch/csrc (build time printed);
  2. the kernel against its plain PyTorch version (fp32 from the same
     operands, TF32 off) at the serving shapes: H/14 @224, L/16 @112, the
     unbiased flat form, clip and exact mode past the clip (logits >> 70),
     the fp32 twin at H/14 @224, and the bucket-256 H/14 shape; errors,
     kernel and plain times per case (at the small shapes the times are
     mostly the wrapper's host-side launch path, not the kernel);
  3. the service: requests of 5, 64 and 300 uint8 images and two caption
     batches; shapes, finite values, unit norms; the kernel's launch count
     equals 32 (image layers) per image chunk; the images' embeddings match
     a service built on the plain attention path (per-row cosine >= 0.999);
     images/s and texts/s at bucket 256.

Every phase raises on failure (non-zero exit). Needs one CUDA device; exits
non-zero without one. The last line is the result JSON.
"""

import json
import os
import subprocess
import sys
import time

MODEL = "ViT-H-14-CL32-GAP-BigVision"
IMAGE_LAYERS = 32
SEED = 0
MIN_COSINE = 0.999


def _time_ms(fn, iters):
    """Mean device time of fn() over `iters` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_case(b, l, d, h, bias, exact, q_scale, gen, dtype=None):
    import torch
    from clipa_tpu_torch.ops import block_attention as ba
    dtype = dtype or torch.bfloat16

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    q, k, v = mk(b * l, d, scale=q_scale), mk(b * l, d), mk(b * l, d)
    biases = (mk(d), mk(d), mk(d)) if bias else None
    out = ba.fused_attention(q, k, v, h, l, biases, exact)
    torch.cuda.synchronize()
    ref = ba.attention_plain(q, k, v, h, l, biases, exact)
    err = (out.float() - ref.float()).abs()
    atol, rtol = ba.tolerance(dtype)
    limit = atol + rtol * ref.float().abs()
    res = {
        "shape": (f"{str(dtype).split('.')[-1]} B={b} L={l} D={d} H={h} "
                  f"bias={bias} exact={exact} q_scale={q_scale}"),
        "max_abs_err": err.max().item(),
        "mean_abs_err": err.mean().item(),
        "finite": bool(torch.isfinite(out).all()),
        "within_tol": bool((err <= limit).all()),
        "ms": _time_ms(lambda: ba.fused_attention(q, k, v, h, l, biases,
                                                  exact), 20),
        "plain_ms": _time_ms(lambda: ba.attention_plain(q, k, v, h, l,
                                                        biases, exact), 5),
    }
    print(f"kernel vs plain {res['shape']}: max_abs_err "
          f"{res['max_abs_err']:.3e} mean_abs_err {res['mean_abs_err']:.3e} "
          f"kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms",
          flush=True)
    if not (res["finite"] and res["within_tol"]):
        raise RuntimeError(f"kernel disagrees with its plain version at "
                           f"{res['shape']} (tolerance atol {atol} + "
                           f"rtol {rtol})")
    return res


def _check_embeddings(z, n, dim, what):
    import numpy as np
    if z.shape != (n, dim):
        raise RuntimeError(f"{what}: shape {z.shape}, expected {(n, dim)}")
    if not np.isfinite(z).all():
        raise RuntimeError(f"{what}: non-finite embeddings")
    norms = np.linalg.norm(z, axis=1)
    if np.abs(norms - 1).max() > 1e-3:
        raise RuntimeError(f"{what}: norms off unit: {norms.min()} "
                           f"{norms.max()}")


def _rate(fn, n_items, repeats=2):
    """Items/s of a synchronous service call (host clock), best of runs."""
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = max(best, n_items / (time.perf_counter() - t0))
    return best


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np
    from clipa_tpu_torch.ops import block_attention as ba, cuda_build
    from clipa_tpu_torch.serving import EmbeddingService

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    source = "fused_attention_fwd.cu"
    ba._library()
    print(f"kernel built from clipa_tpu_torch/csrc/{source} in "
          f"{cuda_build.build_seconds[source]:.2f} s -> "
          f"{cuda_build.library_path(source)}", flush=True)

    # 2. kernel vs plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [_kernel_case(*c, gen=gen) for c in (
        (8, 257, 1280, 16, True, False, 1.0),   # H/14 @224 (K1 path)
        (8, 50, 1024, 16, True, False, 1.0),    # L/16 @112 (K5 path)
        (4, 37, 256, 4, False, False, 1.0),     # flat, no bias (K3)
        (8, 257, 1280, 16, True, False, 40.0),  # clip mode, logits >> 70
        (2, 40, 256, 4, False, False, 40.0),    # ... without bias
        (2, 40, 256, 4, False, True, 40.0),     # exact mode, logits >> 70
    )]
    cases.append(_kernel_case(8, 257, 1280, 16, True, False, 1.0, gen=gen,
                              dtype=torch.float32))  # fp32 twin
    main_case = _kernel_case(256, 257, 1280, 16, True, False, 1.0, gen=gen)

    # 3. the service
    vocab = os.path.join(here, "data", "vocab.txt")
    t0 = time.perf_counter()
    svc = EmbeddingService(MODEL, None, vocab_path=vocab, device="cuda",
                           precision="bfloat16", seed=SEED, num_workers=0)
    torch.cuda.synchronize()
    print(f"service {MODEL}: seeded random weights, built in "
          f"{time.perf_counter() - t0:.2f} s, buckets {svc.buckets}, "
          f"embed_dim {svc.embed_dim}", flush=True)
    dim = svc.embed_dim
    rng = np.random.RandomState(SEED)
    requests = [rng.randint(0, 256, (n, 224, 224, 3), np.uint8)
                for n in (5, 64, 300)]
    captions = [f"a photo of {n} {w}" for n, w in zip(
        range(40), ["cats", "dogs", "a red car on a street", "birds"] * 10)]
    chunks = sum(len(list(svc._chunks(r))) for r in requests)

    ba.fused_attention.launches = 0
    t0 = time.perf_counter()
    z_images = [svc.embed_images(r) for r in requests]
    z_texts = [svc.embed_texts(captions[:7]), svc.embed_texts(captions)]
    served_s = time.perf_counter() - t0
    launches = ba.fused_attention.launches
    print(f"served {sum(len(r) for r in requests)} images in {chunks} "
          f"chunks and {7 + len(captions)} texts in {served_s:.2f} s; "
          f"attention kernel launches {launches} "
          f"(expected {IMAGE_LAYERS} x {chunks})", flush=True)
    for r, z in zip(requests, z_images):
        _check_embeddings(z, len(r), dim, f"{len(r)} images")
    _check_embeddings(z_texts[0], 7, dim, "7 texts")
    _check_embeddings(z_texts[1], len(captions), dim, "40 texts")
    if launches != IMAGE_LAYERS * chunks or launches == 0:
        raise RuntimeError(f"attention kernel launched {launches} times, "
                           f"expected {IMAGE_LAYERS * chunks}")

    plain = EmbeddingService(MODEL, None, vocab_path=vocab, device="cuda",
                             precision="bfloat16", seed=SEED, num_workers=0,
                             attn_impl="plain")
    before = ba.fused_attention.launches
    for r, z in zip(requests[:2], z_images[:2]):
        zp = plain.embed_images(r)
        cos = (z * zp).sum(1) / (np.linalg.norm(z, axis=1)
                                 * np.linalg.norm(zp, axis=1))
        print(f"{len(r)} images: kernel vs plain attention path, per-row "
              f"cosine min {cos.min():.6f} mean {cos.mean():.6f}", flush=True)
        if cos.min() < MIN_COSINE:
            raise RuntimeError(f"service embeddings differ from the plain "
                               f"path: cosine {cos.min()} < {MIN_COSINE}")
    if ba.fused_attention.launches != before:
        raise RuntimeError("the plain path launched the kernel")

    # rates at bucket 256 (full chunks), kernel and plain path in turns
    batch = rng.randint(0, 256, (1024, 224, 224, 3), np.uint8)
    texts = (captions * 52)[:2048]
    img_rate = _rate(lambda: svc.embed_images(batch), len(batch))
    img_rate_plain = _rate(lambda: plain.embed_images(batch), len(batch))
    img_rate2 = _rate(lambda: svc.embed_images(batch), len(batch))
    txt_rate = _rate(lambda: svc.embed_texts(texts), len(texts))
    print(f"{card}: images/s at bucket 256 (kernel path) "
          f"{img_rate:.2f} then {img_rate2:.2f}; plain attention path "
          f"{img_rate_plain:.2f}; texts/s at bucket 256 {txt_rate:.2f}",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": f"clipa_tpu_torch/csrc/{source}",
        "replaces": "clipa_tpu/ops/block_attention.py:165",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases + [main_case]),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
