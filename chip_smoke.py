"""Smoke run of the PyTorch/CUDA port (clipa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's two main paths at full width (seeded random weights: no
CLIPA checkpoint is in the repository) through the hand-written attention
kernels: the embedding service at ViT-H-14-CL32-GAP-BigVision, and the
CLIPA pre-training step of ``clipa_tpu/configs/clipa_pretrain.py`` at
``img=L/16,res=112,token_len=8,batchsize=384``.

  1. the card, torch/CUDA versions, and both kernels built from
     clipa_tpu_torch/csrc, one nvcc per source, in parallel (build times
     printed);
  2. the forward kernel against its plain PyTorch version (fp32 from the
     same operands, TF32 off) at the serving shapes: H/14 @224, L/16 @112,
     the unbiased flat form, clip and exact mode past the clip (logits >>
     70), the fp32 twin at H/14 @224, and the bucket-256 H/14 shape; errors,
     kernel and plain times per case (at the small shapes the times are
     mostly the wrapper's host-side launch path, not the kernel);
  3. the backward kernel against the plain backward: dq, dk, dv and the
     bias grads at the pretrain shape (B=384 L=50 D=1024 H=16, bias), H/14
     @224 (several q-tiles, hd 80), L=577 without bias, clip mode past the
     clip with and without bias (the clip-grad mask bites: the share of
     scores at or past the clip is printed), exact mode, and the fp32 twin;
  4. the service: requests of 5, 64 and 300 uint8 images and two caption
     batches; shapes, finite values, unit norms; the forward kernel's launch
     count equals 32 (image layers) per image chunk; the images' embeddings
     match a service built on the plain attention path (per-row cosine >=
     0.999); images/s and texts/s at bucket 256;
  5. the training step: one step launches each kernel 24 times (the image
     layers; the 8-token text tower takes the einsum path); from the same
     state, the kernel path's loss and every parameter's gradient against
     the plain path's (loss within rtol 1e-2, gradient cosine >= 0.99); 20
     steps on one fixed batch with a const schedule at LEARN_LR lower the
     loss below 0.9x its start; pairs/s of both paths (host clock around
     synchronous steps after warm-up, best of two) and the step's peak
     device memory.

Every phase raises on failure (non-zero exit). Needs one CUDA device; exits
non-zero without one. The last line is the result JSON.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

MODEL = "ViT-H-14-CL32-GAP-BigVision"
IMAGE_LAYERS = 32
SEED = 0
MIN_COSINE = 0.999

PRETRAIN = "img=L/16,res=112,token_len=8,batchsize=384"
TRAIN_IMAGE_LAYERS = 24
# Kernel path vs plain path, one step from the same state: both compute the
# same function, the kernels rounding attention's outputs and gradients to
# bf16 at other places (about one bf16 ulp, 2^-8): the loss agrees to well
# under 1e-2 and every gradient points the same way (cosine >= 0.99).
LOSS_RTOL = 1e-2
MIN_GRAD_COSINE = 0.99
# The key biases get no gradient in exact arithmetic (see _training): their
# bf16 rounding noise is held below this share of the query bias's norm.
KEY_BIAS_NOISE = 5e-2
# The learning check: 20 Adam steps on one fixed batch, const schedule.
LEARN_LR = 3e-5
LEARN_STEPS = 20
LEARN_FACTOR = 0.9


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


def _clipped_share(q, k, h, l, biases):
    """Share of attention scores at or past the clip (|s| >= 70)."""
    import torch
    from clipa_tpu_torch.ops import block_attention as ba
    if biases is not None:
        q, k = q + biases[0], k + biases[1]
    qh = q.reshape(-1, l, h, q.shape[1] // h).transpose(1, 2).float()
    kh = k.reshape(-1, l, h, k.shape[1] // h).transpose(1, 2).float()
    s = qh @ kh.transpose(-1, -2) * (q.shape[1] // h) ** -0.5
    return (s.abs() >= ba._EXP_CLIP).float().mean().item()


def _bwd_case(b, l, d, h, bias, exact, q_scale, gen, dtype=None, iters=10):
    import torch
    from clipa_tpu_torch.ops import block_attention as ba
    dtype = dtype or torch.bfloat16

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    q, k, v, do = (mk(b * l, d, scale=q_scale), mk(b * l, d), mk(b * l, d),
                   mk(b * l, d))
    biases = (mk(d), mk(d), mk(d)) if bias else None
    grads = ba.fused_attention_bwd(q, k, v, do, h, l, biases, exact)
    torch.cuda.synchronize()
    ref = ba.attention_plain_bwd(q, k, v, do, h, l, biases, exact)
    errors = ba.bwd_errors(grads, ref, dtype)
    names = ("dq", "dk", "dv", "dbq", "dbk", "dbv")[:len(errors)]
    res = {
        "shape": (f"{str(dtype).split('.')[-1]} B={b} L={l} D={d} H={h} "
                  f"bias={bias} exact={exact} q_scale={q_scale}"),
        "errors": dict(zip(names, (e for e, _ in errors))),
        "max_abs_err": max(e for e, _ in errors),
        "ok": all(ok for _, ok in errors),
        "clipped_share": _clipped_share(q, k, h, l, biases),
        "ms": _time_ms(lambda: ba.fused_attention_bwd(
            q, k, v, do, h, l, biases, exact), iters),
        "plain_ms": _time_ms(lambda: ba.attention_plain_bwd(
            q, k, v, do, h, l, biases, exact), max(2, iters // 4)),
    }
    errs = " ".join(f"{n} {e:.3e}" for n, e in res["errors"].items())
    print(f"bwd kernel vs plain {res['shape']}: max abs err {errs} "
          f"(tolerance rtol {ba.bwd_tolerance(dtype)} of each output's "
          f"scale); scores past the clip {res['clipped_share']:.4f}; "
          f"kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms",
          flush=True)
    if not res["ok"]:
        raise RuntimeError(f"backward kernel disagrees with its plain "
                           f"version at {res['shape']}: {res['errors']}")
    return res


def _set_attn_impl(tower, impl):
    """Sets the attention path of every block of a tower ("plain": the
    plain PyTorch versions of the kernels, in both directions)."""
    from clipa_tpu_torch.models import layers
    for m in tower.modules():
        if isinstance(m, layers.MultiHeadAttention):
            m.attn_impl = impl


def _grads(model, params, batch):
    """(loss, {name: fp32 grad}) of the training loss at the current state."""
    import torch
    from clipa_tpu_torch import losses
    from clipa_tpu_torch.ops import preprocess
    model.train()
    zi, zt, out = model(preprocess.normalize_uint8(batch["image"]),
                        batch["labels"])
    loss, _ = losses.bidirectional_contrastive_loss(zi, zt, out["t"],
                                                    reduction=True)
    names = list(params)
    found = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.item(), {n: g.float() for n, g in zip(names, found)}


def _steps_per_s(update, state, batch, steps):
    """Steps/s of synchronous update() calls on the host clock."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, meas = update(state, batch)
    float(meas["training_loss"])
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def _training(card):
    """Phase 5: the CLIPA pre-training step at the bench shape."""
    import numpy as np
    import torch
    from clipa_tpu.configs import clipa_pretrain
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.train import step

    config = clipa_pretrain.get_config(PRETRAIN)
    batch_size = config.input.batch_size
    t0 = time.perf_counter()
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED),
        "cuda")
    sched_kw = dict(total_steps=config.total_steps, batch_size=batch_size)
    tx, _ = optim.make(config, model, sched_kw=sched_kw)
    update = step.make_update_fn(model, tx, config, config.total_steps)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    print(f"training: clipa_pretrain.py:{PRETRAIN}, {n_params / 1e6:.1f}M "
          f"fp32 parameters, compute {model.img.dtype}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.RandomState(SEED)
    res, tokens = config.init_shapes[0][1], config.init_shapes[1][1]
    batch = {   # as bench.py build_step makes it
        "image": torch.from_numpy(rng.randint(
            0, 255, (batch_size, res, res, 3), dtype=np.uint8)).cuda(),
        "labels": torch.from_numpy(rng.randint(
            0, 32000, (batch_size, tokens)).astype(np.int32)).cuda(),
    }

    # kernel path vs plain path, one step's gradients from the same state
    params = state["params"]
    loss_k, grads_k = _grads(model, params, batch)
    _set_attn_impl(model.img, "plain")
    bwd_before = ba.fused_attention_bwd.launches
    loss_p, grads_p = _grads(model, params, batch)
    _set_attn_impl(model.img, "auto")
    if ba.fused_attention_bwd.launches != bwd_before:
        raise RuntimeError("the plain path launched the backward kernel")
    # The key biases get no gradient in exact arithmetic (a bias added to
    # every key shifts a softmax row by a constant): both paths hold bf16
    # rounding noise there, whose direction means nothing. They are held to
    # noise level instead (KEY_BIAS_NOISE of the query bias's norm).
    key_bias = [n for n in grads_k if n.endswith("/key/bias")]
    cosines = {n: torch.nn.functional.cosine_similarity(
        grads_k[n].flatten(), grads_p[n].flatten(), dim=0, eps=1e-30).item()
        for n in grads_k if n not in key_bias}
    noise = max(max(g[n].norm().item() / g[n.replace("/key/", "/query/")]
                    .norm().item() for g in (grads_k, grads_p))
                for n in key_bias)
    worst = min(cosines, key=cosines.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"training step, kernel vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel {loss_rel:.2e}, tolerance {LOSS_RTOL}); "
          f"gradient cosine over {len(cosines)} tensors min "
          f"{cosines[worst]:.6f} at {worst}, median "
          f"{float(np.median(list(cosines.values()))):.6f}; "
          f"{len(key_bias)} key-bias grads at most {noise:.2e} of the query "
          f"bias's norm", flush=True)
    del grads_k, grads_p
    if (loss_rel > LOSS_RTOL or cosines[worst] < MIN_GRAD_COSINE
            or noise > KEY_BIAS_NOISE):
        raise RuntimeError("the kernel path's step differs from the plain "
                           "path's")

    # the main path: one update step, counters read around it
    ba.fused_attention.launches = 0
    ba.fused_attention_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state, meas = update(state, batch)
    torch.cuda.synchronize()
    launches = {"fwd": ba.fused_attention.launches,
                "bwd": ba.fused_attention_bwd.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"training step: loss {float(meas['training_loss']):.6f}, "
          f"l2_grads {float(meas['l2_grads']):.4f}; kernel launches fwd "
          f"{launches['fwd']} bwd {launches['bwd']} (expected "
          f"{TRAIN_IMAGE_LAYERS} each); peak device memory {peak_gb:.2f} GiB",
          flush=True)
    if launches != {"fwd": TRAIN_IMAGE_LAYERS, "bwd": TRAIN_IMAGE_LAYERS}:
        raise RuntimeError(f"training step launched the kernels {launches} "
                           f"times, expected {TRAIN_IMAGE_LAYERS} each")
    if not all(bool(torch.isfinite(v)) for v in meas.values()):
        raise RuntimeError(f"non-finite measurements {meas}")

    # pairs/s, kernel and plain path in turns, best of two each
    rates = {"kernel": 0.0, "plain": 0.0}
    update(state, batch)   # warm-up
    for impl in ("kernel", "plain", "kernel", "plain"):
        _set_attn_impl(model.img, "plain" if impl == "plain" else "auto")
        if rates[impl] == 0.0:
            update(state, batch)   # warm-up of this path
        rates[impl] = max(rates[impl], batch_size * _steps_per_s(
            update, state, batch, 5))
    _set_attn_impl(model.img, "auto")
    print(f"{card}: training pairs/s at B={batch_size} (kernel path) "
          f"{rates['kernel']:.2f}; plain attention path {rates['plain']:.2f}",
          flush=True)

    # learning check: a fresh optimizer, const schedule, lr override
    config.schedule = [(".*", dict(decay_type="const"))]
    config.lr = LEARN_LR
    tx, _ = optim.make(config, model, sched_kw=sched_kw)
    update = step.make_update_fn(model, tx, config, LEARN_STEPS)
    curve = []
    for _ in range(LEARN_STEPS):
        state, meas = update(state, batch)
        curve.append(float(meas["training_loss"]))
    print(f"learning check, {LEARN_STEPS} steps on one batch, const lr "
          f"{LEARN_LR}: loss {curve[0]:.4f} -> {curve[-1]:.4f} "
          f"({' '.join(f'{x:.3f}' for x in curve)})", flush=True)
    if not (np.isfinite(curve).all()
            and curve[-1] < LEARN_FACTOR * curve[0]):
        raise RuntimeError(f"the loss did not fall below {LEARN_FACTOR}x "
                           f"its start: {curve}")
    return {"launches": launches, "pairs_per_s": rates, "peak_gb": peak_gb,
            "loss_rel": loss_rel, "min_cosine": cosines[worst]}


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

    # 1. build: one nvcc per source, started together
    sources = {"fused_attention_fwd.cu": ba.fwd_library,
               "fused_attention_bwd.cu": ba.bwd_library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(load) for load in sources.values()]:
            f.result()
    for source in sources:
        print(f"kernel built from clipa_tpu_torch/csrc/{source} in "
              f"{cuda_build.build_seconds[source]:.2f} s -> "
              f"{cuda_build.library_path(source)}", flush=True)
    print(f"both kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)

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

    # 3. backward kernel vs plain backward
    bwd_main = _bwd_case(384, 50, 1024, 16, True, False, 1.0, gen=gen)
    bwd_cases = [bwd_main] + [_bwd_case(*c, gen=gen) for c in (
        (8, 257, 1280, 16, True, False, 1.0),   # several q-tiles, hd 80 (K2)
        (2, 577, 1024, 16, False, False, 1.0),  # L = 577, no bias (K4/K2)
        (8, 50, 1024, 16, True, False, 40.0),   # clip mode past the clip
        (2, 40, 256, 4, False, False, 40.0),    # ... without bias
        (2, 40, 256, 4, True, True, 40.0),      # exact mode, logits >> 70
    )]
    bwd_cases.append(_bwd_case(8, 257, 1280, 16, True, False, 1.0, gen=gen,
                               dtype=torch.float32, iters=2))  # fp32 twin
    for c in bwd_cases[3:5]:
        if c["clipped_share"] <= 0.0:
            raise RuntimeError(f"no score passed the clip at {c['shape']}")

    # 4. the service
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

    # 5. the training step
    train = _training(card)

    print(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "clipa_tpu/ops/block_attention.py:165",
        "launches": launches + train["launches"]["fwd"],
        "launches_by_path": {"serving": launches,
                             "training_step": train["launches"]["fwd"]},
        "max_abs_err": max(c["max_abs_err"] for c in cases + [main_case]),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "clipa_tpu/ops/block_attention.py:672",
        "launches": train["launches"]["bwd"],
        "max_abs_err": max(c["max_abs_err"] for c in bwd_cases),
        "ms": bwd_main["ms"],
        "plain_ms": bwd_main["plain_ms"],
    }], "training": {
        "config": f"clipa_tpu/configs/clipa_pretrain.py:{PRETRAIN}",
        "pairs_per_s": train["pairs_per_s"],
        "peak_gb": train["peak_gb"],
    }}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
