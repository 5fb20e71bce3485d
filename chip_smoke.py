"""Smoke run of the PyTorch/CUDA port (clipa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width (seeded random weights: no
CLIPA checkpoint is in the repository) through the hand-written kernels:
the embedding service at ViT-H-14-CL32-GAP-BigVision, the CLIPA
pre-training step of ``clipa_tpu_torch/configs/clipa_pretrain.py`` at
``img=L/16,res=112,token_len=8,batchsize=384``, CLIPA's unmask-tuning
step of ``clipa_tpu_torch/configs/clipa_finetune.py`` at
``img=L/16,res=224,token_len=32,mask_ratio=0.3,batchsize=128`` with the
image tower on the flash route (``attn_impl="pallas"``), initialized from
the pre-training state by ``masked_init``, the fused uint8 patch embed at
the pre-training stem and the serving bucket, the tools (the
attention-variant sweep and the step-ablation ladder), and CLIPA-v2's
H/14 unmask-tuning step of ``clipa_finetune.py`` at
``img=H/14,res=224,token_len=32,mask_ratio=0.3,batchsize=64`` on the
config's ``auto`` route (the fused kernels; the backward's long scheme).

  1. the card, torch/CUDA versions, and the five kernel sources built from
     clipa_tpu_torch/csrc, one nvcc per source, in parallel (build times
     printed);
  2. the forward kernel against its plain PyTorch version (fp32 from the
     same operands, TF32 off) at the serving shapes: H/14 @224, L/16 @112,
     the unbiased flat form, clip and exact mode past the clip (logits >>
     70), the fp32 twin at H/14 @224; then at FUSED_SHAPES, the three
     main-path shapes (bucket 256 at H/14, the pretrain step's B=384 L=50,
     the fine-tune `auto` route's B=128 L=138), the exact form without
     biases at bucket 256 and the H/14 unmask-tuning stages (B=64 L=180,
     B=16 L=346); per case errors, the output of two calls bit for
     bit, kernel and plain times by CUDA events, and SDPA's where it
     computes the same function (exact mode without biases); at
     FUSED_SHAPES also the kernel's and SDPA's device times (torch.profiler;
     "not measured" where the profiler returns no whole session) and the
     kernel's share of the bound (at the small shapes the event times are
     mostly the wrapper's host-side launch path, not the kernel);
  3. the backward kernel against the plain backward: dq, dk, dv and the
     bias grads, and the outputs of two calls bit for bit, at BWD_SHAPES
     (the pretrain step's B=384 L=50 D=1024 H=16 with bias, H/14 @84's
     B=256 L=37 D=1280 with bias, the fine-tune `auto` route's B=128 L=138,
     the exact form without bias at L=50: the whole-head scheme; the H/14
     unmask-tuning stages B=64 L=180 and B=16 L=346 D=1280 with bias and in
     the exact form without: the long scheme), each with kernel and plain
     times by CUDA events,
     the kernel's device time (torch.profiler), its share of the bound and,
     for the exact form, SDPA's backward beside it; then clip mode past the
     clip with and without bias (the clip-grad mask bites: the share of
     scores at or past the clip is printed; device time too), H/14 @224
     and L=577 (the long scheme), exact mode past the clip, and the fp32
     twin;
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
     device memory;
  6. the flash kernels (forward K7, backward K8), driven through the public
     wrapper under autograd as the towers call it, against their plain
     versions: errors on O, LSE, dq, dk and dv, the backward twice on the
     same inputs bit for bit, kernel, plain and SDPA times by CUDA events
     (``F.scaled_dot_product_attention``, the library yardstick; the port
     never calls it), and kernel and SDPA device times (torch.profiler) at
     FLASH_SHAPES: the unmask-tuning shape (B=128 L=138 H=16 hd 64), H/14
     @224 mask 0.3 (L=180, hd 80), H/14 @336 mask 0.4 (L=346), L=1025 at
     G/14's width (hd 104: the auto route), cross-attention (77 queries,
     257 keys), q x 40 (logits far past 70: exact, no clip); and the fp32
     twin;
  7. the masked_init transition: phase 5's trained parameters saved with
     ``save_params``, the fine-tune model initialized from the file: every
     parameter bit for bit, except ``txt/pos_embedding``, resampled from 8
     to 32 positions and held against a numpy linear interpolation;
  8. the unmask-tuning step: launches per step (flash forward 24 x 2, the
     forward and remat's recompute; backward 24; fused kernels 0, text
     tower none); from the same state and mask noise, the kernel path's
     loss and gradients against the ``pallas_plain`` path's (rtol 1e-2,
     cosine >= 0.99) and remat on against off (rtol 1e-5, cosine >=
     0.9999); 20 steps on one batch lower the loss below 0.9x its start;
     pairs/s on the flash route and on the config's ``auto`` route (the
     fused kernels), best of two, and peak device memory;
  9. the uint8 patch embed (K9): ``fused_patch_embed(impl="pallas")``
     against its plain version (fp32, TF32 off) at L/16 @112 B=384 (p 16,
     width 1024), H/14 @224 B=256 (p 14: K = 588, the K-tail) and Ti/16
     (width 192: a partial 128-column tile, where the reference's Pallas
     route gives way to XLA), bf16 and fp32 outputs, with and without
     bias; then the op as a user calls it at the three shapes, counters
     read around; kernel, plain and library (``F.conv2d`` with the folded
     weights) times, the bound (two bf16 tensor-core products, the
     function's near-fp32 route) and this design's fp32-FMA bound;
 10. ``tools/attn_sweep.py`` at B=384 L=50 D=1024 H=16: the fused forward
     clip / exact and the backward normalized / deferred x clip / exact,
     each against its plain version, the deferred against the normalized,
     and their times;
 11. ``tools/ablate_step.py`` at L/16 @112 B=384 (8 tokens): every key
     finite, fwd < grad, ``grad_noattn`` through the stand-in attention
     core (its calls counted) and without a kernel launch; and
     ``tools/flops.py`` on ViT-H-14-CL32-GAP-BigVision on the meta device;
 12. the H/14 unmask-tuning step (ViT-H/14 @224, 32 layers, D 1280, 16
     heads of 80, mask 0.3: L = 180; the H text tower at 32 tokens; remat
     "minimal", bf16 compute, Adam with a bf16 first moment; B=64, seeded
     random weights): the backward plan is the long scheme; from the same
     state and mask noise the kernel path's loss and gradients against the
     plain path's (rtol 1e-2, cosine >= 0.99); one update step launches
     the fused forward 64 times (32 layers and remat's recompute), the
     fused backward 32, the flash kernels never; pairs/s (best of two runs
     of 3 steps) and peak device memory.

Every phase raises on failure (non-zero exit). Needs one CUDA device; exits
non-zero without one. The last line is the result JSON; the line before it
lists every kernel with its launches, error, time, plain and library time
and the least time the card could take for the same work.
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

FINETUNE = "img=L/16,res=224,token_len=32,mask_ratio=0.3,batchsize=128"
# Phase 12: CLIPA-v2's H/14 unmask-tuning stage at 224 px (the config's
# defaults but the batch): 1 + int(256 x 0.7) = 180 image tokens, the
# config's `auto` route (the fused forward and the backward's long scheme).
FINETUNE_H14 = "img=H/14,res=224,token_len=32,mask_ratio=0.3,batchsize=64"
# Fused launches per H/14 fine-tune step: the forward once per image layer
# and once more in remat's recompute, the backward once per layer; the text
# tower (32 tokens) on the einsum path, the flash kernels never.
FINETUNE_H14_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0,
                         "fused_fwd": 2 * IMAGE_LAYERS,
                         "fused_bwd": IMAGE_LAYERS}
# Flash forward launches per fine-tune step: each image layer's forward and
# remat's recompute of it in the backward.
FINETUNE_FWD_LAUNCHES = 2 * TRAIN_IMAGE_LAYERS
# Remat on vs off from the same state and noise: the forward is the same
# computation, and remat's recompute repeats the saved values bit for bit;
# only the order in which atomics sum in the gather and embedding backwards
# may differ from run to run.
REMAT_LOSS_RTOL = 1e-5
REMAT_MIN_COSINE = 0.9999
# The resampled text posemb against numpy's linear interpolation (fp32).
POSEMB_ATOL = 1e-6

# Phase 9: (name, batch, image side, patch, width): the pre-training stem,
# the serving bucket (K = 588) and a width that is not a multiple of the
# kernel's 128-column tile.
PATCH_CASES = (("L/16 @112", 384, 112, 16, 1024),
               ("H/14 @224", 256, 224, 14, 1280),
               ("Ti/16 @224", 64, 224, 16, 192))
SWEEP_ITERS = 10
ABLATE = ["--batch", "384", "--iters", "3"]
# Phase 6, bf16: (b, lq, lk, h, hd, q_scale), the unmask-tuning shape first
FLASH_SHAPES = ((128, 138, 138, 16, 64, 1.0),  # L/16 @224, mask 0.3
                (64, 180, 180, 16, 80, 1.0),   # H/14 @224, mask 0.3
                (16, 346, 346, 16, 80, 1.0),   # H/14 @336, mask 0.4
                (2, 1025, 1025, 16, 104, 1.0),  # G/14 @448: the auto route
                (16, 77, 257, 16, 64, 1.0),    # cross-attention
                (32, 138, 138, 16, 64, 40.0))  # logits far past 70

# Phase 2's timed cases of the fused forward, (name, b, l, d, h, bias,
# exact): the three main-path shapes (serving bucket 256 at H/14 @224, the
# pretrain step, the fine-tune step's `auto` route), the exact form
# without biases that SDPA also computes, and the H/14 unmask-tuning
# stages (224 px at mask 0.3: L = 180, B = 64 as in phase 12; 336 px at
# mask 0.4: L = 346, B = 16)
FUSED_SHAPES = (("bucket 256", 256, 257, 1280, 16, True, False),
                ("L/16 @112", 384, 50, 1024, 16, True, False),
                ("fine-tune auto", 128, 138, 1024, 16, True, False),
                ("bucket 256 exact", 256, 257, 1280, 16, False, True),
                ("H/14 @224 mask 0.3", 64, 180, 1280, 16, True, False),
                ("H/14 @336 mask 0.4", 16, 346, 1280, 16, True, False))

# Phase 3's timed cases of the fused backward, (name, b, l, d, h, bias,
# exact): the pretrain step's (L/16 @112), the H/14 @84 headline pretrain
# (`bench.py` STAGES["pretrain_h14"]: hd 80), the fine-tune step's `auto`
# route, the exact form without biases that SDPA's backward also computes,
# and the H/14 unmask-tuning stages (the long scheme), each also in the
# exact form without biases beside SDPA's backward
BWD_SHAPES = (("L/16 @112", 384, 50, 1024, 16, True, False),
              ("H/14 @84", 256, 37, 1280, 16, True, False),
              ("fine-tune auto", 128, 138, 1024, 16, True, False),
              ("L/16 @112 exact", 384, 50, 1024, 16, False, True),
              ("H/14 @224 mask 0.3", 64, 180, 1280, 16, True, False),
              ("H/14 @336 mask 0.4", 16, 346, 1280, 16, True, False),
              ("H/14 @224 mask 0.3 exact", 64, 180, 1280, 16, False, True),
              ("H/14 @336 mask 0.4 exact", 16, 346, 1280, 16, False, True))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the peak
# of their type (bf16 on the tensor cores; fp32 twins on the fp32 units).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _card():
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def _device_ms(fn, iters):
    """Mean device time of the kernels that fn() launches, over `iters`
    calls, under torch.profiler: for each kernel name, its mean duration
    times its launches per call. Unlike _time_ms it leaves out the host's
    launch path where that is the slower. Each session first runs `iters`
    calls as the profiler's warm-up step, whose records it drops (the first
    records of a session have come back missing: three sessions in a row 3
    short of 80). Now and then a session's records still come back in part
    or not at all (none, three sessions in a row), so a name's launches per
    call is its count over `iters`, rounded, and a session counts when every
    name's count lies within a quarter of `iters` of that many calls' worth.
    After three sessions that do not, None: the time is not measured, which
    fails no phase (the events time each case as well)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):   # the warm-up step, then the recorded one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us = {}
        for e in prof.events():
            if e.device_type == cuda and not e.is_user_annotation:
                us.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        per_call = {n: round(len(d) / iters) for n, d in us.items()}
        if us and all(per_call[n] >= 1
                      and abs(len(d) - per_call[n] * iters) <= iters / 4
                      for n, d in us.items()):
            return sum(sum(d) / len(d) * per_call[n]
                       for n, d in us.items()) / 1e3
    counts = {n[:60]: len(d) for n, d in us.items()}
    print(f"device time not measured: the profiler saw kernels {counts} in "
          f"{iters} calls, three times", flush=True)
    return None


def _fmt(ms):
    """A time for the log: ms to 4 places, or "not measured" (None)."""
    return "not measured" if ms is None else f"{ms:.4f}"


def _ratio(a, b, spec):
    """a / b formatted by `spec`, or "not measured" where either is None."""
    return "not measured" if a is None or b is None else format(a / b, spec)


def _kernel_case(b, l, d, h, bias, exact, q_scale, gen, dtype=None,
                 device=False):
    """Phase 2: the fused forward against its plain version at one shape:
    errors, the output of two calls bit for bit, kernel and plain times by
    CUDA events, the bound, SDPA's time where it computes the same function
    (exact mode without biases), and with `device` (the timed FUSED_SHAPES)
    the kernel's and SDPA's device times (torch.profiler)."""
    import torch
    from clipa_tpu_torch.ops import block_attention as ba
    dtype = dtype or torch.bfloat16

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    q, k, v = mk(b * l, d, scale=q_scale), mk(b * l, d), mk(b * l, d)
    biases = (mk(d), mk(d), mk(d)) if bias else None

    def kernel():
        return ba.fused_attention(q, k, v, h, l, biases, exact)

    out = kernel()
    # no atomics: two calls on the same inputs agree bit for bit
    repeat = torch.equal(out, kernel())
    torch.cuda.synchronize()
    ref = ba.attention_plain(q, k, v, h, l, biases, exact)
    err = (out.float() - ref.float()).abs()
    atol, rtol = ba.tolerance(dtype)
    limit = atol + rtol * ref.float().abs()
    # q, k, v, out (and the three biases) once each; 4 L^2 hd products per
    # head and sample
    nbytes = q.element_size() * (4 * b * l * d + (3 * d if bias else 0))
    res = {
        "shape": (f"{str(dtype).split('.')[-1]} B={b} L={l} D={d} H={h} "
                  f"bias={bias} exact={exact} q_scale={q_scale}"),
        "max_abs_err": err.max().item(),
        "mean_abs_err": err.mean().item(),
        "finite": bool(torch.isfinite(out).all()),
        "within_tol": bool((err <= limit).all()),
        "repeat_identical": repeat,
        "ms": _time_ms(kernel, 20),
        "device_ms": _device_ms(kernel, 20) if device else None,
        "plain_ms": _time_ms(lambda: ba.attention_plain(q, k, v, h, l,
                                                        biases, exact), 5),
        "bound": _bound(nbytes, 4 * b * l * l * d, dtype),
    }
    library = ""
    if exact and not bias:   # SDPA computes this function: time it beside
        import torch.nn.functional as F
        qt, kt, vt = (x.reshape(b, l, h, d // h).transpose(1, 2)
                      for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt)

        res["library_ms"] = _time_ms(sdpa, 20)
        res["library_device_ms"] = _device_ms(sdpa, 20) if device else None
        library = f" sdpa {res['library_ms']:.4f} ms"
    bound = res["bound"][0]
    by_device = ""
    if device:
        by_device = (f"; device ms: kernel {_fmt(res['device_ms'])}, "
                     f"{_ratio(bound, res['device_ms'], '.1%')} of the bound")
        if "library_ms" in res:
            by_device += f", sdpa {_fmt(res['library_device_ms'])}"
    print(f"kernel vs plain {res['shape']}: max_abs_err "
          f"{res['max_abs_err']:.3e} mean_abs_err {res['mean_abs_err']:.3e} "
          f"bit-identical on repeat {repeat}; kernel {res['ms']:.4f} ms plain "
          f"{res['plain_ms']:.4f} ms{library}; bound {bound:.4f} ms "
          f"({res['bound'][1]}){by_device}", flush=True)
    if not (res["finite"] and res["within_tol"]):
        raise RuntimeError(f"kernel disagrees with its plain version at "
                           f"{res['shape']} (tolerance atol {atol} + "
                           f"rtol {rtol})")
    if not repeat:
        raise RuntimeError(f"kernel output differs between two calls on the "
                           f"same inputs at {res['shape']}")
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


def _bwd_case(b, l, d, h, bias, exact, q_scale, gen, dtype=None, iters=10,
              device=False):
    """Phase 3: the fused backward against its plain version at one shape:
    errors, the outputs of two calls bit for bit, kernel and plain times by
    CUDA events, the bound, and with `device` (the timed BWD_SHAPES and the
    cases past the clip) the kernel's device time and, where SDPA computes the same function (exact
    mode without biases), SDPA's backward by events and device time."""
    import torch
    from clipa_tpu_torch.ops import block_attention as ba
    dtype = dtype or torch.bfloat16

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    q, k, v, do = (mk(b * l, d, scale=q_scale), mk(b * l, d), mk(b * l, d),
                   mk(b * l, d))
    biases = (mk(d), mk(d), mk(d)) if bias else None

    def kernel():
        return ba.fused_attention_bwd(q, k, v, do, h, l, biases, exact)

    grads = kernel()
    # no atomics: two calls on the same inputs agree bit for bit
    repeat = all(torch.equal(x, y) for x, y in zip(grads, kernel())
                 if x is not None)
    torch.cuda.synchronize()
    ref = ba.attention_plain_bwd(q, k, v, do, h, l, biases, exact)
    errors = ba.bwd_errors(grads, ref, dtype)
    names = ("dq", "dk", "dv", "dbq", "dbk", "dbv")[:len(errors)]
    e = q.element_size()
    res = {
        "shape": (f"{str(dtype).split('.')[-1]} B={b} L={l} D={d} H={h} "
                  f"bias={bias} exact={exact} q_scale={q_scale}"),
        "errors": dict(zip(names, (x for x, _ in errors))),
        "max_abs_err": max(x for x, _ in errors),
        "ok": all(ok for _, ok in errors),
        "repeat_identical": repeat,
        "clipped_share": _clipped_share(q, k, h, l, biases),
        "ms": _time_ms(kernel, iters),
        "device_ms": _device_ms(kernel, iters) if device else None,
        "plain_ms": _time_ms(lambda: ba.attention_plain_bwd(
            q, k, v, do, h, l, biases, exact), max(2, iters // 4)),
        # q, k, v, do in and dq, dk, dv out once each (the biases in and
        # their grads out); 10 L^2 hd products per head and sample
        "bound": _bound(e * (7 * b * l * d + (6 * d if bias else 0)),
                        10 * b * l * l * d, dtype),
    }
    library = ""
    if exact and not bias and device:   # SDPA's backward: the same function
        import torch.nn.functional as F
        qt, kt, vt, dot = (x.reshape(b, l, h, d // h).transpose(1, 2)
                           for x in (q, k, v, do))
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        o_lib = F.scaled_dot_product_attention(*leaves)

        def sdpa_bwd():
            return torch.autograd.grad(o_lib, leaves, dot, retain_graph=True)

        res["library_ms"] = _time_ms(sdpa_bwd, iters)
        res["library_device_ms"] = _device_ms(sdpa_bwd, iters)
        library = (f" sdpa bwd {res['library_ms']:.4f} ms "
                   f"({_fmt(res['library_device_ms'])} device)")
    bound = res["bound"][0]
    by_device = ""
    if device:
        by_device = (f"; device ms: kernel {_fmt(res['device_ms'])}, "
                     f"{_ratio(bound, res['device_ms'], '.1%')} of the bound")
    errs = " ".join(f"{n} {x:.3e}" for n, x in res["errors"].items())
    print(f"bwd kernel vs plain {res['shape']}: max abs err {errs} "
          f"(tolerance rtol {ba.bwd_tolerance(dtype)} of each output's "
          f"scale); bit-identical on repeat {repeat}; scores past the clip "
          f"{res['clipped_share']:.4f}; kernel {res['ms']:.4f} ms plain "
          f"{res['plain_ms']:.4f} ms{library}; bound {bound:.4f} ms "
          f"({res['bound'][1]}){by_device}", flush=True)
    if not res["ok"]:
        raise RuntimeError(f"backward kernel disagrees with its plain "
                           f"version at {res['shape']}: {res['errors']}")
    if not repeat:
        raise RuntimeError(f"backward kernel outputs differ between two "
                           f"calls on the same inputs at {res['shape']}")
    return res


def _set_attn_impl(tower, impl):
    """Sets the attention path of every block of a tower ("plain": the
    plain PyTorch versions of the kernels, in both directions)."""
    from clipa_tpu_torch.models import layers
    for m in tower.modules():
        if isinstance(m, layers.MultiHeadAttention):
            m.attn_impl = impl


def _grads(model, params, batch, mask_ratio=0.0, generator=None):
    """(loss, {name: fp32 grad}) of the training loss at the current state;
    image tokens masked at `mask_ratio` with noise from `generator`."""
    import torch
    from clipa_tpu_torch import losses
    from clipa_tpu_torch.ops import preprocess
    model.train()
    zi, zt, out = model(preprocess.normalize_uint8(batch["image"]),
                        batch["labels"], mask_ratio=mask_ratio,
                        generator=generator)
    loss, _ = losses.bidirectional_contrastive_loss(zi, zt, out["t"],
                                                    reduction=True)
    names = list(params)
    found = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.item(), {n: g.float() for n, g in zip(names, found)}


def _compare(loss_a, grads_a, loss_b, grads_b, key_bias_noise=True):
    """How two steps' loss and gradients agree: the loss's relative gap and
    each gradient's cosine. With `key_bias_noise` the key biases are left
    out of the cosines: they get no gradient in exact arithmetic (a bias
    added to every key shifts a softmax row by a constant), so both sides
    hold rounding noise there, whose direction means nothing; their norm is
    reported instead, as a share of the query bias's."""
    import numpy as np
    import torch
    key_bias = ([n for n in grads_a if n.endswith("/key/bias")]
                if key_bias_noise else [])
    cosines = {n: torch.nn.functional.cosine_similarity(
        grads_a[n].flatten(), grads_b[n].flatten(), dim=0, eps=1e-30).item()
        for n in grads_a if n not in key_bias}
    noise = max((max(g[n].norm().item() / g[n.replace("/key/", "/query/")]
                     .norm().item() for g in (grads_a, grads_b))
                 for n in key_bias), default=0.0)
    worst = min(cosines, key=cosines.get)
    return {"loss_rel": abs(loss_a - loss_b) / abs(loss_b),
            "worst": worst, "min_cosine": cosines[worst],
            "median_cosine": float(np.median(list(cosines.values()))),
            "n": len(cosines), "n_key_bias": len(key_bias), "noise": noise,
            "max_abs_gap": max((grads_a[n] - grads_b[n]).abs().max().item()
                               for n in grads_a)}


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
    from clipa_tpu_torch.configs import clipa_pretrain
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
    # The key biases are held to noise level (KEY_BIAS_NOISE of the query
    # bias's norm), not to a cosine: see _compare.
    cmp = _compare(loss_k, grads_k, loss_p, grads_p)
    _print_compare("training step, kernel vs plain path", loss_k, loss_p,
                   cmp, LOSS_RTOL)
    del grads_k, grads_p
    if (cmp["loss_rel"] > LOSS_RTOL or cmp["min_cosine"] < MIN_GRAD_COSINE
            or cmp["noise"] > KEY_BIAS_NOISE):
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
            "loss_rel": cmp["loss_rel"], "min_cosine": cmp["min_cosine"],
            "params": state["params"]}


def _print_compare(what, loss_a, loss_b, cmp, loss_rtol):
    print(f"{what}: loss {loss_a:.6f} vs {loss_b:.6f} (rel "
          f"{cmp['loss_rel']:.2e}, tolerance {loss_rtol}); gradient cosine "
          f"over {cmp['n']} tensors min {cmp['min_cosine']:.7f} at "
          f"{cmp['worst']}, median {cmp['median_cosine']:.7f}; largest "
          f"gradient gap {cmp['max_abs_gap']:.3e}; {cmp['n_key_bias']} "
          f"key-bias grads at most {cmp['noise']:.2e} of the query bias's "
          f"norm", flush=True)


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


def _bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take for
    work that must move `nbytes` and do `flops` operations of `dtype`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_case(b, lq, lk, h, hd, q_scale, gen, dtype=None, iters=20):
    """Phase 6: the flash kernels against their plain versions at one
    shape, with kernel, plain and SDPA times for each direction."""
    import torch
    import torch.nn.functional as F
    from clipa_tpu_torch.ops import flash_attention as fa
    dtype = dtype or torch.bfloat16

    def mk(l, scale=1.0):
        return (torch.randn(b, l, h, hd, device="cuda", generator=gen)
                * scale).to(dtype)

    q, k, v, do = mk(lq, q_scale), mk(lk), mk(lk), mk(lq)
    # the public wrapper under autograd, as the towers call it: the forward
    # kernel, then the backward kernel from the residuals it saved
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves)
    lse = out.grad_fn.saved_tensors[4]   # residuals (q, k, v, out, lse)
    out.backward(do)
    torch.cuda.synchronize()
    grads = [x.grad for x in leaves]
    out = out.detach()
    ref, ref_lse = fa.flash_plain_fwd(q, k, v)
    o_err = (out.float() - ref.float()).abs()
    atol, rtol = fa.tolerance(dtype)
    lse_err = (lse - ref_lse).abs().max().item()
    # the plain backward from the same residuals as the kernel's
    errors = fa.bwd_errors(grads, fa.flash_plain_bwd(q, k, v, out, lse, do),
                           dtype)
    # no atomics: every sum of the backward runs in a fixed order, so two
    # calls on the same inputs agree bit for bit
    first = fa.flash_attention_bwd(q, k, v, out, lse, do)
    repeat = all(torch.equal(x, y) for x, y in zip(
        first, fa.flash_attention_bwd(q, k, v, out, lse, do)))
    # the library yardstick: SDPA over (B, H, L, hd) views, both directions
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    o_lib = F.scaled_dot_product_attention(*leaves)
    e = q.element_size()
    nq, nk = b * lq * h * hd, b * lk * h * hd
    stats = 4 * b * h * lq
    res = {
        "shape": (f"{str(dtype).split('.')[-1]} B={b} Lq={lq} Lk={lk} H={h} "
                  f"hd={hd} q_scale={q_scale}"),
        "errors": {"o": o_err.max().item(), "lse": lse_err,
                   **dict(zip(("dq", "dk", "dv"), (x for x, _ in errors)))},
        "ok": bool(torch.isfinite(out).all()
                   and (o_err <= atol + rtol * ref.float().abs()).all()
                   and lse_err <= fa.LSE_ATOL
                   and all(ok for _, ok in errors)),
        "bwd_repeat_identical": repeat,
        "plain_ms": _time_ms(lambda: fa.flash_plain_fwd(q, k, v),
                             max(2, iters // 4)),
        "bwd_plain_ms": _time_ms(lambda: fa.flash_plain_bwd(
            q, k, v, out, lse, do), max(2, iters // 4)),
        "bound": _bound(e * 2 * (nq + nk) + stats, 4 * b * h * lq * lk * hd,
                        dtype),
        "bwd_bound": _bound(e * 4 * (nq + nk) + stats,
                            10 * b * h * lq * lk * hd, dtype),
    }
    # kernel and SDPA, each direction: CUDA events through the call, and
    # the device time of the kernels it launched
    for name, fn in (
            ("", lambda: fa.flash_attention(q, k, v)),
            ("library_", lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            ("bwd_", lambda: fa.flash_attention_bwd(q, k, v, out, lse, do)),
            ("bwd_library_", lambda: torch.autograd.grad(
                o_lib, leaves, dot, retain_graph=True))):
        res[f"{name}ms"] = _time_ms(fn, iters)
        res[f"{name}device_ms"] = _device_ms(fn, iters)
    res["max_abs_err"] = max(res["errors"].values())
    errs = " ".join(f"{n} {x:.3e}" for n, x in res["errors"].items())
    bwd_rtol = fa.BWD_F32_RTOL if dtype == torch.float32 else fa.BWD_RTOL
    print(f"flash kernels vs plain {res['shape']}: max abs err {errs} "
          f"(tolerance: O atol {atol} + rtol {rtol}, LSE {fa.LSE_ATOL}, "
          f"grads rtol {bwd_rtol} of each one's scale); ms by events "
          f"(device): fwd kernel {res['ms']:.4f} ({_fmt(res['device_ms'])}) "
          f"plain {res['plain_ms']:.4f} sdpa {res['library_ms']:.4f} "
          f"({_fmt(res['library_device_ms'])}) bound {res['bound'][0]:.4f} "
          f"({res['bound'][1]}); bwd kernel {res['bwd_ms']:.4f} "
          f"({_fmt(res['bwd_device_ms'])}) plain {res['bwd_plain_ms']:.4f} "
          f"sdpa {res['bwd_library_ms']:.4f} "
          f"({_fmt(res['bwd_library_device_ms'])}) bound "
          f"{res['bwd_bound'][0]:.4f} ({res['bwd_bound'][1]}); bwd "
          f"bit-identical on repeat {repeat}", flush=True)
    if not res["ok"]:
        raise RuntimeError(f"flash kernels disagree with their plain "
                           f"versions at {res['shape']}: {res['errors']}")
    if not repeat:
        raise RuntimeError(f"flash backward differs between two calls on the "
                           f"same inputs at {res['shape']}")
    return res


def _finetune_batch(config):
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED + 1)
    b = config.input.batch_size
    res, tokens = config.init_shapes[0][1], config.init_shapes[1][1]
    return {"image": torch.from_numpy(rng.randint(
        0, 255, (b, res, res, 3), dtype=np.uint8)).cuda(),
        "labels": torch.from_numpy(rng.randint(
            0, 32000, (b, tokens)).astype(np.int32)).cuda()}


def _transition(pretrained):
    """Phase 7: the fine-tune model initialized by masked_init from the
    pretrain parameters `pretrained` ({JAX name: tensor}) written to npz."""
    import tempfile
    import numpy as np
    import torch
    from clipa_tpu_torch.configs import clipa_finetune
    from clipa_tpu_torch.ops import cuda_build
    from clipa_tpu_torch.train import checkpoint, step

    config = clipa_finetune.get_config(FINETUNE)
    config.model.image.attn_impl = "pallas"
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED + 1),
        "cuda")
    params = state["params"]
    t0 = time.perf_counter()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "pretrain_params.npz")
        checkpoint.save_params(pretrained, path)
        saved_s = time.perf_counter() - t0
        size_gb = os.path.getsize(path) / 2 ** 30
        checkpoint.masked_init(params, path)
    torch.cuda.synchronize()
    copied = [n for n in params if n != "txt/pos_embedding"]
    differ = [n for n in copied if not torch.equal(params[n], pretrained[n])]
    old = pretrained["txt/pos_embedding"].detach().cpu().numpy()
    new = params["txt/pos_embedding"].detach().cpu().numpy()
    # plain linear interpolation at half-pixel centres (np.interp clamps at
    # the ends): jax.image.resize's upsampling
    n_old, n_new = old.shape[1], new.shape[1]
    at = (np.arange(n_new) + 0.5) * n_old / n_new - 0.5
    want = np.stack([np.interp(at, np.arange(n_old), old[0, :, c])
                     for c in range(old.shape[2])], axis=1)[None]
    posemb_err = float(np.abs(new - want).max())
    print(f"masked_init: {len(params)} tensors from a {size_gb:.2f} GiB npz "
          f"(saved in {saved_s:.2f} s, loaded in "
          f"{time.perf_counter() - t0 - saved_s:.2f} s); {len(copied)} copied"
          f", {len(differ)} differ from the saved ones; txt/pos_embedding "
          f"{old.shape} -> {new.shape}, max abs err against linear "
          f"interpolation {posemb_err:.3e} (tolerance {POSEMB_ATOL})",
          flush=True)
    if differ or new.shape != (1, 32, old.shape[2]) \
            or posemb_err > POSEMB_ATOL:
        raise RuntimeError(f"masked_init did not carry the pretrain state "
                           f"over: differ {differ[:5]}, posemb err "
                           f"{posemb_err}")
    return model, state, config


def _attention_counters():
    """(reset, read): set the flash and fused attention kernels' launch
    counters to 0; read them as {"flash_fwd", "flash_bwd", "fused_fwd",
    "fused_bwd": launches}."""
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.ops import flash_attention as fa
    counters = {"flash_fwd": fa.flash_attention,
                "flash_bwd": fa.flash_attention_bwd,
                "fused_fwd": ba.fused_attention,
                "fused_bwd": ba.fused_attention_bwd}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    return reset, read


def _finetune(card, model, state, config):
    """Phase 8: the unmask-tuning step at B = 128 from the masked_init
    state."""
    import numpy as np
    import torch
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.train import step

    reset, read = _attention_counters()
    batch_size = config.input.batch_size
    batch = _finetune_batch(config)
    params = state["params"]
    encoder = model.img.Transformer
    tokens = 1 + int(model.img.grid[0] * model.img.grid[1]
                     * (1 - config.mask_ratio))
    print(f"fine-tune: clipa_finetune.py:{FINETUNE}, image attn_impl "
          f"{encoder.encoderblock_0.MultiHeadDotProductAttention_0.attn_impl}"
          f", remat {encoder.remat_policy}, image tokens {tokens}",
          flush=True)

    def grads():   # the same mask noise every time: step 0's generator
        return _grads(model, params, batch, config.mask_ratio,
                      step.mask_generator(config, 0, "cuda"))

    # kernel path vs plain path, and remat on vs off, from the same state
    loss_k, grads_k = grads()
    before = read()
    _set_attn_impl(model.img, "pallas_plain")
    loss_p, grads_p = grads()
    _set_attn_impl(model.img, "pallas")
    if read() != before:
        raise RuntimeError("the plain path launched a kernel")
    cmp = _compare(loss_k, grads_k, loss_p, grads_p)
    _print_compare("fine-tune step, flash kernels vs pallas_plain", loss_k,
                   loss_p, cmp, LOSS_RTOL)
    del grads_p
    if (cmp["loss_rel"] > LOSS_RTOL or cmp["min_cosine"] < MIN_GRAD_COSINE
            or cmp["noise"] > KEY_BIAS_NOISE):
        raise RuntimeError("the flash kernel path's step differs from the "
                           "plain path's")
    model.img.Transformer.remat_policy = "none"
    loss_n, grads_n = grads()
    model.img.Transformer.remat_policy = "minimal"
    remat = _compare(loss_k, grads_k, loss_n, grads_n, key_bias_noise=False)
    _print_compare("fine-tune step, remat minimal vs none", loss_k, loss_n,
                   remat, REMAT_LOSS_RTOL)
    del grads_k, grads_n
    if (remat["loss_rel"] > REMAT_LOSS_RTOL
            or remat["min_cosine"] < REMAT_MIN_COSINE):
        raise RuntimeError("remat changed the step beyond atomics' noise")

    # the main path: one update step, counters read around it
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=batch_size))
    update = step.make_update_fn(model, tx, config, config.total_steps)
    reset()
    torch.cuda.reset_peak_memory_stats()
    state, meas = update(state, batch)
    torch.cuda.synchronize()
    launches = read()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"flash_fwd": FINETUNE_FWD_LAUNCHES,
            "flash_bwd": TRAIN_IMAGE_LAYERS, "fused_fwd": 0, "fused_bwd": 0}
    print(f"fine-tune step: loss {float(meas['training_loss']):.6f}; kernel "
          f"launches {launches} (expected {want}: the flash forward once "
          f"per image layer and once more in remat's recompute, the text "
          f"tower on the einsum path); peak device memory {peak_gb:.2f} GiB",
          flush=True)
    if launches != want:
        raise RuntimeError(f"fine-tune step launched {launches}, expected "
                           f"{want}")
    if not all(bool(torch.isfinite(v)) for v in meas.values()):
        raise RuntimeError(f"non-finite measurements {meas}")

    # pairs/s on the flash route and on the config's auto route (at L = 138
    # the fused kernels), in turns, best of two each
    rates = {"flash": 0.0, "auto": 0.0}
    auto_launches = None
    for impl in ("flash", "auto", "flash", "auto"):
        _set_attn_impl(model.img, "pallas" if impl == "flash" else "auto")
        if rates[impl] == 0.0:   # warm-up of this route
            reset()
            update(state, batch)
            torch.cuda.synchronize()
            if impl == "auto":
                auto_launches = read()
        rates[impl] = max(rates[impl], batch_size * _steps_per_s(
            update, state, batch, 5))
    _set_attn_impl(model.img, "pallas")
    print(f"{card}: fine-tune pairs/s at B={batch_size}, flash route "
          f"{rates['flash']:.2f}; auto route (fused kernels) "
          f"{rates['auto']:.2f}; auto-route launches per step "
          f"{auto_launches}", flush=True)
    if auto_launches != {"flash_fwd": 0, "flash_bwd": 0,
                         "fused_fwd": FINETUNE_FWD_LAUNCHES,
                         "fused_bwd": TRAIN_IMAGE_LAYERS}:
        raise RuntimeError(f"the auto route launched {auto_launches}")

    # learning check: a fresh optimizer, const schedule, lr override
    config.schedule = [(".*", dict(decay_type="const"))]
    config.lr = LEARN_LR
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=LEARN_STEPS, batch_size=batch_size))
    update = step.make_update_fn(model, tx, config, LEARN_STEPS)
    curve = []
    for _ in range(LEARN_STEPS):
        state, meas = update(state, batch)
        curve.append(float(meas["training_loss"]))
    print(f"fine-tune learning check, {LEARN_STEPS} steps on one batch "
          f"(a new mask each step), const lr {LEARN_LR}: loss "
          f"{curve[0]:.4f} -> {curve[-1]:.4f} "
          f"({' '.join(f'{x:.3f}' for x in curve)})", flush=True)
    if not (np.isfinite(curve).all()
            and curve[-1] < LEARN_FACTOR * curve[0]):
        raise RuntimeError(f"the loss did not fall below {LEARN_FACTOR}x "
                           f"its start: {curve}")
    return {"launches": launches, "auto_launches": auto_launches,
            "pairs_per_s": rates, "peak_gb": peak_gb,
            "loss_rel": cmp["loss_rel"], "min_cosine": cmp["min_cosine"],
            "remat_loss_rel": remat["loss_rel"],
            "remat_min_cosine": remat["min_cosine"],
            "remat_max_abs_gap": remat["max_abs_gap"],
            "learning": [curve[0], curve[-1]]}


def _finetune_h14(card):
    """Phase 12: CLIPA-v2's H/14 unmask-tuning step (FINETUNE_H14: ViT-H/14
    at 224 px, 32 layers, D 1280, 16 heads of 80; the H text tower at 32
    tokens; remat "minimal", bf16 compute, Adam with a bf16 first moment;
    seeded random weights) on the config's `auto` route: the fused forward
    and the backward's long scheme at L = 180. The kernel path against the
    plain path from the same state and mask noise, the launches of one
    update step, pairs/s and peak device memory."""
    import torch
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.configs import clipa_finetune
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.train import step

    reset, read = _attention_counters()
    config = clipa_finetune.get_config(FINETUNE_H14)
    batch_size = config.input.batch_size
    t0 = time.perf_counter()
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED + 2),
        "cuda")
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=batch_size))
    update = step.make_update_fn(model, tx, config, config.total_steps)
    params = state["params"]
    block = model.img.Transformer.encoderblock_0.MultiHeadDotProductAttention_0
    tokens = 1 + int(model.img.grid[0] * model.img.grid[1]
                     * (1 - config.mask_ratio))
    plan = ba.bwd_plan(tokens, model.img.width // block.num_heads)
    torch.cuda.synchronize()
    print(f"H/14 fine-tune: clipa_finetune.py:{FINETUNE_H14}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M fp32 "
          f"parameters, compute {model.img.dtype}, image attn_impl "
          f"{block.attn_impl}, remat {model.img.Transformer.remat_policy}, "
          f"image tokens {tokens}, backward plan {plan}; built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if plan.scheme != ba.BWD_LONG:
        raise RuntimeError(f"the backward plan at L = {tokens} is {plan}, "
                           f"not the long scheme")
    batch = _finetune_batch(config)

    def grads():   # the same mask noise every time: step 0's generator
        return _grads(model, params, batch, config.mask_ratio,
                      step.mask_generator(config, 0, "cuda"))

    # kernel path vs plain path from the same state and noise
    loss_k, grads_k = grads()
    before = read()
    _set_attn_impl(model.img, "plain")
    loss_p, grads_p = grads()
    _set_attn_impl(model.img, "auto")
    if read() != before:
        raise RuntimeError("the plain path launched a kernel")
    cmp = _compare(loss_k, grads_k, loss_p, grads_p)
    _print_compare("H/14 fine-tune step, fused kernels vs plain", loss_k,
                   loss_p, cmp, LOSS_RTOL)
    del grads_k, grads_p
    if (cmp["loss_rel"] > LOSS_RTOL or cmp["min_cosine"] < MIN_GRAD_COSINE
            or cmp["noise"] > KEY_BIAS_NOISE):
        raise RuntimeError("the H/14 kernel path's step differs from the "
                           "plain path's")

    # the main path: one update step, counters read around it
    reset()
    torch.cuda.reset_peak_memory_stats()
    state, meas = update(state, batch)
    torch.cuda.synchronize()
    launches = read()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"H/14 fine-tune step: loss {float(meas['training_loss']):.6f}; "
          f"kernel launches {launches} (expected {FINETUNE_H14_LAUNCHES}); "
          f"peak device memory {peak_gb:.2f} GiB", flush=True)
    if launches != FINETUNE_H14_LAUNCHES:
        raise RuntimeError(f"H/14 fine-tune step launched {launches}, "
                           f"expected {FINETUNE_H14_LAUNCHES}")
    if not all(bool(torch.isfinite(v)) for v in meas.values()):
        raise RuntimeError(f"non-finite measurements {meas}")

    # pairs/s: best of two runs of 3 synchronous steps
    rate = max(batch_size * _steps_per_s(update, state, batch, 3)
               for _ in range(2))
    print(f"{card}: H/14 fine-tune pairs/s at B={batch_size} (auto route) "
          f"{rate:.2f}", flush=True)
    return {"launches": launches, "pairs_per_s": rate, "peak_gb": peak_gb,
            "loss_rel": cmp["loss_rel"], "min_cosine": cmp["min_cosine"],
            "plan": list(plan)}


def _patch_embed(gen):
    """Phase 9: the fused uint8 patch embed against its plain version at the
    PATCH_CASES, then the op as a user calls it, counters read around."""
    import torch
    import torch.nn.functional as F
    from clipa_tpu_torch.ops import patch_embed as pe

    cases = []
    for name, b, side, p, width in PATCH_CASES:
        images = torch.randint(0, 256, (b, side, side, 3), generator=gen,
                               device="cuda", dtype=torch.uint8)
        kernel = torch.randn(p, p, 3, width, generator=gen,
                             device="cuda") * 0.02
        bias = torch.randn(width, generator=gen, device="cuda")
        k_scaled, shift = pe.fold_normalization(kernel)
        errs = []
        for out_dtype in (torch.bfloat16, torch.float32):
            for bb in (bias, None):
                before = pe.fused_patch_embed.launches
                out = pe.fused_patch_embed(images, kernel, bb,
                                           out_dtype=out_dtype,
                                           impl="pallas")
                torch.cuda.synchronize()
                n = pe.fused_patch_embed.launches - before
                if n != 1:
                    raise RuntimeError(f"patch embed at {name}: {n} "
                                       f"launches")
                full = shift if bb is None else shift + bb
                ref = pe.patch_embed_plain(images, k_scaled, full, p,
                                           out_dtype)
                err, ok = pe.errors(out, ref)
                errs.append(err)
                if not ok or out.shape != (b, (side // p) ** 2, width):
                    raise RuntimeError(
                        f"patch embed kernel disagrees with its plain version "
                        f"at {name} {out_dtype} bias={bb is not None}: "
                        f"max abs err {err}")
        full = shift + bias
        x_nchw = images.permute(0, 3, 1, 2).float().contiguous()
        w_oihw = k_scaled.reshape(p, p, 3, width).permute(3, 2, 0, 1) \
            .contiguous()
        lib = F.conv2d(x_nchw, w_oihw, full, stride=p)
        lib_err = (lib.flatten(2).transpose(1, 2) - pe.patch_embed_plain(
            images, k_scaled, full, p, torch.float32)).abs().max().item()
        rows, k = b * (side // p) ** 2, 3 * p * p
        # image, folded weights and bias in, bf16 rows out
        nbytes = images.numel() + 4 * (k * width + width) + 2 * rows * width
        res = {
            "name": name, "max_abs_err": max(errs),
            "ms": _time_ms(lambda: pe.fused_patch_embed(
                images, kernel, bias, impl="pallas"), 20),
            # the op as a user calls it, kernel and folded-product routes
            # (both fold the normalization first); conv2d on pre-folded
            # weights and a pre-cast image
            "plain_ms": _time_ms(lambda: pe.fused_patch_embed(
                images, kernel, bias, impl="xla"), 20),
            "library_ms": _time_ms(lambda: F.conv2d(
                x_nchw, w_oihw, full, stride=p), 20),
            # the function's least time: uint8 is exact in bf16 and the
            # folded weights split into bf16 hi + lo, so two bf16
            # tensor-core products give the fp32 product to near-fp32
            # accuracy (twice the operations at 989 TFLOP/s)
            "bound": _bound(nbytes, 2 * 2 * rows * k * width,
                            torch.bfloat16),
            # this design's bound: one product on the fp32 FMA units
            "fp32_fma_bound": _bound(nbytes, 2 * rows * k * width,
                                     torch.float32),
        }
        cases.append(res)
        print(f"patch embed {name} B={b} p={p} width={width} (K={k}): max "
              f"abs err {res['max_abs_err']:.3e} (bf16/fp32 out, "
              f"with/without bias; conv2d vs plain {lib_err:.2e}); kernel "
              f"{res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms conv2d "
              f"{res['library_ms']:.4f} ms bound {res['bound'][0]:.4f} ms "
              f"({res['bound'][1]}, bf16 hi + lo); fp32-FMA bound of this "
              f"design {res['fp32_fma_bound'][0]:.4f} ms", flush=True)
        del images, x_nchw, lib

    # the main path: the op at the three shapes, counters read around
    inputs = []
    for _, b, side, p, width in PATCH_CASES:
        inputs.append((torch.randint(0, 256, (b, side, side, 3),
                                     generator=gen, device="cuda",
                                     dtype=torch.uint8),
                       torch.randn(p, p, 3, width, generator=gen,
                                   device="cuda") * 0.02))
    pe.fused_patch_embed.launches = 0
    outs = [pe.fused_patch_embed(x, w, impl="pallas") for x, w in inputs]
    torch.cuda.synchronize()
    launches = pe.fused_patch_embed.launches
    want = len(inputs)
    print(f"patch embed main path: {len(inputs)} calls, kernel launches "
          f"{launches} (expected {want})", flush=True)
    if launches != want or not all(bool(torch.isfinite(o).all())
                                   for o in outs):
        raise RuntimeError(f"patch embed launched {launches} times, "
                           f"expected {want}, or non-finite output")
    return {"cases": cases, "launches": launches}


def _sweep():
    """Phase 10: tools/attn_sweep.py, counters read around."""
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.tools import attn_sweep
    counters = {"fwd": ba.fused_attention, "bwd": ba.fused_attention_bwd,
                "deferred": ba.fused_attention_bwd_deferred}
    for c in counters.values():
        c.launches = 0
    rows = attn_sweep.main(["--iters", str(SWEEP_ITERS)])
    launches = {n: c.launches for n, c in counters.items()}
    print(f"attn_sweep kernel launches {launches}", flush=True)
    if min(launches.values()) == 0:
        raise RuntimeError(f"the sweep missed a kernel: {launches}")
    return {"rows": {r["name"]: r for r in rows}, "launches": launches}


def _tools():
    """Phase 11: tools/ablate_step.py at L/16 @112 B=384 and tools/flops.py
    on the serving model."""
    import math
    from clipa_tpu_torch.tools import ablate_step, flops
    t0 = time.perf_counter()
    results, launches = ablate_step.main(ABLATE)
    print(f"ablate_step {' '.join(ABLATE)} in "
          f"{time.perf_counter() - t0:.1f} s; launches per rung {launches}",
          flush=True)
    keys = ("fwd_ms", "grad_ms", "sgd_ms", "adam_ms", "grad_noattn_ms",
            "grad_titext_ms", "hbm_triad_gbps")
    if not all(k in results and math.isfinite(results[k]) for k in keys):
        raise RuntimeError(f"ablate_step results {results}")
    if not results["fwd_ms"] < results["grad_ms"]:
        raise RuntimeError("ablate_step: the forward took longer than the "
                           "gradient")
    # grad_noattn: the stand-in core ran in place of every attention core
    # (its calls counted), and no attention kernel was launched
    noattn = dict(launches["grad_noattn_ms"])
    if noattn.pop("bypassed") == 0 or any(noattn.values()):
        raise RuntimeError(f"grad_noattn did not bypass attention: "
                           f"{launches['grad_noattn_ms']}")
    if any(r["bypassed"] for k, r in launches.items()
           if k != "grad_noattn_ms"):
        raise RuntimeError(f"attention was bypassed outside grad_noattn: "
                           f"{launches}")
    if not (launches["grad_ms"]["fused_fwd"]
            and launches["grad_ms"]["fused_bwd"]):
        raise RuntimeError("the grad rung missed the fused kernels")
    stats = flops.main(["--model", MODEL])
    print(f"flops {MODEL} (meta device): {json.dumps(stats)}", flush=True)
    return {"ablate": results, "flops": stats}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np
    from clipa_tpu_torch.ops import block_attention as ba, cuda_build
    from clipa_tpu_torch.ops import flash_attention as fa
    from clipa_tpu_torch.ops import patch_embed as pe
    from clipa_tpu_torch.serving import EmbeddingService

    card = _card()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build: one nvcc per source, started together
    sources = {"fused_attention_fwd.cu": ba.fwd_library,
               "fused_attention_bwd.cu": ba.bwd_library,
               "flash_attention_fwd.cu": fa.fwd_library,
               "flash_attention_bwd.cu": fa.bwd_library,
               "patch_embed.cu": pe.library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(load) for load in sources.values()]:
            f.result()
    for source in sources:
        print(f"kernel built from clipa_tpu_torch/csrc/{source} in "
              f"{cuda_build.build_seconds[source]:.2f} s -> "
              f"{cuda_build.library_path(source)}", flush=True)
    print(f"{len(sources)} kernel sources built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

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
    by_shape = {name: _kernel_case(*shape, 1.0, gen=gen, device=True)
                for name, *shape in FUSED_SHAPES}
    main_case = by_shape["bucket 256"]
    for name, c in by_shape.items():
        dev, bound = c["device_ms"], c["bound"][0]
        sdpa = ""
        if "library_ms" in c:
            lib = c["library_device_ms"]
            sdpa = (f"; kernel / SDPA {_ratio(dev, lib, '.2f')}x by device "
                    f"time ({_fmt(lib)} ms)")
        print(f"{card}: K1 fused_attention_fwd at {name}: {c['ms']:.4f} ms by "
              f"events, {_fmt(dev)} device; {bound:.4f} ms bound "
              f"({c['bound'][1]}): {_ratio(bound, dev, '.1%')} by device "
              f"time{sdpa}", flush=True)

    # 3. backward kernel vs plain backward
    bwd_by_shape = {name: _bwd_case(*shape, 1.0, gen=gen, device=True)
                    for name, *shape in BWD_SHAPES}
    bwd_main = bwd_by_shape["L/16 @112"]
    for name, c in bwd_by_shape.items():
        dev, bound = c["device_ms"], c["bound"][0]
        sdpa = ""
        if "library_ms" in c:
            lib = c["library_device_ms"]
            sdpa = (f"; kernel / SDPA bwd {_ratio(dev, lib, '.2f')}x by "
                    f"device time ({_fmt(lib)} ms)")
        print(f"{card}: K6 fused_attention_bwd at {name}: {c['ms']:.4f} ms "
              f"by events, {_fmt(dev)} device; {bound:.4f} ms bound "
              f"({c['bound'][1]}): {_ratio(bound, dev, '.1%')} by device "
              f"time{sdpa}", flush=True)
    past_clip = [_bwd_case(*c, gen=gen, device=True) for c in (
        (8, 50, 1024, 16, True, False, 40.0),   # clip mode past the clip
        (2, 40, 256, 4, False, False, 40.0),    # ... without bias
    )]
    bwd_cases = list(bwd_by_shape.values()) + past_clip + [
        _bwd_case(*c, gen=gen) for c in (
            (8, 257, 1280, 16, True, False, 1.0),   # the long scheme, hd 80
            (2, 577, 1024, 16, False, False, 1.0),  # L = 577, no bias (K4)
            (2, 40, 256, 4, True, True, 40.0),      # exact mode, logits >> 70
        )]
    bwd_cases.append(_bwd_case(8, 257, 1280, 16, True, False, 1.0, gen=gen,
                               dtype=torch.float32, iters=2))  # fp32 twin
    for c in past_clip:
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
    del svc, plain   # the services' weights stay out of the later peaks

    # 6. the flash kernels vs their plain versions
    flash_cases = [_flash_case(*c, gen=gen) for c in FLASH_SHAPES]
    flash_main = flash_cases[0]
    flash_cases.append(_flash_case(2, 138, 138, 4, 64, 1.0, gen=gen,
                                   dtype=torch.float32, iters=2))
    for name, pre in (("K7 flash_attention_fwd", ""),
                      ("K8 flash_attention_bwd", "bwd_")):
        ms, dev = flash_main[f"{pre}ms"], flash_main[f"{pre}device_ms"]
        lib_ms = flash_main[f"{pre}library_ms"]
        lib_dev = flash_main[f"{pre}library_device_ms"]
        bound = flash_main[f"{pre}bound"][0]
        print(f"{card}: {name} at B=128 L=138 H=16 hd 64: {ms:.4f} ms by "
              f"events, {_fmt(dev)} device; {bound / ms:.1%} of its bound "
              f"({bound:.4f} ms), {_ratio(bound, dev, '.1%')} by device "
              f"time; kernel / SDPA {ms / lib_ms:.2f}x ({lib_ms:.4f} ms), "
              f"{_ratio(dev, lib_dev, '.2f')}x by device time "
              f"({_fmt(lib_dev)} ms)", flush=True)

    # 7. masked_init from the pretrain state, 8. the unmask-tuning step
    model, state, config = _transition(train.pop("params"))
    tune = _finetune(card, model, state, config)
    del model, state
    torch.cuda.empty_cache()

    # 9. the patch embed, 10. the attention sweep, 11. the tools
    patch = _patch_embed(gen)
    sweep = _sweep()
    tools = _tools()

    # 12. the H/14 unmask-tuning step
    torch.cuda.empty_cache()
    h14 = _finetune_h14(card)
    torch.cuda.empty_cache()

    print(json.dumps({"finetune": {
        "config": f"clipa_tpu_torch/configs/clipa_finetune.py:{FINETUNE}",
        "image_attn_impl": "pallas",
        **{k: tune[k] for k in ("pairs_per_s", "peak_gb", "loss_rel",
                                "min_cosine", "remat_loss_rel",
                                "remat_min_cosine", "remat_max_abs_gap",
                                "learning")},
    }, "finetune_h14": {
        "config": f"clipa_tpu_torch/configs/clipa_finetune.py:{FINETUNE_H14}",
        "image_attn_impl": "auto",
        **{k: h14[k] for k in ("launches", "pairs_per_s", "peak_gb",
                               "loss_rel", "min_cosine", "plan")},
    }}))
    print(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "clipa_tpu/ops/block_attention.py:165",
        "launches": launches + train["launches"]["fwd"],
        "launches_by_path": {
            "serving": launches, "training_step": train["launches"]["fwd"],
            "finetune_step_auto": tune["auto_launches"]["fused_fwd"],
            "finetune_h14_step": h14["launches"]["fused_fwd"]},
        "max_abs_err": max(c["max_abs_err"]
                           for c in cases + list(by_shape.values())),
        "ms": main_case["ms"],
        "device_ms": main_case["device_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound"][0],
        "bound_by": main_case["bound"][1],
        "library_ms": None,   # clip-mode softmax: no one PyTorch call
        "by_shape": {name: {
            **{k: c[k] for k in ("ms", "device_ms", "plain_ms")},
            "bound_ms": c["bound"][0],
            "library_ms": c.get("library_ms"),
            "library_device_ms": c.get("library_device_ms")}
            for name, c in by_shape.items()},
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "clipa_tpu/ops/block_attention.py:672",
        "launches": train["launches"]["bwd"],
        "launches_by_path": {
            "training_step": train["launches"]["bwd"],
            "finetune_step_auto": tune["auto_launches"]["fused_bwd"],
            "finetune_h14_step": h14["launches"]["fused_bwd"]},
        "max_abs_err": max(c["max_abs_err"] for c in bwd_cases),
        "ms": bwd_main["ms"],
        "device_ms": bwd_main["device_ms"],
        "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound"][0],
        "bound_by": bwd_main["bound"][1],
        "library_ms": None,   # clip-mode softmax: no one PyTorch call
        "by_shape": {name: {
            **{k: c[k] for k in ("ms", "device_ms", "plain_ms")},
            "bound_ms": c["bound"][0],
            "library_ms": c.get("library_ms"),
            "library_device_ms": c.get("library_device_ms")}
            for name, c in bwd_by_shape.items()},
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "clipa_tpu/ops/flash_attention.py:57",
        "launches": tune["launches"]["flash_fwd"],
        "max_abs_err": max(c["errors"]["o"] for c in flash_cases),
        "ms": flash_main["ms"],
        "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound"][0],
        "bound_by": flash_main["bound"][1],
        "library_ms": flash_main["library_ms"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "clipa_tpu/ops/flash_attention.py:125",
        "launches": tune["launches"]["flash_bwd"],
        "max_abs_err": max(max(c["errors"][n] for n in ("dq", "dk", "dv"))
                           for c in flash_cases),
        "ms": flash_main["bwd_ms"],
        "plain_ms": flash_main["bwd_plain_ms"],
        "bound_ms": flash_main["bwd_bound"][0],
        "bound_by": flash_main["bwd_bound"][1],
        "library_ms": flash_main["bwd_library_ms"],
    }, {
        "name": "patch_embed",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/patch_embed.cu",
        "replaces": "clipa_tpu/ops/patch_embed.py:54",
        "launches": patch["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in patch["cases"]),
        "ms": patch["cases"][0]["ms"],
        "plain_ms": patch["cases"][0]["plain_ms"],
        "bound_ms": patch["cases"][0]["bound"][0],
        "bound_by": patch["cases"][0]["bound"][1],
        "library_ms": patch["cases"][0]["library_ms"],
        "by_shape": {c["name"]: {
            **{k: c[k] for k in ("ms", "plain_ms", "library_ms")},
            "bound_ms": c["bound"][0],
            "fp32_fma_bound_ms": c["fp32_fma_bound"][0]}
            for c in patch["cases"]},
    }, {
        "name": "fused_attention_bwd_deferred",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "clipa_tpu/tools/attn_sweep.py:76",
        "launches": sweep["launches"]["deferred"],
        "max_abs_err": max(r["max_abs_err"] for n, r in sweep["rows"].items()
                           if "deferred" in n),
        "ms": sweep["rows"]["bwd deferred clip"]["ms"],
        "plain_ms": sweep["rows"]["bwd deferred clip"]["plain_ms"],
        "bound_ms": bwd_main["bound"][0],
        "bound_by": bwd_main["bound"][1],
        "library_ms": None,   # clip-mode softmax: no one PyTorch call
        "sweep_ms": {n: r["ms"] for n, r in sweep["rows"].items()},
    }], "training": {
        "config": f"clipa_tpu_torch/configs/clipa_pretrain.py:{PRETRAIN}",
        "pairs_per_s": train["pairs_per_s"],
        "peak_gb": train["peak_gb"],
    }, "ablate_step": tools["ablate"], "flops": tools["flops"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
