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
config's ``auto`` route (the fused kernels; the backward's long scheme),
the trainer from the data pipeline, CLIPA's zero-shot ImageNet eval in
the trainer and in ``tools/eval_zeroshot``, the trainer from JPEG
tfrecords at a batch of 1536 through two-pass gradient accumulation on the
native host library, CLIPA-v2's 224 -> 336 chain, distillation, and
CLIPA-v1's ``ViT-L-16-CL8-Syntax-GAP`` and open_clip's ``ViT-L-14``
exported to open_clip checkpoints, loaded back and served behind one
``MultiModelService``, and CoCa (``coca_ViT-L-14``) exported and loaded
back, served, captioning and trained, in the step and in the trainer.

  1. the card, torch/CUDA versions, and the five kernel sources built from
     clipa_tpu_torch/csrc, one nvcc per source, in parallel with g++ on the
     native host library (clipa_tpu_torch/native: its seconds, its path,
     whether /usr/include/jpeglib.h exists and which libjpeg it links);
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
     ``save_params`` in the JAX layout (``convert.to_jax_params``), the
     fine-tune model initialized from the file: every
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
     of 3 steps) and peak device memory;
 13. the trainer entry point, ``train.loop.main`` (``python -m
     clipa_tpu_torch.train``), on a config file that wraps
     ``clipa_pretrain.py:img=L/16,res=112,token_len=8,batchsize=384`` and
     changes the data source (synthetic decoded 144 px uint8 images, 16
     captions longer than 7 WordPiece ids), the pp in-keys (``image``,
     ``texts``; ops and arguments unchanged: the inception crop to 112, the
     SimCLR jitter, syntax_tokenize), the shuffle buffer (4 batches), the
     steps, the schedule's warmup (2 steps: the config's 3200 must be fewer
     than total_steps), log every step, checkpoints every 4, keep 2. Run 1
     trains 4 steps, run 2 extends to 8 on the same workdir and resumes at
     step 4. Raises unless metrics.jsonl logs steps 1-8 once each with the
     JAX loop's keys and finite losses, every step launches the fused
     forward and backward 24 times each and the flash kernels never, the
     step-4 checkpoint restores into a fresh model and optimizer equal to
     run 1's final state bit for bit (params, mu, nu, count), and
     params.npz (the JAX layout) loads into a new model through
     ``load_params`` and equals the final params bit for bit. Prints the
     trainer's pairs/s (host clock, steps 2-4 and 6-8) beside phase 5's
     with the batch on the device and the input pipeline's batches/s
     alone; the checkpoint's bytes, save and restore seconds; peak device
     memory;
 14. CLIPA's evals in the trainer: ``imagenet2012-validation`` tfrecords
     (4096 PIL-encoded 160 x 144 JPEGs, labels 0-999, a class-dependent
     channel signal) in a ``data_dir``; phase 13's config wrapper over
     ``clipa_pretrain.py:...,data_dir=<dir>``, so ``config.evals.disclf``
     is the config's own zero-shot eval (1000 class names x 81 CLIP-paper
     prompts, ``decode|resize_small(112)|central_crop(112)``, B = 384)
     with log_steps 2, plus a contrastive eval on 1536 synthetic pairs
     through the train pp. Run A trains 4 steps; run B replays the step-4
     checkpoint with ``eval_only``. Raises unless the zero-shot accuracy is
     logged at steps 1, 2 and 4 (the JAX loop's cadence) in [0, 1], the
     contrastive loss is finite, the training losses equal phase 13's run
     1 bit for bit, every zero-shot run launches the fused forward 24 x 11
     = 264 times and nothing else, and eval_only reproduces the step-4
     accuracy exactly. Then ``tools/eval_zeroshot`` on
     ViT-H-14-CL32-GAP-BigVision @224 from an npz of the serving model's
     seeded random weights (JAX layout) over the same tfrecords: a finite
     accuracy and 32 x 16 fused forwards. Prints the prompt-embedding
     seconds, the eval images/s with JPEG decode in the pp, the evals'
     seconds beside the steps'.
 15. the trainer from JPEG tfrecords: (a) 8192 JPEGs of 256 x 256 random
     pixels with phase 13's captions, as features ``jpg`` and ``txt`` (the
     layout tools/laion writes), in 16 shards; (b) the pipeline alone
     (``tools/bench_pipeline.measure``, the config's pp at B = 384) on 48
     threads on the native route, on 48 threads on the PIL and Python
     route, on 16 and on 32 worker processes, in turns: pairs/s each (the
     thread runs held to their route's decodes and encodes; the worker
     processes count in their own memory, so their route is not read); (c)
     ``train.loop.main`` on a file wrapping
     ``clipa_pretrain.py:img=L/16,res=112,token_len=8,batchsize=1536,
     data_dir=<the shards>`` (shuffle buffer 2 x 1536, warmup 2, log every
     step; no evals or checkpoints: phases 13-14 run those) with
     ``--config.grad_accum_steps=4`` for 3 steps: raises unless the losses
     are finite, every step launches the fused forward 192 times (4
     microbatches x 24 layers x 2 passes), the fused backward 96 times and
     the flash kernels never, every JPEG took the native decode and every
     caption the native WordPiece (``pp/ops_text``'s counts); prints pairs/s over steps 2-3,
     seconds per step and peak device memory beside phase 13's rate; (d)
     on one state and one B = 384 batch, 4 x 96 accumulated against one
     pass: the loss within ACCUM_LOSS_RTOL, every gradient but ``t``'s at
     cosine >= ACCUM_MIN_COSINE and its norm within ACCUM_NORM_RTOL of the
     single pass's, ``t``'s 4x the single pass's within rtol 1e-2;
     (e) one step of ``loss=chunked`` (chunk 96) against the softmax loss
     (rtol 1e-5, cosine >= 0.9999); the accumulated step alone at B =
     1536 with the batch on the device (pairs/s, best of two runs of 2
     steps); one step of ``loss=sigmoid`` with ``bias_init=-10`` (finite,
     ``b`` gets a gradient).
 16. CLIPA-v2's 224 -> 336 unmask-tuning chain at L/16 through
     ``train.loop.main`` on ``file://`` workdirs from phase 15's shards: the
     224 stage from phase 13's params.npz (2 steps, its local stage
     deleted, resumed to 4 from the pull: the restored state bit for bit
     the pushed checkpoint), the 336 stage (L = 265, the backward's long
     scheme) 3 steps from the 224 stage's npz URL, kernel against plain on
     one batch, pairs/s, peak memory, the npz and sync seconds;
 17. distillation from a frozen H/14 teacher (a ``file://`` npz) with
     ``--config.lwd=0.85`` in the trainer: 56 fused forwards and 24
     backwards per step, the teacher bit for bit after the steps, lwd's
     multipliers, kernel against plain, the teacher's share of a step;
 18. open_clip interop at full width, seeded weights: CLIPA-v1's
     ``ViT-L-16-CL8-Syntax-GAP`` (@224, L = 197, ``gap_all``; the 8-token
     text tower, BPE with syntax masking) and open_clip's ``ViT-L-14``
     (L = 257, ``ln_pre``, class-token pool; the causal 77-token text tower
     pooled at eot): each exported with ``compat.export.save_open_clip``
     (which allocates nothing on the card) and loaded back with ``create_model(..., pretrained=<.bin>)``, every
     tensor bit for bit; ViT-L-14's state dict under OpenAI's keys through
     ``load_openai_model``, its embeddings bit for bit those of
     ``create_model("ViT-L-14-quickgelu", <.bin>)``; both served from
     their .bin files by one ``MultiModelService(max_live=1)`` with the BPE
     tokenizer on a merges file of 48 894 merges written here: requests of
     5, 64 and 300 uint8 images and caption batches (some past the 8-token
     budget: syntax sampling bites), shapes, finite values, unit norms, 24
     fused forwards per image chunk, each switch evicts the other model
     (the device's live tensors within one model's weights plus 10%),
     ``embed_*_to`` .npy equal to the in-RAM path, cosine >= 0.999 against
     the plain attention path; images/s at bucket 256 per model, and
     texts/s on 2048 distinct seeded captions, the tokenizer's word cache
     cold and then warm, with the tokenizer's seconds and the text tower's
     apart; peak memory, the export, save and load seconds. Phase 2 times
     the fused forward at both image towers' bucket-256 shapes.
 19. CoCa at ``coca_ViT-L-14``'s full width, seeded weights (the image
     tower L/14 @224: L = 257, D = 1024, 16 heads of 64, on the fused
     kernels; the attentional pooler, the embed_cls text tower at 75 ids
     plus the cls and the caption decoder on the einsum path): (b) the fp32
     model exported with ``save_open_clip`` (nothing allocated on the
     card) and loaded back with ``create_model(..., pretrained=<.bin>)``,
     every tensor bit for bit; (a) ``EmbeddingService`` in bf16 with
     phase 18's merges file: requests of 5, 64 and 300 uint8 images and two
     caption batches, shapes, finite values, unit norms, 24 fused forwards
     per image chunk, cosine >= 0.999 against the plain attention path,
     images/s and texts/s at bucket 256; (c) ``generate`` on 4 images:
     beam search (6 beams in 3 groups, 30 ids) and top-k / top-p from a
     seed, every output from sot, every beam output holding eos, 24 fused
     forwards per call, the logits at every position of the beam outputs
     against the plain path (cosine >= 0.999), seconds per caption; (d)
     ``make_update_fn`` with ``model_name="coca"``, ``loss="coca"`` on
     ``clipa_pretrain.py:img=L/16,res=224,token_len=76,batchsize=128``'s
     optimizer (B = 128, bf16 compute, fp32 masters, 76 BPE ids): 24 fused
     forwards and 24 backwards per step, the kernel path's loss and every
     gradient against the plain path's (rtol 1e-2, cosine >= 0.99), the
     image tower at remat "full" against none (every gradient bit for
     bit, a lower peak), pairs/s (best of two), peak memory, 20 steps on
     one batch lowering the loss below 0.9x its start and the caption
     loss, one step at DropPath 0.1; (e) ``train.loop.main`` for 3 steps on
     a config file setting ``model_name="coca"``, ``loss="coca"`` and the
     model of coca_ViT-L-14 over that pretrain config at 224 px, from
     phase 15's JPEG tfrecords (its pp: WordPiece ids, in the CoCa
     vocabulary's range): finite losses, 24 + 24 fused launches per step.
     Phases 2 and 3 time the fused forward and backward at the step's B =
     128, L = 257, D = 1024.
 20. the HF text towers, Swin, relpos-ViT and the timm ViT table at full
     width, seeded weights, token ids made here (no HF tokenizer on the
     card's machine): (a) ``EmbeddingService`` over
     xlm-roberta-large-ViT-H-14 in bf16 at bucket 256, 1024 uint8 images
     and 2048 id rows of 77 (``embed_tokens``): 32 fused forwards per
     image chunk (L = 257, hd 80) and none in the pad-masked text tower,
     cosine >= 0.999 against the plain path, images/s and texts/s; (b)
     coca_roberta-ViT-B-32: exported (npz: the open_clip layout has no HF
     text map) and loaded back bit for bit, ``generate`` by beam search
     and top-k / top-p (12 fused forwards per call), the CoCa step at B =
     128 against the plain path (rtol 1e-2, cosine >= 0.99), then 3 steps
     of 12 + 12 launches (L = 50, D = 768, 12 heads); (c) LiT: the
     two-towers step with the BERT-base text tower
     (``proj.flaxformer.bert``) over 64 WordPiece ids and a B/32 image
     tower, B = 256, against the plain path, then 3 steps, each launching
     12 fused forwards and 12 backwards in each tower, counted by (L, D):
     the text tower's at L = 64; (d) roberta-, xlm-roberta-base- and
     mt5-base-ViT-B-32, vit_medium_patch16_gap_256 (the fused kernels at L
     = 257, D = 512, 8 heads), swin_base_patch4_window7_224 and
     vit_relpos_medium_patch16_cls_224 served in bf16 at bucket 64 (128
     images, 256 id rows): launches, cosine >= 0.999 against the plain
     path, the export round trip bit for bit (open_clip .bin, or npz for
     the HF text towers). Phases 2 and 3 time the kernels at the new
     shapes.
 21. the conv towers at full width, seeded weights, bf16, no attention
     kernel on their path (the convs are cuDNN's, the 77-token causal text
     towers einsum; the phase launches none, and checks it): (a)
     ``EmbeddingService`` over convnext_xxlarge @256 (dims 384-3072, depths
     3/4/30/3; 24-layer 1024-wide text tower), 1024 uint8 images and 2048
     id rows at bucket 256: images/s and texts/s (best of two), images/s
     beside the bf16 tensor-core bound of its forward FLOPs, the bf16
     embeddings against the port's own fp32 tower on 64 images (cosine >=
     0.99); (b) RN50x64 @448 with seeded statistics (means N(0, 0.1),
     variances U(0.5, 2)): 512 images at bucket 256, images/s; its state
     dict in OpenAI's layout (open_clip's CLIP keys, num_batches_tracked
     included) written to a .pt and read back by ``load_openai_model`` and
     ``create_model(..., pretrained=<.pt>)``: every tensor and the image
     embeddings bit for bit; (c) convnext_large_d's mlp head exported with
     ``save_open_clip`` and loaded back from the .bin, bit for bit; (d) the
     training step (``step.create_model``, the pretrain config's optimizer
     at a const lr) at convnext_xxlarge @256, B = 64, 77 ids, DropPath
     0.1, no remat: 5 steps on one batch, the loss falling, pairs/s (best
     of two 2-step windows), peak memory.

Every phase raises on failure (non-zero exit). Needs one CUDA device; exits
non-zero without one. The last line is the result JSON; the line before it
lists every kernel with its launches, error, time, plain and library time
and the least time the card could take for the same work.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# ... and the release's last stage, at 336 px and mask 0.4: 1 + int(576 x
# 0.6) = 346 image tokens (the backward's long scheme, the forward fused).
FINETUNE_H14_336 = ("img=H/14,res=336,token_len=32,mask_ratio=0.4,"
                    "batchsize=32")
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
# without biases that SDPA also computes (at bucket 256, and at the
# pretrain step's shape, the attention sweep's of phase 10), the H/14
# unmask-tuning stages (224 px at mask 0.3: L = 180, B = 64 as in phase
# 12; 336 px at mask 0.4: L = 346, B = 16), phase 18's image towers at
# bucket 256 (ViT-L/16 @224: L = 197; ViT-L/14 @224: L = 257; D = 1024;
# coca_ViT-L-14's served tower too), phase 19's CoCa step (B = 128), and
# phase 20's: the LiT BERT text tower (L = 64, D = 768, 12 heads), the
# B/32 image tower of coca_roberta's step and LiT's (L = 50), and
# vit_medium_patch16_gap_256 served at bucket 64 (L = 257, D = 512, 8 heads)
FUSED_SHAPES = (("bucket 256", 256, 257, 1280, 16, True, False),
                ("L/16 @112", 384, 50, 1024, 16, True, False),
                ("fine-tune auto", 128, 138, 1024, 16, True, False),
                ("bucket 256 exact", 256, 257, 1280, 16, False, True),
                ("L/16 @112 exact", 384, 50, 1024, 16, False, True),
                ("H/14 @224 mask 0.3", 64, 180, 1280, 16, True, False),
                ("H/14 @336 mask 0.4", 16, 346, 1280, 16, True, False),
                ("L/16 @224 bucket 256", 256, 197, 1024, 16, True, False),
                ("L/14 @224 bucket 256", 256, 257, 1024, 16, True, False),
                ("CoCa L/14 @224 B=128", 128, 257, 1024, 16, True, False),
                ("LiT BERT text L=64 B=256", 256, 64, 768, 12, True, False),
                ("B/32 @224 B=128", 128, 50, 768, 12, True, False),
                ("vit_medium bucket 64", 64, 257, 512, 8, True, False))

# Phase 3's timed cases of the fused backward, (name, b, l, d, h, bias,
# exact): the pretrain step's (L/16 @112), the H/14 @84 headline pretrain
# (`bench.py` STAGES["pretrain_h14"]: hd 80), the fine-tune step's `auto`
# route, the exact form without biases that SDPA's backward also computes,
# the H/14 unmask-tuning stages (the long scheme), each also in the exact
# form without biases beside SDPA's backward, phase 19's CoCa step
# (coca_ViT-L-14 @224, B = 128, L = 257, hd 64: the long scheme), and
# phase 20's steps (the LiT BERT text tower at L = 64 and the B/32 image
# tower at L = 50, D = 768: the whole-head scheme)
BWD_SHAPES = (("L/16 @112", 384, 50, 1024, 16, True, False),
              ("H/14 @84", 256, 37, 1280, 16, True, False),
              ("fine-tune auto", 128, 138, 1024, 16, True, False),
              ("L/16 @112 exact", 384, 50, 1024, 16, False, True),
              ("H/14 @224 mask 0.3", 64, 180, 1280, 16, True, False),
              ("H/14 @336 mask 0.4", 16, 346, 1280, 16, True, False),
              ("H/14 @224 mask 0.3 exact", 64, 180, 1280, 16, False, True),
              ("H/14 @336 mask 0.4 exact", 16, 346, 1280, 16, False, True),
              ("CoCa L/14 @224 B=128", 128, 257, 1024, 16, True, False),
              ("LiT BERT text L=64 B=256", 256, 64, 768, 12, True, False),
              ("B/32 @224 B=128", 128, 50, 768, 12, True, False))

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


def _grads(model, params, batch, mask_ratio=0.0, generator=None,
           teacher=None, apply_loss=None):
    """(loss, {name: fp32 grad}) of the training loss at the current state;
    image tokens masked at `mask_ratio` with noise from `generator`; with a
    `teacher`, the distillation loss against its forward (eval mode, no
    graph, the unmasked images), as the update step computes it; with
    `apply_loss` (the step's loss dispatch), that loss."""
    import torch
    from clipa_tpu_torch import losses
    from clipa_tpu_torch.ops import preprocess
    images = preprocess.normalize_uint8(batch["image"])
    model.train()
    zi, zt, out = model(images, batch["labels"], mask_ratio=mask_ratio,
                        generator=generator)
    if apply_loss is not None:
        loss, _ = apply_loss(zi, zt, out)
    elif teacher is None:
        loss, _ = losses.bidirectional_contrastive_loss(zi, zt, out["t"],
                                                        reduction=True)
    else:
        teacher.eval()
        with torch.no_grad():
            t_zi, t_zt, t_out = teacher(images, batch["labels"])
        loss, _ = losses.distill_contrastive_loss(zi, zt, out["t"], t_zi,
                                                  t_zt, t_out["t"])
    names = list(params)
    found = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.item(), {n: g.float() for n, g in zip(names, found)}


def _compare(loss_a, grads_a, loss_b, grads_b, key_bias_noise=True):
    """How two steps' loss and gradients agree: the loss's relative gap and
    each gradient's cosine. With `key_bias_noise` the key biases are left
    out of the cosines: they get no gradient in exact arithmetic (a bias
    added to every key shifts a softmax row by a constant), so both sides
    hold rounding noise there, whose direction means nothing; their norm is
    reported instead, as a share of the query bias's. (CoCa's attentional
    pooler's ``k_proj`` bias is such a key bias too.)"""
    import numpy as np
    import torch
    key_bias = ([n for n in grads_a
                 if n.endswith(("/key/bias", "/k_proj/bias"))]
                if key_bias_noise else [])
    cosines = {n: torch.nn.functional.cosine_similarity(
        grads_a[n].flatten(), grads_b[n].flatten(), dim=0, eps=1e-30).item()
        for n in grads_a if n not in key_bias}
    noise = max((max(g[n].norm().item() / g[n.replace("/key/", "/query/")
                                            .replace("/k_proj/", "/q_proj/")]
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
            "model": model}


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


def _transition(pretrained_model):
    """Phase 7: the fine-tune model initialized by masked_init from the
    pretrain model's parameters written to npz (the JAX layout)."""
    import numpy as np
    import torch
    from clipa_tpu_torch import convert, optim
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
    pretrained = optim.named_parameters(pretrained_model)
    t0 = time.perf_counter()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "pretrain_params.npz")
        checkpoint.save_params(convert.to_jax_params(pretrained_model), path)
        saved_s = time.perf_counter() - t0
        size_gb = os.path.getsize(path) / 2 ** 30
        checkpoint.masked_init(model, path)
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


def _counting(per_step, stamps):
    """A stand-in for step.make_update_fn whose update records each step's
    kernel launches and end time."""
    import torch
    from clipa_tpu_torch.train import step
    reset, read = _attention_counters()
    make_update_fn = step.make_update_fn

    def counted(*args, **kw):
        update = make_update_fn(*args, **kw)

        def run(state, batch):
            reset()
            state, meas = update(state, batch)
            per_step.append(read())
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return state, meas
        return run
    return counted


class _Patched:
    """Sets attributes of modules for the length of a `with` block:
    _Patched((module, name, value), ...)."""

    def __init__(self, *patches):
        self.patches = patches

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for module, name, value in self.patches:
            setattr(module, name, value)

    def __exit__(self, *exc):
        for module, name, value in self.saved:
            setattr(module, name, value)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


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


def _finetune_h14(card, spec):
    """Phase 12: CLIPA-v2's H/14 unmask-tuning step (`spec`: FINETUNE_H14,
    ViT-H/14 at 224 px and mask 0.3, or FINETUNE_H14_336, 336 px at mask
    0.4; 32 layers, D 1280, 16 heads of 80; the H text tower at 32 tokens;
    remat "minimal", bf16 compute, Adam with a bf16 first moment; seeded
    random weights) on the config's `auto` route: the fused forward and
    the backward's long scheme at L = 180 or 346. The kernel path against
    the plain path from the same state and mask noise, the launches of one
    update step, pairs/s and peak device memory."""
    import torch
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.configs import clipa_finetune
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.train import step

    reset, read = _attention_counters()
    config = clipa_finetune.get_config(spec)
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
    print(f"H/14 fine-tune: clipa_finetune.py:{spec}, "
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
    print(f"{card}: H/14 fine-tune pairs/s at B={batch_size}, L={tokens} "
          f"(auto route) {rate:.2f}", flush=True)
    return {"tokens": tokens, "launches": launches, "pairs_per_s": rate,
            "peak_gb": peak_gb,
            "loss_rel": cmp["loss_rel"], "min_cosine": cmp["min_cosine"],
            "plan": list(plan)}


# Phase 13: the trainer (train/loop.py) from the data pipeline, at the
# pretrain config's full width, in two runs on one workdir: run 1 stops at
# TRAINER_STEPS[0] and checkpoints there, run 2 extends total_steps and must
# resume from that checkpoint.
TRAINER_STEPS = (4, 8)
# 16 alt-text captions, each longer than token_len - 1 = 7 WordPiece ids, so
# that syntax_tokenize samples words by part of speech
TRAINER_CAPTIONS = (
    "a golden retriever puppy playing with a red ball on green grass",
    "aerial view of a small fishing village on a rocky coastline at dawn",
    "vintage wooden chair with a soft blue cushion in an empty room",
    "two children building a large sandcastle on a sunny beach in summer",
    "fresh strawberries and sliced bananas in a white ceramic breakfast bowl",
    "an old steam locomotive crossing a stone bridge over a wide river",
    "modern kitchen interior with marble countertops and bright pendant "
    "lights",
    "a tabby cat sleeping on a cozy knitted blanket next to the window",
    "snow covered mountain peaks reflected in a calm alpine lake at sunset",
    "close up of a hummingbird drinking nectar from a bright pink flower",
    "a busy city street at night with yellow taxis and glowing shop signs",
    "hand drawn illustration of a friendly green dragon reading a book",
    "a cyclist riding along a winding country road through autumn forests",
    "handmade silver earrings with turquoise stones on a dark velvet cloth",
    "a lighthouse standing on a cliff above crashing waves during a storm",
    "chef slicing vegetables on a wooden cutting board in a restaurant "
    "kitchen",
)
# The keys of a metrics.jsonl row of the JAX loop (train/loop.py) on a log
# step, besides `core_hours_<device kind>`; `img/sec/core` and `img/sec`
# join from each run's third tick on.
TRAINER_KEYS = {"step", "t", "t/parameter", "nimg", "ntxt", "ncorrect",
                "training_loss", "l2_grads", "l2_params", "l2_updates",
                "global_schedule", "epoch", "examples_seen"}
TRAINER_RATE_KEYS = {"img/sec/core", "img/sec"}
# Fused launches per trainer step: the image tower's 24 layers, forward and
# backward; the 8-token text tower on the einsum path, the flash kernels
# never.
TRAINER_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0,
                    "fused_fwd": TRAIN_IMAGE_LAYERS,
                    "fused_bwd": TRAIN_IMAGE_LAYERS}
PIPELINE_BATCHES = 4

_TRAINER_CONFIG = """
from clipa_tpu_torch.configs import clipa_pretrain


def get_config(arg=None):
    config = clipa_pretrain.get_config({pretrain!r})
    # decoded uint8 images at 144 px and long captions: the pp without
    # JPEG decoding, apart from it (phase 15 trains from JPEG tfrecords)
    config.input.data = dict(name="synthetic", n_examples=1_000_000,
                             res=144, captions={captions!r})
    config.input.pp = config.input.pp.replace(
        'inkey="jpg"', 'inkey="image"').replace('inkey="txt"',
                                                'inkey="texts"')
    # 15 GB of decoded images at the config's 250 000: four batches here
    config.input.shuffle_buffer_size = 4 * config.input.batch_size
    config.total_steps = {steps}
    # the config's 3200 warmup steps must be fewer than total_steps
    config.schedule = [(".*", dict(decay_type="cosine", warmup_steps=2))]
    config.log_training_steps = 1
    config.ckpt_steps = {ckpt}
    config.keep_ckpts = 2
    return config
"""


def _bits_equal(a, b):
    """Tensors equal bit for bit (same dtype, shape and bytes)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def _trainer(card, phase5_rate, keep_dir=None):
    """Phase 13: the trainer entry point (``train.loop.main``, the function
    behind ``python -m clipa_tpu_torch.train``) at the pretrain config's
    full width (L/16 @112, B = 384) from the data pipeline: synthetic
    decoded 144 px images and 16 long captions through the config's pp
    (inception crop to 112, SimCLR jitter, syntax_tokenize), run 1 for
    TRAINER_STEPS[0] steps, run 2 to TRAINER_STEPS[1] resuming from run 1's
    checkpoint. Checks the metrics, the launches of every step, the resumed
    state bit for bit and the npz export; times the trainer, the pipeline
    alone and the checkpoint. With `keep_dir`, the run's params.npz is
    copied there (phase 16 starts from it)."""
    import numpy as np
    import torch
    from clipa_tpu_torch import convert, optim, registry
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.data import core as data_core
    from clipa_tpu_torch.data import pipeline
    from clipa_tpu_torch.train import checkpoint, loop, metrics, step

    per_step, stamps = [], []

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trainer_config.py")
        with open(path, "w") as f:
            f.write(_TRAINER_CONFIG.format(
                pretrain=PRETRAIN, captions=TRAINER_CAPTIONS,
                steps=TRAINER_STEPS[0], ckpt=TRAINER_STEPS[0]))
        workdir = os.path.join(tmp, "run")
        argv = [f"--config={path}", f"--workdir={workdir}", "--device=cuda"]
        runs = []
        torch.cuda.reset_peak_memory_stats()
        with _Patched((step, "make_update_fn", _counting(per_step, stamps))):
            for total in TRAINER_STEPS:
                t0 = time.perf_counter()
                final = loop.main(argv + [f"--config.total_steps={total}"])
                runs.append({"final": final,
                             "seconds": time.perf_counter() - t0})
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

        # metrics.jsonl: steps 1-8 once each, the JAX loop's keys, finite
        rows = _rows(os.path.join(workdir, "metrics.jsonl"))
        logged = [r["step"] for r in rows]
        if logged != list(range(1, TRAINER_STEPS[1] + 1)):
            raise RuntimeError(f"metrics.jsonl logs steps {logged}, "
                               f"expected 1-{TRAINER_STEPS[1]} once each")
        for r in rows:
            keys = {k for k in r if not k.startswith("core_hours_")}
            # a run's first tick starts the clock, its second is warm-up
            rate = r["step"] - 1 not in (0, 1, TRAINER_STEPS[0],
                                         TRAINER_STEPS[0] + 1)
            want = TRAINER_KEYS | (TRAINER_RATE_KEYS if rate else set())
            if keys != want or len(r) != len(want) + 1:
                raise RuntimeError(f"step {r['step']} logs {sorted(r)}, "
                                   f"expected {sorted(want)} and "
                                   f"core_hours_<kind>")
        losses = [r["training_loss"] for r in rows]
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite training losses {losses}")

        # each step: 24 fused forward and 24 fused backward launches
        if per_step != [TRAINER_LAUNCHES] * TRAINER_STEPS[1]:
            raise RuntimeError(f"trainer steps launched {per_step}, "
                               f"expected {TRAINER_LAUNCHES} each")

        # run 2 resumed from run 1's state, bit for bit
        config = load_config(path)
        manager = checkpoint.CheckpointManager(
            os.path.join(workdir, "checkpoints"))
        if manager.all_steps() != list(TRAINER_STEPS):
            raise RuntimeError(f"checkpoints {manager.all_steps()}, expected "
                               f"{list(TRAINER_STEPS)}")
        t0 = time.perf_counter()
        saved = manager.restore(TRAINER_STEPS[0])
        restore_s = time.perf_counter() - t0
        model = step.create_model(config, device="cuda")
        state = step.init_train_state(
            model, config, torch.Generator(device="cuda").manual_seed(SEED),
            "cuda")
        tx, _ = optim.make(config, model, sched_kw=dict(
            total_steps=TRAINER_STEPS[1],
            batch_size=config.input.batch_size))
        chrono = metrics.Chrono("cuda")
        resumed_at = loop.restore(saved, state, tx, chrono)
        first = runs[0]["final"]
        got = tx.state_dict()
        same = {
            "params": all(_bits_equal(state["params"][n], p)
                          for n, p in first["params"].items()),
            "mu": all(_bits_equal(got["mu"][n], m)
                      for n, m in first["opt"]["mu"].items()),
            "nu": all(_bits_equal(got["nu"][n], v)
                      for n, v in first["opt"]["nu"].items()),
            "count": got["count"] == first["opt"]["count"]
            == TRAINER_STEPS[0],
        }
        mu_dtype = next(iter(got["mu"].values())).dtype
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(
                             manager.step_dir(TRAINER_STEPS[0]))
                         for f in files)
        print(f"resume: run 2 restored step {resumed_at}; against run 1's "
              f"final state bit for bit {same} (mu {mu_dtype})", flush=True)
        if resumed_at != TRAINER_STEPS[0] or not all(same.values()):
            raise RuntimeError("the restored state differs from run 1's "
                               "final state")
        t0 = time.perf_counter()
        other = checkpoint.CheckpointManager(os.path.join(tmp, "save"))
        other.save(TRAINER_STEPS[0], loop.checkpoint_state(state, tx,
                                                           chrono))
        other.close()
        save_s = time.perf_counter() - t0
        del model, state, tx, saved

        # params.npz (the JAX layout) loads back into the model
        model = step.create_model(config, device="cuda")
        convert.load_jax_params(model, checkpoint.load_params(
            os.path.join(workdir, "params.npz")))
        loaded = optim.named_parameters(model)
        last = runs[1]["final"]["params"]
        if set(loaded) != set(last) or not all(
                _bits_equal(loaded[n], p) for n, p in last.items()):
            raise RuntimeError("params.npz differs from the final params")
        runs_s = [r["seconds"] for r in runs]
        del model, runs

        # the input pipeline alone: the config's source and pp, no model
        source = data_core.get_source(**dict(config.input.data))
        batches = pipeline.make_for_train(
            source, registry.get_preprocess_fn(config.input.pp),
            config.input.batch_size,
            shuffle_buffer=config.input.shuffle_buffer_size,
            seed=config.seed, num_workers=config.input.num_workers)
        t0 = time.perf_counter()
        batch = next(batches)
        first_batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(PIPELINE_BATCHES):
            batch = next(batches)
        pipeline_rate = PIPELINE_BATCHES / (time.perf_counter() - t0)
        batches.close()
        shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in batch.items()}
        if keep_dir:
            shutil.copy(os.path.join(workdir, "params.npz"), keep_dir)

    batch_size = config.input.batch_size
    rates = [batch_size * 3 / (stamps[i + 3] - stamps[i])
             for i in (0, TRAINER_STEPS[0])]
    torch.cuda.empty_cache()
    print(f"{card}: trainer pairs/s at B={batch_size} from the pipeline, "
          f"host clock over steps 2-4 {rates[0]:.2f} and 6-8 {rates[1]:.2f}; "
          f"phase 5's step with the batch on the device {phase5_rate:.2f}; "
          f"the input pipeline alone {pipeline_rate:.3f} batches/s "
          f"({pipeline_rate * batch_size:.1f} pairs/s, {shapes}; first batch "
          f"after {first_batch_s:.2f} s, the shuffle buffer filled); "
          f"checkpoint {ckpt_bytes / 2 ** 20:.1f} MiB, save "
          f"{save_s:.2f} s, restore {restore_s:.2f} s; runs "
          f"{runs_s[0]:.2f} s and {runs_s[1]:.2f} s; peak device memory "
          f"{peak_gb:.2f} GiB; losses {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    return {"launches": per_step[0], "steps": len(per_step),
            "pairs_per_s": rates, "phase5_pairs_per_s": phase5_rate,
            "pipeline_batches_per_s": pipeline_rate,
            "first_batch_s": first_batch_s, "checkpoint_bytes": ckpt_bytes,
            "save_s": save_s, "restore_s": restore_s, "peak_gb": peak_gb,
            "losses": losses}


# Phase 14: the trainer with CLIPA's evals: the pretrain config with a
# data_dir, so that config.evals.disclf is the config's own zero-shot
# ImageNet eval (1000 class names x 81 CLIP-paper prompts, its pp and eval
# batch), on imagenet2012 validation tfrecords written here; then the
# eval-only replay of the same workdir and tools/eval_zeroshot at H/14.
EVAL_IMAGES = 4096
EVAL_SHARDS = 2
EVAL_IMAGE_HW = (144, 160)       # JPEGs of 160 x 144 pixels
EVAL_CLASSES = 1000
EVAL_LOG_STEPS = 2
CONTRASTIVE_PAIRS = 1536
TOOL_BATCH = 256
ZEROSHOT_KEY = "z/0shot/imagenet2012_accuracy"
# The JAX loop's cadence: the evals run at multiples of log_steps, at the
# last step and, with log_steps < total_steps, at step 1.
ZEROSHOT_STEPS = [1, 2, 4]
# Launches of one zero-shot run at L/16 @112 (B = 384): the image tower's 24
# layers per image batch (the 8-token text tower on the einsum path); of the
# tool at H/14 @224 (B = 256): 32 per batch (32-token text tower: einsum).
ZEROSHOT_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0,
                     "fused_fwd": TRAIN_IMAGE_LAYERS * -(-EVAL_IMAGES // 384),
                     "fused_bwd": 0}
TOOL_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0,
                 "fused_fwd": IMAGE_LAYERS * -(-EVAL_IMAGES // TOOL_BATCH),
                 "fused_bwd": 0}

_EVAL_CONFIG = _TRAINER_CONFIG.replace("    return config\n", """\
    # the config's own disclf eval, but its cadence
    config.evals.disclf.log_steps = {log_steps}
    config.evals.val = dict(
        type="contrastive", log_steps={steps},
        data=dict(name="synthetic", n_examples={pairs}, res=144,
                  captions={captions!r}),
        pp=config.input.pp)
    return config
""")


def _write_eval_tfrecords(data_dir):
    """imagenet2012-validation tfrecords of EVAL_IMAGES PIL-encoded JPEGs
    ({image, label}, labels in 0-999) with a class-dependent channel
    signal, in EVAL_SHARDS files."""
    import io
    import numpy as np
    from PIL import Image
    from clipa_tpu_torch.data import tfrecord

    rng = np.random.default_rng(SEED)
    per = EVAL_IMAGES // EVAL_SHARDS
    for shard in range(EVAL_SHARDS):
        def payloads():
            for _ in range(per):
                cls = int(rng.integers(0, EVAL_CLASSES))
                arr = rng.integers(0, 255, EVAL_IMAGE_HW + (3,),
                                   dtype=np.uint8)
                arr[..., cls % 3] //= 2
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "JPEG")
                yield tfrecord.build_example({"image": buf.getvalue(),
                                              "label": np.asarray([cls])})
        tfrecord.write_records(os.path.join(
            data_dir, f"imagenet2012-validation.tfrecord-"
                      f"{shard:05d}-of-{EVAL_SHARDS:05d}"), payloads())


def _decode_cost(pp_img, data_dir, n=256):
    """Host ms per image of the eval pp `pp_img` on one thread, on the
    first `n` records' JPEG bytes and on the same images decoded
    beforehand (`decode` passes an array through): what decoding costs."""
    import numpy as np
    from clipa_tpu_torch import registry
    from clipa_tpu_torch.data import core as data_core

    pp = registry.get_preprocess_fn(pp_img)
    decode = registry.get_preprocess_fn("decode")
    source = data_core.get_source(
        name="tfrecord", pattern=f"{data_dir}/imagenet2012-validation*")
    raw = [s["image"] for _, s in zip(range(n), source.iter_process_shard())]
    decoded = [decode({"image": r})["image"] for r in raw]
    ms, out = {}, {}
    for name, images in (("jpeg", raw), ("decoded", decoded)):
        t0 = time.perf_counter()
        out[name] = [pp({"image": x})["image"] for x in images]
        ms[name] = (time.perf_counter() - t0) * 1e3 / n
    if not all(np.array_equal(a, b) for a, b in zip(out["jpeg"],
                                                    out["decoded"])):
        raise RuntimeError("the eval pp differs on decoded images")
    return ms


def _count_zeroshot_runs(zeroshot, runs):
    """Wraps zeroshot.Evaluator.run and _class_embeddings: each run's
    launches (counters set to 0 at its start, read at its end), seconds,
    prompt-embedding seconds and image count go to `runs`. Returns the
    function that undoes the wrap."""
    import torch
    reset, read = _attention_counters()
    run, embed = zeroshot.Evaluator.run, zeroshot.Evaluator._class_embeddings

    def counted_embed(self, params, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = embed(self, params, name)
        runs[-1]["prompts"] = len(zeroshot.build_prompts(
            self.datasets[name]["class_names"],
            self.datasets[name]["templates"])[0])
        runs[-1]["prompt_s"] = time.perf_counter() - t0
        return z

    def counted_run(self, params):
        runs.append({})
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, params)
        torch.cuda.synchronize()
        runs[-1].update(seconds=time.perf_counter() - t0, launches=read(),
                        images=sum(s.total_examples() for s in (
                            d["source"] for d in self.datasets.values())))
        return out

    zeroshot.Evaluator.run = counted_run
    zeroshot.Evaluator._class_embeddings = counted_embed

    def undo():
        zeroshot.Evaluator.run = run
        zeroshot.Evaluator._class_embeddings = embed
    return undo


def _evals(card, phase13_losses):
    """Phase 14: the trainer with CLIPA's evals at L/16 @112 (B = 384):
    run A trains TRAINER_STEPS[0] steps with the config's zero-shot eval
    every EVAL_LOG_STEPS steps and a contrastive eval at the last; run B
    replays the step-4 checkpoint with eval_only; then tools/eval_zeroshot
    on ViT-H-14-CL32-GAP-BigVision @224 from an npz of the serving model's
    seeded random weights. Checks the accuracies, the launches of every
    zero-shot run, and that the evals leave training bit for bit as phase
    13's run 1."""
    import numpy as np
    import torch
    from clipa_tpu_torch import convert
    from clipa_tpu_torch.compat import openclip
    from clipa_tpu_torch.evaluators import zeroshot
    from clipa_tpu_torch.tools import eval_zeroshot
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.train import checkpoint, loop, step

    reset, read = _attention_counters()
    per_step, step_s = [], []
    make_update_fn = step.make_update_fn

    def counted(*args, **kw):   # each step's launches and seconds
        update = make_update_fn(*args, **kw)

        def run(state, batch):
            reset()
            t0 = time.perf_counter()
            state, meas = update(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(read())
            return state, meas
        return run

    runs = []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "imagenet")
        os.makedirs(data_dir)
        t0 = time.perf_counter()
        _write_eval_tfrecords(data_dir)
        write_s = time.perf_counter() - t0
        path = os.path.join(tmp, "eval_config.py")
        with open(path, "w") as f:
            f.write(_EVAL_CONFIG.format(
                pretrain=f"{PRETRAIN},data_dir={data_dir}",
                captions=TRAINER_CAPTIONS, steps=TRAINER_STEPS[0],
                ckpt=TRAINER_STEPS[0], log_steps=EVAL_LOG_STEPS,
                pairs=CONTRASTIVE_PAIRS))
        workdir = os.path.join(tmp, "run")
        argv = [f"--config={path}", f"--workdir={workdir}", "--device=cuda",
                f"--config.total_steps={TRAINER_STEPS[0]}"]
        step.make_update_fn = counted
        undo = _count_zeroshot_runs(zeroshot, runs)
        try:
            t0 = time.perf_counter()
            loop.main(argv)
            run_a_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loop.main(argv + ["--config.eval_only=True"])
            run_b_s = time.perf_counter() - t0
        finally:
            step.make_update_fn = make_update_fn
            undo()
        rows = _rows(os.path.join(workdir, "metrics.jsonl"))
        decode = _decode_cost(load_config(path).evals.disclf.pp_img,
                              data_dir)

        # the tool: H/14 @224 from an npz of the serving model's weights
        clip = openclip.create_model(MODEL, None, precision="bfloat16",
                                     device="cuda", seed=SEED)
        npz = os.path.join(tmp, "h14.npz")
        checkpoint.save_params(convert.to_jax_params(clip.model), npz)
        del clip
        torch.cuda.empty_cache()
        undo = _count_zeroshot_runs(zeroshot, runs)
        try:
            t0 = time.perf_counter()
            tool = eval_zeroshot.main([
                "--model", MODEL, "--pretrained", npz,
                "--data-dir", data_dir, "--vocab",
                os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "vocab.txt"),
                "--batch-size", str(TOOL_BATCH)])
            tool_s = time.perf_counter() - t0
        finally:
            undo()
        torch.cuda.empty_cache()

    # run A: the zero-shot accuracy at the JAX loop's cadence, the
    # contrastive loss at the last step, steps 1-4 logged once each
    train_rows = [r for r in rows if "training_loss" in r]
    losses = [r["training_loss"] for r in train_rows]
    acc = {r["step"]: r[ZEROSHOT_KEY] for r in rows[:len(rows) - 1]
           if ZEROSHOT_KEY in r}
    if sorted(acc) != ZEROSHOT_STEPS or not all(
            0.0 <= a <= 1.0 for a in acc.values()):
        raise RuntimeError(f"run A logged {ZEROSHOT_KEY} {acc}, expected "
                           f"values in [0, 1] at steps {ZEROSHOT_STEPS}")
    val = {r["step"]: r["val/loss"] for r in rows if "val/loss" in r}
    if TRAINER_STEPS[0] not in val or not np.isfinite(list(val.values())
                                                      ).all():
        raise RuntimeError(f"contrastive eval losses {val}")
    if [r["step"] for r in train_rows] != list(
            range(1, TRAINER_STEPS[0] + 1)):
        raise RuntimeError(f"run A logged training steps "
                           f"{[r['step'] for r in train_rows]}")
    # the evals leave training as it was: phase 13's run 1, bit for bit
    if losses != phase13_losses[:TRAINER_STEPS[0]]:
        raise RuntimeError(f"training losses with evals {losses} differ "
                           f"from phase 13's {phase13_losses[:4]}")
    if per_step != [TRAINER_LAUNCHES] * TRAINER_STEPS[0]:
        raise RuntimeError(f"trainer steps launched {per_step}, expected "
                           f"{TRAINER_LAUNCHES} each")
    # run B: eval_only at the restored step reproduces run A's accuracy
    replay = rows[-1]
    if replay["step"] != TRAINER_STEPS[0] or "training_loss" in replay or \
            replay.get(ZEROSHOT_KEY) != acc[TRAINER_STEPS[0]]:
        raise RuntimeError(f"eval_only logged {replay}, expected "
                           f"{ZEROSHOT_KEY} {acc[TRAINER_STEPS[0]]} at step "
                           f"{TRAINER_STEPS[0]}")
    # every zero-shot run: 24 fused forwards per image batch, no backward
    zs, tool_run = runs[:-1], runs[-1]
    if len(zs) != len(ZEROSHOT_STEPS) + 1 or any(
            r["launches"] != ZEROSHOT_LAUNCHES for r in zs):
        raise RuntimeError(f"zero-shot runs launched "
                           f"{[r['launches'] for r in zs]}, expected "
                           f"{ZEROSHOT_LAUNCHES} each")
    tool_acc = tool["imagenet2012_accuracy"]
    if not np.isfinite(tool_acc) or tool_run["launches"] != TOOL_LAUNCHES:
        raise RuntimeError(f"eval_zeroshot: accuracy {tool_acc}, launches "
                           f"{tool_run['launches']}, expected {TOOL_LAUNCHES}")

    phase_s = time.perf_counter() - t_phase

    def rate(r):   # images/s of the image pass (pp, decode included)
        return r["images"] / (r["seconds"] - r["prompt_s"])

    def fmt(values, spec=".2f"):
        return " ".join(format(v, spec) for v in values)

    print(f"{card}: evals at L/16 @112 (B=384): {EVAL_IMAGES} JPEGs "
          f"({EVAL_IMAGE_HW[1]}x{EVAL_IMAGE_HW[0]}) written in {write_s:.2f} "
          f"s; zero-shot accuracy by step {acc}, eval_only "
          f"{replay[ZEROSHOT_KEY]}; contrastive loss {val}; run A "
          f"{run_a_s:.2f} s ({TRAINER_STEPS[0]} steps {fmt(step_s, '.3f')} "
          f"s; zero-shot runs {fmt(r['seconds'] for r in zs[:-1])} s), run "
          f"B {run_b_s:.2f} s (zero-shot {zs[-1]['seconds']:.2f} s); "
          f"{zs[0]['prompts']} prompts embedded (L text tower, 8 tokens) in "
          f"{fmt(r['prompt_s'] for r in zs)} s; eval images/s with JPEG "
          f"decode in the pp {fmt((rate(r) for r in zs), '.1f')}; fused "
          f"forward launches per zero-shot run "
          f"{zs[0]['launches']['fused_fwd']}; training losses {losses} = "
          f"phase 13's", flush=True)
    print(f"{card}: the eval pp (256 images, one host thread): "
          f"{decode['jpeg']:.3f} ms per image from JPEG bytes, "
          f"{decode['decoded']:.3f} ms from decoded arrays", flush=True)
    print(f"{card}: tools/eval_zeroshot {MODEL} @224 (B={TOOL_BATCH}): "
          f"accuracy {tool_acc} in {tool_s:.2f} s (eval "
          f"{tool_run['seconds']:.2f} s); {tool_run['prompts']} prompts "
          f"(H text tower, 32 tokens) in {tool_run['prompt_s']:.2f} s; "
          f"images/s {rate(tool_run):.1f}; fused forward launches "
          f"{tool_run['launches']['fused_fwd']}; phase 14 in "
          f"{phase_s:.2f} s", flush=True)
    return {"zeroshot_launches": zs[0]["launches"],
            "tool_launches": tool_run["launches"],
            "accuracy": acc, "eval_only_accuracy": replay[ZEROSHOT_KEY],
            "contrastive_loss": val, "tool_accuracy": tool_acc,
            "zeroshot_s": [r["seconds"] for r in zs],
            "prompt_s": [r["prompt_s"] for r in zs],
            "images_per_s": [rate(r) for r in zs], "step_s": step_s,
            "run_s": [run_a_s, run_b_s], "tool_s": tool_s,
            "tool_prompt_s": tool_run["prompt_s"],
            "pp_ms_per_image": decode,
            "tool_images_per_s": rate(tool_run), "phase_s": phase_s}


# Phase 15: the trainer from JPEG tfrecords at a batch of 1536 through
# two-pass gradient accumulation (4 microbatches of phase 5's 384), on the
# native host library (libjpeg decode and crop, WordPiece); the pipeline
# alone by route; accumulation against one pass; the chunked and sigmoid
# losses.
JPEG_IMAGES = 8192
JPEG_SIZE = 256           # tools/bench_pipeline's default
JPEG_SHARDS = 16
ACCUM_PRETRAIN = "img=L/16,res=112,token_len=8,batchsize=1536"
ACCUM_STEPS = 4
ACCUM_TRAIN_STEPS = 3
# per accumulated step: pass 1 embeds each microbatch (24 fused forwards),
# pass 2 embeds it again with gradients (24 forwards, 24 backwards)
ACCUM_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0,
                  "fused_fwd": 2 * ACCUM_STEPS * TRAIN_IMAGE_LAYERS,
                  "fused_bwd": ACCUM_STEPS * TRAIN_IMAGE_LAYERS}
PIPELINE_BATCH = 384
PIPELINE_SECONDS = 6.0
# (what, workers, worker processes, native route)
PIPELINE_RUNS = (("native, 48 threads", 48, False, True),
                 ("PIL and Python, 48 threads", 48, False, False),
                 ("native, 16 worker processes", 16, True, True),
                 ("native, 32 worker processes", 32, True, True))
CHUNK_SIZE = 96
SIGMOID_BIAS_INIT = -10.0
CHUNKED_LOSS_RTOL = 1e-5
CHUNKED_MIN_COSINE = 0.9999
T_GRAD_RTOL = 1e-2
# Accumulated against one pass: both run the same kernels on the same
# samples, in microbatches of 96 against one of 384, so only the order of
# fp32 sums and a rare bf16 rounding differ (on an H100 80GB HBM3 at 700 W
# the loss agreed exactly and the least gradient cosine was 0.9999864). A
# scale fault (a mean for a sum, a microbatch counted twice) moves each
# gradient's norm, which the cosine does not see: every gradient's norm but
# t's (and the key biases', rounding noise) is held within ACCUM_NORM_RTOL
# of the single pass's.
ACCUM_LOSS_RTOL = 1e-5
ACCUM_MIN_COSINE = 0.9999
ACCUM_NORM_RTOL = 1e-3

_JPEG_TRAINER_CONFIG = """
from clipa_tpu_torch.configs import clipa_pretrain


def get_config(arg=None):
    config = clipa_pretrain.get_config({pretrain!r})
    # two batches in the shuffle buffer (the config's 250 000 is 30x the
    # shards)
    config.input.shuffle_buffer_size = 2 * config.input.batch_size
    config.total_steps = {steps}
    # the config's 3200 warmup steps must be fewer than total_steps
    config.schedule = [(".*", dict(decay_type="cosine", warmup_steps=2))]
    config.log_training_steps = 1
    # phase 14 runs the config's zero-shot eval, phase 13 the checkpoints
    config.evals = {{}}
    config.save_ckpt = False
    config.export_npz = False
    return config
"""


class _GradRecorder:
    """An optimizer that records the gradients update() gets and leaves
    the parameters as they are (the state stays where it was)."""

    frozen = frozenset()

    def __init__(self):
        self.grads = []

    def update(self, grads):
        self.grads.append({n: g.float().clone() for n, g in grads.items()})
        return {n: g.new_zeros(()) for n, g in grads.items()}

    def apply(self, updates):
        del updates


def _step_grads(model, state, config, batch, **changes):
    """(loss, {name: fp32 grad}) of one update() at `state`, with the
    config changes made, the parameters left as they are."""
    import copy
    from clipa_tpu_torch.train import step
    config = copy.deepcopy(config)
    for key, value in changes.items():
        config[key] = value
    tx = _GradRecorder()
    _, meas = step.make_update_fn(model, tx, config)(dict(state), batch)
    return float(meas["training_loss"]), tx.grads[0]


def _pipeline_rates(pattern, pp):
    """Phase 15(b): pairs/s of the pipeline alone (tools/bench_pipeline
    .measure) on each of PIPELINE_RUNS, in turns; the PIL and Python route
    forced by patching the ops' route builders."""
    from clipa_tpu_torch import tokenizer
    from clipa_tpu_torch.pp import ops_image, ops_text
    from clipa_tpu_torch.tools import bench_pipeline
    rates = {}
    for what, workers, processes, native in PIPELINE_RUNS:
        native_lib, get_tokenizer = ops_image._native_lib, ops_text.get_tokenizer
        if not native:
            ops_image._native_lib = lambda: None
            ops_text.get_tokenizer = lambda path: tokenizer.get_tokenizer(
                path, backend="python")
        ops_image.native_decodes = ops_image.pil_decodes = 0
        ops_text.native_encodes = ops_text.python_encodes = 0
        t0 = time.perf_counter()
        try:
            r = bench_pipeline.measure(pattern, pp, workers, PIPELINE_BATCH,
                                       PIPELINE_SECONDS,
                                       processes=processes)
        finally:
            ops_image._native_lib = native_lib
            ops_text.get_tokenizer = get_tokenizer
        # threads of the run before may still finish a sample or two after
        # its pipeline closed: a forced PIL run is held to its PIL decodes.
        # Worker processes count in their own memory: their route is the
        # one the pp string builds there, not read here.
        for kind, routes in (
                ("decodes", (ops_image.native_decodes,
                             ops_image.pil_decodes)),
                ("encodes", (ops_text.native_encodes,
                             ops_text.python_encodes))):
            if not processes and (routes[0] == 0 or routes[1] > 0 if native
                                  else routes[1] == 0):
                raise RuntimeError(f"pipeline {what}: {kind} by route "
                                   f"(native, PIL or Python) {routes}")
        rates[what] = {"pairs_per_s": r["samples_per_sec"],
                       "batches": r["batches"],
                       "seconds": time.perf_counter() - t0}
    return rates


def _jpeg_trainer(card, phase13, keep_dir=None):
    """Phase 15: (a) JPEG tfrecords in the layout tools/laion writes; (b)
    the pipeline alone on the config's pp by route; (c) the trainer
    (train.loop.main) on clipa_pretrain.py at B = 1536 from those shards,
    grad_accum_steps 4, for ACCUM_TRAIN_STEPS steps: finite losses, 192
    fused forwards, 96 fused backwards and no flash kernel per step, every
    JPEG on the native decode, the native WordPiece; (d) 4 x 96
    accumulated against one pass on one state and one B = 384 batch; (e)
    one step each of the chunked (against the softmax) and the sigmoid
    loss (the towers' b) at B = 384. With `keep_dir`, the shards are
    written under it (phase 16 trains from them)."""
    import numpy as np
    import torch
    from clipa_tpu_torch import native, optim
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch.pp import ops_image, ops_text
    from clipa_tpu_torch.tools import bench_pipeline
    from clipa_tpu_torch.train import loop, step

    per_step, stamps = [], []
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the shards: jpg (256 x 256 random pixels) and txt features
        data_dir = os.path.join(keep_dir or tmp, "laion")
        os.makedirs(data_dir)
        t0 = time.perf_counter()
        pattern = bench_pipeline.make_jpeg_shards(
            data_dir, JPEG_IMAGES, JPEG_SIZE, shards=JPEG_SHARDS,
            captions=TRAINER_CAPTIONS)
        write_s = time.perf_counter() - t0
        shard_bytes = sum(os.path.getsize(os.path.join(data_dir, f))
                          for f in os.listdir(data_dir))
        pretrain = f"{ACCUM_PRETRAIN},data_dir={data_dir}"
        config = clipa_pretrain.get_config(pretrain)

        # (b) the pipeline alone, the config's pp at B = 384, in turns
        pipeline_rates = _pipeline_rates(pattern, config.input.pp)

        # (c) the trainer at B = 1536 = 4 x 384
        path = os.path.join(tmp, "jpeg_trainer_config.py")
        with open(path, "w") as f:
            f.write(_JPEG_TRAINER_CONFIG.format(pretrain=pretrain,
                                                steps=ACCUM_TRAIN_STEPS))
        argv = [f"--config={path}", f"--workdir={os.path.join(tmp, 'run')}",
                "--device=cuda", f"--config.grad_accum_steps={ACCUM_STEPS}"]
        ops_image.native_decodes = ops_image.pil_decodes = 0
        ops_text.native_encodes = ops_text.python_encodes = 0
        torch.cuda.reset_peak_memory_stats()
        with _Patched((step, "make_update_fn", _counting(per_step, stamps))):
            t0 = time.perf_counter()
            loop.main(argv)
            run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        decodes = {"native": ops_image.native_decodes,
                   "pil": ops_image.pil_decodes}
        encodes = {"native": ops_text.native_encodes,
                   "python": ops_text.python_encodes}
        rows = _rows(os.path.join(tmp, "run", "metrics.jsonl"))
    torch.cuda.empty_cache()

    losses = [r["training_loss"] for r in rows]
    if [r["step"] for r in rows] != list(range(1, ACCUM_TRAIN_STEPS + 1)) \
            or not np.isfinite(losses).all():
        raise RuntimeError(f"metrics.jsonl: steps {[r['step'] for r in rows]}"
                           f", losses {losses}")
    if per_step != [ACCUM_LAUNCHES] * ACCUM_TRAIN_STEPS:
        raise RuntimeError(f"accumulated steps launched {per_step}, "
                           f"expected {ACCUM_LAUNCHES} each")
    if decodes["pil"] or not decodes["native"]:
        raise RuntimeError(f"JPEG decodes by route {decodes}: every sample "
                           f"must take the native route")
    if encodes["python"] or not encodes["native"]:
        raise RuntimeError(f"captions encoded by tokenizer {encodes}: every "
                           f"caption must take the native WordPiece")
    batch_size = config.input.batch_size
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    rate = batch_size * (len(stamps) - 1) / (stamps[-1] - stamps[0])

    # (d) 4 x 96 accumulated against one pass, one state, one B = 384 batch
    config = clipa_pretrain.get_config(PRETRAIN)
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED),
        "cuda")
    rng = np.random.RandomState(SEED)
    res, tokens = config.init_shapes[0][1], config.init_shapes[1][1]
    b = config.input.batch_size
    batch = {"image": torch.from_numpy(rng.randint(
                 0, 255, (b, res, res, 3), dtype=np.uint8)).cuda(),
             "labels": torch.from_numpy(rng.randint(
                 0, 32000, (b, tokens)).astype(np.int32)).cuda()}
    loss_1, grads_1 = _step_grads(model, state, config, batch)
    loss_4, grads_4 = _step_grads(model, state, config, batch,
                                  grad_accum_steps=ACCUM_STEPS)
    t_ratio = (grads_4["t"] / grads_1["t"]).item()
    cmp = _compare(loss_4, {n: g for n, g in grads_4.items() if n != "t"},
                   loss_1, {n: g for n, g in grads_1.items() if n != "t"})
    norm_gaps = {n: abs(grads_4[n].norm().item() / g.norm().item() - 1)
                 for n, g in grads_1.items()
                 if n != "t" and not n.endswith("/key/bias")}
    worst_norm = max(norm_gaps, key=norm_gaps.get)
    _print_compare(f"{ACCUM_STEPS} x {b // ACCUM_STEPS} accumulated vs one "
                   f"pass at B={b}", loss_4, loss_1, cmp, ACCUM_LOSS_RTOL)
    print(f"gradient norms, accumulated / one pass, over {len(norm_gaps)} "
          f"tensors: largest gap from 1 {norm_gaps[worst_norm]:.3e} at "
          f"{worst_norm} (tolerance {ACCUM_NORM_RTOL}); t's gradient, "
          f"accumulated / one pass: {t_ratio:.6f} (expected {ACCUM_STEPS}, "
          f"rtol {T_GRAD_RTOL})", flush=True)
    if (cmp["loss_rel"] > ACCUM_LOSS_RTOL
            or cmp["min_cosine"] < ACCUM_MIN_COSINE
            or cmp["noise"] > KEY_BIAS_NOISE
            or norm_gaps[worst_norm] > ACCUM_NORM_RTOL
            or abs(t_ratio / ACCUM_STEPS - 1) > T_GRAD_RTOL):
        raise RuntimeError("the accumulated step differs from one pass")
    del grads_4

    # (e) the chunked loss against the softmax, then the sigmoid loss
    loss_c, grads_c = _step_grads(model, state, config, batch,
                                  loss="chunked", loss_chunk_size=CHUNK_SIZE)
    chunked = _compare(loss_c, grads_c, loss_1, grads_1)
    _print_compare(f"chunked InfoNCE (chunk {CHUNK_SIZE}) vs softmax at "
                   f"B={b}", loss_c, loss_1, chunked, CHUNKED_LOSS_RTOL)
    if (chunked["loss_rel"] > CHUNKED_LOSS_RTOL
            or chunked["min_cosine"] < CHUNKED_MIN_COSINE
            or chunked["noise"] > KEY_BIAS_NOISE):
        raise RuntimeError("the chunked loss differs from the softmax loss")
    del grads_1, grads_c

    # the accumulated step alone at B = 1536, the batch on the device
    config.grad_accum_steps = ACCUM_STEPS
    big = {k: v.repeat(ACCUM_STEPS, *[1] * (v.dim() - 1))
           for k, v in batch.items()}
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=len(big["image"])))
    update = step.make_update_fn(model, tx, config)
    update(state, big)   # warm-up
    step_rate = len(big["image"]) * max(
        _steps_per_s(update, state, big, 2) for _ in range(2))
    del model, state, tx, update, big
    config.grad_accum_steps = 1
    torch.cuda.empty_cache()
    config.loss = "sigmoid"
    config.model.bias_init = SIGMOID_BIAS_INIT
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED),
        "cuda")
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=b))
    grads_s = []
    tx_update = tx.update

    def recording(grads):
        grads_s.append({n: g.float().clone() for n, g in grads.items()})
        return tx_update(grads)

    tx.update = recording
    state, meas = step.make_update_fn(model, tx, config)(state, batch)
    loss_s = float(meas["training_loss"])
    b_grad = grads_s[0]["b"].item()
    finite = all(bool(torch.isfinite(g).all()) for g in grads_s[0].values())
    print(f"sigmoid loss (bias_init {SIGMOID_BIAS_INIT}) at B={b}: loss "
          f"{loss_s:.4f}, b's gradient {b_grad:.6f}, b after the step "
          f"{model.b.item():.6f}; every gradient finite {finite}", flush=True)
    if not (np.isfinite(loss_s) and finite and b_grad != 0.0):
        raise RuntimeError("the sigmoid loss step is not finite or b got "
                           "no gradient")
    del model, state, tx, grads_s
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase

    routes = "; ".join(f"{what} {r['pairs_per_s']:.1f}"
                       for what, r in pipeline_rates.items())
    print(f"{card}: JPEG tfrecords: {JPEG_IMAGES} images of {JPEG_SIZE} x "
          f"{JPEG_SIZE} in {JPEG_SHARDS} shards ({shard_bytes / 2 ** 20:.1f} "
          f"MiB) written in {write_s:.2f} s; native library "
          f"{native.library_path()} (libjpeg: {native.jpeg_route()})",
          flush=True)
    print(f"{card}: the pipeline alone at B={PIPELINE_BATCH} (the config's "
          f"pp from JPEG bytes, pairs/s over {PIPELINE_SECONDS} s after one "
          f"batch): {routes}", flush=True)
    print(f"{card}: trainer pairs/s at B={batch_size} = {ACCUM_STEPS} x "
          f"{batch_size // ACCUM_STEPS} from JPEG tfrecords, host clock over "
          f"steps 2-{ACCUM_TRAIN_STEPS} {rate:.2f} (the step alone with the "
          f"batch on the device {step_rate:.2f}); seconds per step "
          f"{' '.join(f'{s:.3f}' for s in step_s)}; run {run_s:.2f} s; peak "
          f"device memory {peak_gb:.2f} GiB; launches per step "
          f"{per_step[0]}; JPEG decodes native {decodes['native']}, PIL "
          f"{decodes['pil']}; losses {' '.join(f'{x:.4f}' for x in losses)}; "
          f"phase 13's trainer at B=384 {phase13['pairs_per_s'][0]:.2f} and "
          f"{phase13['pairs_per_s'][1]:.2f}; phase 15 in {phase_s:.2f} s",
          flush=True)
    return {"launches": per_step[0], "steps": len(per_step),
            "pairs_per_s": rate, "step_pairs_per_s": step_rate,
            "step_s": step_s, "run_s": run_s,
            "peak_gb": peak_gb, "decodes": decodes, "losses": losses,
            "pipeline": pipeline_rates, "write_s": write_s,
            "accum_loss_rel": cmp["loss_rel"],
            "accum_min_cosine": cmp["min_cosine"], "t_grad_ratio": t_ratio,
            "chunked_loss_rel": chunked["loss_rel"],
            "chunked_min_cosine": chunked["min_cosine"],
            "sigmoid_loss": loss_s, "sigmoid_b_grad": b_grad,
            "phase_s": phase_s}


# Phase 16: CLIPA-v2's 224 -> 336 unmask-tuning chain through the trainer
# (train.loop.main) at ViT-L/16 full width, on file:// workdirs, from phase
# 13's params.npz and phase 15's JPEG tfrecords through the config's own pp
# (decode_jpeg_and_inception_crop, the SimCLR jitter, bert_tokenize at 32
# tokens). The 224 stage trains CHAIN_STEPS_224[0] steps, loses its local
# stage (a restart on a fresh host) and resumes from the URL to
# CHAIN_STEPS_224[1]; the 336 stage takes the 224 stage's params.npz
# through masked_init from its URL and trains CHAIN_STEPS_336 steps.
CHAIN_224 = "img=L/16,res=224,token_len=32,mask_ratio=0.3,batchsize=128"
CHAIN_336 = "img=L/16,res=336,token_len=32,mask_ratio=0.4,batchsize=128"
CHAIN_STEPS_224 = (2, 4)
CHAIN_STEPS_336 = 3
CHAIN_SYNC_SECONDS = 2.0
# per step at 224 (L = 138: the backward's whole-head scheme) and at 336
# (L = 1 + int(441 x 0.6) = 265: its long scheme): the fused forward once
# per image layer and once more in remat's recompute, the backward once per
# layer; the 32-token text tower on the einsum path
CHAIN_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0,
                  "fused_fwd": 2 * TRAIN_IMAGE_LAYERS,
                  "fused_bwd": TRAIN_IMAGE_LAYERS}

_CHAIN_CONFIG = """
from clipa_tpu_torch.configs import clipa_finetune


def get_config(arg=None):
    config = clipa_finetune.get_config(arg)
    # two batches in the shuffle buffer (the config's 250 000 is 30x the
    # shards)
    config.input.shuffle_buffer_size = 2 * config.input.batch_size
    # the config's warmup (204 800 steps at B = 128) must be fewer than
    # total_steps
    config.schedule = [(".*", dict(decay_type="cosine", warmup_steps=1))]
    config.log_training_steps = 1
    # the config's zero-shot eval wants ImageNet tfrecords in data_dir:
    # phase 14 runs it
    config.evals = {{}}
    config.ckpt_steps = {ckpt}
    config.keep_ckpts = 2
    config.save_ckpt = config.export_npz = {save}
    config.local_stage_dir = {stage!r}
    config.remote_sync = dict(every_seconds={every})
    return config
"""


def _unmask_chain(card, pretrain_npz, data_dir):
    """Phase 16: (a) the 224 stage (CHAIN_224, init=file://<phase 13's
    params.npz>) on a file:// workdir mirrored every CHAIN_SYNC_SECONDS:
    run 1 trains 2 steps and checkpoints; the local stage is deleted; run 2
    pulls the URL, restores a state equal bit for bit to the pushed
    checkpoint and trains steps 3-4. (b) the 336 stage (CHAIN_336,
    init=<the 224 stage's URL>/params.npz): every tensor from the URL's npz
    through masked_init, 3 steps; the launches of every step of both
    stages; at 336, the kernel path against the plain path on one batch
    from the same state and mask noise, pairs/s from the pipeline and with
    the batch on the device, peak device memory, the npz save, load and
    sync seconds."""
    import numpy as np
    import torch
    from clipa_tpu_torch import convert, optim
    from clipa_tpu_torch import utils as u
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.train import checkpoint, loop, step

    reset, read = _attention_counters()
    t_phase = time.perf_counter()
    per_step, stamps, syncers, restored, models = [], [], [], [], []
    seconds = {"save_params": [], "masked_init": []}
    masked_init, save_params = checkpoint.masked_init, checkpoint.save_params
    start_sync, restore = loop._start_sync, loop.restore
    create_model = step.create_model

    def timed(fn, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            seconds[key].append(time.perf_counter() - t0)
            return out
        return run

    def keep_syncer(*args, **kw):
        syncers.append(start_sync(*args, **kw))
        return syncers[-1]

    def keep_model(*args, **kw):
        models.append(create_model(*args, **kw))
        return models[-1]

    with tempfile.TemporaryDirectory() as root:
        url224, url336 = f"file://{root}/ft224", f"file://{root}/ft336"
        stage = os.path.join(root, "stage")
        paths = {}
        for save in (True, False):
            paths[save] = os.path.join(root, f"chain_{save}.py")
            with open(paths[save], "w") as f:
                f.write(_CHAIN_CONFIG.format(
                    ckpt=CHAIN_STEPS_224[0], save=save, stage=stage,
                    every=CHAIN_SYNC_SECONDS))
        pushed = f"{url224}/checkpoints/{CHAIN_STEPS_224[0]}"

        def restore_and_check(saved, state, tx, chrono):
            """loop.restore, then the live state against the checkpoint
            the first run pushed to the URL, bit for bit."""
            at = restore(saved, state, tx, chrono)
            ref = checkpoint.load_state(pushed)
            opt = tx.state_dict()
            restored.append({
                "step": at == ref["step"] == CHAIN_STEPS_224[0],
                "params": all(_bits_equal(state["params"][n], p.cuda())
                              for n, p in ref["params"].items()),
                **{k: all(_bits_equal(opt[k][n], m.cuda())
                          for n, m in ref["opt"][k].items())
                   for k in ("mu", "nu")},
                "count": opt["count"] == ref["opt"]["count"]})
            return at

        # (a) the 224 stage: 2 steps, a lost stage, resumed to 4 from the URL
        spec = f"{CHAIN_224},init=file://{pretrain_npz},data_dir={data_dir}"
        argv = [f"--config={paths[True]}:{spec}", f"--workdir={url224}",
                "--device=cuda"]
        runs_s = []
        with _Patched((step, "make_update_fn", _counting(per_step, stamps)),
                      (checkpoint, "save_params",
                       timed(save_params, "save_params")),
                      (loop, "_start_sync", keep_syncer),
                      (loop, "restore", restore_and_check)):
            for total in CHAIN_STEPS_224:
                t0 = time.perf_counter()
                loop.main(argv + [f"--config.total_steps={total}"])
                runs_s.append(time.perf_counter() - t0)
                torch.cuda.empty_cache()
                if total == CHAIN_STEPS_224[0]:
                    pushed_files = sorted(
                        os.path.relpath(os.path.join(d, f), root + "/ft224")
                        for d, _, files in os.walk(root + "/ft224")
                        for f in files)
                    shutil.rmtree(stage)   # a restart on a fresh host
        rows = _rows(os.path.join(root, "ft224", "metrics.jsonl"))
        logged = [r["step"] for r in rows]
        print(f"unmask chain, 224 stage (clipa_finetune.py:{CHAIN_224}): "
              f"run 1 pushed {pushed_files}; run 2 restored {restored}; "
              f"{url224}/metrics.jsonl logs steps {logged}; runs "
              f"{' and '.join(f'{s:.2f} s' for s in runs_s)}", flush=True)
        want = [f"checkpoints/{CHAIN_STEPS_224[0]}/state.pt", "config.json",
                "metrics.jsonl", "params.npz"]
        if pushed_files != want:
            raise RuntimeError(f"run 1 pushed {pushed_files}, expected "
                               f"{want}")
        if logged != list(range(1, CHAIN_STEPS_224[1] + 1)):
            raise RuntimeError(f"the 224 stage logs steps {logged}: run 2 "
                               f"did not resume from the pull")
        if len(restored) != 1 or not all(restored[0].values()):
            raise RuntimeError(f"the state run 2 restored differs from the "
                               f"pushed checkpoint: {restored}")
        losses_224 = [r["training_loss"] for r in rows]

        # (b) the 336 stage from the 224 stage's npz, through its URL
        spec = (f"{CHAIN_336},init={url224}/params.npz,"
                f"data_dir={data_dir}")
        argv = [f"--config={paths[False]}:{spec}", f"--workdir={url336}",
                "--device=cuda", f"--config.total_steps={CHAIN_STEPS_336}"]
        first_336 = len(per_step)
        lines, init_equal = [], []

        def logged_init(model, path, log=None, **kw):
            """masked_init, timed, its line kept; then every parameter
            against the npz at `path`, bit for bit."""
            del log
            timed(masked_init, "masked_init")(model, path, log=lambda m: (
                lines.append(m), print(m, flush=True)), **kw)
            loaded = dict(u.tree_flatten_with_names(
                checkpoint.load_params(path)))
            got = convert.to_jax_params(model)
            init_equal.append(set(got) == set(loaded) and all(
                _bits_equal(got[n], x.cuda()) for n, x in loaded.items()))
            return model

        torch.cuda.reset_peak_memory_stats()
        with _Patched((step, "make_update_fn", _counting(per_step, stamps)),
                      (step, "create_model", keep_model),
                      (checkpoint, "masked_init", logged_init),
                      (loop, "_start_sync", keep_syncer)):
            t0 = time.perf_counter()
            loop.main(argv)
            runs_s.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = _rows(os.path.join(root, "ft336", "metrics.jsonl"))
        losses_336 = [r["training_loss"] for r in rows]
        (model,) = models
        config = load_config(f"{paths[False]}:{spec}")

    if [r["step"] for r in rows] != list(range(1, CHAIN_STEPS_336 + 1)) \
            or not np.isfinite(losses_224 + losses_336).all():
        raise RuntimeError(f"the 336 stage logs {rows}")
    if len(lines) != 1 or "kept at init []" not in lines[0] \
            or "resampled []" not in lines[0] or init_equal != [True]:
        raise RuntimeError(f"the 336 stage's masked_init: {lines}, every "
                           f"tensor equal to the npz {init_equal}")
    if per_step != [CHAIN_LAUNCHES] * (CHAIN_STEPS_224[1] + CHAIN_STEPS_336):
        raise RuntimeError(f"the chain's steps launched {per_step}, "
                           f"expected {CHAIN_LAUNCHES} each")
    failed = [p for s in syncers for p in s.passes if not p[0]]
    if len(syncers) != 3 or failed:
        raise RuntimeError(f"{len(syncers)} syncers, failed passes {failed}")

    # at 336: the long scheme, the kernel path against the plain path
    params = optim.named_parameters(model)
    block = model.img.Transformer.encoderblock_0.MultiHeadDotProductAttention_0
    tokens = 1 + int(model.img.grid[0] * model.img.grid[1]
                     * (1 - config.mask_ratio))
    plan = ba.bwd_plan(tokens, model.img.width // block.num_heads)
    if plan.scheme != ba.BWD_LONG or block.attn_impl != "auto":
        raise RuntimeError(f"at L = {tokens} the route is {block.attn_impl} "
                           f"and the backward plan {plan}")
    batch = _finetune_batch(config)

    def grads():   # the same mask noise every time: step 0's generator
        return _grads(model, params, batch, config.mask_ratio,
                      step.mask_generator(config, 0, "cuda"))

    loss_k, grads_k = grads()
    before = read()
    _set_attn_impl(model.img, "plain")
    loss_p, grads_p = grads()
    _set_attn_impl(model.img, "auto")
    if read() != before:
        raise RuntimeError("the plain path launched a kernel")
    cmp = _compare(loss_k, grads_k, loss_p, grads_p)
    _print_compare(f"336 stage at L={tokens}, fused kernels vs plain",
                   loss_k, loss_p, cmp, LOSS_RTOL)
    del grads_k, grads_p
    if (cmp["loss_rel"] > LOSS_RTOL or cmp["min_cosine"] < MIN_GRAD_COSINE
            or cmp["noise"] > KEY_BIAS_NOISE):
        raise RuntimeError("the 336 stage's kernel path differs from the "
                           "plain path's")
    batch_size = config.input.batch_size
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=batch_size))
    update = step.make_update_fn(model, tx, config, config.total_steps)
    state = {"params": params, "step": 0}
    update(state, batch)   # warm-up
    step_rate = batch_size * max(_steps_per_s(update, state, batch, 3)
                                 for _ in range(2))
    del model, models, tx, update, state, params, batch
    torch.cuda.empty_cache()

    s336 = stamps[first_336:]
    rate = batch_size * (len(s336) - 1) / (s336[-1] - s336[0])
    # the 224 stage: seconds of each run's second step (its first waits for
    # the shuffle buffer)
    step_s_224 = [stamps[i + 1] - stamps[i] for i in (0, 2)]
    sync_s = [p[1] for s in syncers for p in s.passes]
    phase_s = time.perf_counter() - t_phase
    print(f"{card}: the 336 stage (clipa_finetune.py:{CHAIN_336}, L = "
          f"{tokens}, backward plan {plan}): trainer pairs/s from the "
          f"pipeline over steps 2-{CHAIN_STEPS_336} {rate:.2f}; the step "
          f"alone with the batch on the device {step_rate:.2f}; peak device "
          f"memory {peak_gb:.2f} GiB; launches per step {per_step[-1]}; the "
          f"224 stage's second step of each run "
          f"{' and '.join(f'{x:.3f}' for x in step_s_224)} s from the "
          f"pipeline; losses 224 "
          f"{' '.join(f'{x:.4f}' for x in losses_224)}, 336 "
          f"{' '.join(f'{x:.4f}' for x in losses_336)}", flush=True)
    print(f"{card}: chain IO: params.npz saves "
          f"{' '.join(f'{s:.2f}' for s in seconds['save_params'])} s; the "
          f"336 stage's masked_init from the URL "
          f"{seconds['masked_init'][0]:.2f} s; {len(sync_s)} sync passes "
          f"{' '.join(f'{s:.2f}' for s in sync_s)} s; runs "
          f"{' '.join(f'{s:.2f}' for s in runs_s)} s; phase 16 in "
          f"{phase_s:.2f} s", flush=True)
    return {"launches": per_step[-1], "steps": len(per_step),
            "tokens_336": tokens, "plan_336": list(plan),
            "pairs_per_s_336": rate, "step_pairs_per_s_336": step_rate,
            "step_s_224": step_s_224,
            "peak_gb_336": peak_gb, "loss_rel": cmp["loss_rel"],
            "min_cosine": cmp["min_cosine"], "restored": restored[0],
            "save_params_s": seconds["save_params"],
            "masked_init_s": seconds["masked_init"][0], "sync_s": sync_s,
            "runs_s": runs_s, "phase_s": phase_s}


# Phase 17: distillation and layer-wise lr decay through the trainer: the
# pretrain config at L/16 @112 (phase 13's synthetic source) with
# --config.lwd=DISTILL_LWD, distilled from a ViT-H/14 two-towers (the H
# text tower; the student's input shapes, so L = 65 at hd 80) whose seeded
# weights are written as a JAX-layout npz under a file:// URL and read back
# through distill.model_init.
DISTILL_TEACHER = "img=H/14,res=112,token_len=8,batchsize=384"
DISTILL_STEPS = 3
DISTILL_LWD = 0.85
# per step: the student's 24 image layers forward and backward, the
# teacher's 32 forward only (no graph); both text towers on the einsum path
DISTILL_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0,
                    "fused_fwd": TRAIN_IMAGE_LAYERS + IMAGE_LAYERS,
                    "fused_bwd": TRAIN_IMAGE_LAYERS}
# The names whose lr multipliers are printed: lwd ** (24 - i) for block i,
# lwd ** 25 for the stem
DISTILL_NAMES = {
    "img/Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel":
        DISTILL_LWD ** TRAIN_IMAGE_LAYERS,
    "img/Transformer/encoderblock_23/MlpBlock_0/Dense_0/kernel":
        DISTILL_LWD,
    "img/embedding/kernel": DISTILL_LWD ** (TRAIN_IMAGE_LAYERS + 1)}

_DISTILL_CONFIG = _TRAINER_CONFIG.replace("    return config\n", """\
    teacher = clipa_pretrain.get_config({teacher!r})
    config.distill = dict(model_name="two_towers", model=teacher.model,
                          seed={seed}, model_init={init!r})
    config.save_ckpt = config.export_npz = False
    return config
""")


def _distill(card):
    """Phase 17: the trainer with a frozen H/14 teacher and lwd: the
    teacher's seeded weights written to a file:// npz (the JAX layout) and
    read back through distill.model_init; DISTILL_STEPS steps. Raises
    unless distill_loss and contrastive_loss are logged finite every step,
    every step launches DISTILL_LAUNCHES, the teacher equals the written
    weights bit for bit after the steps, the optimizer's lr multipliers are
    lwd's (DISTILL_NAMES; every txt/ name 1) and, on one batch from the same
    state, the kernel path's distilled loss and gradients agree with the
    plain path's. Prints pairs/s of the distilled and the plain step with
    the batch on the device (the teacher's share) and peak memory."""
    import numpy as np
    import torch
    from clipa_tpu_torch import convert, optim
    from clipa_tpu_torch.config import apply_overrides, load_config
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch.train import checkpoint, loop, step

    reset, read = _attention_counters()
    t_phase = time.perf_counter()
    per_step, stamps, teachers, models, txs = [], [], [], [], []
    build_teacher, create_model = loop._build_teacher, step.create_model
    make_optimizer = optim.make

    def keep(store, fn):
        def run(*args, **kw):
            store.append(fn(*args, **kw))
            return store[-1]
        return run

    with tempfile.TemporaryDirectory() as root:
        # the teacher's weights: seeded, written to a URL in the JAX layout
        tcfg = clipa_pretrain.get_config(DISTILL_TEACHER)
        source = step.create_model(tcfg, device="cuda")
        step.init_train_state(source, tcfg, torch.Generator(
            device="cuda").manual_seed(SEED + 3), "cuda")
        written = {n: t.detach().cpu() for n, t in
                   convert.to_jax_params(source).items()}
        del source
        torch.cuda.empty_cache()
        url = f"file://{root}/teacher/params.npz"
        t0 = time.perf_counter()
        checkpoint.save_params(written, url)
        write_s = time.perf_counter() - t0
        npz_gb = os.path.getsize(f"{root}/teacher/params.npz") / 2 ** 30

        path = os.path.join(root, "distill_config.py")
        with open(path, "w") as f:
            f.write(_DISTILL_CONFIG.format(
                pretrain=PRETRAIN, captions=TRAINER_CAPTIONS,
                steps=DISTILL_STEPS, ckpt=DISTILL_STEPS,
                teacher=DISTILL_TEACHER, seed=SEED + 4, init=url))
        overrides = [f"--config.lwd={DISTILL_LWD}"]
        argv = [f"--config={path}", f"--workdir={root}/run",
                "--device=cuda", *overrides]
        torch.cuda.reset_peak_memory_stats()
        with _Patched((step, "make_update_fn", _counting(per_step, stamps)),
                      (loop, "_build_teacher", keep(teachers, build_teacher)),
                      (step, "create_model", keep(models, create_model)),
                      (optim, "make", keep(txs, make_optimizer))):
            t0 = time.perf_counter()
            loop.main(argv)
            run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = _rows(os.path.join(root, "run", "metrics.jsonl"))
        config = apply_overrides(load_config(path), overrides)

    (teacher,) = teachers
    model = models[0]   # the student; the teacher's came second
    (tx, _), = txs
    del models, txs
    keys = ("training_loss", "contrastive_loss", "distill_loss")
    if [r["step"] for r in rows] != list(range(1, DISTILL_STEPS + 1)) or \
            not all(np.isfinite(r[k]) for r in rows for k in keys):
        raise RuntimeError(f"metrics.jsonl: {rows}")
    if per_step != [DISTILL_LAUNCHES] * DISTILL_STEPS:
        raise RuntimeError(f"distilled steps launched {per_step}, expected "
                           f"{DISTILL_LAUNCHES} each")
    held = convert.to_jax_params(teacher)
    frozen = set(held) == set(written) and all(
        _bits_equal(held[n], w.cuda()) for n, w in written.items())
    mults = {n: tx.lr_mults.get(n, 1.0) * tx.lwd.get(n, 1.0)
             for n in tx.params}
    text = {mults[n] for n in mults if n.startswith("txt/")}
    n_teacher = sum(p.numel() for p in teacher.parameters())
    print(f"distillation: teacher clipa_pretrain.py:{DISTILL_TEACHER}'s "
          f"two-towers ({n_teacher / 1e6:.1f}M parameters) from {url} "
          f"({npz_gb:.2f} GiB, written in {write_s:.2f} s); after "
          f"{DISTILL_STEPS} steps equal to the written weights bit for bit: "
          f"{frozen}; lr multipliers "
          f"{ {n: mults[n] for n in DISTILL_NAMES} } (expected "
          f"{DISTILL_NAMES}), every txt/ name {text}", flush=True)
    if not frozen or any(p.requires_grad for p in teacher.parameters()):
        raise RuntimeError("the teacher moved or takes gradients")
    if text != {1.0} or not all(
            abs(mults[n] / w - 1) < 1e-12 for n, w in DISTILL_NAMES.items()):
        raise RuntimeError("the optimizer's lr multipliers are not lwd's")

    # the kernel path against the plain path, one batch, the same state
    params = optim.named_parameters(model)
    rng = np.random.RandomState(SEED)
    res, tokens = config.init_shapes[0][1], config.init_shapes[1][1]
    b = config.input.batch_size
    batch = {"image": torch.from_numpy(rng.randint(
                 0, 255, (b, res, res, 3), dtype=np.uint8)).cuda(),
             "labels": torch.from_numpy(rng.randint(
                 0, 32000, (b, tokens)).astype(np.int32)).cuda()}
    loss_k, grads_k = _grads(model, params, batch, teacher=teacher)
    before = read()
    for tower in (model.img, teacher.img):
        _set_attn_impl(tower, "plain")
    loss_p, grads_p = _grads(model, params, batch, teacher=teacher)
    for tower in (model.img, teacher.img):
        _set_attn_impl(tower, "auto")
    if read() != before:
        raise RuntimeError("the plain path launched a kernel")
    cmp = _compare(loss_k, grads_k, loss_p, grads_p)
    _print_compare("distilled step, fused kernels vs plain (student and "
                   "teacher)", loss_k, loss_p, cmp, LOSS_RTOL)
    del grads_k, grads_p
    if (cmp["loss_rel"] > LOSS_RTOL or cmp["min_cosine"] < MIN_GRAD_COSINE
            or cmp["noise"] > KEY_BIAS_NOISE):
        raise RuntimeError("the distilled kernel path differs from the "
                           "plain path")

    # the distilled step and the plain step, the batch on the device
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=b))
    updates = {"distilled": step.make_update_fn(model, tx, config,
                                                teacher_model=teacher),
               "undistilled": step.make_update_fn(model, tx, config)}
    state = {"params": params, "step": 0}
    rates = {k: 0.0 for k in updates}
    for name in ("distilled", "undistilled") * 2:
        if rates[name] == 0.0:
            updates[name](state, batch)   # warm-up
        rates[name] = max(rates[name], b * _steps_per_s(
            updates[name], state, batch, 3))
    share = 1 - rates["distilled"] / rates["undistilled"]
    del model, teacher, tx, updates, state, params, batch
    torch.cuda.empty_cache()
    rate = b * (len(stamps) - 1) / (stamps[-1] - stamps[0])
    phase_s = time.perf_counter() - t_phase
    print(f"{card}: distilled trainer at B={b} "
          f"(clipa_pretrain.py:{PRETRAIN}, lwd {DISTILL_LWD}, teacher "
          f"clipa_pretrain.py:{DISTILL_TEACHER}'s model): pairs/s from the "
          f"pipeline over steps 2-{DISTILL_STEPS} {rate:.2f}; with the batch "
          f"on the device distilled {rates['distilled']:.2f}, undistilled "
          f"{rates['undistilled']:.2f} (the teacher's share of a distilled "
          f"step {share:.3f}); peak device memory {peak_gb:.2f} GiB; "
          f"launches per step {per_step[0]}; losses "
          f"{[{k: round(r[k], 4) for k in keys} for r in rows]}; run "
          f"{run_s:.2f} s; phase 17 in {phase_s:.2f} s", flush=True)
    return {"launches": per_step[0], "steps": len(per_step),
            "pairs_per_s": rate, "step_pairs_per_s": rates,
            "teacher_share": share, "peak_gb": peak_gb,
            "loss_rel": cmp["loss_rel"], "min_cosine": cmp["min_cosine"],
            "lr_mults": {n: mults[n] for n in DISTILL_NAMES},
            "teacher_npz_gb": npz_gb, "teacher_write_s": write_s,
            "run_s": run_s, "phase_s": phase_s}


# Phase 18: CLIPA-v1's ViT-L/16 (8 BPE tokens, syntax masking, open_clip's
# gap_all pool) and open_clip's ViT-L/14 (ln_pre, class-token pool, a causal
# text tower of 77 tokens pooled at eot), both @224 with 24 image layers:
# L = 197 and L = 257, D = 1024, 16 heads of 64, on the fused forward.
INTEROP_MODELS = ("ViT-L-16-CL8-Syntax-GAP", "ViT-L-14")
INTEROP_LAYERS = 24
# OpenAI's ViT-L/14 release runs QuickGELU: open_clip registers its weights
# under this config (compat/pretrained.py's -quickgelu aliases).
OPENAI_CONFIG = "ViT-L-14-quickgelu"
# bpe_simple_vocab_16e6's merge count: 256 bytes x 2 + 48 894 merges + 2
# specials = the configs' 49 408 rows, <end_of_text> = 49 407.
BPE_MERGES = 48894
# The service's live weights after a switch, against one model's: the
# evicted model's tensors must be gone.
SWITCH_SLACK = 0.10
# captions per timed text request (8 chunks of bucket 256)
TEXT_REQUEST = 2048
INTEROP_CAPTIONS = (
    "a photo of a cat",
    "a small brown dog running on the green grass near a quiet river",
    "two red cars parked beside an old stone church at night",
    "close up of a bright yellow flower with morning dew",
    "an aerial view of a fishing village on a rocky coastline",
    "people walking on a busy street in the rain with umbrellas",
    "a plate of pasta",
    "the tallest building in the city reflected in a calm lake at sunset",
)


def _seeded_captions(rng, n):
    """n captions of 4-20 pseudo-words of 3-10 lowercase letters, drawn from
    `rng`. Few words recur (three-letter ones can), so a tokenizer's word
    cache (SimpleTokenizer.cache) meets almost every word for the first
    time."""
    import numpy as np
    n_words = rng.randint(4, 21, n)
    lengths = rng.randint(3, 11, int(n_words.sum()))
    letters = rng.randint(0, 26, int(lengths.sum())).astype(np.uint8) + 97
    text, ends = letters.tobytes().decode(), np.cumsum(lengths)
    words = [text[e - k:e] for e, k in zip(ends, lengths)]
    cuts = np.concatenate([[0], np.cumsum(n_words)])
    return [" ".join(words[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]


def _text_seconds(live, texts):
    """(tokenizer s, text tower s) of one request: the host's tokenizer
    alone, then the tower alone on its ids (embed_texts runs the two in
    turn)."""
    t0 = time.perf_counter()
    ids = live._tokenize(texts)
    t1 = time.perf_counter()
    live._run_bucketed(live._embed_texts, ids)
    return t1 - t0, time.perf_counter() - t1


def _write_merges(path, count=BPE_MERGES):
    """Writes a BPE merges file of `count` merges over the lowercase letters
    (no merges file ships in the repository): every letter pair, inside a
    word and at its end ("a b", "a b</w>"), then every pair + letter, then
    pair + pair in order, until `count`. Every merge makes a new token, so
    SimpleTokenizer's vocab has 512 + count + 2 entries, and words split
    into multi-letter ids as with OpenAI's file."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    pairs = [a + b for a in letters for b in letters]
    merges = [f"{p[0]} {p[1]}{end}" for p in pairs for end in ("", "</w>")]
    merges += [f"{p} {c}{end}" for p in pairs for c in letters
               for end in ("", "</w>")]
    merges += [f"{p} {q}{end}" for p in pairs for q in pairs
               for end in ("", "</w>")][:max(0, count - len(merges))]
    with open(path, "w") as f:
        f.write("\n".join(["#version: 0.2 (letter n-grams)"]
                          + merges[:count]))


def _bit_equal_models(a, b, what):
    """Raises unless two modules hold the same tensors, bit for bit."""
    import torch
    sa, sb = a.state_dict(), b.state_dict()
    if sa.keys() != sb.keys():
        raise RuntimeError(f"{what}: keys differ: "
                           f"{sorted(sa.keys() ^ sb.keys())[:5]}")
    bad = [k for k in sa if sa[k].dtype != sb[k].dtype
           or not torch.equal(sa[k], sb[k])]
    if bad:
        raise RuntimeError(f"{what}: {len(bad)} tensors differ: {bad[:5]}")
    return len(sa)


def _bytes_allocated():
    """Bytes the caching allocator has handed out since the process began
    (a running total: frees do not lower it)."""
    import torch
    return torch.cuda.memory_stats()["allocated_bytes.all.allocated"]


def _weight_bytes(module):
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def _interop(card):
    """Phase 18: open_clip interop at full width, seeded weights.

    (a) builds INTEROP_MODELS (fp32, seeded); (b) exports each with
    ``save_open_clip`` (no byte allocated on the card) and loads it back
    with ``create_model(..., pretrained=<.bin>)`` (every tensor bit for
    bit), saves ViT-L-14's state dict under OpenAI's keys (with the
    release's metadata scalars) and loads it through
    ``load_openai_model``: its image and text embeddings equal
    ``create_model(OPENAI_CONFIG, <.bin>)``'s bit for bit; (c) serves both
    from their .bin files through one ``MultiModelService(max_live=1)``
    with the BPE tokenizer on a merges file written here (BPE_MERGES):
    requests of 5, 64 and 300 uint8 images and caption batches (some past
    the 8-token tower's budget, so syntax sampling bites), shapes, finite
    values, unit norms, INTEROP_LAYERS fused forwards per image chunk,
    eviction on each switch (the live tensors within one model's weights
    plus SWITCH_SLACK), ``embed_images_to`` / ``embed_texts_to`` into .npy
    equal to the in-RAM path, the image embeddings against a service on
    the plain attention path (per-row cosine >= MIN_COSINE); (d) prints
    images/s at bucket 256 per model; texts/s on TEXT_REQUEST distinct
    seeded captions (``_seeded_captions``), the tokenizer's word cache
    cold and then warm, and the tokenizer's seconds apart from the text
    tower's (``_text_seconds``); peak memory and the export, save and load
    seconds."""
    import numpy as np
    import torch
    from clipa_tpu_torch.compat import export, openclip
    from clipa_tpu_torch.ops import block_attention as ba
    from clipa_tpu_torch.pp.bpe_tokenizer import SimpleTokenizer
    from clipa_tpu_torch.serving import EmbeddingService, MultiModelService

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peaks = {}

    def stage_peak(stage):
        peaks[stage] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()

    work = tempfile.TemporaryDirectory()
    merges = os.path.join(work.name, "bpe_merges.txt")
    _write_merges(merges)
    bpe = SimpleTokenizer(merges)
    if (len(bpe.encoder), bpe.eot) != (49408, 49407):
        raise RuntimeError(f"the merges file gives {len(bpe.encoder)} ids, "
                           f"<end_of_text> {bpe.eot}")
    seconds, bins, out = {}, {}, {"models": {}}

    # (a), (b): build, export, load back
    for i, name in enumerate(INTEROP_MODELS):
        t0 = time.perf_counter()
        built = openclip.create_model(name, device="cuda", seed=SEED + i)
        torch.cuda.synchronize()
        seconds[f"{name} build"] = time.perf_counter() - t0
        allocated = _bytes_allocated()
        t0 = time.perf_counter()
        sd = openclip.export_torch_state_dict(built)
        seconds[f"{name} export"] = time.perf_counter() - t0
        del sd
        folder = os.path.join(work.name, f"model{i}")
        t0 = time.perf_counter()
        export.save_open_clip(built, name, folder)
        seconds[f"{name} save_open_clip"] = time.perf_counter() - t0
        if _bytes_allocated() != allocated:
            raise RuntimeError(
                f"{name}: the export allocated "
                f"{_bytes_allocated() - allocated} bytes on the card")
        bins[name] = os.path.join(folder, export.WEIGHTS_FILENAME)
        t0 = time.perf_counter()
        loaded = openclip.create_model(name, bins[name], device="cuda")
        torch.cuda.synchronize()
        seconds[f"{name} load"] = time.perf_counter() - t0
        n = _bit_equal_models(built.model, loaded.model,
                              f"{name} exported and loaded back")
        out["models"][name] = {
            "tensors_bit_for_bit": n,
            "bin_gb": os.path.getsize(bins[name]) / 2 ** 30}
        del built, loaded
    stage_peak("export and load back")
    torch.cuda.empty_cache()

    # ViT-L-14 under OpenAI's keys, through load_openai_model
    l14 = INTEROP_MODELS[1]
    sd = torch.load(bins[l14], map_location="cpu", weights_only=True)
    sd.update(input_resolution=torch.tensor(224),
              context_length=torch.tensor(77),
              vocab_size=torch.tensor(49408))
    openai_path = os.path.join(work.name, "ViT-L-14-openai.pt")
    torch.save(sd, openai_path)
    del sd
    t0 = time.perf_counter()
    oa = openclip.load_openai_model(openai_path, device="cuda")
    torch.cuda.synchronize()
    seconds["load_openai_model"] = time.perf_counter() - t0
    ref = openclip.create_model(OPENAI_CONFIG, bins[l14], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(8, 224, 224, 3, device="cuda", generator=gen)
    tok = openclip.get_tokenizer(l14, vocab_path=merges)
    ids = tok(list(INTEROP_CAPTIONS))
    for what, za, zb in (("images", oa.encode_image(x), ref.encode_image(x)),
                         ("texts", oa.encode_text(ids),
                          ref.encode_text(ids))):
        if not torch.equal(za, zb):
            raise RuntimeError(
                f"load_openai_model's {what} embeddings differ from "
                f"create_model({OPENAI_CONFIG}): max "
                f"{(za - zb).abs().max().item()}")
    _bit_equal_models(oa.model, ref.model, "load_openai_model")
    del oa, ref, x
    stage_peak("load_openai_model")
    torch.cuda.empty_cache()
    print(f"{card}: open_clip interop: {INTEROP_MODELS} exported and loaded "
          f"back bit for bit ({out['models']}), load_openai_model equals "
          f"create_model({OPENAI_CONFIG}) bit for bit; seconds "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }", flush=True)

    # (c) one MultiModelService, one model live
    svc = MultiModelService({name: dict(
        model_name=name, pretrained=bins[name], vocab_path=merges,
        device="cuda", precision="bfloat16", seed=SEED, num_workers=0)
        for name in INTEROP_MODELS}, max_live=1)
    rng = np.random.RandomState(SEED)
    requests = [rng.randint(0, 256, (n, 224, 224, 3), np.uint8)
                for n in (5, 64, 300)]
    captions = list(INTEROP_CAPTIONS) * 5
    batch = rng.randint(0, 256, (1024, 224, 224, 3), np.uint8)
    baseline = torch.cuda.memory_allocated()
    served = {}
    for name in INTEROP_MODELS + INTEROP_MODELS[:1]:   # switch, and back
        t0 = time.perf_counter()
        live = svc.get(name)
        torch.cuda.synchronize()
        switch_s = time.perf_counter() - t0
        weights = _weight_bytes(live.clip.model)
        held = torch.cuda.memory_allocated() - baseline
        if list(svc._live) != [name]:
            raise RuntimeError(f"live services {list(svc._live)} after "
                               f"switching to {name}")
        if held > (1 + SWITCH_SLACK) * weights:
            raise RuntimeError(
                f"after switching to {name} the device holds {held} bytes "
                f"beyond the baseline, its weights {weights}: the evicted "
                f"model was not freed")
        print(f"{card}: switched to {name} in {switch_s:.2f} s: "
              f"{held / 2 ** 30:.3f} GiB held, its weights "
              f"{weights / 2 ** 30:.3f} GiB", flush=True)
        if name in served:   # the second visit: the same embeddings
            again = [live.embed_images(r) for r in requests[:2]]
            if not all(np.array_equal(a, b) for a, b in
                       zip(again, served[name]["images"])):
                raise RuntimeError(f"{name} served other embeddings after "
                                   f"its eviction")
            continue
        chunks = sum(len(list(live._chunks(r))) for r in requests)
        ba.fused_attention.launches = 0
        z_images = [live.embed_images(r) for r in requests]
        launches = ba.fused_attention.launches
        z_texts = [live.embed_texts(captions[:7]), live.embed_texts(captions)]
        if ba.fused_attention.launches != launches:
            raise RuntimeError(f"{name}'s text tower launched the fused "
                               f"kernel")
        dim = live.embed_dim
        for r, z in zip(requests, z_images):
            _check_embeddings(z, len(r), dim, f"{name}: {len(r)} images")
        _check_embeddings(z_texts[0], 7, dim, f"{name}: 7 texts")
        _check_embeddings(z_texts[1], len(captions), dim,
                          f"{name}: {len(captions)} texts")
        if launches != INTEROP_LAYERS * chunks:
            raise RuntimeError(f"{name}: the fused forward launched "
                               f"{launches} times over {chunks} chunks, "
                               f"expected {INTEROP_LAYERS * chunks}")
        ctx = live.clip.context_length
        long = sum(len(bpe.encode(c)) > ctx - 2 for c in INTEROP_CAPTIONS)
        sampled = int((live.tokenizer(captions)
                       != bpe(captions, ctx)).any(1).sum())
        if name == INTEROP_MODELS[0] and not (long and sampled):
            raise RuntimeError(f"{name}: syntax sampling did not bite "
                               f"({long} long captions, {sampled} rows "
                               f"unlike plain truncation)")
        npy = os.path.join(work.name, "images.npy")
        tnpy = os.path.join(work.name, "texts.npy")
        live.embed_images_to(requests[1], npy)
        live.embed_texts_to(captions, tnpy)
        if not (np.array_equal(np.load(npy), z_images[1])
                and np.array_equal(np.load(tnpy), z_texts[1])):
            raise RuntimeError(f"{name}: embed_*_to's .npy differs from "
                               f"the in-RAM path")
        img_rate = _rate(lambda: live.embed_images(batch), len(batch))
        # texts at bucket 256: TEXT_REQUEST distinct seeded captions, each
        # word new to the tokenizer's cache, then the same request again
        # with the cache warm; and each split into the tokenizer's seconds
        # and the tower's on a second fresh request and its repeat
        texts = _seeded_captions(rng, TEXT_REQUEST)
        t0 = time.perf_counter()
        live.embed_texts(texts)
        txt_rate = len(texts) / (time.perf_counter() - t0)
        txt_rate_warm = _rate(lambda: live.embed_texts(texts), len(texts))
        fresh = _seeded_captions(rng, TEXT_REQUEST)
        split = {"cold": _text_seconds(live, fresh),
                 "warm": _text_seconds(live, fresh)}
        served[name] = {"images": z_images[:2], "chunks": chunks,
                        "launches": launches, "weights_gb": weights / 2 ** 30,
                        "switch_s": switch_s,
                        "images_per_s": img_rate, "texts_per_s": txt_rate,
                        "texts_per_s_warm_cache": txt_rate_warm,
                        "text_seconds": {k: {"tokenizer": a, "tower": b}
                                         for k, (a, b) in split.items()},
                        "captions_past_budget": long,
                        "syntax_sampled_rows": sampled}
        print(f"{card}: {name} served {sum(len(r) for r in requests)} "
              f"images in {chunks} chunks ({launches} fused forwards) and "
              f"{7 + len(captions)} texts ({long} of "
              f"{len(INTEROP_CAPTIONS)} captions past the {ctx - 2}-id "
              f"budget, {sampled} of {len(captions)} rows syntax-sampled); "
              f"images/s at bucket 256 {img_rate:.2f}; texts/s at "
              f"bucket 256 over {len(texts)} distinct seeded captions "
              f"{txt_rate:.2f} (tokenizer's cache cold), "
              f"{txt_rate_warm:.2f} (warm); {len(fresh)} texts: "
              f"tokenizer {split['cold'][0]:.4f} s, tower "
              f"{split['cold'][1]:.4f} s (cold), tokenizer "
              f"{split['warm'][0]:.4f} s, tower {split['warm'][1]:.4f} s "
              f"(warm)", flush=True)
        del live
    del svc
    stage_peak("serving")
    torch.cuda.empty_cache()

    # the plain attention path, one model at a time
    for name in INTEROP_MODELS:
        plain = EmbeddingService(name, bins[name], vocab_path=merges,
                                 device="cuda", precision="bfloat16",
                                 num_workers=0, attn_impl="plain")
        before = ba.fused_attention.launches
        cos_min = 1.0
        for r, z in zip(requests[:2], served[name]["images"]):
            zp = plain.embed_images(r)
            cos = (z * zp).sum(1) / (np.linalg.norm(z, axis=1)
                                     * np.linalg.norm(zp, axis=1))
            cos_min = min(cos_min, float(cos.min()))
        if ba.fused_attention.launches != before:
            raise RuntimeError("the plain path launched the kernel")
        print(f"{name}: kernel vs plain attention path, per-row cosine min "
              f"{cos_min:.6f}", flush=True)
        if cos_min < MIN_COSINE:
            raise RuntimeError(f"{name}: service embeddings differ from the "
                               f"plain path: cosine {cos_min} < "
                               f"{MIN_COSINE}")
        served[name]["min_cosine"] = cos_min
        del plain
        torch.cuda.empty_cache()
    stage_peak("plain path")
    work.cleanup()
    peak_gb = max(peaks.values())
    phase_s = time.perf_counter() - t_phase
    print(f"{card}: phase 18 peak device memory {peak_gb:.2f} GiB (by "
          f"stage: { {k: round(v, 3) for k, v in peaks.items()} }); phase "
          f"18 in {phase_s:.2f} s", flush=True)
    for name, s in served.items():
        s.pop("images")
        out["models"][name].update(s)
    return {**out, "seconds": seconds, "peak_gb": peak_gb,
            "peak_gb_by_stage": peaks,
            "launches": sum(s["launches"] for s in served.values()),
            "phase_s": phase_s}


# Phase 19: CoCa at coca_ViT-L-14's full width (seeded weights): the image
# tower L/14 @224 (24 x 1024, L = 257, 16 heads of 64: the fused forward,
# and in training the backward's long scheme), the attentional pooler (256
# queries, 8 heads of 96), the embed_cls text tower (12 x 768, 75 ids and
# the cls) and the caption decoder (12 x 768, vocab 49 408) on the einsum
# path.
COCA_MODEL = "coca_ViT-L-14"
COCA_LAYERS = 24
# the CoCa step at B = 128 (the release trained at 90k; one card), 224 px,
# 76 BPE ids, with the pretrain config's optimizer (Adam b2 0.95, bf16
# first moment, wd 0.2) over fp32 masters, bf16 compute
COCA_TRAIN = "img=L/16,res=224,token_len=76,batchsize=128"
COCA_LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0,
                 "fused_fwd": COCA_LAYERS, "fused_bwd": COCA_LAYERS}
# the learning check's const lr: 20 steps of Adam must move the caption
# decoder's logits by nats (3e-5, phase 5's, moves them by ~0.4)
COCA_LEARN_LR = 3e-4
COCA_DROP_PATH = 0.1
COCA_TRAINER_STEPS = 3
# caption generation: 4 images, 6 beams in 3 groups, 30 ids
COCA_CAPTION_IMAGES = 4
COCA_BEAMS = (6, 3)
COCA_SEQ_LEN = 30
COCA_TOP_K = 5
COCA_TOP_P = 0.9

_COCA_TRAINER_CONFIG = """
from clipa_tpu_torch.compat import openclip
from clipa_tpu_torch.configs import clipa_pretrain


def get_config(arg=None):
    config = clipa_pretrain.get_config({pretrain!r})
    config.model_name = "coca"
    config.loss = "coca"
    config.model = dict(openclip._to_coca_cfg(openclip.get_model_config(
        {model!r})), dtype="bfloat16")
    # two batches in the shuffle buffer (the config's 250 000 is 30x the
    # shards)
    config.input.shuffle_buffer_size = 2 * config.input.batch_size
    config.total_steps = {steps}
    # the config's 3200 warmup steps must be fewer than total_steps
    config.schedule = [(".*", dict(decay_type="cosine", warmup_steps=2))]
    config.log_training_steps = 1
    config.evals = {{}}
    config.save_ckpt = False
    config.export_npz = False
    return config
"""


def _coca(card, data_dir):
    """Phase 19: CoCa (coca_ViT-L-14) at full width, seeded weights.

    (b) the model in fp32, exported with ``save_open_clip`` (nothing
    allocated on the card) and loaded back with ``create_model(...,
    pretrained=<.bin>)``: every tensor bit for bit; (a) the
    ``EmbeddingService`` in bf16 with a BPE merges file written here:
    requests of 5, 64 and 300 uint8 images and two caption batches, shapes,
    finite values, unit norms, COCA_LAYERS fused forwards per image chunk,
    per-row cosine >= MIN_COSINE against a service on the plain attention
    path, images/s and texts/s at bucket 256; (c) ``generate`` on
    COCA_CAPTION_IMAGES images: beam search (COCA_BEAMS) and top-k / top-p
    sampling from SEED, every output from sot, every beam output holding
    eos, COCA_LAYERS fused forwards per call (the images encoded once), the
    logits at every position of the beam outputs against the plain path's
    (cosine >= MIN_COSINE), seconds per caption; (d) the step of
    ``make_update_fn(model_name="coca", loss="coca")`` at COCA_TRAIN: one
    step launches COCA_LAUNCHES, the kernel path's loss and gradients
    against the plain path's (both at remat "full"; LOSS_RTOL,
    MIN_GRAD_COSINE), the image tower at remat "full" against none at rate
    0 (every gradient bit for bit, a lower peak), pairs/s (best of two),
    peak memory, 20 steps at COCA_LEARN_LR lowering the total loss below
    LEARN_FACTOR x its start and the caption loss, one step at DropPath
    COCA_DROP_PATH with a finite loss; (e) ``train.loop.main`` for
    COCA_TRAINER_STEPS steps on a config file setting model_name, loss and
    the model of COCA_MODEL over COCA_TRAIN with `data_dir` (phase 15's
    JPEG tfrecords; the pretrain config's pp: WordPiece ids, in the CoCa
    vocabulary's range): finite losses, COCA_LAUNCHES per step."""
    import numpy as np
    import torch
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.compat import export, openclip
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch.ops import preprocess
    from clipa_tpu_torch.serving import EmbeddingService
    from clipa_tpu_torch.train import loop, step

    t_phase = time.perf_counter()
    reset, read = _attention_counters()
    work = tempfile.TemporaryDirectory()
    merges = os.path.join(work.name, "bpe_merges.txt")
    _write_merges(merges)
    seconds, out = {}, {}
    torch.cuda.empty_cache()

    # (b) export and load back
    t0 = time.perf_counter()
    built = openclip.create_model(COCA_MODEL, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    seconds["build"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in built.model.parameters())
    folder = os.path.join(work.name, "coca")
    allocated = _bytes_allocated()
    t0 = time.perf_counter()
    export.save_open_clip(built, COCA_MODEL, folder)
    seconds["save_open_clip"] = time.perf_counter() - t0
    if _bytes_allocated() != allocated:
        raise RuntimeError(f"the CoCa export allocated "
                           f"{_bytes_allocated() - allocated} bytes on the "
                           f"card")
    t0 = time.perf_counter()
    loaded = openclip.create_model(
        COCA_MODEL, os.path.join(folder, export.WEIGHTS_FILENAME),
        device="cuda")
    torch.cuda.synchronize()
    seconds["load"] = time.perf_counter() - t0
    if not isinstance(loaded, openclip.CoCaModel):
        raise RuntimeError(f"create_model({COCA_MODEL}) gave {type(loaded)}")
    out["tensors_bit_for_bit"] = _bit_equal_models(
        built.model, loaded.model, f"{COCA_MODEL} exported and loaded back")
    del built, loaded
    torch.cuda.empty_cache()
    print(f"{card}: {COCA_MODEL}: {n_params / 1e6:.1f}M parameters; "
          f"exported and loaded back, {out['tensors_bit_for_bit']} tensors "
          f"bit for bit; seconds "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }", flush=True)

    # (a) the service
    svc = EmbeddingService(COCA_MODEL, None, vocab_path=merges,
                           device="cuda", precision="bfloat16", seed=SEED,
                           num_workers=0)
    rng = np.random.RandomState(SEED)
    requests = [rng.randint(0, 256, (n, 224, 224, 3), np.uint8)
                for n in (5, 64, 300)]
    captions = list(INTEROP_CAPTIONS) * 5
    chunks = sum(len(list(svc._chunks(r))) for r in requests)
    reset()
    z_images = [svc.embed_images(r) for r in requests]
    serve_launches = read()["fused_fwd"]
    z_texts = [svc.embed_texts(captions[:7]), svc.embed_texts(captions)]
    if read()["fused_fwd"] != serve_launches:
        raise RuntimeError("CoCa's text tower launched the fused kernel")
    dim = svc.embed_dim
    for r, z in zip(requests, z_images):
        _check_embeddings(z, len(r), dim, f"CoCa: {len(r)} images")
    _check_embeddings(z_texts[0], 7, dim, "CoCa: 7 texts")
    _check_embeddings(z_texts[1], len(captions), dim,
                      f"CoCa: {len(captions)} texts")
    if serve_launches != COCA_LAYERS * chunks:
        raise RuntimeError(f"CoCa serving launched the fused forward "
                           f"{serve_launches} times over {chunks} chunks, "
                           f"expected {COCA_LAYERS * chunks}")
    plain = EmbeddingService(COCA_MODEL, None, vocab_path=merges,
                             device="cuda", precision="bfloat16", seed=SEED,
                             num_workers=0, attn_impl="plain")
    before = read()
    serve_cos = 1.0
    for r, z in zip(requests[:2], z_images[:2]):
        zp = plain.embed_images(r)
        cos = (z * zp).sum(1) / (np.linalg.norm(z, axis=1)
                                 * np.linalg.norm(zp, axis=1))
        serve_cos = min(serve_cos, float(cos.min()))
    if read() != before:
        raise RuntimeError("the plain CoCa service launched a kernel")
    if serve_cos < MIN_COSINE:
        raise RuntimeError(f"CoCa service embeddings differ from the plain "
                           f"path: cosine {serve_cos} < {MIN_COSINE}")
    batch = rng.randint(0, 256, (1024, 224, 224, 3), np.uint8)
    texts = _seeded_captions(rng, TEXT_REQUEST)
    img_rate = _rate(lambda: svc.embed_images(batch), len(batch))
    img_rate_plain = _rate(lambda: plain.embed_images(batch), len(batch))
    svc.embed_texts(texts)   # the tokenizer's word cache warm
    txt_rate = _rate(lambda: svc.embed_texts(texts), len(texts))
    print(f"{card}: CoCa served {sum(len(r) for r in requests)} images in "
          f"{chunks} chunks ({serve_launches} fused forwards) and "
          f"{7 + len(captions)} texts; per-row cosine against the plain "
          f"path min {serve_cos:.6f}; images/s at bucket 256 {img_rate:.2f} "
          f"(plain path {img_rate_plain:.2f}); texts/s at bucket 256 "
          f"{txt_rate:.2f} ({len(texts)} seeded captions, cache warm)",
          flush=True)
    out["serving"] = {"chunks": chunks, "launches": serve_launches,
                      "min_cosine": serve_cos, "images_per_s": img_rate,
                      "images_per_s_plain": img_rate_plain,
                      "texts_per_s": txt_rate}

    # (c) captions
    clip = svc.clip
    sot, eos = 49406, 49407
    images = preprocess.normalize_uint8(torch.from_numpy(
        requests[0][:COCA_CAPTION_IMAGES]).cuda())
    kinds = {"beam_search": dict(num_beams=COCA_BEAMS[0],
                                 num_beam_groups=COCA_BEAMS[1]),
             "top_k": dict(top_k=COCA_TOP_K, seed=SEED),
             "top_p": dict(top_p=COCA_TOP_P, seed=SEED)}
    captioned, caption_s, gen_launches = {}, {}, {}
    for kind, kw in kinds.items():
        reset()
        t0 = time.perf_counter()
        ids = clip.generate(images, seq_len=COCA_SEQ_LEN,
                            generation_type=kind, **kw)
        caption_s[kind] = (time.perf_counter() - t0) / len(ids)
        gen_launches[kind] = read()["fused_fwd"]
        captioned[kind] = ids
        if ids.shape[0] != COCA_CAPTION_IMAGES or (ids[:, 0] != sot).any():
            raise RuntimeError(f"{kind} captions {ids.shape} do not all "
                               f"start with sot: {ids[:, :3]}")
        if kind == "beam_search" and not (ids == eos).any(axis=1).all():
            raise RuntimeError(f"beam outputs without eos: {ids}")
        if gen_launches[kind] != COCA_LAYERS:
            raise RuntimeError(f"generate ({kind}) launched the fused "
                               f"forward {gen_launches[kind]} times, expected "
                               f"{COCA_LAYERS} (the images once)")

    def logits(impl):   # every position of the beam outputs
        _set_attn_impl(clip.model.img, impl)
        with torch.inference_mode():
            _, _, tokens_img = clip.model.encode_image(images)
            ids = torch.as_tensor(captioned["beam_search"],
                                  device=clip.device)
            _, _, o = clip.model(None, ids, embed_cls=False)
            return clip.model.decoder(o["txt/tokens"], tokens_img)

    lk, lp = logits("auto"), logits("plain")
    _set_attn_impl(clip.model.img, "auto")
    logit_cos = float(torch.nn.functional.cosine_similarity(
        lk, lp, dim=-1).min())
    if logit_cos < MIN_COSINE:
        raise RuntimeError(f"CoCa's caption logits differ from the plain "
                           f"path: cosine {logit_cos} < {MIN_COSINE}")
    print(f"{card}: CoCa captions of {COCA_CAPTION_IMAGES} images, "
          f"{COCA_SEQ_LEN} ids: seconds per caption "
          f"{ {k: round(v, 4) for k, v in caption_s.items()} }; lengths "
          f"{ {k: v.shape[1] for k, v in captioned.items()} }; fused "
          f"forwards per call {gen_launches}; logits at every position of "
          f"the beam outputs against the plain path: cosine min "
          f"{logit_cos:.6f}; beam ids {captioned['beam_search'][0][:8]}",
          flush=True)
    out["captions"] = {"seconds_per_caption": caption_s,
                       "lengths": {k: int(v.shape[1])
                                   for k, v in captioned.items()},
                       "launches": gen_launches,
                       "logit_min_cosine": logit_cos}
    del svc, plain, clip, lk, lp
    torch.cuda.empty_cache()

    # (d) the step
    config = clipa_pretrain.get_config(COCA_TRAIN)
    config.model_name, config.loss = "coca", "coca"
    config.model = dict(openclip._to_coca_cfg(openclip.get_model_config(
        COCA_MODEL)), dtype="bfloat16")
    b = config.input.batch_size
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED),
        "cuda")
    params = state["params"]
    tok = openclip.get_tokenizer(COCA_MODEL, vocab_path=merges)
    batch = {"image": torch.from_numpy(rng.randint(
                 0, 255, (b, 224, 224, 3), dtype=np.uint8)).cuda(),
             "labels": torch.from_numpy(
                 tok(_seeded_captions(rng, b))).cuda()}
    apply_loss = step._make_loss_dispatch("coca", config)
    encoder = model.img.Transformer

    # kernel path vs plain path (the image tower rematted on both sides:
    # the plain path's fp32 scores of 24 layers would not fit beside)
    encoder.remat_policy = "full"
    loss_k, grads_k = _grads(model, params, batch, apply_loss=apply_loss)
    before = read()
    _set_attn_impl(model.img, "plain")
    loss_p, grads_p = _grads(model, params, batch, apply_loss=apply_loss)
    _set_attn_impl(model.img, "auto")
    if read() != before:
        raise RuntimeError("the plain path launched a kernel")
    cmp = _compare(loss_k, grads_k, loss_p, grads_p)
    _print_compare("CoCa step, kernel vs plain path", loss_k, loss_p, cmp,
                   LOSS_RTOL)
    del grads_p
    if (cmp["loss_rel"] > LOSS_RTOL or cmp["min_cosine"] < MIN_GRAD_COSINE
            or cmp["noise"] > KEY_BIAS_NOISE):
        raise RuntimeError("the CoCa kernel path's step differs from the "
                           "plain path's")

    # remat "full" against none at rate 0: every gradient bit for bit
    remat_peaks = {}
    for policy in ("none", "full"):
        encoder.remat_policy = policy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss_r, grads_r = _grads(model, params, batch, apply_loss=apply_loss)
        remat_peaks[policy] = torch.cuda.max_memory_allocated() / 2 ** 30
        if policy == "none":
            grads_none = grads_r
    differ = [n for n in grads_k if not _bits_equal(grads_k[n], grads_r[n])]
    same_none = [n for n in grads_k
                 if not _bits_equal(grads_none[n], grads_r[n])]
    encoder.remat_policy = "none"
    print(f"CoCa step, image tower remat full vs none: {len(same_none)} of "
          f"{len(grads_r)} gradients differ ({same_none[:4]}); full twice: "
          f"{len(differ)} differ; peak device memory "
          f"{ {k: round(v, 2) for k, v in remat_peaks.items()} } GiB",
          flush=True)
    if same_none or differ:
        raise RuntimeError(f"remat full changed gradients: {same_none[:5]} "
                           f"{differ[:5]}")
    if not remat_peaks["full"] < remat_peaks["none"]:
        raise RuntimeError(f"remat full did not lower the peak: "
                           f"{remat_peaks}")
    del grads_k, grads_r, grads_none

    # the main path: one update step, counters read around it
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=b))
    update = step.make_update_fn(model, tx, config, config.total_steps)
    reset()
    torch.cuda.reset_peak_memory_stats()
    state, meas = update(state, batch)
    torch.cuda.synchronize()
    step_launches = read()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"CoCa step: loss {float(meas['training_loss']):.6f} (contrastive "
          f"{float(meas['contrastive_loss']):.4f}, caption "
          f"{float(meas['caption_loss']):.4f}); kernel launches "
          f"{step_launches} (expected {COCA_LAUNCHES}); peak device memory "
          f"{peak_gb:.2f} GiB", flush=True)
    if step_launches != COCA_LAUNCHES:
        raise RuntimeError(f"the CoCa step launched {step_launches}, "
                           f"expected {COCA_LAUNCHES}")
    if not all(bool(torch.isfinite(v)) for v in meas.values()):
        raise RuntimeError(f"non-finite measurements {meas}")
    rate = max(b * _steps_per_s(update, state, batch, 3) for _ in range(2))
    print(f"{card}: CoCa pairs/s at B={b} {rate:.2f}", flush=True)

    # DropPath in training: one step at COCA_DROP_PATH
    rates = np.linspace(0.0, COCA_DROP_PATH, COCA_LAYERS)
    for i in range(COCA_LAYERS):
        getattr(encoder, f"encoderblock_{i}").drop_path.rate = float(rates[i])
    state, meas = update(state, batch)
    drop_loss = float(meas["training_loss"])
    for i in range(COCA_LAYERS):
        getattr(encoder, f"encoderblock_{i}").drop_path.rate = 0.0
    if not np.isfinite(drop_loss):
        raise RuntimeError(f"the DropPath step's loss is {drop_loss}")

    # learning check: a fresh optimizer, const schedule, lr override
    config.schedule = [(".*", dict(decay_type="const"))]
    config.lr = COCA_LEARN_LR
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=LEARN_STEPS, batch_size=b))
    update = step.make_update_fn(model, tx, config, LEARN_STEPS)
    curve, caption = [], []
    for _ in range(LEARN_STEPS):
        state, meas = update(state, batch)
        curve.append(float(meas["training_loss"]))
        caption.append(float(meas["caption_loss"]))
    print(f"CoCa: one step at DropPath {COCA_DROP_PATH}: loss "
          f"{drop_loss:.4f}; learning check, {LEARN_STEPS} steps on one "
          f"batch, const lr {COCA_LEARN_LR}: loss {curve[0]:.4f} -> "
          f"{curve[-1]:.4f} ({' '.join(f'{x:.3f}' for x in curve)}), "
          f"caption loss {caption[0]:.4f} -> {caption[-1]:.4f}", flush=True)
    if not (np.isfinite(curve).all() and curve[-1] < LEARN_FACTOR * curve[0]
            and caption[-1] < caption[0]):
        raise RuntimeError(f"the CoCa loss did not fall: {curve} {caption}")
    out["step"] = {"launches": step_launches, "pairs_per_s": rate,
                   "peak_gb": peak_gb, "loss_rel": cmp["loss_rel"],
                   "min_cosine": cmp["min_cosine"],
                   "remat_peak_gb": remat_peaks, "drop_path_loss": drop_loss,
                   "learning": [curve[0], curve[-1]],
                   "caption_learning": [caption[0], caption[-1]]}
    del model, state, tx, update, params
    torch.cuda.empty_cache()

    # (e) the trainer from phase 15's JPEG tfrecords
    per_step, stamps = [], []
    path = os.path.join(work.name, "coca_trainer_config.py")
    with open(path, "w") as f:
        f.write(_COCA_TRAINER_CONFIG.format(
            pretrain=f"{COCA_TRAIN},data_dir={data_dir}", model=COCA_MODEL,
            steps=COCA_TRAINER_STEPS))
    argv = [f"--config={path}",
            f"--workdir={os.path.join(work.name, 'run')}", "--device=cuda"]
    torch.cuda.reset_peak_memory_stats()
    with _Patched((step, "make_update_fn", _counting(per_step, stamps))):
        t0 = time.perf_counter()
        loop.main(argv)
        run_s = time.perf_counter() - t0
    trainer_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = _rows(os.path.join(work.name, "run", "metrics.jsonl"))
    rows = [r for r in rows if "training_loss" in r]
    losses = [r["training_loss"] for r in rows]
    if [r["step"] for r in rows] != list(range(1, COCA_TRAINER_STEPS + 1)) \
            or not np.isfinite(losses).all() \
            or not all(np.isfinite(r["caption_loss"]) for r in rows):
        raise RuntimeError(f"CoCa metrics.jsonl: {rows}")
    if per_step != [COCA_LAUNCHES] * COCA_TRAINER_STEPS:
        raise RuntimeError(f"CoCa trainer steps launched {per_step}, "
                           f"expected {COCA_LAUNCHES} each")
    trainer_rate = b * (len(stamps) - 1) / (stamps[-1] - stamps[0])
    work.cleanup()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"{card}: CoCa trainer (train.loop.main, {COCA_TRAINER_STEPS} "
          f"steps from JPEG tfrecords): losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}, pairs/s over steps "
          f"2-{COCA_TRAINER_STEPS} {trainer_rate:.2f}, peak "
          f"{trainer_peak:.2f} GiB, run {run_s:.2f} s; phase 19 in "
          f"{phase_s:.2f} s", flush=True)
    out["trainer"] = {"losses": losses, "launches": per_step[0],
                      "pairs_per_s": trainer_rate, "peak_gb": trainer_peak,
                      "run_s": run_s}
    return {**out, "seconds": seconds, "n_params": n_params,
            "phase_s": phase_s,
            "launches": {"serving": serve_launches,
                         "generate": sum(gen_launches.values()),
                         "training_step": step_launches,
                         "trainer_step": per_step[0]}}


# Phase 20: the HF text towers, Swin, relpos-ViT and the timm ViT name
# table at full width, seeded weights, token ids made here (the card
# machine has no `transformers` for the HF tokenizers).
HF_SERVE_MODEL = "xlm-roberta-large-ViT-H-14"
HF_SERVE_LAYERS = 32          # the H/14 tower: L = 257, D = 1280, hd 80
HF_IMAGES, HF_TEXTS = 1024, 2048
COCA_HF_MODEL = "coca_roberta-ViT-B-32"
COCA_HF_LAYERS = 12           # ViT-B/32 @224: L = 50, D = 768, 12 heads
# the step at B = 128 on the pretrain config's optimizer, 77 ids; the ids
# stay below the decoder's 49 408 (open_clip's default vocabulary, which
# coca_roberta keeps: a RoBERTa id past it is no label)
COCA_HF_TRAIN = "img=B/32,res=224,token_len=77,batchsize=128"
COCA_HF_STEPS = 3
COCA_HF_VOCAB = 49408
# LiT: the BERT-base text tower at 64 WordPiece ids beside a B/32 image
# tower, B = 256: the fused kernels in both towers
LIT_TRAIN = ("img=B/32,res=224,token_len=64,batchsize=256,"
             "text_sampling=plain")
LIT_STEPS = 3
LIT_LAUNCHES = {(50, 768): 12, (64, 768): 12}   # (L, D): per direction
# (config, fused forwards per image chunk) served at bucket 64
OTHER_MODELS = (("roberta-ViT-B-32", 12), ("xlm-roberta-base-ViT-B-32", 12),
                ("mt5-base-ViT-B-32", 12),
                ("vit_medium_patch16_gap_256", 12),   # L = 257, D 512, H 8
                ("swin_base_patch4_window7_224", 0),  # biased einsums only
                ("vit_relpos_medium_patch16_cls_224", 0))
OTHER_IMAGES, OTHER_TEXTS, OTHER_BUCKET = 128, 256, 64


def _token_ids(name, rng, n, vocab=None):
    """(n, context) int32 ids for config `name`'s text tower: ids from 3
    up to its vocabulary (or `vocab`) and a pad tail of random length (the
    HF trunks' pad id: RoBERTa's 1, mT5's 0; 0 for the others)."""
    import numpy as np
    from clipa_tpu_torch.compat import openclip
    from clipa_tpu_torch.models import hf_text, t5_text
    t = openclip.get_model_config(name)["text_cfg"]
    ctx = t.get("context_length", 77)
    if "hf_model_name" in t:
        arch = {**hf_text.HF_ARCHS, **t5_text.T5_ARCHS}[
            t["hf_model_name"].split("/")[-1]]
        top, pad = arch["vocab_size"], arch.get("pad_id", 0)
    else:
        top, pad = t["vocab_size"], 0
    ids = rng.randint(3, vocab or top, (n, ctx))
    lengths = rng.randint(2, ctx + 1, n)
    ids[np.arange(ctx)[None] >= lengths[:, None]] = pad
    return ids.astype(np.int32)


def _cosines(a, b):
    import numpy as np
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


class _ShapeLaunches:
    """Counts the fused kernels' launches by (L, D) while it is entered:
    wraps block_attention's launch functions (the counters stay as they
    are)."""

    def __init__(self):
        from clipa_tpu_torch.ops import block_attention as ba
        self.fwd, self.bwd = {}, {}

        def counted(fn, seen, seq_arg):
            def run(*args, **kw):
                key = (args[seq_arg], args[0].shape[-1])
                seen[key] = seen.get(key, 0) + 1
                return fn(*args, **kw)
            return run

        self.patch = _Patched((ba, "_launch", counted(ba._launch, self.fwd,
                                                      4)),
                              (ba, "_launch_bwd", counted(ba._launch_bwd,
                                                          self.bwd, 5)))

    def __enter__(self):
        self.patch.__enter__()
        return self

    def __exit__(self, *exc):
        self.patch.__exit__(*exc)


def _round_trip(clip, name, folder):
    """Exports a served model and loads it back: Swin, relpos and the ViT
    configs through save_open_clip's .bin, the HF-text ones (which the
    open_clip layout cannot hold: save_open_clip refuses them) through the
    JAX-layout npz. Returns (route, tensors compared, seconds)."""
    import torch
    from clipa_tpu_torch import convert
    from clipa_tpu_torch.compat import export, openclip
    from clipa_tpu_torch.train import checkpoint
    t0 = time.perf_counter()
    if "hf_model_name" in clip.config["text_cfg"]:
        try:
            export.save_open_clip(clip, name, folder)
        except NotImplementedError:
            pass
        else:
            raise RuntimeError(f"save_open_clip wrote the HF tower of {name}")
        route, path = "npz", os.path.join(folder, "params.npz")
        os.makedirs(folder, exist_ok=True)
        checkpoint.save_params(convert.to_jax_params(clip.model), path)
    else:
        route = "open_clip .bin"
        path = os.path.join(export.save_open_clip(clip, name, folder),
                            export.WEIGHTS_FILENAME)
    precision = ("bf16" if next(clip.model.img.parameters()).dtype
                 == torch.bfloat16 else "float32")
    loaded = openclip.create_model(name, path, device="cuda",
                                   precision=precision)
    n = _bit_equal_models(clip.model, loaded.model,
                          f"{name} exported and loaded back")
    shutil.rmtree(folder)
    return route, n, time.perf_counter() - t0


def _hf_towers(card):
    """Phase 20: the HF text towers, Swin, relpos-ViT and the timm ViT name
    table at full width, seeded weights, ids made here.

    (a) ``EmbeddingService`` over HF_SERVE_MODEL in bf16 at bucket 256:
    HF_IMAGES uint8 images and HF_TEXTS id rows of 77 (``embed_tokens``;
    XLM-R ids below 250 002, pad-1 tails): shapes, finite values, unit
    norms, HF_SERVE_LAYERS fused forwards per image chunk and none in the
    pad-masked text tower, per-row image cosine >= MIN_COSINE against the
    plain path, images/s and texts/s (best of two). (b) COCA_HF_MODEL: the bf16
    model exported (npz; save_open_clip refuses its HF tower) and loaded
    back bit for bit; ``generate`` on 4 images (beam search and top-k /
    top-p), COCA_HF_LAYERS fused forwards per call; the step of
    ``make_update_fn(model_name="coca", loss="coca")`` at COCA_HF_TRAIN:
    the kernel path's loss and gradients against the plain path's
    (LOSS_RTOL, MIN_GRAD_COSINE), then COCA_HF_STEPS steps, each launching
    COCA_HF_LAYERS forwards and backwards (K5 / K6 at L = 50, D = 768).
    (c) LiT: the two-towers step at LIT_TRAIN with the BERT-base text
    tower (``proj.flaxformer.bert``) over WordPiece ids of seeded captions:
    kernel against plain path (both towers), then LIT_STEPS steps, each
    launching LIT_LAUNCHES by (L, D) in each direction: the text tower's at
    L = 64. (d) OTHER_MODELS served in bf16 at bucket OTHER_BUCKET
    (OTHER_IMAGES images, OTHER_TEXTS id rows): the fused forwards per
    image chunk and none in the (masked) text towers, cosine >= MIN_COSINE
    against the plain path, the export round trip bit for bit. (The text
    towers reach no kernel: their plain path is their path.)"""
    import numpy as np
    import torch
    from clipa_tpu_torch import optim, tokenizer
    from clipa_tpu_torch.compat import openclip
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch.ops import preprocess
    from clipa_tpu_torch.serving import EmbeddingService
    from clipa_tpu_torch.train import step

    t_phase = time.perf_counter()
    reset, read = _attention_counters()
    work = tempfile.TemporaryDirectory()
    rng = np.random.RandomState(SEED)
    out = {}
    torch.cuda.empty_cache()

    # (a) xlm-roberta-large-ViT-H-14 served at bucket 256
    t0 = time.perf_counter()
    svc = EmbeddingService(HF_SERVE_MODEL, None, device="cuda",
                           precision="bfloat16", seed=SEED, num_workers=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    size = svc.image_size
    images = rng.randint(0, 256, (HF_IMAGES, size, size, 3), np.uint8)
    ids = _token_ids(HF_SERVE_MODEL, rng, HF_TEXTS)
    chunks = len(list(svc._chunks(images)))
    reset()
    z_img = svc.embed_images(images)
    serve_launches = read()["fused_fwd"]
    z_txt = svc.embed_tokens(ids)
    if read()["fused_fwd"] != serve_launches:
        raise RuntimeError("the pad-masked XLM-R tower launched the fused "
                           "kernel")
    _check_embeddings(z_img, HF_IMAGES, svc.embed_dim, "XLM-R H/14 images")
    _check_embeddings(z_txt, HF_TEXTS, svc.embed_dim, "XLM-R texts")
    if serve_launches != HF_SERVE_LAYERS * chunks:
        raise RuntimeError(f"{HF_SERVE_MODEL} launched the fused forward "
                           f"{serve_launches} times over {chunks} chunks, "
                           f"expected {HF_SERVE_LAYERS * chunks}")
    plain = EmbeddingService(HF_SERVE_MODEL, None, device="cuda",
                             precision="bfloat16", seed=SEED, num_workers=0,
                             attn_impl="plain")
    before = read()
    serve_cos = float(_cosines(z_img[:256],
                               plain.embed_images(images[:256])).min())
    if read() != before:
        raise RuntimeError("the plain service launched a kernel")
    if serve_cos < MIN_COSINE:
        raise RuntimeError(f"{HF_SERVE_MODEL} embeddings differ from the "
                           f"plain path: cosine {serve_cos}")
    del plain
    img_rate = _rate(lambda: svc.embed_images(images), HF_IMAGES)
    txt_rate = _rate(lambda: svc.embed_tokens(ids), HF_TEXTS)
    print(f"{card}: {HF_SERVE_MODEL} (bf16, seeded, built in {build_s:.2f} "
          f"s): {chunks} image chunks, {serve_launches} fused forwards (L = "
          f"257, hd 80); per-row cosine against the plain path "
          f"{serve_cos:.6f}; images/s at bucket 256 "
          f"{img_rate:.2f}; texts/s at bucket 256 {txt_rate:.2f} "
          f"({HF_TEXTS} id rows of 77)", flush=True)
    out["serving"] = {"model": HF_SERVE_MODEL, "chunks": chunks,
                      "launches": serve_launches, "min_cosine": serve_cos,
                      "images_per_s": img_rate, "texts_per_s": txt_rate}
    del svc
    torch.cuda.empty_cache()

    # (b) coca_roberta-ViT-B-32: export and load back, captions, the step
    clip = openclip.create_model(COCA_HF_MODEL, device="cuda",
                                 precision="bf16", seed=SEED)
    route, n_tensors, trip_s = _round_trip(
        clip, COCA_HF_MODEL, os.path.join(work.name, "coca_roberta"))
    size = clip.image_size
    cap_images = preprocess.normalize_uint8(torch.from_numpy(
        rng.randint(0, 256, (COCA_CAPTION_IMAGES, size, size, 3),
                    np.uint8)).cuda())
    kinds = {"beam_search": dict(num_beams=COCA_BEAMS[0],
                                 num_beam_groups=COCA_BEAMS[1]),
             "top_k": dict(top_k=COCA_TOP_K, seed=SEED),
             "top_p": dict(top_p=COCA_TOP_P, seed=SEED)}
    caption_s, gen_launches = {}, {}
    for kind, kw in kinds.items():
        reset()
        t0 = time.perf_counter()
        caption = clip.generate(cap_images, seq_len=COCA_SEQ_LEN,
                                generation_type=kind, **kw)
        caption_s[kind] = (time.perf_counter() - t0) / len(caption)
        gen_launches[kind] = read()["fused_fwd"]
        if caption.shape[0] != COCA_CAPTION_IMAGES or \
                (caption[:, 0] != 49406).any():
            raise RuntimeError(f"{kind} captions {caption[:, :3]}")
        if kind == "beam_search" and \
                not (caption == 49407).any(axis=1).all():
            raise RuntimeError(f"beam outputs without eos: {caption}")
        if gen_launches[kind] != COCA_HF_LAYERS:
            raise RuntimeError(f"generate ({kind}) launched the fused "
                               f"forward {gen_launches[kind]} times")
    del clip
    torch.cuda.empty_cache()

    config = clipa_pretrain.get_config(COCA_HF_TRAIN)
    config.model_name, config.loss = "coca", "coca"
    config.model = dict(openclip._to_coca_cfg(openclip.get_model_config(
        COCA_HF_MODEL)), dtype="bfloat16")
    b, (_, size, _, _) = config.input.batch_size, config.init_shapes[0]
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED),
        "cuda")
    batch = {"image": torch.from_numpy(rng.randint(
                 0, 256, (b, size, size, 3), dtype=np.uint8)).cuda(),
             "labels": torch.from_numpy(_token_ids(
                 COCA_HF_MODEL, rng, b, vocab=COCA_HF_VOCAB)).cuda()}
    apply_loss = step._make_loss_dispatch("coca", config)
    loss_k, grads_k = _grads(model, state["params"], batch,
                             apply_loss=apply_loss)
    before = read()
    _set_attn_impl(model.img, "plain")
    loss_p, grads_p = _grads(model, state["params"], batch,
                             apply_loss=apply_loss)
    _set_attn_impl(model.img, "auto")
    if read() != before:
        raise RuntimeError("the plain path launched a kernel")
    cmp = _compare(loss_k, grads_k, loss_p, grads_p)
    _print_compare("coca_roberta step, kernel vs plain path", loss_k, loss_p,
                   cmp, LOSS_RTOL)
    del grads_k, grads_p
    if (cmp["loss_rel"] > LOSS_RTOL or cmp["min_cosine"] < MIN_GRAD_COSINE
            or cmp["noise"] > KEY_BIAS_NOISE):
        raise RuntimeError("the coca_roberta kernel path's step differs from "
                           "the plain path's")
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=b))
    update = step.make_update_fn(model, tx, config, config.total_steps)
    coca_steps, stamps = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(COCA_HF_STEPS):
        reset()
        state, meas = update(state, batch)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        coca_steps.append(read())
        if not all(bool(torch.isfinite(v)) for v in meas.values()):
            raise RuntimeError(f"non-finite measurements {meas}")
    want = {"flash_fwd": 0, "flash_bwd": 0, "fused_fwd": COCA_HF_LAYERS,
            "fused_bwd": COCA_HF_LAYERS}
    if coca_steps != [want] * COCA_HF_STEPS:
        raise RuntimeError(f"the coca_roberta steps launched {coca_steps}, "
                           f"expected {want} each")
    coca_rate = b * (COCA_HF_STEPS - 1) / (stamps[-1] - stamps[0])
    coca_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{card}: {COCA_HF_MODEL}: export ({route}) and load back, "
          f"{n_tensors} tensors bit for bit in {trip_s:.2f} s; seconds per "
          f"caption { {k: round(v, 4) for k, v in caption_s.items()} }, fused "
          f"forwards per call {gen_launches}; the step at B={b}: loss "
          f"{float(meas['training_loss']):.4f} (caption "
          f"{float(meas['caption_loss']):.4f}), {coca_steps[0]} per step, "
          f"pairs/s over steps 2-{COCA_HF_STEPS} {coca_rate:.2f}, peak "
          f"{coca_peak:.2f} GiB", flush=True)
    out["coca"] = {"model": COCA_HF_MODEL, "round_trip": route,
                   "tensors_bit_for_bit": n_tensors,
                   "seconds_per_caption": caption_s,
                   "generate_launches": gen_launches,
                   "step_launches": coca_steps[0], "loss_rel":
                   cmp["loss_rel"], "min_cosine": cmp["min_cosine"],
                   "pairs_per_s": coca_rate, "peak_gb": coca_peak}
    del model, state, tx, update, batch
    torch.cuda.empty_cache()

    # (c) LiT: the BERT-base text tower in a two-towers step
    config = clipa_pretrain.get_config(LIT_TRAIN)
    config.model.text_model = "proj.flaxformer.bert"
    config.model.text = {"variant": "base"}
    b, (_, size, _, _) = config.input.batch_size, config.init_shapes[0]
    (_, text_len) = config.init_shapes[1]
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED),
        "cuda")
    wordpiece = tokenizer.get_wordpiece(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data", "vocab.txt"))
    labels = np.stack([tokenizer.bert_tokenize(t, wordpiece, text_len)
                       for t in _seeded_captions(rng, b)])
    batch = {"image": torch.from_numpy(rng.randint(
                 0, 256, (b, size, size, 3), dtype=np.uint8)).cuda(),
             "labels": torch.from_numpy(labels).cuda()}
    loss_k, grads_k = _grads(model, state["params"], batch)
    before = read()
    _set_attn_impl(model, "plain")
    loss_p, grads_p = _grads(model, state["params"], batch)
    _set_attn_impl(model, "auto")
    if read() != before:
        raise RuntimeError("the plain path launched a kernel")
    lit_cmp = _compare(loss_k, grads_k, loss_p, grads_p)
    _print_compare("LiT BERT step, kernel vs plain path", loss_k, loss_p,
                   lit_cmp, LOSS_RTOL)
    del grads_k, grads_p
    if (lit_cmp["loss_rel"] > LOSS_RTOL
            or lit_cmp["min_cosine"] < MIN_GRAD_COSINE
            or lit_cmp["noise"] > KEY_BIAS_NOISE):
        raise RuntimeError("the LiT kernel path's step differs from the "
                           "plain path's")
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=config.total_steps, batch_size=b))
    update = step.make_update_fn(model, tx, config, config.total_steps)
    lit_steps, stamps = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LIT_STEPS):
        reset()
        with _ShapeLaunches() as shapes:
            state, meas = update(state, batch)
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        lit_steps.append({"fwd": shapes.fwd, "bwd": shapes.bwd,
                          "counters": read()})
        if shapes.fwd != LIT_LAUNCHES or shapes.bwd != LIT_LAUNCHES:
            raise RuntimeError(f"the LiT step launched {shapes.fwd} / "
                               f"{shapes.bwd} by (L, D), expected "
                               f"{LIT_LAUNCHES} each way")
        if not np.isfinite(float(meas["training_loss"])):
            raise RuntimeError(f"the LiT loss is {meas['training_loss']}")
    lit_rate = b * (LIT_STEPS - 1) / (stamps[-1] - stamps[0])
    lit_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{card}: LiT (BERT-base text at 64 ids, B/32 image, B={b}): "
          f"fused launches per step by (L, D) {lit_steps[0]['fwd']} forward,"
          f" {lit_steps[0]['bwd']} backward; losses "
          f"{float(meas['training_loss']):.4f}; pairs/s over steps "
          f"2-{LIT_STEPS} {lit_rate:.2f}, peak {lit_peak:.2f} GiB",
          flush=True)
    out["lit"] = {"launches_by_shape": {f"L={l} D={d}": n for (l, d), n in
                                        lit_steps[0]["fwd"].items()},
                  "step_launches": lit_steps[0]["counters"],
                  "loss_rel": lit_cmp["loss_rel"],
                  "min_cosine": lit_cmp["min_cosine"],
                  "pairs_per_s": lit_rate, "peak_gb": lit_peak}
    del model, state, tx, update, batch
    torch.cuda.empty_cache()

    # (d) the other configs at bucket 64
    others = {}
    for name, layers in OTHER_MODELS:
        t0 = time.perf_counter()
        svc, plain = (EmbeddingService(
            name, None, device="cuda", precision="bfloat16", seed=SEED,
            num_workers=0, buckets=(OTHER_BUCKET,), attn_impl=impl)
            for impl in ("auto", "plain"))
        size = svc.image_size
        images = rng.randint(0, 256, (OTHER_IMAGES, size, size, 3), np.uint8)
        ids = _token_ids(name, rng, OTHER_TEXTS)
        reset()
        z_img = svc.embed_images(images)
        launches = read()["fused_fwd"]
        z_txt = svc.embed_tokens(ids)
        text_launches = read()["fused_fwd"] - launches
        before = read()
        cos = float(_cosines(z_img, plain.embed_images(images)).min())
        if read() != before:
            raise RuntimeError(f"the plain {name} service launched a kernel")
        _check_embeddings(z_img, OTHER_IMAGES, svc.embed_dim, name)
        _check_embeddings(z_txt, OTHER_TEXTS, svc.embed_dim, name)
        chunks = OTHER_IMAGES // OTHER_BUCKET
        if launches != layers * chunks or text_launches:
            raise RuntimeError(f"{name}: {launches} fused forwards over "
                               f"{chunks} image chunks (expected "
                               f"{layers * chunks}), {text_launches} in the "
                               f"text tower (expected 0)")
        if cos < MIN_COSINE:
            raise RuntimeError(f"{name} embeddings differ from the plain "
                               f"path: cosine {cos}")
        route, n_tensors, trip_s = _round_trip(
            svc.clip, name,
            os.path.join(work.name, os.path.basename(name)))
        others[name] = {"launches": launches, "min_cosine": cos,
                        "round_trip": route, "tensors_bit_for_bit": n_tensors,
                        "seconds": time.perf_counter() - t0}
        print(f"{card}: {name} (bf16, bucket {OTHER_BUCKET}): {launches} "
              f"fused forwards over {chunks} image chunks; cosine against "
              f"the plain path min {cos:.6f}; export ({route}) and load "
              f"back, {n_tensors} tensors bit for bit in {trip_s:.2f} s; "
              f"{others[name]['seconds']:.2f} s", flush=True)
        del svc, plain
        torch.cuda.empty_cache()
    out["others"] = others
    work.cleanup()
    phase_s = time.perf_counter() - t_phase
    print(f"phase 20 in {phase_s:.2f} s", flush=True)
    return {**out, "phase_s": phase_s, "launches": {
        "serving": serve_launches,
        "generate": sum(gen_launches.values()),
        "coca_step": coca_steps[0],
        "lit_step": lit_steps[0]["counters"],
        "others": sum(o["launches"] for o in others.values())}}


# Phase 21: the conv towers at full width, seeded weights, bf16.
CONV_SERVE_MODEL = "convnext_xxlarge"
CONV_IMAGES, CONV_TEXTS = 1024, 2048
CONV_FP32_IMAGES = 64
CONV_MIN_COSINE = 0.99       # bf16 embeddings against the fp32 tower
RN_MODEL = "RN50x64"
RN_IMAGES = 512
MLP_HEAD_MODEL = "convnext_large_d"
CONV_TRAIN = "img=B/16,res=256,token_len=77,batchsize=64"
CONV_TRAIN_STEPS = 5
CONV_LR = 1e-4


def _convnext_flops(dims, depths, size):
    """Forward FLOPs of one image through the ConvNeXt trunk: the stem, the
    downsamples, and per block the 7 x 7 depthwise conv and the two
    pointwise layers (2 x HW x 8C^2, the bulk)."""
    side = -(-size // 4)
    flops = 2 * side * side * 4 * 4 * 3 * dims[0]
    for i, (c, depth) in enumerate(zip(dims, depths)):
        if i:
            side = -(-side // 2)
            flops += 2 * side * side * 2 * 2 * dims[i - 1] * c
        flops += depth * (2 * side * side * 49 * c
                          + 2 * side * side * 8 * c * c)
    return flops


def _resnet_flops(stage_blocks, width, size, out_dim):
    """Forward FLOPs of one image through the ModifiedResNet: the convs
    (2 x outputs x k^2 x C_in x C_out), the pool's projections (the query
    of one token, keys and values of all) and its attention."""
    side = (size - 1) // 2 + 1
    w = width
    flops = 2 * side * side * 9 * (3 * w // 2 + w // 2 * w // 2
                                   + w // 2 * w)
    side //= 2
    inplanes = w
    for i, (blocks, planes) in enumerate(
            zip(stage_blocks, (w, 2 * w, 4 * w, 8 * w))):
        for j in range(blocks):
            stride = 2 if (j == 0 and i > 0) else 1
            out = side // stride
            flops += 2 * side * side * (inplanes * planes + 9 * planes
                                        * planes)
            flops += 2 * out * out * planes * 4 * planes
            if stride > 1 or inplanes != 4 * planes:
                flops += 2 * out * out * inplanes * 4 * planes
            side, inplanes = out, 4 * planes
    tokens, c = side * side + 1, inplanes
    return flops + 2 * c * c * (1 + 2 * tokens) + 4 * tokens * c \
        + 2 * c * out_dim


def _conv_towers(card):
    """Phase 21: the conv towers at full width, seeded weights, bf16 (the
    docstring's list). Launches no attention kernel, and checks that."""
    import numpy as np
    import torch
    from clipa_tpu_torch import convert, optim
    from clipa_tpu_torch.compat import export, openclip
    from clipa_tpu_torch.configs import clipa_pretrain
    from clipa_tpu_torch.models import layers as layers_lib
    from clipa_tpu_torch.ops import preprocess
    from clipa_tpu_torch.serving import EmbeddingService
    from clipa_tpu_torch.train import step

    t_phase = time.perf_counter()
    reset, read = _attention_counters()
    reset()
    work = tempfile.TemporaryDirectory()
    rng = np.random.RandomState(SEED)
    out = {}
    torch.cuda.empty_cache()

    # (a) convnext_xxlarge @256 served in bf16 at bucket 256
    t0 = time.perf_counter()
    svc = EmbeddingService(CONV_SERVE_MODEL, None, device="cuda",
                           precision="bfloat16", seed=SEED, num_workers=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    size = svc.image_size
    n_img = sum(p.numel() for p in svc.clip.model.img.parameters())
    n_txt = sum(p.numel() for p in svc.clip.model.txt.parameters())
    images = rng.randint(0, 256, (CONV_IMAGES, size, size, 3), np.uint8)
    ids = _token_ids(CONV_SERVE_MODEL, rng, CONV_TEXTS)
    z_img = svc.embed_images(images)
    z_txt = svc.embed_tokens(ids)
    _check_embeddings(z_img, CONV_IMAGES, svc.embed_dim,
                      f"{CONV_SERVE_MODEL} images")
    _check_embeddings(z_txt, CONV_TEXTS, svc.embed_dim,
                      f"{CONV_SERVE_MODEL} texts")
    img_rate = _rate(lambda: svc.embed_images(images), CONV_IMAGES)
    txt_rate = _rate(lambda: svc.embed_tokens(ids), CONV_TEXTS)
    cfg = openclip.get_model_config(CONV_SERVE_MODEL)
    trunk = openclip._TIMM_CONVNEXT[cfg["vision_cfg"]["timm_model_name"]]
    flops = _convnext_flops(trunk["dims"], trunk["depths"], size)
    bound_rate = PEAK_FLOPS["bfloat16"] / flops
    fp32 = openclip.create_model(CONV_SERVE_MODEL, device="cuda",
                                 precision="float32", seed=SEED)
    with torch.inference_mode():
        ref = fp32.encode_image(preprocess.normalize_uint8(torch.from_numpy(
            images[:CONV_FP32_IMAGES]).cuda())).cpu().numpy()
    fp32_cos = float(_cosines(z_img[:CONV_FP32_IMAGES], ref).min())
    del fp32
    torch.cuda.empty_cache()
    if fp32_cos < CONV_MIN_COSINE:
        raise RuntimeError(f"{CONV_SERVE_MODEL}: bf16 embeddings against "
                           f"the fp32 tower: cosine {fp32_cos}")
    print(f"{card}: {CONV_SERVE_MODEL} @{size} (bf16, seeded, "
          f"{n_img / 1e9:.3f}B image and {n_txt / 1e9:.3f}B text "
          f"parameters, built in {build_s:.2f} s): images/s at bucket 256 "
          f"{img_rate:.2f} ({flops / 1e12:.4f} TFLOP forward per image: "
          f"{img_rate * flops / 1e12:.1f} TFLOP/s, "
          f"{100 * img_rate / bound_rate:.1f}% of the bf16 bound "
          f"{bound_rate:.0f} images/s); texts/s at bucket 256 "
          f"{txt_rate:.2f} ({CONV_TEXTS} id rows of 77); per-row cosine "
          f"against the fp32 tower on {CONV_FP32_IMAGES} images min "
          f"{fp32_cos:.6f}", flush=True)
    out["convnext_serving"] = {
        "model": CONV_SERVE_MODEL, "image_size": size,
        "image_params": n_img, "text_params": n_txt,
        "images_per_s": img_rate, "texts_per_s": txt_rate,
        "tflop_per_image": flops / 1e12, "bound_images_per_s": bound_rate,
        "min_cosine_fp32": fp32_cos}
    del svc
    torch.cuda.empty_cache()

    # (b) RN50x64 @448 with seeded statistics, and its OpenAI-layout .pt
    t0 = time.perf_counter()
    svc = EmbeddingService(RN_MODEL, None, device="cuda",
                           precision="bfloat16", seed=SEED, num_workers=0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        for m in svc.clip.model.modules():
            if isinstance(m, layers_lib.BatchNorm):
                m.mean.normal_(0.0, 0.1, generator=gen)
                m.var.uniform_(0.5, 2.0, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    size = svc.image_size
    rn_images = rng.randint(0, 256, (RN_IMAGES, size, size, 3), np.uint8)
    z_rn = svc.embed_images(rn_images)
    _check_embeddings(z_rn, RN_IMAGES, svc.embed_dim, f"{RN_MODEL} images")
    rn_rate = _rate(lambda: svc.embed_images(rn_images), RN_IMAGES)
    vcfg = openclip.get_model_config(RN_MODEL)["vision_cfg"]
    rn_flops = _resnet_flops(vcfg["layers"], vcfg["width"], size,
                             svc.embed_dim)
    rn_bound = PEAK_FLOPS["bfloat16"] / rn_flops
    stats = convert.to_jax_batch_stats(svc.clip.model)
    if any(v.dtype != torch.float32 for v in stats.values()):
        raise RuntimeError("the bf16 service rounded the statistics")
    t0 = time.perf_counter()
    sd = openclip.export_torch_state_dict(svc.clip)
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = np.asarray(
            0, np.int64)

    def stored(v):   # bf16 where the value is bf16 exactly, as served
        t = torch.from_numpy(np.asarray(v))
        if t.is_floating_point() and torch.equal(t.bfloat16().float(), t):
            return t.bfloat16()
        return t

    pt = os.path.join(work.name, "RN50x64.pt")
    torch.save({k: stored(v) for k, v in sd.items()}, pt)
    del sd
    pt_mb = os.path.getsize(pt) / 2 ** 20
    openai = openclip.load_openai_model(pt, precision="bf16", device="cuda")
    n_openai = _bit_equal_models(svc.clip.model.img, openai.model.img,
                                 f"{RN_MODEL} through load_openai_model")
    chunk = rn_images[:256]
    want = svc.embed_images(chunk)
    svc.clip, kept = openai, svc.clip
    got = svc.embed_images(chunk)
    if not np.array_equal(got, want):
        raise RuntimeError(f"{RN_MODEL}: load_openai_model's embeddings "
                           f"differ, max {np.abs(got - want).max()}")
    del openai
    svc.clip = openclip.create_model(RN_MODEL, pt, precision="bf16",
                                     device="cuda")
    n_bin = _bit_equal_models(kept.model, svc.clip.model,
                              f"{RN_MODEL} through create_model(<.pt>)")
    got = svc.embed_images(chunk)
    if not np.array_equal(got, want):
        raise RuntimeError(f"{RN_MODEL}: create_model(<.pt>)'s embeddings "
                           f"differ, max {np.abs(got - want).max()}")
    trip_s = time.perf_counter() - t0
    print(f"{card}: {RN_MODEL} @{size} (bf16, seeded weights and "
          f"statistics, built in {build_s:.2f} s): images/s at bucket 256 "
          f"{rn_rate:.2f} ({rn_flops / 1e12:.4f} TFLOP forward per image: "
          f"{rn_rate * rn_flops / 1e12:.1f} TFLOP/s, "
          f"{100 * rn_rate / rn_bound:.1f}% of the bf16 bound "
          f"{rn_bound:.0f} images/s); {len(stats)} statistics fp32; "
          f"OpenAI-layout .pt "
          f"({pt_mb:.0f} MiB) through load_openai_model ({n_openai} image "
          f"tensors) and create_model ({n_bin} tensors), bit for bit, "
          f"embeddings bit for bit, in {trip_s:.2f} s", flush=True)
    out["resnet_serving"] = {
        "model": RN_MODEL, "image_size": size, "images_per_s": rn_rate,
        "tflop_per_image": rn_flops / 1e12, "bound_images_per_s": rn_bound,
        "statistics": len(stats), "openai_pt_mib": pt_mb,
        "tensors_bit_for_bit": n_bin, "round_trip_s": trip_s}
    del svc, kept, stats
    os.remove(pt)
    torch.cuda.empty_cache()

    # (c) convnext_large_d's mlp head through save_open_clip and back
    clip = openclip.create_model(MLP_HEAD_MODEL, device="cuda",
                                 precision="bf16", seed=SEED)
    if clip.model.img.head_mlp_fc is None:
        raise RuntimeError(f"{MLP_HEAD_MODEL} has no mlp head")
    route, n_mlp, mlp_s = _round_trip(clip, MLP_HEAD_MODEL, os.path.join(
        work.name, os.path.basename(MLP_HEAD_MODEL)))
    print(f"{card}: {MLP_HEAD_MODEL} (mlp head): export ({route}) and load "
          f"back, {n_mlp} tensors bit for bit in {mlp_s:.2f} s", flush=True)
    out["mlp_head_round_trip"] = {"model": MLP_HEAD_MODEL, "route": route,
                                  "tensors_bit_for_bit": n_mlp}
    del clip
    torch.cuda.empty_cache()

    # (d) the training step at convnext_xxlarge @256, B = 64
    config = clipa_pretrain.get_config(CONV_TRAIN)
    config.model = dict(openclip._to_two_towers_cfg(openclip.get_model_config(
        CONV_SERVE_MODEL)), dtype="bfloat16")
    config.schedule = [(".*", dict(decay_type="const"))]
    config.lr = CONV_LR
    b, (_, size, _, _) = config.input.batch_size, config.init_shapes[0]
    model = step.create_model(config, device="cuda")
    state = step.init_train_state(
        model, config, torch.Generator(device="cuda").manual_seed(SEED),
        "cuda")
    batch = {"image": torch.from_numpy(rng.randint(
                 0, 256, (b, size, size, 3), dtype=np.uint8)).cuda(),
             "labels": torch.from_numpy(_token_ids(
                 CONV_SERVE_MODEL, rng, b)).cuda()}
    tx, _ = optim.make(config, model, sched_kw=dict(
        total_steps=CONV_TRAIN_STEPS, batch_size=b))
    update = step.make_update_fn(model, tx, config, CONV_TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    losses, stamps = [], [time.perf_counter()]
    for _ in range(CONV_TRAIN_STEPS):
        state, meas = update(state, batch)
        losses.append(float(meas["training_loss"]))
        stamps.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = max(2 * b / (stamps[i + 2] - stamps[i]) for i in (1, 3))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError(f"the {CONV_SERVE_MODEL} step's loss does not "
                           f"fall: {losses}")
    print(f"{card}: the step at {CONV_SERVE_MODEL} @{size} (bf16 compute, "
          f"fp32 masters, B={b}, 77 ids, DropPath 0.1, no remat, const lr "
          f"{CONV_LR}): losses {' '.join(f'{x:.4f}' for x in losses)}; "
          f"pairs/s (best of two 2-step windows) {rate:.2f}; peak "
          f"{peak:.2f} GiB", flush=True)
    out["convnext_step"] = {"config": CONV_TRAIN, "batch": b,
                            "losses": losses, "pairs_per_s": rate,
                            "peak_gb": peak}
    del model, state, tx, update, batch
    torch.cuda.empty_cache()
    work.cleanup()

    launches = read()
    if any(launches.values()):
        raise RuntimeError(f"the conv towers launched attention kernels: "
                           f"{launches}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 21 in {phase_s:.2f} s (attention kernel launches "
          f"{launches})", flush=True)
    return {**out, "phase_s": phase_s, "launches": launches}


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
    from clipa_tpu_torch import native
    from clipa_tpu_torch.ops import block_attention as ba, cuda_build
    from clipa_tpu_torch.ops import flash_attention as fa
    from clipa_tpu_torch.ops import patch_embed as pe
    from clipa_tpu_torch.serving import EmbeddingService

    card = _card()
    print(card)
    import fsspec
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} fsspec {fsspec.__version__} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build: one nvcc per source and g++ for the native host library,
    # started together
    sources = {"fused_attention_fwd.cu": ba.fwd_library,
               "fused_attention_bwd.cu": ba.bwd_library,
               "flash_attention_fwd.cu": fa.fwd_library,
               "flash_attention_bwd.cu": fa.bwd_library,
               "patch_embed.cu": pe.library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(native.load)
        for f in [pool.submit(load) for load in sources.values()]:
            f.result()
        host.result()
    print(f"native host library built from clipa_tpu_torch/native/src in "
          f"{native.build_seconds:.2f} s -> {native.library_path()}; "
          f"{native.SYSTEM_HEADER} exists: "
          f"{os.path.exists(native.SYSTEM_HEADER)}; libjpeg: "
          f"{native.jpeg_route()}", flush=True)
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
    model, state, config = _transition(train.pop("model"))
    tune = _finetune(card, model, state, config)
    del model, state
    torch.cuda.empty_cache()

    # 9. the patch embed, 10. the attention sweep, 11. the tools
    patch = _patch_embed(gen)
    sweep = _sweep()
    tools = _tools()

    # 12. the H/14 unmask-tuning steps at 224 and 336 px
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    h14 = _finetune_h14(card, FINETUNE_H14)
    torch.cuda.empty_cache()
    h14_336 = _finetune_h14(card, FINETUNE_H14_336)
    torch.cuda.empty_cache()
    print(f"phase 12 in {time.perf_counter() - t0:.2f} s", flush=True)

    # 13. the trainer from the data pipeline (its params.npz kept for 16)
    keep = tempfile.TemporaryDirectory()
    trainer = _trainer(card, train["pairs_per_s"]["kernel"], keep.name)

    # 14. the trainer with CLIPA's evals, eval_only, tools/eval_zeroshot
    evals = _evals(card, trainer["losses"])

    # 15. the trainer from JPEG tfrecords at B = 1536 (4 x 384), the native
    # host library, the pipeline by route, the chunked and sigmoid losses
    # (the shards kept for 16)
    jpeg = _jpeg_trainer(card, trainer, keep.name)

    # 16. CLIPA-v2's 224 -> 336 unmask-tuning chain through the trainer on
    # file:// workdirs
    chain = _unmask_chain(card, os.path.join(keep.name, "params.npz"),
                          os.path.join(keep.name, "laion"))

    # 17. distillation from a frozen H/14 teacher, and lwd, in the trainer
    distill = _distill(card)

    # 18. open_clip interop: CLIPA-v1's L/16 and open_clip's L/14 exported,
    # loaded back and served behind one MultiModelService
    interop = _interop(card)

    # 19. CoCa: export and load back, serve, caption, train, the trainer
    # (from phase 15's shards)
    coca = _coca(card, os.path.join(keep.name, "laion"))
    keep.cleanup()

    # 20. the HF text towers, Swin, relpos-ViT and the timm ViT table
    hf = _hf_towers(card)

    # 21. the conv towers: ConvNeXt and the ModifiedResNet
    conv = _conv_towers(card)

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
    }, "finetune_h14_336": {
        "config": f"clipa_tpu_torch/configs/clipa_finetune.py:"
                  f"{FINETUNE_H14_336}",
        "image_attn_impl": "auto",
        **{k: h14_336[k] for k in ("tokens", "launches", "pairs_per_s",
                                   "peak_gb", "loss_rel", "min_cosine",
                                   "plan")},
    }, "trainer": {
        "config": f"clipa_tpu_torch/configs/clipa_pretrain.py:{PRETRAIN}",
        "source": "synthetic, 144 px uint8, 16 captions",
        **{k: v for k, v in trainer.items() if k != "losses"},
    }, "evals": {
        "config": f"clipa_tpu_torch/configs/clipa_pretrain.py:{PRETRAIN},"
                  "data_dir=<tfrecords>",
        "tool_model": MODEL, **evals,
    }, "trainer_jpeg": {
        "config": f"clipa_tpu_torch/configs/clipa_pretrain.py:"
                  f"{ACCUM_PRETRAIN},data_dir=<JPEG tfrecords> "
                  f"--config.grad_accum_steps={ACCUM_STEPS}",
        "source": f"{JPEG_IMAGES} JPEGs of {JPEG_SIZE} px, random pixels",
        **{k: v for k, v in jpeg.items() if k != "losses"},
    }, "unmask_chain": {
        "configs": [f"clipa_tpu_torch/configs/clipa_finetune.py:{spec}"
                    for spec in (CHAIN_224, CHAIN_336)],
        "source": "phase 15's JPEG tfrecords; file:// workdirs", **chain,
    }, "distill": {
        "config": f"clipa_tpu_torch/configs/clipa_pretrain.py:{PRETRAIN} "
                  f"--config.lwd={DISTILL_LWD}",
        "teacher": f"clipa_tpu_torch/configs/clipa_pretrain.py:"
                   f"{DISTILL_TEACHER} (model)", **distill,
    }, "interop": {
        "configs": list(INTEROP_MODELS), "openai_config": OPENAI_CONFIG,
        "bpe_merges": BPE_MERGES, **interop,
    }, "coca": {
        "model": COCA_MODEL,
        "train_config": f"clipa_tpu_torch/configs/clipa_pretrain.py:"
                        f"{COCA_TRAIN} (model_name=coca, loss=coca)",
        **coca,
    }, "hf_towers": {
        "lit_config": f"clipa_tpu_torch/configs/clipa_pretrain.py:"
                      f"{LIT_TRAIN} (text_model=proj.flaxformer.bert)",
        "coca_train_config": f"clipa_tpu_torch/configs/clipa_pretrain.py:"
                             f"{COCA_HF_TRAIN} (model_name=coca, loss=coca)",
        **hf,
    }, "conv_towers": {
        "configs": [CONV_SERVE_MODEL, RN_MODEL, MLP_HEAD_MODEL],
        "train_config": f"clipa_tpu_torch/configs/clipa_pretrain.py:"
                        f"{CONV_TRAIN} (model of {CONV_SERVE_MODEL}, const "
                        f"lr {CONV_LR})",
        **conv,
    }}))
    print(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "clipa_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "clipa_tpu/ops/block_attention.py:165",
        "launches": (launches + train["launches"]["fwd"]
                     + evals["zeroshot_launches"]["fused_fwd"]
                     + evals["tool_launches"]["fused_fwd"]
                     + chain["launches"]["fused_fwd"]
                     + distill["launches"]["fused_fwd"]
                     + interop["launches"]
                     + coca["launches"]["serving"]
                     + coca["launches"]["generate"]
                     + coca["launches"]["training_step"]["fused_fwd"]
                     + coca["launches"]["trainer_step"]["fused_fwd"]
                     + hf["launches"]["serving"]
                     + hf["launches"]["generate"]
                     + hf["launches"]["coca_step"]["fused_fwd"]
                     + hf["launches"]["lit_step"]["fused_fwd"]
                     + hf["launches"]["others"]),
        "launches_by_path": {
            "serving": launches, "training_step": train["launches"]["fwd"],
            "finetune_step_auto": tune["auto_launches"]["fused_fwd"],
            "finetune_h14_step": h14["launches"]["fused_fwd"],
            "finetune_h14_336_step": h14_336["launches"]["fused_fwd"],
            "trainer_step": trainer["launches"]["fused_fwd"],
            "trainer_accumulated_step": jpeg["launches"]["fused_fwd"],
            "unmask_chain_trainer_step": chain["launches"]["fused_fwd"],
            "distilled_trainer_step": distill["launches"]["fused_fwd"],
            "zeroshot_eval": evals["zeroshot_launches"]["fused_fwd"],
            "eval_zeroshot_tool": evals["tool_launches"]["fused_fwd"],
            **{f"interop_serving {name}": m["launches"]
               for name, m in interop["models"].items()},
            "coca_serving": coca["launches"]["serving"],
            "coca_generate": coca["launches"]["generate"],
            "coca_training_step":
                coca["launches"]["training_step"]["fused_fwd"],
            "coca_trainer_step":
                coca["launches"]["trainer_step"]["fused_fwd"],
            f"hf_serving {HF_SERVE_MODEL}": hf["launches"]["serving"],
            "coca_roberta_generate": hf["launches"]["generate"],
            "coca_roberta_training_step":
                hf["launches"]["coca_step"]["fused_fwd"],
            "lit_bert_training_step":
                hf["launches"]["lit_step"]["fused_fwd"],
            "bucket_64_serving (vit_medium)": hf["launches"]["others"]},
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
        "launches": (train["launches"]["bwd"]
                     + chain["launches"]["fused_bwd"]
                     + distill["launches"]["fused_bwd"]
                     + coca["launches"]["training_step"]["fused_bwd"]
                     + coca["launches"]["trainer_step"]["fused_bwd"]
                     + hf["launches"]["coca_step"]["fused_bwd"]
                     + hf["launches"]["lit_step"]["fused_bwd"]),
        "launches_by_path": {
            "training_step": train["launches"]["bwd"],
            "finetune_step_auto": tune["auto_launches"]["fused_bwd"],
            "finetune_h14_step": h14["launches"]["fused_bwd"],
            "finetune_h14_336_step": h14_336["launches"]["fused_bwd"],
            "trainer_step": trainer["launches"]["fused_bwd"],
            "trainer_accumulated_step": jpeg["launches"]["fused_bwd"],
            "unmask_chain_trainer_step": chain["launches"]["fused_bwd"],
            "distilled_trainer_step": distill["launches"]["fused_bwd"],
            "coca_training_step":
                coca["launches"]["training_step"]["fused_bwd"],
            "coca_trainer_step":
                coca["launches"]["trainer_step"]["fused_bwd"],
            "coca_roberta_training_step":
                hf["launches"]["coca_step"]["fused_bwd"],
            "lit_bert_training_step":
                hf["launches"]["lit_step"]["fused_bwd"]},
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
        # SDPA at the sweep's shape in the exact form without biases (the
        # sweep's exact variants compute it with them)
        "sdpa_exact_ms": {
            "fwd": by_shape["L/16 @112 exact"]["library_ms"],
            "bwd": bwd_by_shape["L/16 @112 exact"]["library_ms"]},
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
