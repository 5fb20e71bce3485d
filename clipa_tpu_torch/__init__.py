"""clipa_tpu_torch: CLIPA in PyTorch on an NVIDIA GPU.

A port of ``clipa_tpu`` (JAX, TPU), which stays in the repository as the
reference: the embedding service, the CLIPA pre-training and
unmask-tuning steps, and the trainer entry point (``python -m
clipa_tpu_torch.train``: data sources, host pp ops, the input pipeline,
metrics and resumable checkpoints). Modules keep the JAX package's names,
so each one's counterpart is at the same path under ``clipa_tpu/``. The
attention cores run hand-written CUDA kernels (``csrc/``, built at first
use); everything else is plain PyTorch and numpy. The port imports nothing
of ``clipa_tpu``: what it needs of the JAX package's host-only modules
(the config system and the experiment configs, the WordPiece tokenizer,
the open_clip model JSON files, the pp ops and data sources, the prompt
data) it keeps as its own copy. A few modules are the port's own, with no
counterpart under ``clipa_tpu/``: ``ops/cuda_build.py`` (the kernels'
build) and ``tracing.py`` (named host spans of the training step, the
optimizer and the embedding service, on the profiler's clock).
"""
