"""clipa_tpu_torch: CLIPA in PyTorch on an NVIDIA GPU.

A port of ``clipa_tpu`` (JAX, TPU), which stays in the repository as the
reference: the embedding service, the CLIPA pre-training step and the
unmask-tuning step. Modules keep the JAX package's names, so each one's
counterpart is at the same path under ``clipa_tpu/``. The attention cores
run hand-written CUDA kernels (``csrc/``, built at first use); everything
else is plain PyTorch. The port imports nothing of ``clipa_tpu``: what it
needs of the JAX package's host-only modules (the config system and the
experiment configs, the WordPiece tokenizer, the open_clip model JSON
files) it keeps as its own copy (``config.py``, ``configs/``,
``tokenizer.py``, ``compat/model_configs/``).
"""
