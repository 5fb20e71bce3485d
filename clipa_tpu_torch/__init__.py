"""clipa_tpu_torch: the CLIPA embedding service in PyTorch on an NVIDIA GPU.

A port of ``clipa_tpu`` (JAX, TPU), which stays in the repository as the
reference. Modules keep the JAX package's names, so each one's counterpart
is at the same path under ``clipa_tpu/``. The attention core runs a
hand-written CUDA kernel (``csrc/``, built at first use); everything else is
plain PyTorch. Host-only modules of ``clipa_tpu`` that import no JAX (the
WordPiece tokenizer, ``registry``, ``pathio``) are reused as they are.
"""
