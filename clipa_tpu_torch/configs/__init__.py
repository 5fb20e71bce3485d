"""CLIPA experiment configs of the port: copies of ``clipa_tpu/configs``
that build on :mod:`clipa_tpu_torch.config`."""
