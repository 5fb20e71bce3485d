"""The benchmark of clipa_tpu_torch on the H100 (see README.md)."""
