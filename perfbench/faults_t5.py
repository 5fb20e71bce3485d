"""Faults of the mT5 text tower's timed path, beside ``faults.py``'s
(which it uses as they are): :data:`TRAIN` is theirs plus
``rmsnorm_bf16``, the T5 RMSNorms computed in bf16 where the program
computes them in float32."""

from __future__ import annotations

import torch

from perfbench import faults


def rmsnorm_bf16():
    """Every RMSNorm of ``models/t5_text.py`` computed in bf16: the mean of
    squares, its reciprocal root and the gain, each rounded to bf16."""
    from clipa_tpu_torch.models import t5_text

    def forward(self, x):
        y = x.to(torch.bfloat16)
        y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.to(torch.bfloat16)).to(self.dtype or x.dtype)
    return faults._patched(t5_text.RMSNorm, "forward", forward)


TRAIN = {**faults.TRAIN, "rmsnorm_bf16": rmsnorm_bf16}
