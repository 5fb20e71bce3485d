"""Weights and inputs from the seed, made on the device in a few large calls.

The same seed gives the same tensors on every run, so the program and the
reference get identical weights and inputs, and the reference can make them
again after the program's state is freed. Scales follow the towers' own
initializers (fan-in for matrices), with non-zero biases and LayerNorm
gains away from 1, so that a kernel that drops a bias or a gain is seen.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# stream tags: one seed, independent streams for each kind of tensor
WEIGHTS, IMAGES, LABELS, SAMPLE = 1, 2, 3, 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on `device` for (`seed`, `stream`); any whole
    seed, negative or past 64 bits included."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    value = int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(value)


def _std(kind: str, fan_in) -> float:
    if fan_in:
        return fan_in ** -0.5
    return {"scale": 0.05, "bias": 0.02, "cls": 0.02, "posemb": 0.02,
            "embed": 0.02}[kind]


def make(specs: list, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} for `specs` (``reference.clip.param_specs``): one
    normal draw over every element, scaled per tensor. LayerNorm gains are
    1 + 0.05 n; the log temperature is log(1 / 0.07), CLIP's init."""
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS,
                                                       device),
                       device=device, dtype=torch.float32)
    out = {}
    for (name, shape, kind, fan_in), part in zip(specs,
                                                 torch.split(flat, sizes)):
        if kind == "t":
            x = torch.full(shape, math.log(1 / 0.07), device=device)
        else:
            x = part.view(shape) * _std(kind, fan_in)
            if kind == "scale":
                x = x + 1.0
        out[name] = x.to(dtype)
    return out


def images(n: int, size: int, seed: int, device) -> torch.Tensor:
    """(n, size, size, 3) uint8 images, uniform noise."""
    return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8,
                         generator=generator(seed, IMAGES, device),
                         device=device)


def labels(n: int, length: int, vocab: int, seed: int,
           device) -> torch.Tensor:
    """(n, length) int32 token ids in [1, vocab): no padding id."""
    return torch.randint(1, vocab, (n, length), dtype=torch.int32,
                         generator=generator(seed, LABELS, device),
                         device=device)


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """`k` distinct indices of range(n), drawn from the seed, sorted."""
    rng = np.random.default_rng([abs(int(seed)), int(seed < 0), SAMPLE])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def copy_into(params: dict, made: dict) -> None:
    """Copies `made` into the program's parameters `params` (by name); the
    two must hold the same names and shapes."""
    if set(params) != set(made):
        raise ValueError(f"the program's parameters and the reference's "
                         f"differ: {sorted(set(params) ^ set(made))[:8]}")
    with torch.no_grad():
        for name, x in made.items():
            if tuple(params[name].shape) != tuple(x.shape):
                raise ValueError(f"{name}: the program holds "
                                 f"{tuple(params[name].shape)}, the "
                                 f"reference {tuple(x.shape)}")
            params[name].copy_(x)
