"""Faults planted in the program's timed path, each of which `correct`
must refuse: the readings the limits are set against (``readings.py``)
and the CPU tests use the same ones. Each is a context manager that
patches the program's module while it is open."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def unchanged():
    """A training step that returns its state unchanged: the optimizer's
    update is computed and never applied."""
    from clipa_tpu_torch import optim
    return _patched(optim.Optimizer, "apply", lambda self, updates: None)


def half_batch():
    """Half of each training batch left out: the step takes the mean over
    the other half."""
    from clipa_tpu_torch.train import step
    make = step.make_update_fn

    def made(*args, **kwargs):
        update = make(*args, **kwargs)

        def broken(state, batch):
            n = batch["image"].shape[0] // 2
            return update(state, {k: v[:n] for k, v in batch.items()})
        return broken
    return _patched(step, "make_update_fn", made)


def _served(transform):
    from clipa_tpu_torch.serving import EmbeddingService
    embed = EmbeddingService.__dict__["_embed_images"].__func__
    return _patched(EmbeddingService, "_embed_images", staticmethod(
        lambda model, images: transform(embed, model, images)))


def answer_altered():
    """A quarter of the served embeddings altered where they are made
    (each such row's components rotated by one)."""
    def transform(embed, model, images):
        z = embed(model, images).clone()
        z[::4] = z[::4].roll(1, dims=1)
        return z
    return _served(transform)


def half_served():
    """Half of each served chunk left out: its rows come back as zeros."""
    def transform(embed, model, images):
        z = embed(model, images[:images.shape[0] // 2])
        return torch.cat([z, torch.zeros_like(z)])
    return _served(transform)


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
EMBED = {"answer_altered": answer_altered, "half_batch": half_served}
