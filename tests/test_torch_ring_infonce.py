"""The port's ring losses against ``clipa_tpu.ops.ring_infonce``.

The JAX rings run under ``shard_map`` on conftest's 4 virtual CPU devices
(the ``mesh8`` fixture's batch sharding); the port's on 4 spawned gloo
processes (``tests/torch_dist_ranks.py``), each with its 8 rows of the
same seeded (32, 16) unit-norm embeddings, the temperature 1 / 0.07 and,
for the sigmoid ring, the bias -10 as a tensor. The JAX loss is the mean
over the devices of their rows' means; the port's process returns its
rows' mean and, from its backward, the gradients of the sum of every
process's loss for its rows (and its partial sums for ``t`` and
``bias``). So: the mean of the 4 values equals the JAX value, and the
gradients over 4 equal the JAX gradients of zimg, ztxt, t and bias, rtol
1e-5 (atol 1e-7 for the entries near 0). The JAX ring's ``ncorrect`` is
``pos >= img_max``, where both sides of a row whose positive is its largest
logit are the same number rounded two ways: such rows count or not by
rounding, in either package, so the two agree up to the count of those
rows. With one process (no group) the ring is one hop and equals the
global losses of ``clipa_tpu_torch.losses`` (rtol 1e-5, atol 1e-6 on
gradients of about 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from clipa_tpu.ops import ring_infonce as jax_ring
from clipa_tpu.parallel import batch_sharding
from clipa_tpu_torch import losses
from clipa_tpu_torch.ops import ring_infonce

B, C = 32, 16
T = np.asarray([1 / 0.07], np.float32)
BIAS = np.asarray(-10.0, np.float32)


def _embeddings(seed=0):
    rng = np.random.RandomState(seed)
    zi = rng.randn(B, C).astype(np.float32)
    zt = rng.randn(B, C).astype(np.float32)
    # pair every text with its image, loosely: about half the positives win
    # their row
    zt = zt + 0.5 * zi
    zi /= np.linalg.norm(zi, axis=-1, keepdims=True)
    zt /= np.linalg.norm(zt, axis=-1, keepdims=True)
    return zi, zt


def _jax_ring(mesh8, zi, zt):
    sh = batch_sharding(mesh8)
    args = (jax.device_put(jnp.asarray(zi), sh),
            jax.device_put(jnp.asarray(zt), sh), jnp.asarray(T))
    out = {}

    def softmax(zi, zt, t):
        return jax_ring.ring_contrastive_loss(zi, zt, t, mesh8)

    value, extras = jax.jit(softmax)(*args)
    grads = jax.jit(jax.grad(lambda *a: softmax(*a)[0],
                             argnums=(0, 1, 2)))(*args)
    out["ring"] = (float(value), float(extras["ncorrect"]), grads, None)

    def sigmoid(zi, zt, t, bias):
        return jax_ring.ring_sigmoid_contrastive_loss(zi, zt, t, mesh8,
                                                      bias=bias)[0]

    value = jax.jit(sigmoid)(*args, jnp.asarray(BIAS))
    *grads, g_bias = jax.jit(jax.grad(sigmoid, argnums=(0, 1, 2, 3)))(
        *args, jnp.asarray(BIAS))
    out["ring_sigmoid"] = (float(value), None, grads, g_bias)
    return out


@pytest.fixture(scope="module")
def both(mesh8, tmp_path_factory):
    assert mesh8.devices.size == 4
    zi, zt = _embeddings()
    port = ranks.run_ranks(ranks.ring_case, 4, tmp_path_factory.mktemp("r"),
                           zi, zt, T, BIAS)
    return _jax_ring(mesh8, zi, zt), port


@pytest.mark.parametrize("name", ["ring", "ring_sigmoid"])
def test_ring_matches_jax_on_four_processes(both, name):
    jax_out, port = both
    value, ncorrect, (g_zi, g_zt, g_t), g_bias = jax_out[name]
    got = [r[name] for r in port]
    np.testing.assert_allclose(np.mean([r["loss"] for r in got]), value,
                               rtol=1e-5)
    if ncorrect is not None:
        # pos >= img_max: a row whose positive is its largest logit counts
        # only where the two roundings of that logit compare >= (in either
        # package); the rows whose positive is beaten count in neither
        zi, zt = _embeddings()
        logits = (zi @ zt.T).astype(np.float64)
        ties = int(np.sum(np.diag(logits) >= logits.max(axis=1) - 1e-5))
        assert 0 < ties < B
        port = np.mean([r["ncorrect"] for r in got])
        assert abs(port - ncorrect) <= ties / B
        assert max(port, ncorrect) <= ties / B
    n = len(got)
    for key, want in (("zimg", g_zi), ("ztxt", g_zt)):
        np.testing.assert_allclose(
            np.concatenate([r[key] for r in got]) / n, np.asarray(want),
            rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(sum(r["t"] for r in got) / n,
                               np.asarray(g_t), rtol=1e-5)
    if g_bias is not None:
        np.testing.assert_allclose(sum(r["bias"] for r in got) / n,
                                   np.asarray(g_bias), rtol=1e-5)


def test_one_process_ring_is_the_global_loss():
    """No process group: one hop, no sends; values and gradients equal the
    global softmax and sigmoid losses (rtol 1e-5)."""
    zi, zt = _embeddings(1)

    def run(fn):
        args = [torch.tensor(x, requires_grad=True) for x in (zi, zt, T)]
        bias = torch.tensor(BIAS, requires_grad=True)
        value = fn(*args, bias)
        value.backward()
        return [float(value.detach())] + [a.grad.numpy()
                                          for a in args + [bias]]

    pairs = [
        (lambda zi, zt, t, b: ring_infonce.ring_contrastive_loss(
            zi, zt, t)[0] + 0 * b,
         lambda zi, zt, t, b: losses.bidirectional_contrastive_loss(
             zi, zt, t, reduction=True)[0] + 0 * b),
        (lambda zi, zt, t, b: ring_infonce.ring_sigmoid_contrastive_loss(
            zi, zt, t, bias=b)[0],
         lambda zi, zt, t, b: losses.sigmoid_contrastive_loss(
             zi, zt, t, bias=b)[0]),
    ]
    for ring, ref in pairs:
        for got, want in zip(run(ring), run(ref)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_alone_ignores_the_process_group(monkeypatch):
    """``group=ALONE`` (the step of one process's whole batch) runs one hop
    whatever group exists: no send is attempted."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(ring_infonce, "_shift", None)   # a send would fail
    zi, zt = (torch.tensor(x) for x in _embeddings(2))
    got = ring_infonce.ring_contrastive_loss(zi, zt, torch.tensor(T),
                                             group=ring_infonce.ALONE)[0]
    want = losses.bidirectional_contrastive_loss(zi, zt, torch.tensor(T),
                                                 reduction=True)[0]
    assert float(got) == pytest.approx(float(want), rel=1e-5)
