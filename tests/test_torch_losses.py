"""The port's pre-training losses against clipa_tpu on the same inputs.

  * ``ops/infonce.chunked_contrastive_loss`` (a ``torch.autograd.Function``
    whose backward walks the chunks again) against the JAX custom VJP
    (``clipa_tpu/ops/infonce.py``) and against the port's own
    ``losses.bidirectional_contrastive_loss``: the loss, ncorrect and the
    gradients of zimg, ztxt and t, with chunks that divide the batch and
    chunks that do not (the largest divisor below them is taken, as in the
    JAX op), and the refusal of a batch with no divisor near the chunk;
  * ``losses.sigmoid_contrastive_loss`` against the JAX loss, with a bias
    of 0, a learned ``b`` (``bias_init`` -10, as SigLIP) and per-row values;
  * the two-towers ``b`` parameter: its init, its npz name both ways.

Inputs are seeded numpy, L2-normalized, in fp32; JAX runs under
``default_matmul_precision("highest")``. Tolerances: values rtol 1e-5 and
gradients 1e-5 of each gradient's largest element (fp32 sums over B = 24
rows in another order), at least a tenth of t / B (see _close_grads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu import losses as jax_losses
from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu.ops import infonce as jax_infonce
from clipa_tpu_torch import convert, losses
from clipa_tpu_torch.models import layers, two_towers
from clipa_tpu_torch.ops import infonce

B, C = 24, 16
RTOL = 1e-5


def _inputs(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    zi = rng.normal(size=(B, C)).astype(np.float32)
    zt = (zi + rng.normal(scale=scale, size=(B, C))).astype(np.float32)
    zi /= np.linalg.norm(zi, axis=1, keepdims=True)
    zt /= np.linalg.norm(zt, axis=1, keepdims=True)
    return zi, zt, np.float32(np.exp(2.3))


def _torch_grads(fn, zi, zt, t, **kw):
    a, b = (torch.tensor(x, requires_grad=True) for x in (zi, zt))
    tt = torch.tensor([t], requires_grad=True)
    loss, extras = fn(a, b, tt, **kw)
    loss.backward()
    return (float(loss.detach()), {k: float(v) for k, v in extras.items()},
            (a.grad.numpy(), b.grad.numpy(), tt.grad.numpy().reshape(())))


def _jax_grads(fn, zi, zt, t, **kw):
    def f(a, b, tt):
        loss, extras = fn(a, b, tt, **kw)
        return loss, extras
    with jax.default_matmul_precision("highest"):
        (loss, extras), grads = jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(zi), jnp.asarray(zt), jnp.asarray([t]))
    return (float(loss), {k: float(v) for k, v in extras.items()},
            tuple(np.asarray(g).reshape(np.shape(r)) for g, r in
                  zip(grads, (zi, zt, np.float32(0)))))


def _close_grads(ours, ref, t):
    """Each gradient within RTOL of its largest element, or of a tenth of
    t / B, the scale of the terms that cancel in it (t / B times unit
    vectors, or their dot products) where each row's softmax is nearly
    one-hot."""
    for g, r in zip(ours, ref):
        atol = RTOL * max(np.abs(r).max(), 0.1 * t / B)
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)


@pytest.mark.parametrize("chunk", [24, 8, 6, 5, 7])
def test_chunked_loss_matches_the_jax_custom_vjp(chunk):
    """5 and 7 do not divide 24: both take the largest divisor below (4, 6);
    every chunk gives the full loss."""
    zi, zt, t = _inputs()
    loss, extras, grads = _torch_grads(infonce.chunked_contrastive_loss,
                                       zi, zt, t, chunk_size=chunk)
    jloss, jextras, jgrads = _jax_grads(jax_infonce.chunked_contrastive_loss,
                                        zi, zt, t, chunk_size=chunk)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    assert extras == jextras
    _close_grads(grads, jgrads, t)


@pytest.mark.parametrize("chunk", [24, 6, 5])
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 0.1), (2, 3.0)])
def test_chunked_loss_equals_the_full_softmax_loss(chunk, seed, scale):
    zi, zt, t = _inputs(seed, scale)
    loss, extras, grads = _torch_grads(infonce.chunked_contrastive_loss,
                                       zi, zt, t, chunk_size=chunk)
    full, fextras, fgrads = _torch_grads(
        losses.bidirectional_contrastive_loss, zi, zt, t, reduction=True)
    np.testing.assert_allclose(loss, full, rtol=RTOL)
    assert extras["ncorrect"] == pytest.approx(fextras["ncorrect"])
    _close_grads(grads, fgrads, t)


def test_chunked_loss_refuses_a_batch_without_a_divisor_near_the_chunk():
    zi = torch.nn.functional.normalize(torch.randn(23, 8), dim=1)
    with pytest.raises(ValueError, match="no divisor near"):
        infonce.chunked_contrastive_loss(zi, zi, torch.ones(1), chunk_size=8)
    assert infonce._largest_divisor(24, 7) == 6
    assert infonce._largest_divisor(23, 8) == 1


@pytest.mark.parametrize("bias", [0.0, -10.0, 2.5])
def test_sigmoid_loss_matches_jax(bias):
    zi, zt, t = _inputs(3)
    fn = losses.sigmoid_contrastive_loss
    a, b = (torch.tensor(x, requires_grad=True) for x in (zi, zt))
    tt = torch.tensor([t], requires_grad=True)
    bb = torch.tensor([bias], requires_grad=True)
    loss, extras = fn(a, b, tt, bias=bb)
    loss.backward()
    assert extras == {}

    def f(x, y, temp, bias_):
        return jax_losses.sigmoid_contrastive_loss(x, y, temp, bias=bias_)[0]
    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(
            jnp.asarray(zi), jnp.asarray(zt), jnp.asarray([t]),
            jnp.asarray([bias], jnp.float32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    _close_grads([x.grad.numpy() for x in (a, b, tt, bb)],
                 [np.asarray(g) for g in jgrads], t)
    assert float(bb.grad.abs()) > 0
    # per-row values, and a plain number as the bias
    rows, _ = fn(torch.from_numpy(zi), torch.from_numpy(zt),
                 torch.tensor([t]), bias=bias, reduction=False)
    with jax.default_matmul_precision("highest"):
        jrows, _ = jax_losses.sigmoid_contrastive_loss(
            jnp.asarray(zi), jnp.asarray(zt), jnp.asarray([t]), bias=bias,
            reduction=False)
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(jrows),
                               rtol=RTOL)


@pytest.mark.parametrize("bias_init", [None, -10.0])
def test_two_towers_bias_parameter(bias_init):
    """``b`` exists where bias_init is set, starts at bias_init, reaches the
    forward's extras and keeps its npz name ("b") both ways, as the flax
    model's."""
    kw = dict(image=None, text=dict(variant="Ti", vocab_size=20,
                                    context_length=4, depth=1),
              out_dim=8, bias_init=bias_init)
    ours = two_towers.Model(**kw)
    layers.init_parameters(ours, torch.Generator().manual_seed(0))
    ref = jax_two_towers.Model(**kw).init(
        {"params": jax.random.PRNGKey(0)}, None,
        jnp.zeros((1, 4), jnp.int32))["params"]
    names = set(convert.to_jax_names(ours).values())
    assert ("b" in names) == ("b" in ref) == (bias_init is not None)
    tokens = torch.ones(2, 4, dtype=torch.long)
    _, _, out = ours(None, tokens)
    if bias_init is None:
        assert "b" not in out
        return
    assert float(out["b"]) == bias_init == float(ref["b"][0])
    flat = convert.to_jax_params(ours)
    assert tuple(flat["b"].shape) == tuple(ref["b"].shape) == (1,)
    flat["b"] = torch.tensor([1.5])
    convert.load_jax_params(ours, flat)
    assert float(ours.b) == 1.5
