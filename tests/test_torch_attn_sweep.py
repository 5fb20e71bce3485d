"""The attention sweep's functions against clipa_tpu/tools/attn_sweep.py.

The JAX tool's ``make_fwd_bias(g)`` / ``make_bwd_bias(g, defer)`` run here
as Pallas kernels in interpret mode on the CPU, at B=4 L=50 D=128 H=2 (g=2,
two programs): the tool's module constants are monkeypatched for the test,
and its ``pl`` with a namespace whose ``pallas_call`` interprets. Nothing in
``clipa_tpu`` changes. The port's sweep callables run their plain versions
on CPU tensors. Inputs are bf16 from numpy seeds, the same in both.

Tolerances are the port's kernel tolerances (``block_attention.tolerance``
for the forward, ``bwd_errors`` for the backward): both packages compute in
fp32 from the same bf16 operands and round the same intermediates to bf16,
so only summation order and exp's last bits differ. Against float64
autodiff of the clipped-softmax attention the same rtol (1e-2 of each
output's scale) bounds the bf16 roundings of dS, P (or e) and dohn.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from clipa_tpu_torch.ops import block_attention as ba
from clipa_tpu_torch.tools import attn_sweep

SHAPE = dict(B=4, L=50, D=128, H=2)
G = 2


@pytest.fixture(scope="module")
def jax_sweep():
    """clipa_tpu.tools.attn_sweep at the test shape, Pallas interpreted.
    (Imported here, not at collection: its import draws B=384 operands.)"""
    from clipa_tpu.tools import attn_sweep as mod
    patch = pytest.MonkeyPatch()
    for name, value in SHAPE.items():
        patch.setattr(mod, name, value)
    patch.setattr(mod, "HD", SHAPE["D"] // SHAPE["H"])
    patch.setattr(mod, "SCALE", (SHAPE["D"] // SHAPE["H"]) ** -0.5)
    patch.setattr(mod, "pl", types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True)))
    yield mod
    patch.undo()


@pytest.fixture(autouse=True)
def port_shape(monkeypatch):
    for name, value in SHAPE.items():
        monkeypatch.setattr(attn_sweep, name, value)


def _inputs(seed=0, q_scale=1.0):
    """numpy fp32 values exactly representable in bf16: q, k, v, do (B*L,
    D), biases (D,) at 0.1 scale."""
    rng = np.random.RandomState(seed)
    rows, d = SHAPE["B"] * SHAPE["L"], SHAPE["D"]

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)

    x = {n: bf16(rng.randn(rows, d) * (q_scale if n == "q" else 1.0))
         for n in ("q", "k", "v", "do")}
    x.update({n: bf16(rng.randn(d) * 0.1) for n in ("bq", "bk", "bv")})
    return x


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


def _jax_fwd(mod, x):
    out = mod.make_fwd_bias(G)(
        *(_jax(x[n]) for n in ("q", "k", "v")),
        *(_jax(x[n]).reshape(1, -1) for n in ("bq", "bk", "bv")))
    return _torch(out).to(torch.bfloat16)


def _jax_bwd(mod, x, defer):
    outs = mod.make_bwd_bias(G, defer)(
        *(_jax(x[n]) for n in ("q", "k", "v", "do")),
        *(_jax(x[n]).reshape(1, -1) for n in ("bq", "bk", "bv")))
    dq, dk, dv = (_torch(o).to(torch.bfloat16) for o in outs[:3])
    # fp32 bias-grad partials, (8 * n_prog, D) with one live row per program
    dbias = [_torch(o).sum(dim=0).to(torch.bfloat16) for o in outs[3:]]
    return (dq, dk, dv, *dbias)


def _port_bwd(x, defer, exact=False):
    return attn_sweep.make_bwd_bias(defer, exact)(
        *(x[n] for n in ("q", "k", "v", "do", "bq", "bk", "bv")))


def _autodiff(x, exact=False):
    """float64 autodiff of the clipped-softmax (or exact) attention, the
    biases added in bf16 as the kernels add them."""
    hd = SHAPE["D"] // SHAPE["H"]
    b, l, h = SHAPE["B"], SHAPE["L"], SHAPE["H"]
    leaves = {n: (x[n] + x["b" + n]).double().requires_grad_()
              for n in ("q", "k", "v")}

    def heads(t):
        return t.reshape(b, l, h, hd).transpose(1, 2)

    s = heads(leaves["q"]) @ heads(leaves["k"]).transpose(-1, -2) * hd ** -0.5
    e = (s - s.amax(-1, keepdim=True)).exp() if exact \
        else s.clamp(-ba._EXP_CLIP, ba._EXP_CLIP).exp()
    o = (e / e.sum(-1, keepdim=True)) @ heads(leaves["v"])
    o = o.transpose(1, 2).reshape(b * l, h * hd)
    grads = torch.autograd.grad(o, [leaves[n] for n in ("q", "k", "v")],
                                x["do"].double())
    return (*grads, *(g.sum(dim=0) for g in grads))


def _within(grads, ref):
    errors = ba.bwd_errors(grads, ref, torch.bfloat16)
    return [e for e, _ in errors], all(ok for _, ok in errors)


def test_forward_clip_and_exact_match_jax(jax_sweep):
    x = _inputs(0)
    args = [x[n] for n in ("q", "k", "v", "bq", "bk", "bv")]
    got = attn_sweep.make_fwd_bias(exact=False)(*args)
    want = _jax_fwd(jax_sweep, x)
    atol, rtol = ba.tolerance(torch.bfloat16)
    assert ((got.float() - want.float()).abs()
            <= atol + rtol * want.float().abs()).all()
    # no score reaches the clip at this scale: exact and clip agree
    exact = attn_sweep.make_fwd_bias(exact=True)(*args)
    assert ((exact.float() - want.float()).abs()
            <= atol + rtol * want.float().abs()).all()


def test_normalized_backward_matches_jax(jax_sweep):
    x = _inputs(1)
    errs, ok = _within(_port_bwd(x, defer=False), _jax_bwd(jax_sweep, x,
                                                            defer=False))
    assert ok, errs


@pytest.mark.parametrize("exact", [False, True])
def test_deferred_backward_is_the_gradient(jax_sweep, exact):
    """The port's deferred form computes the normalized form's gradient:
    against the JAX normalized kernel and against float64 autodiff."""
    x = _inputs(2)
    deferred = _port_bwd(x, defer=True, exact=exact)
    errs, ok = _within(deferred, _jax_bwd(jax_sweep, x, defer=False))
    assert ok, errs
    errs, ok = _within(deferred, _autodiff(x, exact))
    assert ok, errs


def test_reference_deferred_backward_is_wrong(jax_sweep):
    """Pins the fault of clipa_tpu/tools/attn_sweep.py make_bwd_bias(g,
    defer=True): its dv (and dbv) agree with the normalized kernel's, its
    dq is off by more than ten times dq's scale (the row-sum term of dS
    lacks its 1/denom)."""
    x = _inputs(2)
    norm = _jax_bwd(jax_sweep, x, defer=False)
    ref_deferred = _jax_bwd(jax_sweep, x, defer=True)
    errors = ba.bwd_errors(ref_deferred, norm, torch.bfloat16)
    assert errors[2][1] and errors[5][1]              # dv, dbv right
    dq_gap = (ref_deferred[0].float() - norm[0].float()).abs().max()
    assert dq_gap > 10 * norm[0].float().abs().max()
    assert not errors[1][1]                           # dk wrong too


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("q_scale", [1.0, 40.0])
def test_plain_deferred_equals_normalized_in_fp32(exact, q_scale):
    """In fp32 nothing is rounded in between: the two forms agree to 1e-5
    of each output's scale, past the clip too (q x 40). The scale of a bias
    grad is that of ``bwd_errors``: the largest column sum of magnitudes of
    the matching grad (dbk is 0 in exact arithmetic)."""
    x = {n: t.float() for n, t in _inputs(3, q_scale).items()}
    args = [x[n] for n in ("q", "k", "v", "do")]
    biases = tuple(x[n] for n in ("bq", "bk", "bv"))
    want = ba.attention_plain_bwd(*args, SHAPE["H"], SHAPE["L"], biases,
                                  exact)
    got = ba.attention_plain_bwd(*args, SHAPE["H"], SHAPE["L"], biases,
                                 exact, defer=True)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = (w.abs().max() if i < 3
                 else want[i - 3].abs().sum(dim=0).max())
        assert ((g - w).abs() <= 1e-5 * (w.abs() + scale)).all()


def test_deferred_wrapper_runs_the_plain_version_on_cpu():
    x = _inputs(4)
    args = [x[n] for n in ("q", "k", "v", "do")]
    biases = tuple(x[n] for n in ("bq", "bk", "bv"))
    ba.fused_attention_bwd_deferred.launches = 0
    got = ba.fused_attention_bwd_deferred(*args, SHAPE["H"], SHAPE["L"],
                                          biases)
    want = ba.attention_plain_bwd(*args, SHAPE["H"], SHAPE["L"], biases,
                                  defer=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ba.fused_attention_bwd_deferred.launches == 0
    with pytest.raises(ValueError, match="do has shape"):
        ba.fused_attention_bwd_deferred(*args[:3], args[3][:-1], SHAPE["H"],
                                        SHAPE["L"], biases)


def test_sweep_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        attn_sweep.main(["--iters", "1"])
