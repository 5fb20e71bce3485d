"""ops/layer_norm.py on the CPU: the plain version against the cast chain
that ``layers.LayerNorm`` runs for every input the kernels do not take,
the route ``layers.LayerNorm`` picks by dtype, device and width, and the
wrapper's refusals. The kernels themselves are held against the chain on
the card (``tests/test_torch_cuda.py``).

Tolerances: the plain version takes its statistics by two passes where
PyTorch's ``layer_norm`` runs Welford's loop, so the fp32 numbers differ in
the last bits (a few fp32 ulps of the row's largest output: PyTorch's CPU
kernel forms y as x (rstd w) + (b - mean rstd w)); after the one rounding
to bf16 the output may differ by one bf16 ulp beyond that fp32 floor, dx by
one bf16 ulp of its row's scale (dx is a difference of terms that can
cancel), and the fp32 parameter gradients, sums over every row, by 1e-5 of
their scale.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from clipa_tpu_torch.models import layers
from clipa_tpu_torch.ops import layer_norm as ln

WIDTHS = [768, 1024, 1280, 3072]
EPS = 1e-6


def _operands(shape, seed=0, dtype=torch.bfloat16):
    """x (an offset and a spread per row, as a residual stream has), and
    fp32 weight and bias away from 1 and 0."""
    rng = np.random.RandomState(seed)
    d = shape[-1]
    x = (rng.randn(*shape) * rng.uniform(0.5, 3.0, shape[:-1] + (1,))
         + rng.uniform(-2, 2, shape[:-1] + (1,)))
    w = 1.0 + 0.3 * rng.randn(d)
    b = 0.2 * rng.randn(d)
    return (torch.tensor(x, dtype=dtype),
            torch.tensor(w, dtype=torch.float32),
            torch.tensor(b, dtype=torch.float32))


def _chain(x, w, b, eps=EPS):
    """What layers.LayerNorm ran before the kernels: cast, fp32
    layer_norm, cast."""
    stats = torch.promote_types(x.dtype, torch.float32)
    return F.layer_norm(x.to(stats), x.shape[-1:], w, b, eps).to(x.dtype)


def _bf16_ulp(t):
    """One bf16 ulp of |t| (of the smallest normal at 0)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return 2.0 ** (torch.floor(torch.log2(a)) - 7)


def _within_an_ulp(got, want):
    """|got - want| within one bf16 ulp of `want` plus 4 fp32 ulps of its
    row's largest magnitude (the fp32 arithmetic's own floor)."""
    floor = want.float().abs().amax(-1, keepdim=True) * 2.0 ** -21
    off = (got.float() - want.float()).abs()
    return bool((off <= _bf16_ulp(want) + floor).all())


def _grads(fn, x, w, b, dy):
    x, w, b = (t.detach().requires_grad_() for t in (x, w, b))
    y = fn(x, w, b)
    return (y.detach(), *torch.autograd.grad(y, (x, w, b), dy))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("lead", [(96,), (4, 37)], ids=["2d", "3d"])
def test_plain_version_is_the_cast_chain(d, lead):
    """Forward and backward of the plain version against the chain's
    autograd, bf16 x and dy, fp32 weight and bias: the output within one
    bf16 ulp (nearly all bits equal), dx within one ulp of its row's
    scale, the parameter gradients within 1e-5."""
    x, w, b = _operands(lead + (d,), seed=d)
    dy = _operands(lead + (d,), seed=d + 1)[0]
    want_y, want_dx, want_dw, want_db = _grads(_chain, x, w, b, dy)

    y, stats = ln.layer_norm_plain(x, w, b, EPS)
    assert y.dtype == torch.bfloat16 and stats.dtype == torch.float32
    assert stats.shape == (2,) + lead
    assert _within_an_ulp(y, want_y)
    assert float((y != want_y).float().mean()) < 1e-3
    torch.testing.assert_close(stats[0], x.float().mean(-1), rtol=0,
                               atol=1e-5)

    dx, dw, db = ln.layer_norm_plain_bwd(x, dy, stats, w)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    scale = want_dx.float().abs().amax(-1, keepdim=True)
    assert bool(((dx.float() - want_dx.float()).abs()
                 <= _bf16_ulp(scale)).all())
    for got, want in ((dw, want_dw), (db, want_db)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def _fake_kernels(monkeypatch):
    """Stands the plain version in for the kernels' launches (_forward,
    _backward), recording how they are called: [(phase, ...)]."""
    calls = []

    def forward(x, w, b, eps, stats):
        calls.append(("forward", stats, x.is_contiguous()))
        y, st = ln.layer_norm_plain(x, w, b, eps)
        return y, (st.reshape(2, -1) if stats else None)

    def backward(x, dy, st, w):
        calls.append(("backward", dy.is_contiguous(), st.shape))
        return ln.layer_norm_plain_bwd(x, dy, st.reshape((2,) + x.shape[:-1]),
                                       w)

    monkeypatch.setattr(ln, "_forward", forward)
    monkeypatch.setattr(ln, "_backward", backward)
    return calls


@pytest.mark.parametrize("d", WIDTHS)
def test_function_runs_the_kernels_each_way(monkeypatch, d):
    """run with autograd: LayerNormFn hands the forward contiguous rows
    and asks for the statistics, hands the backward the saved rows and
    statistics with a contiguous dy, and returns its gradients in order
    (the plain version's, bit for bit, standing in for the launches);
    without autograd the forward alone, writing no statistics."""
    calls = _fake_kernels(monkeypatch)
    x, w, b = _operands((5, 3, d), seed=d)
    x = x.transpose(0, 1)                                 # strided rows
    dy = _operands((5, 3, d), seed=d + 7)[0].transpose(0, 1)
    y, dx, dw, db = _grads(lambda *a: ln.run(*a, EPS), x, w, b, dy)
    want_y, stats = ln.layer_norm_plain(x, w, b, EPS)
    want = ln.layer_norm_plain_bwd(x, dy, stats, w)
    assert torch.equal(y, want_y)
    for got, exp in zip((dx, dw, db), want):
        assert torch.equal(got, exp)
    assert calls == [("forward", True, True),
                     ("backward", True, (2, 15))]
    with torch.no_grad():
        assert torch.equal(ln.run(x.requires_grad_(), w, b, EPS), want_y)
    assert torch.equal(ln.run(x.detach(), w, b, EPS), want_y)
    assert calls[2:] == [("forward", False, True)] * 2


def test_function_recomputed_under_minimal_remat(monkeypatch):
    """The Function under the encoder's "minimal" policy (not a 2-D
    product: recomputed in the backward) gives the gradients it gives
    without remat, bit for bit, running its forward twice."""
    calls = _fake_kernels(monkeypatch)
    x, w, b = _operands((64, 256), seed=3)
    dy = _operands((64, 256), seed=4)[0]

    def fn(x, w, b):
        return ln.run(x, w, b, EPS) * 2

    def rematted(x, w, b):
        return checkpoint.checkpoint(fn, x, w, b, use_reentrant=False,
                                     context_fn=layers._minimal_remat)

    got = _grads(rematted, x, w, b, dy)
    assert [c[0] for c in calls] == ["forward", "forward", "backward"]
    for a, c in zip(got, _grads(fn, x, w, b, dy)):
        assert torch.equal(a, c)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on CUDA: the route's predicate and the
    wrapper's refusals run without a card."""

    @property
    def is_cuda(self):
        return True


def _fake(t):
    return t.as_subclass(_FakeCuda)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.float16, torch.bfloat16])
def test_layer_norm_module_takes_the_chain_off_the_kernels_path(
        monkeypatch, d, dtype):
    """layers.LayerNorm: every CPU input, and a CUDA input of any dtype but
    bf16, takes the cast chain (its numbers exactly); a bf16 CUDA input
    with fp32 parameters goes to ops/layer_norm.run."""
    calls = []

    def spy(x, w, b, eps):
        calls.append((x.dtype, eps))
        return x

    monkeypatch.setattr(ln, "run", spy)
    mod = layers.LayerNorm(d, eps=EPS)
    x, w, b = _operands((6, d), seed=d, dtype=dtype)
    if dtype == torch.float64:
        mod.double()
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        assert torch.equal(mod(x), _chain(x, mod.weight, mod.bias))
        assert not calls
        assert not ln.takes(x, mod.weight, mod.bias)
        mod(_fake(x))
    if dtype == torch.bfloat16:
        assert calls == [(torch.bfloat16, EPS)]
    else:
        assert not calls


@pytest.mark.parametrize("d", WIDTHS)
def test_takes(d):
    """The route's predicate on a (faked) CUDA input: bf16 x of a width
    that is a multiple of 8 up to 8192 with fp32 weight and bias of that
    width; nothing else (the parameters' layout is the wrapper's: a
    module's are whole tensors)."""
    x, w, b = _operands((4, d), seed=d)
    fx = _fake(x)
    assert ln.takes(fx, w, b)
    assert ln.takes(_fake(x.reshape(2, 2, d)), w, b)
    assert not ln.takes(x, w, b)                       # a CPU tensor
    for dtype in (torch.float32, torch.float16, torch.float64):
        assert not ln.takes(_fake(x.to(dtype)), w, b)
    assert not ln.takes(fx, w.bfloat16(), b)
    assert not ln.takes(fx, w, b.double())
    assert not ln.takes(fx, None, b)
    assert not ln.takes(fx, w, None)
    assert not ln.takes(fx, w[:-8], b)
    assert not ln.takes(fx, w, b[:-8])
    assert not ln.takes(_fake(torch.zeros((), dtype=torch.bfloat16)), w, b)
    for width in (4, 12, 1001, 8200):
        y, wy, by = _operands((2, width), seed=width)
        assert not ln.takes(_fake(y), wy, by)


REFUSED = "layer_norm kernels take a bf16 CUDA x"


@pytest.mark.parametrize("d", WIDTHS)
def test_wrapper_refuses_what_the_kernels_cannot_take(monkeypatch, d):
    """A (faked) CUDA input the kernels do not take raises, saying what
    they take and what it got, before any library is loaded."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(ln, "library", no_library)
    x, w, b = _operands((4, d), seed=d)
    for dtype in (torch.float32, torch.float16, torch.float64):
        with pytest.raises(ValueError, match=f"{REFUSED}.*got x {dtype}"):
            ln.layer_norm(_fake(x.to(dtype)), w, b, EPS)
    with pytest.raises(ValueError, match="weight torch.bfloat16"):
        ln.layer_norm(_fake(x), w.bfloat16(), b, EPS)
    with pytest.raises(ValueError, match="bias None"):
        ln.layer_norm(_fake(x), w, None, EPS)
    with pytest.raises(ValueError, match=rf"weight torch.float32 \({d - 8},\)"):
        ln.layer_norm(_fake(x), w[:-8], b, EPS)
    y, wy, by = _operands((2, d + 4), seed=1)
    with pytest.raises(ValueError, match=f"multiple of 8.*{d + 4}"):
        ln.layer_norm(_fake(y), wy, by, EPS)


def test_wrapper_refuses_other_devices():
    """The CPU and other devices are the cast chain's: the wrapper raises
    on them."""
    x, w, b = _operands((2, 16), seed=0)
    for t in (x, x.to("meta")):
        with pytest.raises(ValueError, match=REFUSED):
            ln.layer_norm(t, w, b, EPS)


def test_rows_copies_only_what_the_kernels_cannot_read():
    """_rows: a contiguous aligned tensor as it is; a strided one made
    contiguous; a view 2 bytes off a 16-byte boundary copied to an
    aligned one; the values kept."""
    x = torch.randn(8, 16).bfloat16()
    assert ln._rows(x) is x
    t = ln._rows(x.t())
    assert t.is_contiguous() and torch.equal(t, x.t())
    flat = torch.randn(8 * 16 + 1).bfloat16()
    view = flat[1:].view(8, 16)
    assert view.data_ptr() % 16 != 0
    r = ln._rows(view)
    assert r.data_ptr() % 16 == 0 and torch.equal(r, view)
    weights = torch.randn(2 * 64 + 1)         # the wrapper's parameters
    for w in (weights[1:65], weights[:128:2]):
        r = ln._rows(w)
        assert r.is_contiguous() and r.data_ptr() % 16 == 0
        assert torch.equal(r, w)


@pytest.mark.parametrize("d", WIDTHS)
def test_forward_floor_admits_one_rounding_and_refuses_faults(d):
    """tools/layer_norm_bench.forward_ulps, the card tests' measure of the
    forward, on the CPU with the bench's inputs: the plain version (its
    fp32 sums in another order, one rounding) reads within one bf16 ulp of
    the chain and half an ulp of the float64 value beyond their floors;
    outputs one ulp up everywhere, without their bias, or normalised by a
    mean that misses one element of the row read beyond them."""
    from clipa_tpu_torch.tools import layer_norm_bench as lnb
    x, _, w, b = lnb.operands(64, d, seed=d, device="cpu")
    chain32 = F.layer_norm(x.float(), (d,), w, b, EPS)

    def ulps(y):
        return lnb.forward_ulps(y, chain32, x, w, b, EPS)

    y = ln.layer_norm_plain(x, w, b, EPS)[0]
    good = ulps(y)
    assert good["y_ulps"] <= 1 and good["y_exact_ulps"] <= 0.5, good
    assert ulps(chain32.bfloat16())["y_ulps"] == 0
    up = (y.float() + lnb._bf16_ulp(y.float())).bfloat16()
    assert ulps(up)["y_exact_ulps"] > 0.5
    assert ulps((y.float() - b).bfloat16())["y_ulps"] > 1
    xf = x.float()
    mean = xf[:, :-1].mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + EPS)
    short = ((xf - mean) * rstd * w + b).bfloat16()
    bad = ulps(short)
    assert bad["y_ulps"] > 1 and bad["y_exact_ulps"] > 0.5, bad
