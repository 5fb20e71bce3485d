"""Times the LayerNorm kernels against their byte bound and the cast chain.

    python -m clipa_tpu_torch.tools.layer_norm_bench [--shape 65792x1280]
        [--shape ...] [--iters 50] [--seed 0 [--seed 1 ...]]

For each (rows x width) shape (default: the main path's, H/14 @84, @224
masked and served at 1280 wide and the H/14 text tower's 8192 x 1024), from
seeded bf16 x and dy and fp32 weight and bias on the card:

  kernel_fwd_ms     ``ops/layer_norm``'s forward as training runs it (the
                    row statistics written), device time by torch.profiler
                    (None where three sessions lose records), beside
                    ``kernel_fwd_events_ms`` by CUDA events over `iters`
  kernel_bwd_ms     its backward (both launches), the same two ways
  bound_fwd_ms      the least traffic over 3.35 TB/s, the H100 SXM's
                    published rate: x read and y written (4 bytes an
                    element) and the statistics (8 bytes a row); the
                    backward's: x and dy read, dx written (6 bytes an
                    element), the statistics read; ``*_share`` = bound /
                    device time
  chain_*_ms        the cast chain ``layers.LayerNorm`` runs off the
                    kernels' path (x cast to fp32, fp32 layer_norm, cast
                    back; autograd's backward of it), device time
  plain_*_ms        the plain version (``layer_norm_plain``,
                    ``layer_norm_plain_bwd``) on the card, device time
  y_ulps            the forward's largest difference from the chain in
                    bf16 ulps beyond :func:`forward_floor` (at most 1 where
                    the two differ only by their sums' orders and one
                    rounding each); ``y_exact_ulps`` its difference from
                    the float64 LayerNorm of the same bf16 input beyond
                    the kernel's own fp32 error bound (at most 0.5: the
                    one rounding); ``y_raw_ulps`` the difference from the
                    chain in ulps of the chain's value with no floor, and
                    ``y_raw_at`` that element's values (near 0 a few fp32
                    ulps of the row are many bf16 ulps of the element)
  dx_ulps           dx's largest difference from the chain's in bf16 ulps
                    of its row's scale; ``dw_rel``, ``db_rel`` the
                    parameter gradients' largest difference over their
                    largest value; ``bwd_bitwise`` two backward calls bit
                    for bit

  host_*_us         the host's time per call of ``layers.LayerNorm`` on a
                    bf16 input that needs its gradient (the kernels' route:
                    the route's checks, the autograd Function, the launch)
                    and per backward through it, beside the cast chain's
                    (``chain_host_*_us``), medians over `iters` calls at
                    256 rows, where the device keeps up with the host;
                    ``*_nograd_fwd_us`` the forward without autograd (the
                    service's route)

One JSON line per shape and seed, then one with all of them and the card's name and
power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch
import torch.nn.functional as F

from clipa_tpu_torch.tools.adam_bench import HBM_BYTES_PER_S, _card, \
    _device_ms

SHAPES = ["37888x1280", "46080x1280", "65792x1280", "8192x1024"]
EPS = 1e-6


def _events_ms(fn, iters: int) -> float:
    fn()
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    begin.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / iters


U = 2.0 ** -24   # fp32's unit roundoff


def _bf16_ulp(a):
    """One bf16 ulp of |a| (of the smallest normal at 0), in float64: 2^(E -
    7) for |a| = 1.f 2^E, built from the exponent's bits (the card's log2
    can put an exact power of two in the binade below)."""
    bits = a.double().abs().clamp_min(2.0 ** -126).view(torch.int64)
    return (((bits >> 52) - 7) << 52).view(torch.float64)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def kernel_error_bound(x, w, b, eps):
    """(bound, y64): the float64 LayerNorm of the bf16 rows x, and a bound
    on how far csrc/layer_norm.cu's fp32 output lies from it before its one
    rounding to bf16, element by element. With u = 2^-24, K the kernel's
    16-byte steps a thread (d / 256 rounded up to a width of 2048, d / 1024
    past it) and n = 8 K + 8 the additions and the division an element
    goes through in a row sum (8 K - 1 in its thread, 5 across the warp, 3
    across a block's warps), first order in u, from the exact mean mu,
    rstd r, xh = (x - mu) r and m = mean |x| of the row:

      the mean    |mu' - mu| <= n u m (recursive summation: each term's
                  error is u times the additions it goes through)
      the rstd    |r' / r - 1| <= (4 K + 10) u + (n u m r)^2 / 2 (the
                  squares' sum as the mean's, plus the squares, the
                  division, eps and rsqrtf's 2 ulps; the second term is
                  the mean's error squared, which adds to the variance)
      the affine  (x - mu') r' gamma + beta: three roundings

      bound = u (n r |gamma| m + (4 K + 14) |xh gamma| + |beta|)
              + |xh gamma| (n u m r)^2 / 2
    """
    d = x.shape[-1]
    k = -(-d // (256 if d <= 2048 else 1024))
    n = 8 * k + 8
    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    e = xd - mu
    r = torch.rsqrt((e * e).mean(-1, keepdim=True) + eps)
    xg = (e * r * w.double()).abs()
    y64 = (e * r * w.double()).add_(b.double())
    del e
    mr = xd.abs().mean(-1, keepdim=True) * r
    del xd
    bound = (U * (n * mr * w.double().abs() + (4 * k + 14) * xg
                  + b.double().abs()) + xg * (n * U * mr) ** 2 / 2)
    return bound, y64


def forward_floor(chain32, bound, y64):
    """How far the kernel's fp32 output and the chain's (``chain32``, its
    fp32 layer_norm before the cast) may lie apart: the kernel's bound
    plus the chain's measured distance from the float64 value. The two
    bf16 outputs, each one rounding of those, then differ by at most that
    floor and one bf16 ulp of the larger."""
    return bound + (chain32.double() - y64).abs()


def forward_ulps(y, chain32, x, w, b, eps) -> dict:
    """The kernel's forward output y against the chain and the float64
    value, in bf16 ulps beyond their floors: ``y_ulps`` (at most 1),
    ``y_exact_ulps`` (at most 0.5), and the raw difference from the chain
    with no floor, ``y_raw_ulps``, with ``y_raw_at`` its element's values
    (want, off, floor, the row's largest |want|)."""
    bound, y64 = kernel_error_bound(x, w, b, eps)
    floor = forward_floor(chain32, bound, y64)
    yd, want = y.double(), chain32.to(y.dtype).double()
    off = (yd - want).abs()
    excess = (off - floor).clamp_min(0) / _bf16_ulp(
        torch.maximum(yd.abs(), want.abs()))
    exact = ((yd - y64).abs() - bound).clamp_min(0) / _bf16_ulp(yd)
    raw = off / _bf16_ulp(want)
    i = int(raw.argmax())
    row = i // x.shape[-1]
    return {"y_ulps": float(excess.max()), "y_exact_ulps": float(exact.max()),
            "y_raw_ulps": float(raw.max()), "y_raw_at": {
                "want": float(want.flatten()[i]),
                "off": float(off.flatten()[i]),
                "floor": float(floor.flatten()[i]),
                "row_max": float(want.reshape(-1, x.shape[-1])[row].abs()
                                 .max())}}


def dx_ulps(dx, want) -> float:
    """max |dx - want| in bf16 ulps of its row's largest |want|."""
    off = (dx.float() - want.float()).abs()
    scale = want.float().abs().amax(-1, keepdim=True)
    return float((off / _bf16_ulp(scale)).max())


def operands(rows: int, d: int, seed: int, device="cuda"):
    """(x, dy, weight, bias): seeded bf16 x (a spread of 2 about an offset
    drawn per row) and dy, fp32 weight about 1 and bias about 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(rows, d, device=device, generator=gen) * 2
         + torch.randn(rows, 1, device=device, generator=gen)).bfloat16()
    dy = torch.randn(rows, d, device=device, generator=gen).bfloat16()
    w = 1 + 0.3 * torch.randn(d, device=device, generator=gen)
    b = 0.2 * torch.randn(d, device=device, generator=gen)
    return x, dy, w, b


def _host_us(fn, iters: int) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def host(d: int, iters: int) -> dict:
    """Host microseconds per forward and backward call of layers.LayerNorm
    at 256 x d, and per forward without autograd, the kernels' route
    against the cast chain's."""
    from clipa_tpu_torch.models import layers
    mod = layers.LayerNorm(d, eps=EPS).cuda()
    x = torch.randn(256, d, device="cuda").bfloat16().requires_grad_()
    dy = torch.randn(256, d, device="cuda").bfloat16()

    def chain(x):
        return F.layer_norm(x.float(), (d,), mod.weight, mod.bias,
                            EPS).to(x.dtype)

    out = {}
    for name, f in (("host", mod), ("chain_host", chain)):
        ys = []
        out[f"{name}_fwd_us"] = _host_us(lambda: ys.append(f(x)), iters)
        out[f"{name}_bwd_us"] = _host_us(
            lambda: torch.autograd.backward(ys.pop(), dy), iters)
        with torch.no_grad():
            out[f"{name}_nograd_fwd_us"] = _host_us(lambda: f(x), iters)
    return out


def measure(rows: int, d: int, iters: int = 50, seed: int = 0,
            timed: bool = True) -> dict:
    """One shape's line (the module's docstring); `timed` False: the
    checks alone (ulps, relative errors, bits, launches)."""
    from clipa_tpu_torch.ops import layer_norm as ln
    x, dy, w, b = operands(rows, d, seed)
    out = {"rows": rows, "width": d, "seed": seed,
           "bound_fwd_ms": (rows * d * 4 + rows * 8) / HBM_BYTES_PER_S * 1e3,
           "bound_bwd_ms": (rows * d * 6 + rows * 8) / HBM_BYTES_PER_S * 1e3}

    y, st = ln._forward(x, w, b, EPS, stats=True)
    dx, dw, db = ln._backward(x, dy, st, w)
    again = ln._backward(x, dy, st, w)
    out["bwd_bitwise"] = all(torch.equal(_bits(a), _bits(c))
                             for a, c in zip((dx, dw, db), again))
    del again
    xc, wc, bc = (t.detach().requires_grad_() for t in (x, w, b))
    yc = F.layer_norm(xc.float(), (d,), wc, bc, EPS).to(torch.bfloat16)
    dxc, dwc, dbc = torch.autograd.grad(yc, (xc, wc, bc), dy,
                                        retain_graph=True)
    with torch.no_grad():
        out.update(forward_ulps(y, F.layer_norm(x.float(), (d,), w, b, EPS),
                                x, w, b, EPS))
    out["dx_ulps"] = dx_ulps(dx, dxc)
    out["dw_rel"] = float((dw - dwc).abs().max() / dwc.abs().max())
    out["db_rel"] = float((db - dbc).abs().max() / dbc.abs().max())
    before = dict(ln.layer_norm.launches)
    ln.layer_norm(xc, wc, bc, EPS).backward(dy)
    torch.cuda.synchronize()
    out["launches"] = {k: ln.layer_norm.launches[k] - before[k]
                       for k in before}
    torch.cuda.empty_cache()
    if not timed:
        return out

    def fwd():
        ln._forward(x, w, b, EPS, stats=True)

    def bwd():
        ln._backward(x, dy, st, w)

    def chain_fwd():
        F.layer_norm(x.float(), (d,), w, b, EPS).to(torch.bfloat16)

    def chain_bwd():
        torch.autograd.grad(yc, (xc, wc, bc), dy, retain_graph=True)

    def plain_fwd():
        ln.layer_norm_plain(x, w, b, EPS)

    def plain_bwd():
        ln.layer_norm_plain_bwd(x, dy, st, w)

    for name, fn in (("kernel_fwd", fwd), ("kernel_bwd", bwd),
                     ("chain_fwd", chain_fwd), ("chain_bwd", chain_bwd),
                     ("plain_fwd", plain_fwd), ("plain_bwd", plain_bwd)):
        out[f"{name}_ms"], out[f"{name}_kernels"] = _device_ms(fn)
        out[f"{name}_events_ms"] = _events_ms(fn, iters)
    for phase in ("fwd", "bwd"):
        ms = out[f"kernel_{phase}_ms"]
        out[f"{phase}_share"] = out[f"bound_{phase}_ms"] / ms if ms else None
    out.update(host(d, iters))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", action="append",
                        help="rows x width, e.g. 65792x1280 (repeatable; "
                             "default: the main path's)")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--seed", type=int, action="append",
                        help="input seed (repeatable: the first is timed, "
                             "the others checked alone; default 0)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layer_norm_bench needs a CUDA card")
    results = []
    for shape in args.shape or SHAPES:
        rows, d = map(int, shape.split("x"))
        for i, seed in enumerate(args.seed or [0]):
            results.append(measure(rows, d, args.iters, seed, timed=not i))
            print(json.dumps(results[-1]), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({**_card(), "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
