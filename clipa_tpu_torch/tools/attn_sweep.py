"""Attention-kernel variant sweep on the card (the perf-sweep driver).

    python -m clipa_tpu_torch.tools.attn_sweep [--iters 20] [--seed 0]

Port of ``clipa_tpu/tools/attn_sweep.py``. Times the bias-fused attention
kernels (the towers' hot path, ``use_bias=True``) at the pre-training shape
B=384, L=50, D=1024, H=16, bf16, in every variant that computes something
different on Hopper:

  fwd  clip / exact               csrc/fused_attention_fwd.cu (K5's function)
  bwd  normalized / deferred,     csrc/fused_attention_bwd.cu: the landed
       each clip / exact          backward and the deferred variant, which
                                  folds 1/denom into dO's rows so the
                                  score-sized products run on unnormalized
                                  e; at this shape both take the whole-head
                                  scheme (bwd_plan, bwd_deferred_plan)

Each variant is held against its plain PyTorch version (the forward's
tolerance, or the backward's per output) and against a second call of
itself, bit for bit, and the deferred backward also against the
normalized one; a disagreement raises. Times are CUDA events
around `--iters` launches, the best of 3 after a warm-up. One JSON line
closes the output.

Not swept: the reference's `g`, the samples per Pallas program under a
block-diagonal mask. It is a Mosaic layout knob (sublane alignment, VMEM);
every g computes the same function, and the CUDA kernels work per
(sample, head) instead. The history in the reference's docstring (v5e
times, r3-r5b) is TPU data, not a Hopper figure, and its deferred backward
computes a wrong dq and dk (its row-sum term lacks the 1/denom).

The sweep's answer on Hopper (NVIDIA H100 80GB HBM3, 700.00 W; CUDA
events, tools/flash_bench.py --kernels deferred, both kernels on the
whole-head scheme in one run): deferring loses. The deferred backward
takes 0.2387-0.2439 ms in both modes against the normalized one's
0.1735-0.1781 (1.36-1.40x). Its dohn needs denom, so the product dohn
Vb^T waits for S and its row sums, behind one more pass over dO's
fragments with an IEEE division per element, where the normalized form
forms S and dP side by side. Folding 1/denom into dO saves the
normalization of the L x L scores, which in registers costs a multiply
per score.

Needs a CUDA device; on CPU tensors the callables below run the plain
versions (the tests use them so, at a small shape).
"""

from __future__ import annotations

import argparse
import json

import torch

from clipa_tpu_torch.ops import block_attention as ba

B, L, D, H = 384, 50, 1024, 16
HD = D // H
SCALE = HD ** -0.5


def operands(device, seed: int = 0) -> dict:
    """q, k, v, do: (B*L, D) bf16 standard normal; bq, bk, bv: (D,) bf16 at
    0.1 scale, as the reference draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, device=device, generator=gen)
                * scale).to(torch.bfloat16)

    out = {n: mk(B * L, D) for n in ("q", "k", "v", "do")}
    out.update({n: mk(D, scale=0.1) for n in ("bq", "bk", "bv")})
    return out


def make_fwd_bias(exact: bool):
    """f(q, k, v, bq, bk, bv) -> out through the fused forward kernel."""
    def f(q, k, v, bq, bk, bv):
        return ba.fused_attention(q, k, v, H, L, (bq, bk, bv), exact)
    return f


def make_bwd_bias(defer: bool, exact: bool):
    """f(q, k, v, do, bq, bk, bv) -> (dq, dk, dv, dbq, dbk, dbv) through the
    normalized or the deferred backward kernel."""
    bwd = ba.fused_attention_bwd_deferred if defer else ba.fused_attention_bwd

    def f(q, k, v, do, bq, bk, bv):
        return bwd(q, k, v, do, H, L, (bq, bk, bv), exact)
    return f


def plain_fwd(exact: bool):
    def f(q, k, v, bq, bk, bv):
        return ba.attention_plain(q, k, v, H, L, (bq, bk, bv), exact)
    return f


def plain_bwd(defer: bool, exact: bool):
    def f(q, k, v, do, bq, bk, bv):
        return ba.attention_plain_bwd(q, k, v, do, H, L, (bq, bk, bv), exact,
                                      defer=defer)
    return f


def time_ms(fn, iters: int) -> float:
    """Best of 3 of the mean device time of `iters` calls, after a warm-up
    (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _fwd_error(out, ref):
    err = (out.float() - ref.float()).abs()
    ok = bool(torch.isfinite(out).all() and (
        err <= ba.KERNEL_ATOL + ba.KERNEL_RTOL * ref.float().abs()).all())
    return err.max().item(), ok


def variants() -> list:
    """(name, kernel, plain version, backward) of every swept variant, in
    the sweep's order; arguments(x, backward) gives their operands."""
    out = [(f"fwd {_mode(exact)}", make_fwd_bias(exact), plain_fwd(exact),
            False) for exact in (False, True)]
    for defer in (False, True):
        for exact in (False, True):
            out.append((f"bwd {'deferred' if defer else 'normalized'} "
                        f"{_mode(exact)}", make_bwd_bias(defer, exact),
                        plain_bwd(defer, exact), True))
    return out


def arguments(x: dict, backward: bool) -> tuple:
    """A variant's operands from operands()' dict."""
    names = ("q", "k", "v", "do") if backward else ("q", "k", "v")
    return tuple(x[n] for n in names + ("bq", "bk", "bv"))


def _mode(exact: bool) -> str:
    return "exact" if exact else "clip"


def sweep(iters: int = 20, seed: int = 0) -> list[dict]:
    """Every variant at the module shape on the card: its ms, its plain
    version's ms, its max error against that (and, for the deferred
    backward, against the normalized kernel) and whether a second call
    gives the same output bit for bit (no variant uses atomics). Raises on
    a disagreement."""
    x = operands("cuda", seed)
    rows, normalized = [], {}
    for name, f, ref_f, backward in variants():
        args = arguments(x, backward)
        out, again = f(*args), f(*args)
        repeat = (all(map(torch.equal, out, again)) if backward
                  else torch.equal(out, again))
        if not backward:
            err, ok = _fwd_error(out, ref_f(*args))
            row = {"name": name, "max_abs_err": err, "ok": ok}
        else:
            errors = ba.bwd_errors(out, ref_f(*args))
            row = {"name": name, "max_abs_err": max(e for e, _ in errors),
                   "ok": all(ok for _, ok in errors)}
            mode = name.split()[-1]
            if "deferred" in name:
                # the same gradient as the normalized kernel's
                vs = ba.bwd_errors(out, normalized[mode])
                row["vs_normalized_max_abs_err"] = max(e for e, _ in vs)
                row["ok"] = row["ok"] and all(ok for _, ok in vs)
            else:
                normalized[mode] = out
        row["repeat_identical"] = repeat
        row["ok"] = row["ok"] and repeat
        row["ms"] = time_ms(lambda: f(*args), iters)
        row["plain_ms"] = time_ms(lambda: ref_f(*args), max(2, iters // 4))
        rows.append(row)
    for row in rows:
        extra = (f" vs normalized {row['vs_normalized_max_abs_err']:.3e}"
                 if "vs_normalized_max_abs_err" in row else "")
        print(f"{row['name']:<24} {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f} ms), max abs err vs plain "
              f"{row['max_abs_err']:.3e}{extra}, bit-identical on repeat "
              f"{row['repeat_identical']}", flush=True)
    bad = [row["name"] for row in rows if not row["ok"]]
    if bad:
        raise RuntimeError(f"variants disagree with their plain versions or "
                           f"across two calls: {bad}")
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_sweep needs a CUDA device")
    print(f"shape B={B} L={L} D={D} H={H} bf16 (bias kernels) on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    rows = sweep(args.iters, args.seed)
    print(json.dumps({"shape": {"B": B, "L": L, "D": D, "H": H},
                      "variants": rows}))
    return rows


if __name__ == "__main__":
    main()
