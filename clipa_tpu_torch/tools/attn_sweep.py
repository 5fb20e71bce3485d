"""Attention-kernel variant sweep on the card (the perf-sweep driver).

    python -m clipa_tpu_torch.tools.attn_sweep [--iters 20] [--seed 0]

Port of ``clipa_tpu/tools/attn_sweep.py``. Times the bias-fused attention
kernels (the towers' hot path, ``use_bias=True``) at the pre-training shape
B=384, L=50, D=1024, H=16, bf16, in every variant that computes something
different on Hopper:

  fwd  clip / exact               csrc/fused_attention_fwd.cu (K5's function)
  bwd  normalized / deferred,     csrc/fused_attention_bwd.cu: the landed
       each clip / exact          backward (its whole-head scheme at this
                                  shape) and the deferred variant (its split
                                  scheme), which folds 1/denom into dO's rows
                                  so the score-sized products run on
                                  unnormalized e

Each variant is held against its plain PyTorch version (the forward's
tolerance, or the backward's per output) and the deferred backward also
against the normalized one; a disagreement raises. Times are CUDA events
around `--iters` launches, the best of 3 after a warm-up. One JSON line
closes the output.

Not swept: the reference's `g`, the samples per Pallas program under a
block-diagonal mask. It is a Mosaic layout knob (sublane alignment, VMEM);
every g computes the same function, and the CUDA kernels work per
(sample, head) instead. The history in the reference's docstring (v5e
times, r3-r5b) is TPU data, not a Hopper figure; its
deferred backward also computes a wrong dq and dk (its row-sum term lacks
the 1/denom), so its "defer loses" timed another function than this one.

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
    atol, rtol = ba.tolerance(ref.dtype)
    err = (out.float() - ref.float()).abs()
    ok = bool(torch.isfinite(out).all()
              and (err <= atol + rtol * ref.float().abs()).all())
    return err.max().item(), ok


def sweep(iters: int = 20, seed: int = 0) -> list[dict]:
    """Every variant at the module shape on the card: its ms, its plain
    version's ms and its max error against that (and, for the deferred
    backward, against the normalized kernel). Raises on a disagreement."""
    x = operands("cuda", seed)
    fwd_args = (x["q"], x["k"], x["v"], x["bq"], x["bk"], x["bv"])
    bwd_args = (x["q"], x["k"], x["v"], x["do"], x["bq"], x["bk"], x["bv"])
    rows = []
    for exact in (False, True):
        name = f"fwd {'exact' if exact else 'clip'}"
        f, ref_f = make_fwd_bias(exact), plain_fwd(exact)
        err, ok = _fwd_error(f(*fwd_args), ref_f(*fwd_args))
        rows.append({"name": name, "max_abs_err": err, "ok": ok,
                     "ms": time_ms(lambda: f(*fwd_args), iters),
                     "plain_ms": time_ms(lambda: ref_f(*fwd_args),
                                         max(2, iters // 4))})
    normalized = {}
    for defer in (False, True):
        for exact in (False, True):
            name = (f"bwd {'deferred' if defer else 'normalized'} "
                    f"{'exact' if exact else 'clip'}")
            f, ref_f = make_bwd_bias(defer, exact), plain_bwd(defer, exact)
            grads = f(*bwd_args)
            errors = ba.bwd_errors(grads, ref_f(*bwd_args), torch.bfloat16)
            row = {"name": name, "max_abs_err": max(e for e, _ in errors),
                   "ok": all(ok for _, ok in errors)}
            if defer:
                # the same gradient as the normalized kernel's
                vs = ba.bwd_errors(grads, normalized[exact], torch.bfloat16)
                row["vs_normalized_max_abs_err"] = max(e for e, _ in vs)
                row["ok"] = row["ok"] and all(ok for _, ok in vs)
            else:
                normalized[exact] = grads
            row["ms"] = time_ms(lambda: f(*bwd_args), iters)
            row["plain_ms"] = time_ms(lambda: ref_f(*bwd_args),
                                      max(2, iters // 4))
            rows.append(row)
    for row in rows:
        extra = (f" vs normalized {row['vs_normalized_max_abs_err']:.3e}"
                 if "vs_normalized_max_abs_err" in row else "")
        print(f"{row['name']:<24} {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f} ms), max abs err vs plain "
              f"{row['max_abs_err']:.3e}{extra}", flush=True)
    bad = [row["name"] for row in rows if not row["ok"]]
    if bad:
        raise RuntimeError(f"variants disagree with their plain versions: "
                           f"{bad}")
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
