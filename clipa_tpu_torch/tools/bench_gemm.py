"""Microbenchmark: int8-quantized GEMM strategies at CLIPA step shapes.

Port of ``clipa_tpu/tools/bench_gemm.py``. Times, per (M, K, N), by CUDA
events (wall clock on the CPU):

  * ``bf16``       -- the plain bf16 product (what the step runs by default);
  * ``int8``       -- ``ops/quantization.int8_dot_general``'s forward: x
                      quantized per row and w per column inside the timing,
                      the int8 product, the scales;
  * ``int8_preqw`` -- w quantized outside the timing (training quantizes w
                      once per step, amortized over the forward and dx);
  * ``int8_pure``  -- both operands quantized outside the timing: the int8
                      product and the scales alone;
  * ``int8_mm`` and ``int8_mm_row_major`` -- the int8 product alone (no
                      scales), on the column-major int8 weight and on a
                      row-major one (cuBLASLt's int8 path takes it
                      column-major: the two say what the layout costs).

The pre-quantized weights are stored column-major, as ``int8_mm`` hands
them to cuBLASLt (a Linear weight's layout).

The int8 product is ``torch._int_mm`` (cuBLASLt) on the card. The JAX
tool's ``int8_pallas`` rows are not ported: they import an
``ops/int8_gemm.py`` that does not exist. Each row also checks that the
int8 product's int32 accumulators of the first `check_rows` rows equal the
plain version's (the exact float64 product of the codes on the CPU).

    python -m clipa_tpu_torch.tools.bench_gemm [--iters 30] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from clipa_tpu_torch import utils
from clipa_tpu_torch.ops import quantization as q

# CLIPA ViT-L/16 @112 step shapes: M = 512 * 50 image tokens.
SHAPES = [
    (25600, 1024, 4096),   # MLP fc1
    (25600, 4096, 1024),   # MLP fc2
    (25600, 1024, 3072),   # fused QKV
    (25600, 1024, 1024),   # single projection / attention out
    (4096, 768, 3072),     # text tower fc1 (512 * 8 tokens)
]


def _time(f, *args, iters: int = 30, device=None) -> float:
    """Seconds per call of `f(*args)`, after one warm-up call."""
    f(*args)
    if device is not None and device.type == "cuda":
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(iters):
            f(*args)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        f(*args)
    return (time.perf_counter() - t0) / iters


def _scaled(acc, sx, sw):
    return (acc.float() * sx * sw).to(torch.bfloat16)


@torch.no_grad()
def run_shape(m: int, k: int, n: int, device, iters: int = 30,
              check_rows: int = 256, seed: int = 0) -> dict:
    """One row of the table at (m, k, n) on `device`."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
        device, torch.bfloat16)
    w = torch.from_numpy((rng.randn(k, n) * 0.02).astype(np.float32)).to(
        device, torch.bfloat16)

    t_bf16 = _time(torch.matmul, x, w, iters=iters, device=device)
    t_int8 = _time(lambda a, b: q.int8_dot_general(a, b, 1), x, w,
                   iters=iters, device=device)
    qw, sw = q._quantize(w.float(), (0,))
    qw_rows = qw.contiguous()
    qw = qw.t().contiguous().t()   # column-major, as int8_mm hands it over

    def preqw(a, qw, sw):
        qa, sa = q._quantize(a.float(), (1,))
        return _scaled(q.int8_mm(qa, qw), sa, sw)

    t_preqw = _time(preqw, x, qw, sw, iters=iters, device=device)
    qx, sx = q._quantize(x.float(), (1,))
    t_pure = _time(lambda qa, sa, qw, sw: _scaled(q.int8_mm(qa, qw), sa, sw),
                   qx, sx, qw, sw, iters=iters, device=device)

    t_mm = _time(q.int8_mm, qx, qw, iters=iters, device=device)
    t_rows = (_time(torch._int_mm, qx, qw_rows, iters=iters, device=device)
              if device.type == "cuda" else None)   # cuBLASLt only
    rows = min(check_rows, m)
    acc = q.int8_mm(qx, qw)[:rows].cpu()
    plain = (qx[:rows].cpu().double() @ qw.cpu().double()).to(torch.int32)
    flops = 2 * m * k * n
    return {
        "MKN": [m, k, n],
        "bf16_ms": t_bf16 * 1e3,
        "bf16_tflops": flops / t_bf16 / 1e12,
        "int8_ms": t_int8 * 1e3,
        "int8_preqw_ms": t_preqw * 1e3,
        "int8_pure_ms": t_pure * 1e3,
        "int8_pure_tops": flops / t_pure / 1e12,
        "int8_mm_ms": t_mm * 1e3,
        "int8_mm_tops": flops / t_mm / 1e12,
        "int8_mm_row_major_ms": None if t_rows is None else t_rows * 1e3,
        "speedup_int8": t_bf16 / t_int8,
        "speedup_preqw": t_bf16 / t_preqw,
        "speedup_pure": t_bf16 / t_pure,
        "int32_exact_rows": rows if torch.equal(acc, plain) else 0,
    }


def main(argv=None) -> list:
    """Prints one JSON line per shape; returns the rows."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = utils.resolve_device(args.device, "bench_gemm")
    rows = []
    for m, k, n in SHAPES:
        row = run_shape(m, k, n, device, iters=args.iters)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
