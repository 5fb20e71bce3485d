"""The H100's peaks and the least time a piece of work could take.

Published peaks of one NVIDIA H100 SXM (dense, 700 W): 989 TFLOP/s in bf16
and fp16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
A bound is the larger of the bytes over the bandwidth and the operations
over the peak. Bytes count each input read once and each output written
once, whatever a kernel reads again, so no share of a bound can pass 100%.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """Seconds the card needs at least for `nbytes` moved and `flops`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def attention_fwd(batch: int, seq: int, width: int, bias: bool = True,
                  elem: int = 2) -> tuple:
    """(bytes, flops) of one fused attention forward over (batch * seq,
    width) rows: q, k, v in and o out (and the three biases in); 4 L^2 D
    products per sample."""
    nbytes = elem * (4 * batch * seq * width + (3 * width if bias else 0))
    return float(nbytes), 4.0 * batch * seq * seq * width


def attention_bwd(batch: int, seq: int, width: int, bias: bool = True,
                  elem: int = 2) -> tuple:
    """(bytes, flops) of one fused attention backward: q, k, v, do in and
    dq, dk, dv out (the biases in, their gradients out); the scores
    recomputed and four more L^2 D products, 10 L^2 D per sample."""
    nbytes = elem * (7 * batch * seq * width + (6 * width if bias else 0))
    return float(nbytes), 10.0 * batch * seq * seq * width
