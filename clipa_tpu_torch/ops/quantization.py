"""Int8 quantized matmuls for training (AQT-style), opt-in.

Port of ``clipa_tpu/ops/quantization.py``: the towers' matmuls (the QKV and
out projections and the MLP) run as int8 x int8 -> int32 products with
dynamic symmetric scales,

    y = (q(x) @ q(w)) * sx * sw,   q(a) = clip(round(a / s), -127, 127),
    s = max(amax(|a|), 1e-6) / 127,

per row of x over the contraction dims and per output column of w, the
finest granularity that still factors out of the product. Rounding is
half to even, as in the JAX package. w is quantized from the fp32 master
(callers hand over the parameter, not its bf16 cast). The backward keeps
full precision (dx = g w^T, dw = x^T g with the original operands: AQT's
"quantized forward, high-precision backward"); under ``"int8_full"`` both
backward products run int8 too, dx quantized over the output dims and dw
over the leading dims.

The JAX package computes the int8 product with XLA's ``dot_general``,
outside any Pallas kernel, and so does this port with a library product:
on a CUDA tensor it is ``torch._int_mm`` (cuBLASLt, int8 -> int32), whose
operands this module pads with zeros to the shapes cuBLASLt takes (rows a
multiple of 8 and above 16, the contraction and the columns multiples of
8; zeros leave the int32 sums exact) and crops back, and hands over in
the layout of cuBLASLt's int8 tensor-core path: A row-major, B
column-major (a row-major B runs 4-6x slower on an H100:
``tools/bench_gemm.py``'s ``int8_mm_row_major_ms``). A Linear weight
(out, in) is already column-major as the (in, out) kernel. On a CPU
tensor it is the plain version, the int32 product of the int8 codes. No
shape falls back to a float product. The quantization itself (a row amax,
a divide, a round, a clip) is PyTorch ops.

Enable per tower with ``quant="int8"`` or ``"int8_full"`` in the model
config.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

MODES = (None, "none", "bf16", "int8", "int8_full")


def _quantize(x: torch.Tensor, axes: tuple):
    """Symmetric int8 quantization of fp32 `x`; the scales reduce over
    `axes` (kept as size-1 dims)."""
    amax = torch.amax(torch.abs(x), dim=axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact.

    On CUDA: ``torch._int_mm`` on operands zero-padded to M a multiple of 8
    and at least 24, K and N multiples of 8, A row-major and B column-major
    (copied into those layouts where they are not), cropped back to (M,
    N). On the CPU: the int32 product of the codes (the plain version)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8 operands, got {a.dtype} and "
                        f"{b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32)
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(max(k, 1), 8), \
        _round_up(max(n, 1), 8)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _qdot(a: torch.Tensor, b: torch.Tensor, dims_a: tuple,
          dims_b: tuple) -> torch.Tensor:
    """int8 x int8 -> fp32 ``dot_general`` of fp32 `a` and `b` contracting
    `dims_a` with `dims_b` (output: a's other dims, then b's), each operand
    quantized over its contraction dims."""
    qa, sa = _quantize(a, dims_a)
    qb, sb = _quantize(b, dims_b)
    out_a = [d for d in range(a.ndim) if d not in dims_a]
    out_b = [d for d in range(b.ndim) if d not in dims_b]
    shape_a = [a.shape[d] for d in out_a]
    shape_b = [b.shape[d] for d in out_b]
    k = math.prod(a.shape[d] for d in dims_a)
    qa2 = qa.permute(*out_a, *dims_a).reshape(math.prod(shape_a), k)
    qb2 = qb.permute(*dims_b, *out_b).reshape(k, math.prod(shape_b))
    acc = int8_mm(qa2, qb2).reshape(shape_a + shape_b)
    sa = sa.reshape(shape_a + [1] * len(shape_b))
    sb = sb.reshape(shape_b)
    return acc.float() * sa * sb


def _dot(a: torch.Tensor, b: torch.Tensor, dims_a: tuple,
         dims_b: tuple) -> torch.Tensor:
    """The fp32 ``dot_general`` of :func:`_qdot`, unquantized."""
    return torch.tensordot(a, b, dims=(list(dims_a), list(dims_b)))


def _dims(x_ndim: int, n: int):
    return tuple(range(x_ndim - n, x_ndim)), tuple(range(n))


class Int8DotGeneral(torch.autograd.Function):
    """``apply(x, w, n_contract, quant_bwd)``: x (*A, *C) . w (*C, *O) ->
    (*A, *O) fp32 with an int8 forward; the backward's two products in
    fp32, or int8 with `quant_bwd`."""

    @staticmethod
    def forward(ctx, x, w, n, quant_bwd):
        ctx.save_for_backward(x, w)
        ctx.n, ctx.quant_bwd = n, quant_bwd
        cx, cw = _dims(x.ndim, n)
        return _qdot(x.float(), w.float(), cx, cw)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n = ctx.n
        g = g.float()
        xf, wf = x.float(), w.float()
        n_a, n_o = x.ndim - n, w.ndim - n
        # dx (*A, *C) = g (*A, *O) . w (*C, *O) contracting O
        g_o = tuple(range(n_a, n_a + n_o))
        w_o = tuple(range(n, n + n_o))
        # dw (*C, *O) = x (*A, *C) . g (*A, *O) contracting A
        x_a = g_a = tuple(range(n_a))
        product = _qdot if ctx.quant_bwd else _dot
        dx = product(g, wf, g_o, w_o) if ctx.needs_input_grad[0] else None
        dw = product(xf, g, x_a, g_a) if ctx.needs_input_grad[1] else None
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype), None, None)


def int8_dot_general(x: torch.Tensor, w: torch.Tensor, n_contract: int = 1,
                     quant_bwd: bool = False) -> torch.Tensor:
    """Contracts the last `n_contract` dims of x with the first of w, int8
    forward, fp32 result (module docstring)."""
    return Int8DotGeneral.apply(x, w, n_contract, quant_bwd)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) int8-forward matmul (2D convenience wrapper)."""
    return int8_dot_general(x, w, 1)


def quant_dot(x: torch.Tensor, kernel: torch.Tensor, *,
              quant: Optional[str] = None,
              n_contract: int = 1) -> torch.Tensor:
    """(..., *C) x (*C, *out) contraction with optional int8 quantization,
    in x's dtype. `kernel` is the fp32 master (JAX layout: contraction
    dims first). quant: None / "none" / "bf16" (plain: the kernel cast to
    x's dtype), "int8" (forward only), "int8_full" (forward and both
    backward products)."""
    if quant == "int8":
        return int8_dot_general(x, kernel, n_contract, False).to(x.dtype)
    if quant == "int8_full":
        return int8_dot_general(x, kernel, n_contract, True).to(x.dtype)
    if quant not in MODES:
        raise ValueError(f"Unknown quant mode {quant!r}")
    cx, cw = _dims(x.ndim, n_contract)
    return _dot(x, kernel.to(x.dtype), cx, cw)
