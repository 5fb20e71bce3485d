"""Tiled flash attention: CUDA kernels and plain versions.

Port of ``clipa_tpu/ops/flash_attention.py``: exact softmax attention over
``(B, L, H, hd)`` operands (self- or cross-attention), with the per-row
log-sum-exp saved for a backward that rebuilds P from it
(FlashAttention-2). The Pallas forward ``_fwd_kernel`` becomes
``csrc/flash_attention_fwd.cu`` (K7); the backward ``_dq_kernel`` and
``_dkv_kernel``, with the rowsum(dO * O) in front of them, become
``csrc/flash_attention_bwd.cu`` (K8). bf16 operands run on the tensor cores,
fp32 operands through scalar twins in the same sources. The TPU version's
``(B*H, hd, L)`` transposed layout suited its lane tiling only: the kernels
read ``(B, L, H, hd)`` in place, which is the towers' flat ``(B*L, D)``
stream reshaped without a copy.

:class:`FlashAttentionFn` is the JAX custom-VJP boundary: residuals
``(q, k, v, out, lse)``. A CUDA tensor runs the kernels, a CPU tensor (or
``plain=True``) the plain versions, which compute the Pallas functions in
plain PyTorch with the same roundings:

  * scores in fp32 from the operand dtype, times ``hd**-0.5`` applied to the
    fp32 scores;
  * forward: an online softmax over ``block_k``-key tiles (running max m,
    sum l, fp32 accumulator), p rounded to v's dtype before P.V, then
    ``out = acc / l`` and ``lse = m + log(l)`` in fp32;
  * backward: ``delta = rowsum(dO * O)`` in fp32 from the stored O,
    ``p = exp(s - lse)``, ``ds = p * (dp - delta)``; ds rounded to the
    operand dtype before dq and dk, the scale applied once at the end in
    fp32; dv from p rounded to dO's dtype.

Keys past the sequence end get -1e30 in the Pallas kernels and contribute
exactly 0; the plain versions take only the real keys, which is the same.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from clipa_tpu_torch.ops import cuda_build

# The kernels' head-dim limit (the largest register tile they instantiate);
# the plain versions take any multiple of 8, as the JAX kernel does.
MAX_HEAD_DIM = 128
# Keys per online-softmax step: the Pallas block_k, and the CUDA kernel's
# key tile (so p is rounded against the same running max).
BLOCK_K = 128

# Forward kernel vs plain version, bf16: |kernel - plain| <= ATOL + RTOL *
# |plain| on O (both round p and O to bf16; the fp32 summation order and the
# hardware exp can move one rounding to the neighbouring bf16 value: about
# one bf16 ulp, 2^-8, of the output's scale) and LSE_ATOL on the fp32 LSE.
# fp32: nothing is rounded to a narrower type; summation order only.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 1e-2
KERNEL_F32_ATOL = 2e-5
KERNEL_F32_RTOL = 2e-5
LSE_ATOL = 1e-3
# Backward, per output x in (dq, dk, dv): |kernel - plain| <= rtol * (|plain|
# + max|plain|). bf16: ds and p are rounded to bf16 in both, and a few-ulp
# fp32 difference can round one of them to the neighbouring bf16 value; the
# outputs are rounded to bf16 once more: about one bf16 ulp of the largest
# term. fp32: summation order only.
BWD_RTOL = 1e-2
BWD_F32_RTOL = 2e-5

# Launch plans (see launch_plan). A block may use this much shared memory
# on an H100 (227 KB), an SM holds this much for all its blocks (228 KB),
# and each block takes 1 KB of it for the system.
SMEM_LIMIT = 232_448
SM_SMEM = 233_472
SMEM_PER_BLOCK = 1024
# The split backward's rings hold 64-row tiles.
BWD_TILE = 64


class KernelPlan(NamedTuple):
    """One kernel's launch: `blocks` blocks of `warps` warps per (sample,
    head), `smem` bytes of dynamic shared memory per block, and `stages`:
    the work items in shared memory at once for the persistent fused
    backward (1 or 2; its grid is what fits on the card), 0 for a grid of
    blocks."""
    warps: int
    blocks: int
    smem: int
    stages: int


class LaunchPlan(NamedTuple):
    """The forward's launch, and the backward's: one fused kernel, or the dq
    kernel then the dk/dv kernel."""
    fwd: KernelPlan
    bwd: tuple


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _max_warps(hd: int) -> int:
    """The kernels' widest block (attention_common.cuh flash_max_warps):
    their fp32 accumulators grow with the head dim."""
    return 12 if _round16(hd) <= 80 else 8


def _spread(strips: int, max_warps: int) -> tuple[int, int]:
    """(warps, blocks): the fewest blocks of at most `max_warps` warps that
    hold `strips` 16-row strips, and the warps that the fullest needs."""
    blocks = -(-strips // max_warps)
    return -(-strips // blocks), blocks


def strip_range(strips: int, blocks: int, bx: int) -> tuple[int, int]:
    """Strips [first, end) of block `bx`: the strips spread evenly, block
    sizes differing by at most one (attention_common.cuh strip_range)."""
    return bx * strips // blocks, (bx + 1) * strips // blocks


def fwd_candidates(lq: int, lk: int, hd: int) -> list[KernelPlan]:
    """The forward's splits of the query strips over blocks that _fwd_plan
    weighs: for each block width up to _max_warps(hd), the fewest blocks of
    it (so no warp idles where the strips divide evenly), where the block
    fits in shared memory: its Q strips and the K and V rings of 128-key
    tiles (every key while Lk fits two tiles)."""
    row = (_round16(hd) + 8) * 2          # one padded bf16 row, bytes
    ring = _round16(lk) if lk <= 2 * BLOCK_K else 2 * BLOCK_K
    strips = _round16(lq) // 16
    plans = []
    for blocks in sorted({-(-strips // w)
                          for w in range(1, _max_warps(hd) + 1)}):
        warps = -(-strips // blocks)
        smem = (warps * 16 + 2 * ring) * row
        if smem <= SMEM_LIMIT:
            plans.append(KernelPlan(warps, blocks, smem, 0))
    return plans


def _fwd_plan(lq: int, lk: int, hd: int) -> KernelPlan:
    """Of fwd_candidates, the split that keeps the most warps with a strip
    resident on an SM, then the one with the most blocks (a block waiting
    for its copies leaves the SM to the others). The kernel's launch bound
    lets the register file hold _max_warps(hd) of its warps; the shared
    memory holds SM_SMEM // (smem + SMEM_PER_BLOCK) of its blocks."""
    strips, max_warps = _round16(lq) // 16, _max_warps(hd)

    def warps_with_a_strip(p: KernelPlan):
        per_sm = min(max_warps // p.warps,
                     SM_SMEM // (p.smem + SMEM_PER_BLOCK))
        return per_sm * strips / p.blocks, p.blocks

    return max(fwd_candidates(lq, lk, hd), key=warps_with_a_strip)


@functools.lru_cache(maxsize=None)
def launch_plan(lq: int, lk: int, hd: int) -> LaunchPlan:
    """The kernels' launches at one shape (a pure function, cached). The
    CUDA entry points take its numbers, shared-memory sizes included, and
    refuse a plan whose sizes are not their own layouts'.

    Forward: one warp per 16-row query strip, the strips of a (sample, head)
    spread evenly over blocks as _fwd_plan picks; each block streams K and
    V through a two-stage ring of 128-key tiles. Backward: the fused
    persistent kernel (per (sample, head): Q, dO, K, V, LSE, delta and
    bf16(dS)^T in shared memory, 5 products), with two items' operands where
    they fit, else one; where not even one fits, the dq kernel over query
    strips and the dk/dv kernel over key strips, each spread over the
    fewest blocks of at most _max_warps(hd) warps, with 64-row rings.
    """
    row = (_round16(hd) + 8) * 2
    max_warps = _max_warps(hd)
    lqp, lkp = _round16(lq), _round16(lk)
    fwd = _fwd_plan(lq, lk, hd)
    stage = 2 * (lqp + lkp) * row
    shared = lkp * (lqp + 8) * 2 + 2 * lqp * 4    # bf16(dS)^T, LSE, delta
    for stages in (2, 1):
        if stages * stage + shared <= SMEM_LIMIT:
            warps, _ = _spread(max(lqp, lkp) // 16, max_warps)
            return LaunchPlan(fwd, (KernelPlan(warps, 1, stages * stage
                                               + shared, stages),))
    return LaunchPlan(fwd, bwd_split_plan(lq, lk, hd))


def bwd_split_plan(lq: int, lk: int, hd: int) -> tuple:
    """The split backward's launches: the dq kernel over the query strips,
    then the dk/dv kernel over the key strips, each spread over the fewest
    blocks of at most _max_warps(hd) warps; per block its strips' two
    operands, a two-stage ring of BWD_TILE-row tiles of two more, and fp32
    row statistics."""
    row = (_round16(hd) + 8) * 2
    qw, qb = _spread(_round16(lq) // 16, _max_warps(hd))
    kw, kb = _spread(_round16(lk) // 16, _max_warps(hd))
    return (KernelPlan(qw, qb, (2 * qw * 16 + 4 * BWD_TILE) * row
                       + 2 * qw * 16 * 4, 0),
            KernelPlan(kw, kb, (2 * kw * 16 + 4 * BWD_TILE) * row
                       + 4 * BWD_TILE * 4, 0))


_SOURCE = "flash_attention_fwd.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_ENTRY = {torch.bfloat16: "clipa_flash_attention_fwd",
          torch.float32: "clipa_flash_attention_fwd_f32"}
_BWD_ENTRY = {torch.bfloat16: "clipa_flash_attention_bwd",
              torch.float32: "clipa_flash_attention_bwd_f32"}


def tolerance(dtype: torch.dtype) -> tuple[float, float]:
    """(atol, rtol) of the forward kernel's O against flash_plain_fwd's."""
    if dtype == torch.float32:
        return KERNEL_F32_ATOL, KERNEL_F32_RTOL
    return KERNEL_ATOL, KERNEL_RTOL


def bwd_errors(grads, ref, dtype: torch.dtype) -> list[tuple[float, bool]]:
    """(max abs error, within tolerance) of each of (dq, dk, dv) against
    the reference `ref`; the scale of each is its largest element."""
    rtol = BWD_F32_RTOL if dtype == torch.float32 else BWD_RTOL
    out = []
    for g, r in zip(grads, ref):
        g, r = g.float(), r.float()
        err = (g - r).abs()
        ok = bool(torch.isfinite(g).all()
                  and (err <= rtol * (r.abs() + r.abs().max())).all())
        out.append((err.max().item(), ok))
    return out


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, hd) -> (B, H, L, hd) in fp32."""
    return x.transpose(1, 2).float()


def flash_plain_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_k: int = BLOCK_K):
    """The forward kernel's function in plain PyTorch, on any device.

    q: (B, Lq, H, hd); k, v: (B, Lk, H, hd). Returns (out, lse): out
    (B, Lq, H, hd) in q's dtype, lse (B, H, Lq) fp32.
    """
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    b, h, lq, hd = qh.shape
    m = torch.full((b, h, lq), -1e30, device=q.device)
    l = torch.zeros((b, h, lq), device=q.device)
    acc = torch.zeros((b, h, lq, vh.shape[-1]), device=q.device)
    for j in range(0, kh.shape[2], block_k):
        s = qh @ kh[:, :, j:j + block_k].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + (p.to(v.dtype).float()
                                        @ vh[:, :, j:j + block_k])
        m = m_new
    out = (acc / l[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    return out, m + torch.log(l)


def flash_plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor):
    """The backward kernel's function in plain PyTorch, on any device.

    The Pallas backward (``_flash_bwd``), not autograd's: see the module
    docstring. Returns (dq, dk, dv) in the dtypes and shapes of (q, k, v).
    """
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    delta = (doh * _heads(out)).sum(dim=-1)
    p = torch.exp(qh @ kh.transpose(-1, -2) * scale - lse[..., None])
    ds = p * (doh @ vh.transpose(-1, -2) - delta[..., None])
    dq = (ds.to(k.dtype).float() @ kh) * scale
    dk = (ds.to(q.dtype).float().transpose(-1, -2) @ qh) * scale
    dv = p.to(do.dtype).float().transpose(-1, -2) @ doh
    return tuple(g.transpose(1, 2).to(x.dtype).contiguous()
                 for g, x in zip((dq, dk, dv), (q, k, v)))


def _uses_kernel(x: torch.Tensor) -> bool:
    """Whether a tensor on x's device goes to the CUDA kernel (True) or to
    the plain version (False, CPU tensors); any other device raises."""
    if x.device.type == "cpu":
        return False
    if not x.is_cuda:
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return True


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward, for autograd.

    ``apply(q, k, v, plain)``. The kernels run for CUDA tensors, the plain
    versions for CPU tensors and whenever `plain` is set. The forward saves
    (q, k, v, out, lse), the JAX custom VJP's residuals.
    """

    @staticmethod
    def forward(ctx, q, k, v, plain):
        if plain or not _uses_kernel(q):
            out, lse = flash_plain_fwd(q, k, v)
        else:
            out, lse = _launch(q, k, v)
            flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # a .sum().backward() hands in a stride-0 gradient
        do = do.contiguous()
        bwd = flash_plain_bwd if ctx.plain else flash_attention_bwd
        return (*bwd(q, k, v, out, lse, do), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    block_q: int = 128, block_k: int = BLOCK_K,
                    plain: bool = False) -> torch.Tensor:
    """Tiled attention over (B, L, H, hd) tensors (self- or cross-attention),
    differentiable; returns (B, Lq, H, hd) in q's dtype.

    On a CUDA tensor this launches the CUDA kernels (bf16 or fp32 operands)
    in both directions; on a CPU tensor, or with `plain`, it runs the plain
    versions. `mask` is refused, as in the JAX version (CLIPA's towers are
    bidirectional: masked attention takes the einsum path). `block_q` and
    `block_k` are kept only for parity with the JAX signature: they are the
    Pallas tile sizes, the function depends on `block_k` alone (the online
    softmax's key tile), and the kernels implement its default, so
    `block_q` changes nothing here and any other `block_k` is refused.
    """
    del block_q  # the Pallas q-tile: no effect on the function
    if mask is not None:
        raise NotImplementedError("flash_attention is for unmasked towers")
    _check_shapes(q, k, v)
    if block_k != BLOCK_K:
        raise ValueError(f"block_k={block_k}: the kernels tile keys by "
                         f"{BLOCK_K}")
    return FlashAttentionFn.apply(q, k, v, plain)


# Forward kernel launches (a plain counter: callers reset it to 0 and read it
# back to prove a run went through the kernel).
flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor):
    """The backward of :func:`flash_attention`: (dq, dk, dv) from the
    forward's output and LSE. On a CUDA tensor this launches
    ``csrc/flash_attention_bwd.cu``; on a CPU tensor it runs
    :func:`flash_plain_bwd`."""
    _check_shapes(q, k, v)
    b, lq, h, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {lq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not _uses_kernel(q):
        return flash_plain_bwd(q, k, v, out, lse, do)
    grads = _launch_bwd(q, k, v, out, lse, do)
    flash_attention_bwd.launches += 1
    return grads


# Backward kernel launches (one per call; counted like the forward's).
flash_attention_bwd.launches = 0


def _check_shapes(q, k, v) -> None:
    """The shapes every device takes (the kernels' head-dim limit is
    checked where a CUDA tensor reaches them: _check_memory)."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, L, H, hd) operands, got {q.shape}")
    b, _, h, hd = q.shape
    if hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8")
    if b > 65535 or h > 65535:
        raise ValueError("batch and num_heads must be at most 65535")
    if k.dim() != 4 or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k has shape {tuple(k.shape)}, expected "
                         f"({b}, Lk, {h}, {hd})")
    if v.shape != k.shape:
        raise ValueError(f"v has shape {tuple(v.shape)}, expected "
                         f"{tuple(k.shape)}")


def _check_memory(name: str, x: torch.Tensor, like: torch.Tensor,
                  dtype: torch.dtype) -> None:
    if x.device != like.device:
        raise ValueError(f"{name} on {x.device}, expected {like.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}; the CUDA kernel takes q, k, "
                        f"v, out and do all bfloat16 or all float32 (lse "
                        f"float32)")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if x.dim() == 4 and x.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {x.shape[-1]} unsupported by the "
                         f"kernel (at most {MAX_HEAD_DIM}); the plain "
                         f"versions take it (plain=True)")


def _library(source: str, entries: dict, n_ptrs: int,
             n_plan: int) -> ctypes.CDLL:
    """Loads `source`, typing its entries as (n_ptrs pointers, batch, lq, lk,
    num_heads, head_dim, [n_plan plan ints for bf16], scale, stream)."""
    def args(n_ints):
        return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                + [ctypes.c_float, ctypes.c_void_p])
    lib = cuda_build.load_entries(source, [entries[torch.float32]], args(5))
    bf16 = getattr(lib, entries[torch.bfloat16])
    if bf16.argtypes is None:
        bf16.restype = ctypes.c_int
        bf16.argtypes = args(5 + n_plan)
    return lib


def fwd_library() -> ctypes.CDLL:
    return _library(_SOURCE, _ENTRY, 5, 3)


def bwd_library() -> ctypes.CDLL:
    return _library(_BWD_SOURCE, _BWD_ENTRY, 10, 7)


def _call(lib: ctypes.CDLL, entry: str, like: torch.Tensor, what: str,
          *args) -> None:
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = getattr(lib, entry)(*args, like.shape[-1] ** -0.5, stream)
    cuda_build.raise_on(err, lib, what)


def _dims(q, k) -> tuple:
    b, lq, h, hd = q.shape
    return b, lq, k.shape[1], h, hd


def _launch(q, k, v, plan: Optional[KernelPlan] = None):
    """Runs the forward kernel: (out, lse). `plan`: the bf16 kernel's
    launch, launch_plan's by default (tools/flash_bench.py times others)."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"q is {q.dtype}; the CUDA kernel takes q, k, v all "
                        f"bfloat16 or all float32")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_memory(name, x, q, q.dtype)
    b, lq, lk, h, hd = _dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    args = ()   # the fp32 twin takes no plan
    if q.dtype == torch.bfloat16:
        args = tuple((plan or launch_plan(lq, lk, hd).fwd)[:3])
    _call(fwd_library(), _ENTRY[q.dtype], q, "flash attention kernel",
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr(), b, lq, lk, h, hd, *args)
    return out, lse


def _launch_bwd(q, k, v, out, lse, do, plan: Optional[tuple] = None):
    """Runs the backward kernels: (dq, dk, dv). `plan`: the bf16 kernels'
    launches as in LaunchPlan.bwd, launch_plan's by default."""
    if q.dtype not in _BWD_ENTRY:
        raise TypeError(f"q is {q.dtype}; the CUDA kernel takes q, k, v all "
                        f"bfloat16 or all float32")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("do", do)):
        _check_memory(name, x, q, q.dtype)
    _check_memory("lse", lse, q, torch.float32)
    b, lq, lk, h, hd = _dims(q, k)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the bf16 entry's plan: (stages, warps_q, blocks_q, smem_q, warps_k,
    # blocks_k, smem_k), the fused kernel's with stages > 0 and zeros after
    # it, or stages 0, the dq kernel's, then the dk/dv kernel's
    args = ()   # the fp32 twins take no plan
    if q.dtype == torch.bfloat16:
        plan = plan or launch_plan(lq, lk, hd).bwd
        args = ((plan[0].stages, *plan[0][:3], 0, 0, 0) if len(plan) == 1
                else (0, *plan[0][:3], *plan[1][:3]))
    # rowsum(dO * O): written by the dq kernel for the dk/dv kernel (the
    # split scheme and the fp32 twins); the fused kernel keeps it in shared
    # memory and takes a null pointer
    delta = torch.empty_like(lse) if not args or args[0] == 0 else None
    _call(bwd_library(), _BWD_ENTRY[q.dtype], q,
          "flash attention backward kernel",
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
          dv.data_ptr(), None if delta is None else delta.data_ptr(),
          b, lq, lk, h, hd, *args)
    return dq, dk, dv
