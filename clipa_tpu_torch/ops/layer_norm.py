"""LayerNorm of a bf16 tensor over its last dimension with fp32 gain and
bias, one CUDA pass each way.

``csrc/layer_norm.cu`` replaces no Pallas kernel: the JAX package leaves
LayerNorm to XLA's fusion (``clipa_tpu/models/layers.py:276,293``). The
port's ``models/layers.LayerNorm`` computes flax's semantics, statistics
and affine in fp32, as a chain of three PyTorch kernels each way (the input
cast to fp32, the fp32 ``layer_norm``, the output cast back), about 20
bytes of traffic per element. The op is bound by bytes, so the kernels read
the bf16 row once, hold it and its statistics in fp32 registers and write
bf16 once: 4 bytes per element forward, 6 backward, where the composition
also saved an fp32 copy of every input for its backward. The source's
header gives the design.

:func:`layer_norm` is the entry: differentiable, it launches the kernels
and raises on operands they do not take (:func:`takes` says which).
``layers.LayerNorm`` asks :func:`takes` once a call and hands the operands
it passes to :func:`run`; every other input takes the cast chain, so the
CPU tests keep holding the chain against the JAX package. The plain
version (:func:`layer_norm_plain`, :func:`layer_norm_plain_bwd`) repeats
the kernels' arithmetic in PyTorch, the reference of the tests and of
``tools/layer_norm_bench.py``: two-pass statistics and the closed-form
backward in fp32 (float64 for a float64 input), one rounding to the
input's dtype.

The forward saves the bf16 input and the fp32 mean and rstd (8 bytes a
row). Under remat "minimal" the kernel is no 2-D product, so it is
recomputed in the backward; the counter counts that as a forward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from clipa_tpu_torch.ops import cuda_build

_SOURCE = "layer_norm.cu"
_FWD = "clipa_layer_norm_fwd"
_BWD = "clipa_layer_norm_bwd"
_OCCUPANCY = "clipa_layer_norm_bwd_occupancy"

# csrc/layer_norm.cu: 8 bf16 per 16-byte access; widths up to kMaxWidth
VEC = 8
MAX_WIDTH = 8192

# (device index, width) -> the backward's (most blocks: SMs x resident
# blocks, rows a block takes at a time)
_grid: dict = {}


def takes(x: torch.Tensor, weight, bias) -> bool:
    """Whether the kernels take these operands: a bf16 CUDA `x` whose last
    dimension is a multiple of 8 up to :data:`MAX_WIDTH`, with fp32 `weight`
    and `bias` of that width on its device. ``layers.LayerNorm`` asks once
    a call and then hands its parameters to :func:`run`: whole tensors of
    their own, so contiguous and aligned as the kernels read them."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and x.dim()
            and weight is not None and bias is not None):
        return False
    d = x.shape[-1]
    return (0 < d <= MAX_WIDTH and d % VEC == 0
            and weight.dtype == torch.float32 and bias.dtype == torch.float32
            and weight.shape == bias.shape == x.shape[-1:]
            and weight.get_device() == bias.get_device() == x.get_device())


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous rows at a 16-byte aligned address (a copy only where
    it is not)."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' library, built at first use: the forward (x, gamma,
    beta, y, mean, rstd, rows, d, eps, stream), the backward (x, dy, mean,
    rstd, gamma, dx, partial, dgamma, dbeta, rows, d, parts, stream) and the
    backward's layout (d, &blocks per SM, &rows per block)."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib = cuda_build.load_entries(
        _SOURCE, [_FWD], [ptr] * 6 + [i64, i32, ctypes.c_float, ptr])
    bwd = getattr(lib, _BWD)
    if bwd.argtypes is None:
        bwd.restype = getattr(lib, _OCCUPANCY).restype = ctypes.c_int
        bwd.argtypes = [ptr] * 9 + [i64, i32, i32, ptr]
        getattr(lib, _OCCUPANCY).argtypes = [i32, ctypes.POINTER(i32),
                                             ctypes.POINTER(i32)]
    return lib


def _launch(x: torch.Tensor, entry: str, *args) -> None:
    """Calls the library's `entry` with `args` and the current stream of
    x's device, that device selected; raises on the error it returns."""
    lib = library()
    dev = x.get_device()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args,
                                  torch._C._cuda_getCurrentRawStream(dev))
    cuda_build.raise_on(err, lib, entry)


def _forward(x, weight, bias, eps: float, stats: bool):
    """The forward kernel on contiguous aligned rows: (y, stats) with stats
    the fp32 (2, rows) mean and rstd, or None unless `stats`."""
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    st = x.new_empty((2, rows), dtype=torch.float32) if stats else None
    if rows:
        mean = rstd = None
        if stats:
            mean = st.data_ptr()
            rstd = mean + rows * 4
        _launch(x, _FWD, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                y.data_ptr(), mean, rstd, rows, d, eps)
        layer_norm.launches["forward"] += 1
    return y, st


def _bwd_grid(device: int, d: int, rows: int) -> int:
    """The backward's blocks for `rows` rows of width d: one wave, as many
    as the card holds at once, fewer where the rows run out first."""
    key = (device, d)
    if key not in _grid:
        lib = library()
        blocks, per_block = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = getattr(lib, _OCCUPANCY)(d, ctypes.byref(blocks),
                                           ctypes.byref(per_block))
        cuda_build.raise_on(err, lib, "layer_norm occupancy query")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _grid[key] = (sms * max(blocks.value, 1), per_block.value)
    most, per_block = _grid[key]
    return min(most, -(-rows // per_block))


def _backward(x, dy, st, weight):
    """The backward kernels on contiguous aligned rows x and dy (autograd
    hands a dy of x's dtype and shape): (dx, dweight, dbias)."""
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if not rows:
        return (dx, *x.new_zeros((2, d), dtype=torch.float32))
    grads = x.new_empty((2, d), dtype=torch.float32)
    parts = _bwd_grid(x.get_device(), d, rows)
    partial = x.new_empty((parts, 2, d), dtype=torch.float32)
    mean, dweight = st.data_ptr(), grads.data_ptr()
    _launch(x, _BWD, x.data_ptr(), dy.data_ptr(), mean, mean + rows * 4,
            weight.data_ptr(), dx.data_ptr(), partial.data_ptr(), dweight,
            dweight + d * 4, rows, d, parts)
    layer_norm.launches["backward"] += 1
    return (dx, *grads)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float):
    """The kernels' forward in PyTorch: (y, stats), y in x's dtype and
    stats the (2, *x.shape[:-1]) mean and rstd, in fp32 (float64 for a
    float64 x)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean = xf.mean(-1)
    e = xf - mean[..., None]
    rstd = torch.rsqrt((e * e).mean(-1) + eps)
    y = e * rstd[..., None] * weight.to(acc) + bias.to(acc)
    return y.to(x.dtype), torch.stack([mean, rstd])


def layer_norm_plain_bwd(x: torch.Tensor, dy: torch.Tensor,
                         stats: torch.Tensor, weight: torch.Tensor):
    """The kernels' backward in PyTorch: (dx in x's dtype, dweight, dbias
    in the statistics' dtype)."""
    acc = stats.dtype
    mean, rstd = stats[0][..., None], stats[1][..., None]
    xh = (x.to(acc) - mean) * rstd
    dyf = dy.to(acc)
    g = dyf * weight.to(acc)
    dx = rstd * (g - g.mean(-1, keepdim=True)
                 - xh * (g * xh).mean(-1, keepdim=True))
    d = x.shape[-1]
    return (dx.to(x.dtype), (dyf * xh).reshape(-1, d).sum(0),
            dyf.reshape(-1, d).sum(0))


class LayerNormFn(torch.autograd.Function):
    """The kernels for autograd. Saves x (as contiguous rows), weight and
    the fp32 mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x = _rows(x)
        y, stats = _forward(x, weight, bias, eps, stats=True)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        return (*_backward(x, _rows(dy), stats, weight), None)


def run(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
        eps: float) -> torch.Tensor:
    """The kernels on operands :func:`takes` has passed, with contiguous
    aligned `weight` and `bias`: through :class:`LayerNormFn` where
    autograd wants a gradient, else the forward alone, writing no
    statistics."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFn.apply(x, weight, bias, eps)
    return _forward(_rows(x), weight, bias, eps, stats=False)[0]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over x's last dimension with `weight` and `bias` by the
    kernels, differentiable in all three; raises on operands
    :func:`takes` refuses."""
    if not takes(x, weight, bias):
        raise ValueError(
            f"layer_norm kernels take a bf16 CUDA x whose last dimension is "
            f"a multiple of {VEC} up to {MAX_WIDTH}, and fp32 weight and "
            f"bias of that width on its device; got x {_desc(x)}, weight "
            f"{_desc(weight)}, bias {_desc(bias)}")
    return run(x, _rows(weight), _rows(bias), eps)


def _desc(t) -> str:
    return "None" if t is None else f"{t.dtype} {tuple(t.shape)} on {t.device}"


# Kernel launches by phase (plain counters: callers reset them to 0 and read
# them back to prove a run went through the kernels). A remat recompute is a
# "forward"; a "backward" is one call of the backward entry (two launches:
# the rows' pass and the parameter gradients' sum).
layer_norm.launches = {"forward": 0, "backward": 0}
