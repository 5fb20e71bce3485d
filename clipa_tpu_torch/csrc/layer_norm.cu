// LayerNorm over the last dimension of a bf16 row stream with fp32 gain and
// bias, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA, which
// fuses its statistics and affine into the neighbouring loops
// (clipa_tpu/models/layers.py:276,293, flax nn.LayerNorm). The port ran it
// as three PyTorch kernels each way: a cast of the bf16 input to fp32, the
// fp32 layer_norm, a cast of the output back (and in the backward a cast of
// the gradient up, the fp32 layer_norm backward, a cast down), some 20
// bytes of traffic per element where 4 do. This source computes the same
// function with the same arithmetic in fp32 and one rounding to bf16 at the
// same place:
//
//   forward    mean = sum(x) / d,  var = sum((x - mean)^2) / d,
//              rstd = rsqrt(var + eps),
//              y = (x - mean) rstd gamma + beta           (rounded once)
//   backward   xh = (x - mean) rstd,  g = dy gamma,
//              dx = rstd (g - sum(g) / d - xh sum(g xh) / d)   (rounded once)
//              dgamma = sum over rows of dy xh,  dbeta = sum over rows of dy
//
// Bytes bound it: a few flops per element against 4 bytes (forward: x read,
// y written) or 6 (backward: x and dy read, dx written) is far below the
// card's ratio of some 295 flops per byte, so the design moves each byte of
// the row stream once. A row (at most 8192 wide) lives in registers as fp32
// from its load to its store: the forward reads it once with 16-byte loads
// (8 bf16 a thread a step, all of a thread's loads issued before the first
// use), takes the mean and then the variance by two passes over the
// registers (no E[x^2] - E[x]^2 cancellation), writes y with 16-byte stores
// and, where the caller asks, the row's fp32 mean and rstd (8 bytes a row)
// for the backward. One warp holds a row up to a width of 2048 (8 steps of
// 256 elements), four rows to a block of 128 threads; past that one block
// holds a row, its warps' sums added in shared memory. The backward reads
// x, dy and the row's statistics once in the same layout, reduces sum(g)
// and sum(g xh) across the row, writes dx, and keeps each thread's columns
// of dgamma and dbeta in fp32 registers over the rows it visits: a grid of
// as many blocks as the card holds at once walks over the rows, each block
// adds its warps' column sums in warp order and writes one partial row
// pair, and a second small launch adds the partials in a fixed order. So
// the gradients are bit-identical from run to run on one card (the grid
// follows the card's SM count and the kernel's occupancy), and the extra
// traffic is the partials, blocks x 2 x d x 4 bytes (4 MB at d = 1280 on an
// H100), against the row stream's hundreds of MB.
//
// The mean and variance sums run in another order than PyTorch's Welford
// loop, and the rsqrt is rsqrtf as PyTorch's; the numbers are the cast
// chain's up to the order of those sums (tests/test_torch_cuda.py: the
// output within one bf16 ulp, dx within one ulp of its scale, dgamma and
// dbeta within 1e-5). Kernel names hold "layer_norm" and no name of another
// family of perfbench/trace.py.
//
// The wrapper (ops/layer_norm.py) hands in contiguous rows whose pointers,
// like gamma's and beta's, are 16-byte aligned, and a width d that is a
// multiple of 8 and at most kMaxWidth; the entry points refuse any other d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;            // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                  // bf16 per 16-byte access
constexpr int kMaxSteps = 8;             // 16-byte accesses a thread a row
constexpr int kWarpWidth = 32 * kVec * kMaxSteps;         // 2048
constexpr int kMaxWidth = kThreads * kVec * kMaxSteps;    // 8192

template <int K_, int TPR_>
struct Shape {
  static constexpr int K = K_;      // 16-byte steps a thread takes a row
  static constexpr int TPR = TPR_;  // threads that hold one row
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[kVec]) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 u;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  return u;
}

__device__ __forceinline__ void load8(const float* p, float (&f)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// The sum of v over the TPR threads that hold one row, the same value in
// each of them: xor-shuffles within a warp (every lane ends with the same
// bits, since IEEE addition commutes), then, for a row over several warps,
// the warps' sums from shared memory in warp order. Every thread of the
// block calls it.
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (TPR == 32) {
    return v;
  } else {
    constexpr int kPerRow = TPR / 32;
    const int warp = threadIdx.x / 32;
    const int first = warp / kPerRow * kPerRow;
    __syncthreads();                  // the previous sum's reads are done
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kPerRow; ++w) s += red[first + w];
    return s;
  }
}

// One row per TPR threads, kThreads / TPR rows a block; stats (mean, rstd)
// written where mean_out is not null.
template <int K, int TPR>
__global__ void __launch_bounds__(kThreads) layer_norm_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, __nv_bfloat16* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int64_t rows,
    int d, float eps) {
  __shared__ float red[kWarps];
  constexpr int kRows = kThreads / TPR;
  const int t = threadIdx.x % TPR;
  const int64_t row = (int64_t)blockIdx.x * kRows + threadIdx.x / TPR;
  const bool live = row < rows;
  const int steps = d / kVec;
  const auto* xr = reinterpret_cast<const uint4*>(x + row * d);

  uint4 raw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = k * TPR + t;
    raw[k] = (live && c < steps) ? xr[c] : make_uint4(0, 0, 0, 0);
  }
  float v[K][kVec];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    unpack(raw[k], v[k]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) sum += v[k][i];
  }
  const float mean = row_sum<TPR>(sum, red) / d;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k * TPR + t < steps) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float e = v[k][i] - mean;
        sq += e * e;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<TPR>(sq, red) / d + eps);
  if (!live) return;

  auto* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = k * TPR + t;
    if (c < steps) {
      float g[kVec], b[kVec], o[kVec];
      load8(gamma + c * kVec, g);
      load8(beta + c * kVec, b);
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = (v[k][i] - mean) * rstd * g[i] + b[i];
      yr[c] = pack(o);
    }
  }
  if (t == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// The row layout of the forward; the grid (gridDim.x blocks) walks over the
// rows kThreads / TPR at a time. partial: per block, d floats of dgamma then
// d of dbeta (the block's rows' sums; with several rows a block, the row
// slots' sums added in slot order through `cols`, 2 d floats of dynamic
// shared memory).
template <int K, int TPR>
__global__ void __launch_bounds__(kThreads) layer_norm_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const float* __restrict__ gamma, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ partial, int64_t rows, int d) {
  __shared__ float red[kWarps];
  extern __shared__ float cols[];
  constexpr int kRows = kThreads / TPR;
  const int t = threadIdx.x % TPR;
  const int slot = threadIdx.x / TPR;
  const int steps = d / kVec;
  const float inv_d = 1.f / d;

  float dg[K][kVec], db[K][kVec];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) dg[k][i] = db[k][i] = 0.f;
  }

  // the loop's bound depends on the block alone: row_sum's barriers are
  // reached by every thread
  for (int64_t base = (int64_t)blockIdx.x * kRows; base < rows;
       base += (int64_t)gridDim.x * kRows) {
    const int64_t row = base + slot;
    const bool live = row < rows;
    const auto* xr = reinterpret_cast<const uint4*>(x + row * d);
    const auto* gr = reinterpret_cast<const uint4*>(dy + row * d);
    uint4 xs[K], gs[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * TPR + t;
      const bool in = live && c < steps;
      xs[k] = in ? xr[c] : make_uint4(0, 0, 0, 0);
      gs[k] = in ? gr[c] : make_uint4(0, 0, 0, 0);
    }
    const float mu = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    // a dead row or padding step holds dy = 0: it adds nothing below
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * TPR + t;
      if (c < steps) {
        float xf[kVec], gf[kVec], gm[kVec];
        unpack(xs[k], xf);
        unpack(gs[k], gf);
        load8(gamma + c * kVec, gm);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float xh = (xf[i] - mu) * rs;
          const float g = gf[i] * gm[i];
          s1 += g;
          s2 += g * xh;
          dg[k][i] += gf[i] * xh;
          db[k][i] += gf[i];
        }
      }
    }
    const float a = row_sum<TPR>(s1, red) * inv_d;
    const float b = row_sum<TPR>(s2, red) * inv_d;
    if (live) {
      auto* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = k * TPR + t;
        if (c < steps) {
          float xf[kVec], gf[kVec], gm[kVec], o[kVec];
          unpack(xs[k], xf);
          unpack(gs[k], gf);
          load8(gamma + c * kVec, gm);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float xh = (xf[i] - mu) * rs;
            o[i] = rs * (gf[i] * gm[i] - a - xh * b);
          }
          dxr[c] = pack(o);
        }
      }
    }
  }

  float* out = partial + (int64_t)blockIdx.x * 2 * d;
  if constexpr (kRows == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = k * TPR + t;
      if (c < steps) {
        store8(out + c * kVec, dg[k]);
        store8(out + d + c * kVec, db[k]);
      }
    }
  } else {
    for (int s = 0; s < kRows; ++s) {
      if (slot == s) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = k * TPR + t;
          if (c < steps) {
#pragma unroll
            for (int i = 0; i < kVec; ++i) {
              const int j = c * kVec + i;
              cols[j] = s ? cols[j] + dg[k][i] : dg[k][i];
              cols[d + j] = s ? cols[d + j] + db[k][i] : db[k][i];
            }
          }
        }
      }
      __syncthreads();
    }
    for (int j = threadIdx.x; j < 2 * d; j += kThreads) out[j] = cols[j];
  }
}

// dgamma and dbeta from the `parts` partial row pairs, each column by a
// 32 x 32 block: thread (x, y) adds the partials y, y + 32, ... in order,
// then thread (x, 0) adds the 32 sums in order.
__global__ void __launch_bounds__(1024) layer_norm_param_grad_kernel(
    const float* __restrict__ partial, int parts, int d,
    float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float sums[2][32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float g = 0.f, b = 0.f;
  if (col < d) {
    for (int p = threadIdx.y; p < parts; p += 32) {
      g += partial[(int64_t)p * 2 * d + col];
      b += partial[(int64_t)p * 2 * d + d + col];
    }
  }
  sums[0][threadIdx.y][threadIdx.x] = g;
  sums[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float tg = 0.f, tb = 0.f;
    for (int j = 0; j < 32; ++j) {
      tg += sums[0][j][threadIdx.x];
      tb += sums[1][j][threadIdx.x];
    }
    dgamma[col] = tg;
    dbeta[col] = tb;
  }
}

// Calls fn(Shape<K, TPR>{}) for the layout of width d: one warp a row up to
// kWarpWidth, one block a row past it; cudaErrorInvalidValue for a width
// the kernels do not take.
template <typename Fn>
cudaError_t with_shape(int d, Fn&& fn) {
  if (d <= 0 || d % kVec != 0 || d > kMaxWidth) return cudaErrorInvalidValue;
  if (d <= kWarpWidth) {
    switch ((d + 32 * kVec - 1) / (32 * kVec)) {
      case 1: return fn(Shape<1, 32>{});
      case 2: return fn(Shape<2, 32>{});
      case 3: return fn(Shape<3, 32>{});
      case 4: return fn(Shape<4, 32>{});
      case 5: return fn(Shape<5, 32>{});
      case 6: return fn(Shape<6, 32>{});
      case 7: return fn(Shape<7, 32>{});
      default: return fn(Shape<8, 32>{});
    }
  }
  switch ((d + kThreads * kVec - 1) / (kThreads * kVec)) {
    case 3: return fn(Shape<3, kThreads>{});
    case 4: return fn(Shape<4, kThreads>{});
    case 5: return fn(Shape<5, kThreads>{});
    case 6: return fn(Shape<6, kThreads>{});
    case 7: return fn(Shape<7, kThreads>{});
    default: return fn(Shape<8, kThreads>{});
  }
}

template <int TPR>
constexpr size_t bwd_smem(int d) {
  return TPR < kThreads ? 2 * (size_t)d * sizeof(float) : 0;
}

}  // namespace

// y = LayerNorm(x) over rows x d (bf16 x and y, fp32 gamma and beta); mean
// and rstd (fp32, one per row) written unless mean is null. On `stream`;
// returns the launch's cudaError_t (cudaErrorInvalidValue for a width or
// row count it refuses).
extern "C" int clipa_layer_norm_fwd(const void* x, const void* gamma,
                                    const void* beta, void* y, void* mean,
                                    void* rstd, int64_t rows, int d, float eps,
                                    void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_shape(d, [&](auto s) {
    using S = decltype(s);
    constexpr int kRows = kThreads / S::TPR;
    const int64_t blocks = (rows + kRows - 1) / kRows;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    layer_norm_fwd_kernel<S::K, S::TPR><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, eps);
    return cudaGetLastError();
  });
}

// The backward of clipa_layer_norm_fwd: dx (bf16, rows x d), dgamma and
// dbeta (fp32, d each), from x, dy (bf16) and the forward's mean and rstd.
// partial: parts x 2 x d fp32 scratch, parts the backward's grid (at most
// the card's SMs times clipa_layer_norm_bwd_occupancy's blocks, for one
// wave). Two launches on `stream`; returns the first failure's
// cudaError_t.
extern "C" int clipa_layer_norm_bwd(const void* x, const void* dy,
                                    const void* mean, const void* rstd,
                                    const void* gamma, void* dx,
                                    void* partial, void* dgamma, void* dbeta,
                                    int64_t rows, int d, int parts,
                                    void* stream) {
  if (rows <= 0 || parts <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_shape(d, [&](auto s) {
    using S = decltype(s);
    layer_norm_bwd_kernel<S::K, S::TPR>
        <<<parts, kThreads, bwd_smem<S::TPR>(d), st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(dy),
            static_cast<const float*>(mean), static_cast<const float*>(rstd),
            static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(dx),
            static_cast<float*>(partial), rows, d);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  layer_norm_param_grad_kernel<<<(d + 31) / 32, dim3(32, 32), 0, st>>>(
      static_cast<const float*>(partial), parts, d,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}

// The backward kernel's layout at width d: its resident blocks per SM and
// the rows a block takes at a time (the wrapper's grid is the blocks per SM
// times the SM count, capped by the rows over the rows a block takes).
extern "C" int clipa_layer_norm_bwd_occupancy(int d, int* blocks,
                                              int* rows_per_block) {
  return (int)with_shape(d, [&](auto s) {
    using S = decltype(s);
    *rows_per_block = kThreads / S::TPR;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, layer_norm_bwd_kernel<S::K, S::TPR>, kThreads,
        bwd_smem<S::TPR>(d));
  });
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
