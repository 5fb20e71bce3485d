// Fused multi-head self-attention forward for Hopper (sm_90a), bf16 or fp32
// in/out (one entry point per operand type).
//
// Replaces three Pallas TPU kernels of clipa_tpu/ops/block_attention.py with
// one kernel over flat (B*L, D) rows, row i belonging to sample i // L:
//   _fwd_kernel         (:165)  per-sample attention over (B, L, D)
//   _fwd2d_kernel       (:475)  the same over flat rows, no bias
//   _fwd2d_bias_kernel  (:652)  the same with the (D,) q/k/v biases added
//                               inside the kernel (has-bias: non-null bq/bk/bv)
// The TPU kernels' sample groups, VMEM plans and block-diagonal masks exist
// only to suit Mosaic; here each block owns one (sample, head, q-tile), so no
// cross-sample scores are ever computed.
//
// Math (held against the plain PyTorch version in ops/block_attention.py):
//   s = (q . k) in fp32 from bf16 operands, times scale (on the fp32 scores)
//   clip mode : e = exp(clip(s, +-70)), no row max, so E.V and rowsum(E)
//               simply accumulate over key tiles in fp32;
//   exact mode: online row max with rescaling of the running sums;
//   E is rounded to bf16 for the P.V product (fp16 would overflow: e^70 is
//   far above 65504); O = (E.V) / rowsum(E), the division deferred to the
//   (L, hd) output domain, rounded to bf16 once.
//   The bias is added in fp32 and rounded to bf16 once: the same single
//   rounding as the bf16 add round(x@W) + b of the JAX graph.
//
// Layout: block = 4 warps, 64 query rows (16 per warp); keys and values
// stream through shared memory in tiles of 64 rows. Ragged edges are masked:
// CLIPA lengths are odd (L = 257 at 224px, 577 at 336px) and H/14 has
// hd = 80, which is not a power of two. Head dims that are a multiple of 8
// but not of 16 are zero-padded to the next multiple of 16 in shared memory.
// The products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
// fp32 accumulate); Q's fragments stay in registers for the whole key sweep.
//
// What bounds it: at ViT-H/14 @224 (L = 257, D = 1280, 16 heads of 80)
// attention is about 3% of the tower's FLOPs (4*L^2*D per layer against
// about 2*params*L for the GEMMs), and a block re-reads its sample's K/V
// from L2 once per q-tile (5 q-tiles at L = 257). The kernel is bound by
// tensor-core throughput and shared-memory traffic, not by device memory: the
// scores never leave registers. This first version keeps the loads simple
// (no cp.async/TMA double buffering, no wgmma); those are the known headroom.
//
// fp32 operands (the service at precision float32, as the Pallas kernels
// take fp32 operands) run a second, scalar kernel: the same function with
// fp32 FMA for both products, no TF32 and no rounding of E. Block = 128
// threads over 16 query rows; K/V tiles of 32 rows and the 16x32 score tile
// sit in shared memory. It is written to be right, not fast: serving runs
// bf16.

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;           // key rows per shared-memory tile
constexpr float kExpClip = 70.f;      // block_attention._EXP_CLIP

// Copies rows [row0, row0 + 64) of one head's columns into shared memory
// (row stride kHdp + 8), adding the bias in fp32 with one rounding. Rows at
// or past `seq` and columns at or past `hd` are written as zeros.
template <int kHdp>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          const bf16* bias, int row0, int seq,
                                          int hd, int ld) {
  constexpr int kChunks = kHdp / 8;  // 16-byte chunks per row
  constexpr int kStride = kHdp + 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq && c < hd) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
      if (bias != nullptr) {
        const uint4 bval = *reinterpret_cast<const uint4*>(bias + c);
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&val);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&bval);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xf = __bfloat1622float2(x[j]);
          const float2 yf = __bfloat1622float2(y[j]);
          x[j] = __floats2bfloat162_rn(xf.x + yf.x, xf.y + yf.y);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

template <int kHdp>
__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ bq,
                           const bf16* __restrict__ bk,
                           const bf16* __restrict__ bv,
                           bf16* __restrict__ out, int seq, int num_heads,
                           int hd, float scale, int exact) {
  constexpr int kKc = kHdp / 16;  // k-steps of the score product
  constexpr int kNt = kHdp / 8;   // n-tiles of the output product
  constexpr int kStride = kHdp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kBlockQ * kStride;
  bf16* sv = sk + kBlockK * kStride;

  const int h = blockIdx.y;
  const int d_model = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * d_model + (size_t)h * hd;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t = lane & 3;   // column pair within the fragment
  // Warps whose 16 rows all lie past the sequence end only help load tiles.
  const bool active = q0 + warp * 16 < seq;

  load_tile<kHdp>(sq, q + base, bq ? bq + h * hd : nullptr, q0, seq, hd,
                  d_model);
  __syncthreads();

  uint32_t qf[kKc][4];
  {
    const bf16* qw = sq + warp * 16 * kStride;
#pragma unroll
    for (int kc = 0; kc < kKc; ++kc) {
      const int c = kc * 16 + 2 * t;
      qf[kc][0] = load_u32(qw + g * kStride + c);
      qf[kc][1] = load_u32(qw + (g + 8) * kStride + c);
      qf[kc][2] = load_u32(qw + g * kStride + c + 8);
      qf[kc][3] = load_u32(qw + (g + 8) * kStride + c + 8);
    }
  }

  float acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  // Per thread: rows g and g + 8; sums over this thread's columns only until
  // the quad reduction at the end. The max is quad-reduced per tile.
  float row_sum[2] = {0.f, 0.f};
  float row_max[2] = {-INFINITY, -INFINITY};

  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<kHdp>(sk, k + base, bk ? bk + h * hd : nullptr, k0, seq, hd,
                    d_model);
    load_tile<kHdp>(sv, v + base, bv ? bv + h * hd : nullptr, k0, seq, hd,
                    d_model);
    __syncthreads();
    if (!active) continue;

    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
        const bf16* kr = sk + (nt * 8 + g) * kStride + kc * 16 + 2 * t;
        mma_16816(s[nt], qf[kc], load_u32(kr), load_u32(kr + 8));
      }
    }

    // Element i of tile nt: row g + 8 * (i >> 1), key k0 + nt*8 + 2t + (i & 1).
    if (exact) {
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          s[nt][i] = key < seq ? s[nt][i] * scale : -INFINITY;
          tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[nt][i]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r],
                            __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r],
                            __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
        const float m_new = fmaxf(row_max[r], tile_max[r]);
        const float alpha = __expf(row_max[r] - m_new);
        row_max[r] = m_new;
        row_sum[r] *= alpha;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          acc[nt][2 * r] *= alpha;
          acc[nt][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt][i] = __expf(s[nt][i] - row_max[i >> 1]);
          row_sum[i >> 1] += s[nt][i];
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          const float x = fminf(fmaxf(s[nt][i] * scale, -kExpClip), kExpClip);
          s[nt][i] = key < seq ? __expf(x) : 0.f;
          row_sum[i >> 1] += s[nt][i];
        }
      }
    }

    // O += E.V: the score accumulators of key tiles 2kk and 2kk+1 are
    // exactly the A fragment of a 16x16 product (rows g/g+8, keys 2t..).
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = sv + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const bf16* p = vr + nt * 8;
        const uint32_t b0 = pack_bf16(p[0], p[kStride]);
        const uint32_t b1 = pack_bf16(p[8 * kStride], p[9 * kStride]);
        mma_16816(acc[nt], a, b0, b1);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= seq) continue;
    bf16* o = out + base + (size_t)row * d_model;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < hd) {
        *reinterpret_cast<uint32_t*>(o + c) =
            pack_floats(acc[nt][2 * r] / row_sum[r],
                        acc[nt][2 * r + 1] / row_sum[r]);
      }
    }
  }
}

template <int kHdp>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* bq,
           const bf16* bk, const bf16* bv, bf16* out, int batch, int seq,
           int num_heads, int hd, float scale, int exact,
           cudaStream_t stream) {
  const int smem = (kBlockQ + 2 * kBlockK) * (kHdp + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_fwd_kernel<kHdp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  fused_attention_fwd_kernel<kHdp><<<grid, kThreads, smem, stream>>>(
      q, k, v, bq, bk, bv, out, seq, num_heads, hd, scale, exact);
  return (int)cudaGetLastError();
}

constexpr int kF32Threads = 128;
constexpr int kF32Rows = 16;    // query rows per block
constexpr int kF32Keys = 32;    // key rows per shared-memory tile
constexpr int kF32MaxHd = 128;
constexpr int kF32PerThread = kF32Rows * kF32MaxHd / kF32Threads;

// The same function on fp32 operands, scalar FMA throughout. Thread i owns
// outputs i, i + 128, ... of the block's (16, hd) output tile.
__global__ void __launch_bounds__(kF32Threads)
fused_attention_fwd_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ bq,
                               const float* __restrict__ bk,
                               const float* __restrict__ bv,
                               float* __restrict__ out, int seq,
                               int num_heads, int hd, float scale,
                               int exact) {
  // +1 on the row strides: the score loop reads sk down a column.
  __shared__ float sq[kF32Rows][kF32MaxHd + 1];
  __shared__ float sk[kF32Keys][kF32MaxHd + 1];
  __shared__ float sv[kF32Keys][kF32MaxHd];
  __shared__ float sp[kF32Rows][kF32Keys + 1];
  __shared__ float row_max[kF32Rows], row_sum[kF32Rows], row_alpha[kF32Rows];

  const int h = blockIdx.y;
  const int d_model = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * d_model + (size_t)h * hd;
  const int q0 = blockIdx.x * kF32Rows;
  const int tid = threadIdx.x;
  const float* bqh = bq ? bq + h * hd : nullptr;
  const float* bkh = bk ? bk + h * hd : nullptr;
  const float* bvh = bv ? bv + h * hd : nullptr;

  for (int i = tid; i < kF32Rows * hd; i += kF32Threads) {
    const int r = i / hd, c = i % hd;
    float x = 0.f;
    if (q0 + r < seq) {
      x = q[base + (size_t)(q0 + r) * d_model + c];
      if (bqh) x += bqh[c];
    }
    sq[r][c] = x;
  }
  if (tid < kF32Rows) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.f;
  }
  float acc[kF32PerThread];
#pragma unroll
  for (int i = 0; i < kF32PerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kF32Keys) {
    __syncthreads();  // sq and the row stats written; previous tile consumed
    for (int i = tid; i < kF32Keys * hd; i += kF32Threads) {
      const int r = i / hd, c = i % hd;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < seq) {
        const size_t at = base + (size_t)(k0 + r) * d_model + c;
        kx = k[at];
        vx = v[at];
        if (bkh) kx += bkh[c];
        if (bvh) vx += bvh[c];
      }
      sk[r][c] = kx;
      sv[r][c] = vx;
    }
    __syncthreads();
    for (int i = tid; i < kF32Rows * kF32Keys; i += kF32Threads) {
      const int r = i / kF32Keys, c = i % kF32Keys;
      float s = 0.f;
      for (int j = 0; j < hd; ++j) s = fmaf(sq[r][j], sk[c][j], s);
      sp[r][c] = s * scale;
    }
    __syncthreads();
    if (tid < kF32Rows) {
      const int r = tid;
      const int n = min(kF32Keys, seq - k0);
      float m = row_max[r], alpha = 1.f;
      if (exact) {
        float m_new = m;
        for (int c = 0; c < n; ++c) m_new = fmaxf(m_new, sp[r][c]);
        alpha = expf(m - m_new);
        m = m_new;
        row_max[r] = m;
      }
      float sum = 0.f;
      for (int c = 0; c < kF32Keys; ++c) {
        const float s = sp[r][c];
        const float e =
            c >= n ? 0.f
                   : expf(exact ? s - m
                                : fminf(fmaxf(s, -kExpClip), kExpClip));
        sp[r][c] = e;
        sum += e;
      }
      row_sum[r] = row_sum[r] * alpha + sum;
      row_alpha[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32PerThread; ++i) {
      const int j = tid + i * kF32Threads;
      if (j < kF32Rows * hd) {
        const int r = j / hd, c = j % hd;
        float a = acc[i] * row_alpha[r];
        for (int key = 0; key < kF32Keys; ++key) {
          a = fmaf(sp[r][key], sv[key][c], a);
        }
        acc[i] = a;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kF32PerThread; ++i) {
    const int j = tid + i * kF32Threads;
    if (j < kF32Rows * hd) {
      const int r = j / hd, c = j % hd;
      if (q0 + r < seq) {
        out[base + (size_t)(q0 + r) * d_model + c] = acc[i] / row_sum[r];
      }
    }
  }
}

}  // namespace

// The fp32 twin of clipa_fused_attention_fwd: same arguments and limits,
// fp32 tensors (4-byte aligned suffices).
extern "C" int clipa_fused_attention_fwd_f32(const void* q, const void* k,
                                             const void* v, const void* bq,
                                             const void* bk, const void* bv,
                                             void* out, int batch, int seq,
                                             int num_heads, int head_dim,
                                             float scale, int exact,
                                             void* stream) {
  if (bad_shape(batch, seq, num_heads, head_dim)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((seq + kF32Rows - 1) / kF32Rows, num_heads, batch);
  fused_attention_fwd_f32_kernel<<<grid, kF32Threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bq),
      static_cast<const float*>(bk), static_cast<const float*>(bv),
      static_cast<float*>(out), seq, num_heads, head_dim, scale, exact);
  return (int)cudaGetLastError();
}

// q/k/v/out: (batch * seq, num_heads * head_dim) bf16, contiguous, 16-byte
// aligned; bq/bk/bv: (num_heads * head_dim,) bf16 or all null. head_dim must
// be a multiple of 8 and at most 128. Returns the cudaError_t of the launch.
extern "C" int clipa_fused_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* bq,
                                         const void* bk, const void* bv,
                                         void* out, int batch, int seq,
                                         int num_heads, int head_dim,
                                         float scale, int exact,
                                         void* stream) {
  if (bad_shape(batch, seq, num_heads, head_dim)) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* bq_ = static_cast<const bf16*>(bq);
  const bf16* bk_ = static_cast<const bf16*>(bk);
  const bf16* bv_ = static_cast<const bf16*>(bv);
  bf16* out_ = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CLIPA_LAUNCH(HDP)                                                    \
  return launch<HDP>(q_, k_, v_, bq_, bk_, bv_, out_, batch, seq, num_heads, \
                     head_dim, scale, exact, s)
  switch ((head_dim + 15) / 16 * 16) {
    case 16: CLIPA_LAUNCH(16);
    case 32: CLIPA_LAUNCH(32);
    case 48: CLIPA_LAUNCH(48);
    case 64: CLIPA_LAUNCH(64);
    case 80: CLIPA_LAUNCH(80);
    case 96: CLIPA_LAUNCH(96);
    case 112: CLIPA_LAUNCH(112);
    case 128: CLIPA_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CLIPA_LAUNCH
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
