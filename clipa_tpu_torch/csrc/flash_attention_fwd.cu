// Tiled flash attention forward for Hopper (sm_90a), bf16 or fp32 in/out
// (one entry point per operand type).
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// clipa_tpu/ops/flash_attention.py (:57, called at :99): exact softmax
// attention with an online row max over key tiles, emitting the per-row
// log-sum-exp for the backward (flash_attention_bwd.cu). Held against the
// plain PyTorch version flash_plain_fwd in ops/flash_attention.py:
//   s   = (q . k) in fp32 from the operands, times scale (on the fp32 scores);
//         keys at or past lk get -1e30 (not -inf: 0 * x stays finite)
//   per 128-key tile: m' = max(m, rowmax(s)), alpha = exp(m - m'),
//         p = exp(s - m'), l = l * alpha + rowsum(p),
//         acc = acc * alpha + bf16(p) . V     (fp32 accumulator)
//   O = acc / l in the operand dtype, LSE = m + log(l) in fp32.
// The key tile is the Pallas block_k (128), so p is rounded to bf16 against
// the same running max as there.
//
// Layout: q/out are (B, Lq, H, hd), k/v (B, Lk, H, hd), contiguous: the flat
// (B*L, D) stream of the towers read in place, head h at columns
// [h*hd, (h+1)*hd) of each row. The TPU kernel's (B*H, hd, L) transposed
// operands existed for its (8, 128) lane tiling and are not carried over.
// LSE is (B, H, Lq) fp32. One block per (64-row q-tile, head, sample), 4
// warps of 16 rows; K and V stream through shared memory in 128-row tiles;
// the score tile, the row statistics and the output accumulator stay in
// registers. Rows past Lq are zero-filled and never written; head-dim
// columns past hd are zero-filled (hd 64, 80, 104, 112 and 128 are the heads
// of L/16, H/14, G/14 and e/14; any multiple of 8 up to 128 is taken).
// Lq and Lk are independent (cross-attention).
//
// What bounds it: at the unmask-tuning shape (ViT-L/16 @224 with mask 0.3:
// B = 128, L = 138, 16 heads of 64) the function needs 10 GFLOP and moves
// 146 MB (q, k, v, o once each): on an H100 SXM (data-sheet rates) device
// memory bounds it (0.044 ms at 3.35 TB/s against 0.010 ms at 989
// TFLOP/s). Each block reads its sample's K/V once per q-tile (3 q-tiles at
// L = 138), from L2 after the first. This first version keeps the loads
// synchronous (no cp.async/TMA pipeline, no wgmma) and idles the warps of a
// ragged last q-tile: that is the known headroom.
//
// fp32 operands run a scalar twin (fp32 FMA, no TF32, nothing rounded):
// 16 query rows per block, 32-key shared-memory tiles, the same online
// softmax. It is written to be right, not fast.

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block, 16 per warp
constexpr int kBlockK = 128;          // keys per tile: the Pallas block_k
constexpr float kNegInf = -1e30f;     // flash_attention.NEG_INF

template <int kHdp>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int lq, int lk, int num_heads, int hd,
                           float scale) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;      // n-tiles of the output product
  constexpr int kSn = kBlockK / 8;   // n-tiles of the score product
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kBlockQ * kStride;
  bf16* sv = sk + kBlockK * kStride;

  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const bf16* qh = q + (size_t)b * lq * ld + (size_t)h * hd;
  const bf16* kh = k + (size_t)b * lk * ld + (size_t)h * hd;
  const bf16* vh = v + (size_t)b * lk * ld + (size_t)h * hd;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // Warps whose 16 rows all lie past Lq only help load tiles.
  const bool active = q0 + warp * 16 < lq;

  load_rows<kHdp, kBlockQ, kThreads>(sq, qh, q0, lq, hd, ld);
  const bf16* sqw = sq + warp * 16 * kStride;

  float acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  // Per thread: rows g and g + 8. The max is quad-reduced per tile, so the
  // four threads of a row agree on it; the sums are partial over this
  // thread's columns until the quad reduction at the end.
  float row_max[2] = {kNegInf, kNegInf};
  float row_sum[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < lk; k0 += kBlockK) {
    __syncthreads();  // sq written; every warp done with the last K/V tile
    load_rows<kHdp, kBlockK, kThreads>(sk, kh, k0, lk, hd, ld);
    load_rows<kHdp, kBlockK, kThreads>(sv, vh, k0, lk, hd, ld);
    __syncthreads();
    if (!active) continue;

    float s[kSn][4];
    warp_scores<kHdp, kSn>(s, sqw, sk);
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kSn; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        s[nt][i] = key < lk ? s[nt][i] * scale : kNegInf;
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
    for (int nt = 0; nt < kSn; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = __expf(s[nt][i] - row_max[i >> 1]);
        row_sum[i >> 1] += s[nt][i];
      }
    }
    // acc += bf16(p) . V: the score fragments of n-tiles 2kk and 2kk + 1
    // are the A fragment of a 16 x 16 product.
    warp_accumulate<kHdp, kSn / 2>(acc, s, sv);
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= lq) continue;
    bf16* o = out + ((size_t)b * lq + row) * ld + (size_t)h * hd;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < hd) {
        *reinterpret_cast<uint32_t*>(o + c) =
            pack_floats(acc[nt][2 * r] / row_sum[r],
                        acc[nt][2 * r + 1] / row_sum[r]);
      }
    }
    if (t == 0) {
      lse[((size_t)b * num_heads + h) * lq + row] =
          row_max[r] + logf(row_sum[r]);
    }
  }
}

template <int kHdp>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
           float* lse, int batch, int lq, int lk, int num_heads, int hd,
           float scale, cudaStream_t stream) {
  const int smem = (kBlockQ + 2 * kBlockK) * (kHdp + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<kHdp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  flash_attention_fwd_kernel<kHdp><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, lq, lk, num_heads, hd, scale);
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
flash_attention_fwd_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out,
                               float* __restrict__ lse, int lq, int lk,
                               int num_heads, int hd, float scale) {
  // +1 on the row strides: the score loop reads sk down a column.
  __shared__ float sq[kF32Rows][kF32MaxHd + 1];
  __shared__ float sk[kF32Keys][kF32MaxHd + 1];
  __shared__ float sv[kF32Keys][kF32MaxHd];
  __shared__ float sp[kF32Rows][kF32Keys + 1];
  __shared__ float row_max[kF32Rows], row_sum[kF32Rows], row_alpha[kF32Rows];

  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const float* qh = q + (size_t)b * lq * ld + (size_t)h * hd;
  const float* kh = k + (size_t)b * lk * ld + (size_t)h * hd;
  const float* vh = v + (size_t)b * lk * ld + (size_t)h * hd;
  const int q0 = blockIdx.x * kF32Rows;
  const int tid = threadIdx.x;

  for (int i = tid; i < kF32Rows * hd; i += kF32Threads) {
    const int r = i / hd, c = i % hd;
    sq[r][c] = q0 + r < lq ? qh[(size_t)(q0 + r) * ld + c] : 0.f;
  }
  if (tid < kF32Rows) {
    row_max[tid] = kNegInf;
    row_sum[tid] = 0.f;
  }
  float acc[kF32PerThread];
#pragma unroll
  for (int i = 0; i < kF32PerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kF32Keys) {
    __syncthreads();  // sq and the row stats written; previous tile consumed
    for (int i = tid; i < kF32Keys * hd; i += kF32Threads) {
      const int r = i / hd, c = i % hd;
      const bool ok = k0 + r < lk;
      sk[r][c] = ok ? kh[(size_t)(k0 + r) * ld + c] : 0.f;
      sv[r][c] = ok ? vh[(size_t)(k0 + r) * ld + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kF32Rows * kF32Keys; i += kF32Threads) {
      const int r = i / kF32Keys, c = i % kF32Keys;
      float s = 0.f;
      for (int j = 0; j < hd; ++j) s = fmaf(sq[r][j], sk[c][j], s);
      sp[r][c] = k0 + c < lk ? s * scale : kNegInf;
    }
    __syncthreads();
    if (tid < kF32Rows) {
      const int r = tid;
      float m_new = row_max[r];
      for (int c = 0; c < kF32Keys; ++c) m_new = fmaxf(m_new, sp[r][c]);
      const float alpha = expf(row_max[r] - m_new);
      float sum = 0.f;
      for (int c = 0; c < kF32Keys; ++c) {
        const float e = expf(sp[r][c] - m_new);
        sp[r][c] = e;
        sum += e;
      }
      row_max[r] = m_new;
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
      if (q0 + r < lq) {
        out[((size_t)b * lq + q0 + r) * ld + (size_t)h * hd + c] =
            acc[i] / row_sum[r];
      }
    }
  }
  if (tid < kF32Rows && q0 + tid < lq) {
    lse[((size_t)b * num_heads + h) * lq + q0 + tid] =
        row_max[tid] + logf(row_sum[tid]);
  }
}

}  // namespace

// q/out: (batch, lq, num_heads, head_dim) bf16, k/v: (batch, lk, num_heads,
// head_dim) bf16, all contiguous and 16-byte aligned; lse: (batch,
// num_heads, lq) fp32. head_dim must be a multiple of 8 and at most 128.
// Returns the cudaError_t of the launch.
extern "C" int clipa_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int batch, int lq, int lk,
                                         int num_heads, int head_dim,
                                         float scale, void* stream) {
  if (bad_shape(batch, lq, num_heads, head_dim) || lk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  bf16* out_ = static_cast<bf16*>(out);
  float* lse_ = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CLIPA_LAUNCH(HDP)                                                  \
  return launch<HDP>(q_, k_, v_, out_, lse_, batch, lq, lk, num_heads,    \
                     head_dim, scale, s)
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

// The fp32 twin: same arguments and limits, fp32 q/k/v/out (4-byte aligned
// suffices).
extern "C" int clipa_flash_attention_fwd_f32(const void* q, const void* k,
                                             const void* v, void* out,
                                             void* lse, int batch, int lq,
                                             int lk, int num_heads,
                                             int head_dim, float scale,
                                             void* stream) {
  if (bad_shape(batch, lq, num_heads, head_dim) || lk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((lq + kF32Rows - 1) / kF32Rows, num_heads, batch);
  flash_attention_fwd_f32_kernel<<<grid, kF32Threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), lq, lk, num_heads, head_dim, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
