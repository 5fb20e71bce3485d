// Tensor-core fragment helpers shared by the attention kernels of this
// directory (fused_attention_{fwd,bwd}.cu, flash_attention_{fwd,bwd}.cu).
//
// Products run through mma.sync m16n8k16 (bf16 in, fp32 accumulate): one warp
// owns 16 rows of a tile. In an accumulator fragment float d[4] of a 16 x 8
// tile, lane (g = lane / 4, t = lane % 4) holds element i at row
// g + 8 * (i >> 1), column 2t + (i & 1). Shared-memory tiles are row-major
// bf16 with a row stride of kHdp + 8 elements (kHdp: the head dim rounded up
// to 16; the 8-element skew spreads a column's rows over the banks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A.B for one 16x8x16 tile: A 16x16 row-major, B 16x8 column-major.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] (16 x 8 per n-tile, kN n-tiles) = A . B^T: A the warp's 16 rows
// at `a_rows`, B the 8 * kN rows at `b_rows`, contracted over the head dim.
template <int kHdp, int kN>
__device__ __forceinline__ void warp_scores(float acc[kN][4],
                                            const bf16* a_rows,
                                            const bf16* b_rows) {
  constexpr int kStride = kHdp + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < kHdp / 16; ++kc) {
    const bf16* ar = a_rows + g * kStride + kc * 16 + 2 * t;
    uint32_t a[4];
    a[0] = load_u32(ar);
    a[1] = load_u32(ar + 8 * kStride);
    a[2] = load_u32(ar + 8);
    a[3] = load_u32(ar + 8 * kStride + 8);
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
      const bf16* br = b_rows + (nt * 8 + g) * kStride + kc * 16 + 2 * t;
      mma_16816(acc[nt], a, load_u32(br), load_u32(br + 8));
    }
  }
}

// out[nt] += X . M: X the warp's 16 x (16 * kK) fp32 tile `x` (the layout
// of warp_scores with kN = 2 * kK, rounded to bf16 here), M the 16 * kK
// rows at `m_rows`, contracted over those rows.
template <int kHdp, int kK>
__device__ __forceinline__ void warp_accumulate(float out[kHdp / 8][4],
                                                float x[2 * kK][4],
                                                const bf16* m_rows) {
  constexpr int kStride = kHdp + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    uint32_t a[4];
    a[0] = pack_floats(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_floats(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_floats(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_floats(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const bf16* mr = m_rows + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
    for (int nt = 0; nt < kHdp / 8; ++nt) {
      const bf16* p = mr + nt * 8;
      const uint32_t b0 = pack_bf16(p[0], p[kStride]);
      const uint32_t b1 = pack_bf16(p[8 * kStride], p[9 * kStride]);
      mma_16816(out[nt], a, b0, b1);
    }
  }
}

// Copies rows [row0, row0 + kRows) of one head into shared memory (row
// stride kHdp + 8): `src` points at the head's first column of row 0, rows
// are `ld` elements apart. Rows at or past `len` and columns at or past `hd`
// are written as zeros, so no uninitialised value enters a product (0 * NaN
// would poison a sum).
template <int kHdp, int kRows, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int len, int hd,
                                          int ld) {
  constexpr int kChunks = kHdp / 8;  // 16-byte chunks per row
  constexpr int kStride = kHdp + 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len && c < hd) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

// Block-wide sum (or max) of one value per thread, in a fixed order;
// `scratch` holds kThreads / 32 floats of shared memory.
template <int kThreads>
__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // scratch free from the previous reduction
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    r = is_max ? fmaxf(r, scratch[w]) : r + scratch[w];
  }
  return r;
}

// The entry points' shape check: head dims a multiple of 8 up to 128.
inline bool bad_shape(int batch, int seq, int num_heads, int head_dim) {
  return batch <= 0 || seq <= 0 || num_heads <= 0 || head_dim % 8 != 0 ||
         head_dim <= 0 || head_dim > 128 || batch > 65535 ||
         num_heads > 65535;
}

}  // namespace attn
