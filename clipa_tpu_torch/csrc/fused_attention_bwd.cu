// Fused multi-head self-attention backward for Hopper (sm_90a), bf16 or fp32
// in/out (one entry point per operand type).
//
// Replaces the three Pallas TPU backward kernels of
// clipa_tpu/ops/block_attention.py with one kernel family over flat
// (B*L, D) rows, row i belonging to sample i // L:
//   _bwd_kernel         (:185)  per-sample, dK/dV fp32-accumulated across
//                               q-tiles, rows past L zeroed
//   _bwd2d_kernel       (:504)  flat rows, no bias
//   _bwd2d_bias_kernel  (:672)  flat rows with the (D,) q/k/v biases, plus
//                               fp32 bias grads (has-bias: non-null bq/bk/bv)
// They differ only in layout; the function (held against the plain PyTorch
// version attention_plain_bwd in ops/block_attention.py) is:
//   qb = q + bq (fp32 add, one rounding), kb, vb likewise
//   s  = (qb . kb) in fp32 times scale;   p = softmax(clip(s, +-70)) with no
//   row max (clip mode) or the row-max softmax (exact mode), in fp32
//   dp = do . vb in fp32;   ds = p * (dp - rowsum(dp * p))
//   clip mode: ds = 0 where |s| >= 70 (the clip's own gradient)
//   dsb = bf16(ds * scale), pb = bf16(p)
//   dq = dsb . kb,  dk = dsb^T . qb,  dv = pb^T . do   (fp32 sums, rounded
//   once);  dbq/dbk/dbv = fp32 column sums of the fp32 dq/dk/dv.
//
// Blocks share nothing, so the cross-block reductions are split the way
// clipa_tpu/ops/flash_attention.py splits them (deterministic, no atomics):
//   1. dq kernel, one block per (sample, head, 64-row q-tile): sweep A over
//      the key tiles accumulates the row sum r of exp (with the online row
//      max m in exact mode) and u = sum(exp * dp), so rowsum(dp * p) = u / r
//      without a third sweep; sweep B recomputes s and dp and accumulates
//      dq in registers. It writes (m, r, delta) per (row, head) to scratch.
//   2. dk/dv kernel, one block per (sample, head, 64-row key tile): sweeps
//      the q-tiles with those statistics and accumulates dK and dV in fp32
//      registers, rounded once at the end (_bwd_kernel's fp32 accumulators).
//   3. bias grads: each block of 1. and 2. writes the fp32 column sums of its
//      tile (valid rows only); a third kernel sums those partials per column
//      in a fixed order.
// rowsum(dp * p) is taken from p and dp themselves, not from dO . O (the
// FlashAttention-2 shortcut would use the bf16-rounded O).
//
// Layout: block = 4 warps, 16 rows per warp; products on the tensor cores
// through mma.sync m16n8k16 (bf16 in, fp32 accumulate). Rows past L and
// head-dim columns past hd are zero-filled in shared memory (no
// uninitialised value ever enters a product: 0 * NaN would poison a sum);
// scores of keys past L and of query rows past L are masked to p = ds = 0.
// Head dims that are a multiple of 8 but not of 16 (H/14's 80 is, but 40
// is not) are zero-padded to the next multiple of 16.
//
// What bounds it: at the pretrain shape (ViT-L/16 @112: L = 50, D = 1024,
// 16 heads of 64) the five backward products are about 10 GFLOP per layer
// at B = 384, under 1% of the step; the sweeps recompute s twice and dp
// twice (9 products instead of 5) to keep every reduction inside a block.
// The kernel is bound by tensor-core issue and shared-memory traffic, not by
// device memory. This first version keeps the loads simple (synchronous
// tiles, no cp.async/TMA, no wgmma): that is the known headroom.
//
// fp32 operands (configs/smoke.py trains in fp32, as the Pallas kernels
// take fp32 operands) run scalar twins: one block per (sample, head, row),
// fp32 FMA throughout, no TF32, nothing rounded to a narrower type. They are
// written to be right, not fast.
//
// Deferred normalization (entry clipa_fused_attention_bwd_deferred, bf16
// only; the compile-time variant kDefer of the same two kernels): the
// backward variant that clipa_tpu/tools/attn_sweep.py:76 make_bwd_bias(g,
// defer=True) times, computing the same gradients with the softmax's 1/denom
// folded into dO's rows so the score-sized products run on unnormalized e:
//   e = exp(clip(s)) (exact mode: exp(s - rowmax)), denom = rowsum(e)
//   dohn = bf16(do / denom);  dphat = dohn . vb (fp32)
//   ds = e * (dphat - rowsum(dphat * e) / denom), zeroed where |s| >= 70
//   dsb = bf16(ds * scale);  dq = dsb . kb, dk = dsb^T . qb, dv = bf16(e)^T .
//   dohn.
// The reference's kernel drops the row-sum term's 1/denom (its
// ds = e * (dphat - rowsum(dphat * e))): its dq and dk are wrong, its dv
// right; this variant computes the gradient. The held-against plain twin is
// attention_plain_bwd(..., defer=True). The dq kernel needs denom before it
// can form dohn, so it sweeps the key tiles three times (denom; then
// rowsum(dphat * e); then dq) where the normalized variant sweeps twice; the
// dk/dv kernel scales its dO tiles by the stored 1/denom as it loads them.
// Same tiles, no atomics, deterministic.

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;  // rows per block tile, 16 per warp
constexpr float kExpClip = 70.f;    // block_attention._EXP_CLIP

// Copies rows [row0, row0 + 64) of one head's columns into shared memory
// (row stride kHdp + 8), adding the bias in fp32 with one rounding. Rows at
// or past `seq` and columns at or past `hd` are written as zeros.
template <int kHdp>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          const bf16* bias, int row0, int seq,
                                          int hd, int ld) {
  constexpr int kChunks = kHdp / 8;  // 16-byte chunks per row
  constexpr int kStride = kHdp + 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
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

// Divides the rows of a 64-row tile in shared memory by den[row] (IEEE
// division, one rounding to bf16): dO -> dohn of the deferred variant.
template <int kHdp>
__device__ __forceinline__ void scale_rows(bf16* tile, const float* den) {
  constexpr int kStride = kHdp + 8;
  constexpr int kPairs = kHdp / 2;
  for (int i = threadIdx.x; i < kTile * kPairs; i += kThreads) {
    const int r = i / kPairs;
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(
        tile + r * kStride + 2 * (i % kPairs));
    const float2 f = __bfloat1622float2(*x);
    *x = __floats2bfloat162_rn(__fdiv_rn(f.x, den[r]),
                               __fdiv_rn(f.y, den[r]));
  }
}

// Writes the warp tiles `acc` (16 rows per warp, rows tile0 + ...) of one
// head to `dst` in bf16 (rows < seq, columns < hd) and, with `partial`, the
// fp32 column sums of the whole 64-row block tile to partial[0, hd) through
// `colsum` (kWarps * kHdp floats of shared memory).
template <int kHdp>
__device__ __forceinline__ void store_tile(float acc[kHdp / 8][4],
                                           bf16* dst, float* partial,
                                           float* colsum, int tile0, int seq,
                                           int hd, int ld) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = tile0 + warp * 16 + g + 8 * r;
    if (row >= seq) continue;
    bf16* o = dst + (size_t)row * ld;
#pragma unroll
    for (int nt = 0; nt < kHdp / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < hd) {
        *reinterpret_cast<uint32_t*>(o + c) =
            pack_floats(acc[nt][2 * r], acc[nt][2 * r + 1]);
      }
    }
  }
  if (partial == nullptr) return;
  const bool lo_ok = tile0 + warp * 16 + g < seq;
  const bool hi_ok = tile0 + warp * 16 + g + 8 < seq;
#pragma unroll
  for (int nt = 0; nt < kHdp / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = (lo_ok ? acc[nt][j] : 0.f) + (hi_ok ? acc[nt][2 + j] : 0.f);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) colsum[warp * kHdp + nt * 8 + 2 * t + j] = s;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < hd; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += colsum[w * kHdp + c];
    partial[c] = s;
  }
}

// Kernel 1: dq and the softmax statistics, one block per (q-tile, head,
// sample). stats: m, r, delta, each (batch * seq * num_heads) fp32 indexed
// (sample * num_heads + head) * seq + row. kDefer: the deferred variant
// (delta = rowsum(dphat * e) / r there).
template <int kHdp, bool kDefer>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const bf16* __restrict__ bq,
                        const bf16* __restrict__ bk,
                        const bf16* __restrict__ bv, bf16* __restrict__ dq,
                        float* __restrict__ stats,
                        float* __restrict__ partial, int seq, int num_heads,
                        int hd, float scale, int exact, int n_stats) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kTile * kStride;
  bf16* sk = sdo + kTile * kStride;
  bf16* sv = sk + kTile * kStride;
  float* colsum = reinterpret_cast<float*>(sv + kTile * kStride);
  float* s_den = colsum + kWarps * kHdp;  // kDefer: denom per tile row

  const int h = blockIdx.y;
  const int d_model = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * d_model + (size_t)h * hd;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool active = q0 + warp * 16 < seq;
  const bf16* bkh = bk ? bk + h * hd : nullptr;
  const bf16* bvh = bv ? bv + h * hd : nullptr;

  load_tile<kHdp>(sq, q + base, bq ? bq + h * hd : nullptr, q0, seq, hd,
                  d_model);
  load_tile<kHdp>(sdo, dout + base, nullptr, q0, seq, hd, d_model);
  const bf16* sqw = sq + warp * 16 * kStride;
  const bf16* sdow = sdo + warp * 16 * kStride;

  // Sweep A: per row (g, g + 8 of this thread), partial over this thread's
  // key columns until the quad reduction; the row max is quad-reduced per
  // tile so all four threads of a row agree on it. kDefer: r only (u needs
  // dohn, hence r, first).
  float row_max[2] = {exact ? -INFINITY : 0.f, exact ? -INFINITY : 0.f};
  float row_sum[2] = {0.f, 0.f};
  float row_u[2] = {0.f, 0.f};
  float s[kTile / 8][4], dp[kTile / 8][4];
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<kHdp>(sk, k + base, bkh, k0, seq, hd, d_model);
    if (!kDefer) load_tile<kHdp>(sv, v + base, bvh, k0, seq, hd, d_model);
    __syncthreads();
    if (!active) continue;
    warp_scores<kHdp, kTile / 8>(s, sqw, sk);
    if (!kDefer) warp_scores<kHdp, kTile / 8>(dp, sdow, sv);
    if (exact) {
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
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
        row_u[r] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = __expf(s[nt][i] - row_max[i >> 1]);
          row_sum[i >> 1] += e;
          if (!kDefer) row_u[i >> 1] += e * dp[nt][i];
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          const float x = fminf(fmaxf(s[nt][i] * scale, -kExpClip), kExpClip);
          const float e = key < seq ? __expf(x) : 0.f;
          row_sum[i >> 1] += e;
          if (!kDefer) row_u[i >> 1] += e * dp[nt][i];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
  if (kDefer) {
    // dO -> dohn = bf16(dO / r) in place (rows past seq divide by 1), then
    // sweep A2: u = rowsum(dphat * e) with dphat = dohn . V.
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = warp * 16 + g + 8 * r;
        s_den[lr] = q0 + lr < seq ? row_sum[r] : 1.f;
      }
    }
    __syncthreads();
    scale_rows<kHdp>(sdo, s_den);
    for (int k0 = 0; k0 < seq; k0 += kTile) {
      __syncthreads();
      load_tile<kHdp>(sk, k + base, bkh, k0, seq, hd, d_model);
      load_tile<kHdp>(sv, v + base, bvh, k0, seq, hd, d_model);
      __syncthreads();
      if (!active) continue;
      warp_scores<kHdp, kTile / 8>(s, sqw, sk);
      warp_scores<kHdp, kTile / 8>(dp, sdow, sv);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          const float x = s[nt][i] * scale;
          const float xe = exact ? x : fminf(fmaxf(x, -kExpClip), kExpClip);
          if (key < seq) {
            row_u[i >> 1] += __expf(xe - row_max[i >> 1]) * dp[nt][i];
          }
        }
      }
    }
  }
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_u[r] += __shfl_xor_sync(0xffffffffu, row_u[r], 1);
    row_u[r] += __shfl_xor_sync(0xffffffffu, row_u[r], 2);
    delta[r] = row_u[r] / row_sum[r];
    const int row = q0 + warp * 16 + g + 8 * r;
    if (active && t == 0 && row < seq) {
      const size_t at =
          ((size_t)blockIdx.z * num_heads + h) * seq + row;
      stats[at] = row_max[r];
      stats[n_stats + at] = row_sum[r];
      stats[2 * (size_t)n_stats + at] = delta[r];
    }
  }

  // Sweep B: ds per score, then dq += bf16(ds * scale) . K.
  float acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<kHdp>(sk, k + base, bkh, k0, seq, hd, d_model);
    load_tile<kHdp>(sv, v + base, bvh, k0, seq, hd, d_model);
    __syncthreads();
    if (!active) continue;
    warp_scores<kHdp, kTile / 8>(s, sqw, sk);
    warp_scores<kHdp, kTile / 8>(dp, sdow, sv);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        const float x = s[nt][i] * scale;
        float ds = 0.f;
        if (key < seq) {
          const float xe = exact ? x : fminf(fmaxf(x, -kExpClip), kExpClip);
          const float e = __expf(xe - row_max[r]);
          const float p = kDefer ? e : e / row_sum[r];
          ds = p * (dp[nt][i] - delta[r]);
          if (!exact && fabsf(x) >= kExpClip) ds = 0.f;
        }
        s[nt][i] = ds * scale;
      }
    }
    warp_accumulate<kHdp, kTile / 16>(acc, s, sk);
  }
  const int n_tiles = (seq + kTile - 1) / kTile;
  store_tile<kHdp>(acc, dq + base, partial ? partial +
                   ((size_t)blockIdx.z * n_tiles + blockIdx.x) * d_model +
                   h * hd : nullptr, colsum, q0, seq, hd, d_model);
}

// Kernel 2: dk and dv, one block per (key tile, head, sample), sweeping the
// q-tiles with kernel 1's statistics. The warp's 16 key rows are the rows of
// the transposed score tile s^T (keys x queries). kDefer: dO tiles scaled to
// dohn as they arrive, p replaced by the unnormalized e.
template <int kHdp, bool kDefer>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const bf16* __restrict__ bq,
                         const bf16* __restrict__ bk,
                         const bf16* __restrict__ bv, bf16* __restrict__ dk,
                         bf16* __restrict__ dv,
                         const float* __restrict__ stats,
                         float* __restrict__ partial_k,
                         float* __restrict__ partial_v, int seq,
                         int num_heads, int hd, float scale, int exact,
                         int n_stats) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kTile * kStride;
  bf16* sq = sv + kTile * kStride;
  bf16* sdo = sq + kTile * kStride;
  float* s_max = reinterpret_cast<float*>(sdo + kTile * kStride);
  float* s_sum = s_max + kTile;
  float* s_delta = s_sum + kTile;
  float* colsum = s_delta + kTile;

  const int h = blockIdx.y;
  const int d_model = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * d_model + (size_t)h * hd;
  const size_t stat0 = ((size_t)blockIdx.z * num_heads + h) * seq;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool active = k0 + warp * 16 < seq;
  const bf16* bqh = bq ? bq + h * hd : nullptr;

  load_tile<kHdp>(sk, k + base, bk ? bk + h * hd : nullptr, k0, seq, hd,
                  d_model);
  load_tile<kHdp>(sv, v + base, bv ? bv + h * hd : nullptr, k0, seq, hd,
                  d_model);
  const bf16* skw = sk + warp * 16 * kStride;
  const bf16* svw = sv + warp * 16 * kStride;
  const bool key_ok[2] = {k0 + warp * 16 + g < seq,
                          k0 + warp * 16 + g + 8 < seq};

  float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;
  }
  float st[kTile / 8][4], dpt[kTile / 8][4];
  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    load_tile<kHdp>(sq, q + base, bqh, q0, seq, hd, d_model);
    load_tile<kHdp>(sdo, dout + base, nullptr, q0, seq, hd, d_model);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < seq;
      s_max[i] = ok ? stats[stat0 + q0 + i] : 0.f;
      s_sum[i] = ok ? stats[n_stats + stat0 + q0 + i] : 1.f;
      s_delta[i] = ok ? stats[2 * (size_t)n_stats + stat0 + q0 + i] : 0.f;
    }
    __syncthreads();
    if (kDefer) {
      scale_rows<kHdp>(sdo, s_sum);
      __syncthreads();
    }
    if (!active) continue;
    warp_scores<kHdp, kTile / 8>(st, skw, sq);
    warp_scores<kHdp, kTile / 8>(dpt, svw, sdo);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t + (i & 1);  // query row within tile
        const float x = st[nt][i] * scale;
        float p = 0.f, ds = 0.f;
        if (key_ok[i >> 1] && q0 + col < seq) {
          const float xe = exact ? x : fminf(fmaxf(x, -kExpClip), kExpClip);
          const float e = __expf(xe - s_max[col]);
          p = kDefer ? e : e / s_sum[col];
          ds = p * (dpt[nt][i] - s_delta[col]);
          if (!exact && fabsf(x) >= kExpClip) ds = 0.f;
        }
        st[nt][i] = p;
        dpt[nt][i] = ds * scale;
      }
    }
    warp_accumulate<kHdp, kTile / 16>(dv_acc, st, sdo);
    warp_accumulate<kHdp, kTile / 16>(dk_acc, dpt, sq);
  }
  __syncthreads();
  const int n_tiles = (seq + kTile - 1) / kTile;
  const size_t part =
      ((size_t)blockIdx.z * n_tiles + blockIdx.x) * d_model + h * hd;
  store_tile<kHdp>(dk_acc, dk + base, partial_k ? partial_k + part : nullptr,
                   colsum, k0, seq, hd, d_model);
  __syncthreads();
  store_tile<kHdp>(dv_acc, dv + base, partial_v ? partial_v + part : nullptr,
                   colsum, k0, seq, hd, d_model);
}

// out[y * width + c] = sum over p < n of src_y[p * width + c], in order of p:
// the bias grads from the per-tile partials (bf16) or from the fp32 dq/dk/dv
// themselves (fp32 twin). blockIdx.y selects q, k or v.
__global__ void column_sum_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ c, int n,
                                  int width, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= width) return;
  const float* src = blockIdx.y == 0 ? a : (blockIdx.y == 1 ? b : c);
  float s = 0.f;
  for (int p = 0; p < n; ++p) s += src[(size_t)p * width + col];
  out[blockIdx.y * width + col] = s;
}

int column_sums(const float* a, const float* b, const float* c, int n,
                int width, float* out, cudaStream_t stream) {
  const dim3 grid((width + 255) / 256, 3);
  column_sum_kernel<<<grid, 256, 0, stream>>>(a, b, c, n, width, out);
  return (int)cudaGetLastError();
}

template <int kHdp, bool kDefer>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const bf16* bq, const bf16* bk, const bf16* bv, bf16* dq, bf16* dk,
           bf16* dv, float* stats, float* partial, float* dbias, int batch,
           int seq, int num_heads, int hd, float scale, int exact,
           cudaStream_t stream) {
  const int tiles_bytes = 4 * kTile * (kHdp + 8) * (int)sizeof(bf16);
  const int smem_dq = tiles_bytes + (kWarps * kHdp + (kDefer ? kTile : 0)) *
                                        (int)sizeof(float);
  const int smem_dkv =
      tiles_bytes + (3 * kTile + kWarps * kHdp) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<kHdp, kDefer>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<kHdp, kDefer>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (seq + kTile - 1) / kTile;
  const int n_stats = batch * num_heads * seq;
  const size_t part_size = (size_t)batch * n_tiles * num_heads * hd;
  float* pq = partial;
  float* pk = partial ? partial + part_size : nullptr;
  float* pv = partial ? partial + 2 * part_size : nullptr;
  const dim3 grid(n_tiles, num_heads, batch);
  attention_bwd_dq_kernel<kHdp, kDefer><<<grid, kThreads, smem_dq, stream>>>(
      q, k, v, dout, bq, bk, bv, dq, stats, pq, seq, num_heads, hd, scale,
      exact, n_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<kHdp, kDefer><<<grid, kThreads, smem_dkv, stream>>>(
      q, k, v, dout, bq, bk, bv, dk, dv, stats, pk, pv, seq, num_heads, hd,
      scale, exact, n_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (partial == nullptr) return 0;
  return column_sums(pq, pk, pv, batch * n_tiles, num_heads * hd, dbias,
                     stream);
}

// ---------------------------------------------------------------------------
// fp32 twins: one block per (row, head, sample), thread-per-key (or query)
// scalar dot products, chunks of 128 columns staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32MaxHd = 128;

// dq of one query row and its statistics.
__global__ void __launch_bounds__(kF32Threads)
attention_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ bq,
                            const float* __restrict__ bk,
                            const float* __restrict__ bv,
                            float* __restrict__ dq, float* __restrict__ stats,
                            int seq, int num_heads, int hd, float scale,
                            int exact, int n_stats) {
  __shared__ float sq[kF32MaxHd], sdo[kF32MaxHd], sds[kF32Threads];
  __shared__ float scratch[kF32Threads / 32];
  const int row = blockIdx.x, h = blockIdx.y;
  const int d_model = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * d_model + (size_t)h * hd;
  const int tid = threadIdx.x;
  const float* bkh = bk ? bk + h * hd : nullptr;
  const float* bvh = bv ? bv + h * hd : nullptr;
  for (int c = tid; c < hd; c += kF32Threads) {
    sq[c] = q[base + (size_t)row * d_model + c] + (bq ? bq[h * hd + c] : 0.f);
    sdo[c] = dout[base + (size_t)row * d_model + c];
  }
  __syncthreads();

  // s and dp of key j, the scaled score in x, dp returned.
  auto score = [&](int j, float* x) {
    const size_t at = base + (size_t)j * d_model;
    float s = 0.f, dp = 0.f;
    for (int c = 0; c < hd; ++c) {
      s = fmaf(sq[c], k[at + c] + (bkh ? bkh[c] : 0.f), s);
      dp = fmaf(sdo[c], v[at + c] + (bvh ? bvh[c] : 0.f), dp);
    }
    *x = s * scale;
    return dp;
  };

  float m = 0.f;
  if (exact) {
    float local = -INFINITY;
    for (int j = tid; j < seq; j += kF32Threads) {
      float x;
      score(j, &x);
      local = fmaxf(local, x);
    }
    m = block_reduce<kF32Threads>(local, true, scratch);
  }
  float sum = 0.f, u = 0.f;
  for (int j = tid; j < seq; j += kF32Threads) {
    float x;
    const float dp = score(j, &x);
    const float e =
        expf((exact ? x : fminf(fmaxf(x, -kExpClip), kExpClip)) - m);
    sum += e;
    u += e * dp;
  }
  sum = block_reduce<kF32Threads>(sum, false, scratch);
  u = block_reduce<kF32Threads>(u, false, scratch);
  const float delta = u / sum;

  float acc = 0.f;  // dq[c] for c = tid (hd <= 128 = threads)
  for (int j0 = 0; j0 < seq; j0 += kF32Threads) {
    const int j = j0 + tid;
    float ds = 0.f;
    if (j < seq) {
      float x;
      const float dp = score(j, &x);
      const float xe = exact ? x : fminf(fmaxf(x, -kExpClip), kExpClip);
      const float p = expf(xe - m) / sum;
      ds = p * (dp - delta);
      if (!exact && fabsf(x) >= kExpClip) ds = 0.f;
    }
    __syncthreads();  // previous chunk consumed
    sds[tid] = ds * scale;
    __syncthreads();
    if (tid < hd) {
      const int n = min(kF32Threads, seq - j0);
      for (int jj = 0; jj < n; ++jj) {
        const size_t at = base + (size_t)(j0 + jj) * d_model + tid;
        acc = fmaf(sds[jj], k[at] + (bkh ? bkh[tid] : 0.f), acc);
      }
    }
  }
  if (tid < hd) dq[base + (size_t)row * d_model + tid] = acc;
  if (tid == 0) {
    const size_t at = ((size_t)blockIdx.z * num_heads + h) * seq + row;
    stats[at] = m;
    stats[n_stats + at] = sum;
    stats[2 * (size_t)n_stats + at] = delta;
  }
}

// dk and dv of one key row, sweeping the query rows.
__global__ void __launch_bounds__(kF32Threads)
attention_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ bq,
                             const float* __restrict__ bk,
                             const float* __restrict__ bv,
                             float* __restrict__ dk, float* __restrict__ dv,
                             const float* __restrict__ stats, int seq,
                             int num_heads, int hd, float scale, int exact,
                             int n_stats) {
  __shared__ float sk[kF32MaxHd], sv[kF32MaxHd];
  __shared__ float sp[kF32Threads], sds[kF32Threads];
  const int key = blockIdx.x, h = blockIdx.y;
  const int d_model = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * d_model + (size_t)h * hd;
  const size_t stat0 = ((size_t)blockIdx.z * num_heads + h) * seq;
  const int tid = threadIdx.x;
  const float* bqh = bq ? bq + h * hd : nullptr;
  for (int c = tid; c < hd; c += kF32Threads) {
    sk[c] = k[base + (size_t)key * d_model + c] + (bk ? bk[h * hd + c] : 0.f);
    sv[c] = v[base + (size_t)key * d_model + c] + (bv ? bv[h * hd + c] : 0.f);
  }
  float dk_acc = 0.f, dv_acc = 0.f;
  for (int i0 = 0; i0 < seq; i0 += kF32Threads) {
    __syncthreads();  // sk/sv written; previous chunk consumed
    const int i = i0 + tid;
    float p = 0.f, ds = 0.f;
    if (i < seq) {
      const size_t at = base + (size_t)i * d_model;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < hd; ++c) {
        s = fmaf(q[at + c] + (bqh ? bqh[c] : 0.f), sk[c], s);
        dp = fmaf(dout[at + c], sv[c], dp);
      }
      const float x = s * scale;
      const float xe = exact ? x : fminf(fmaxf(x, -kExpClip), kExpClip);
      p = expf(xe - stats[stat0 + i]) / stats[n_stats + stat0 + i];
      ds = p * (dp - stats[2 * (size_t)n_stats + stat0 + i]);
      if (!exact && fabsf(x) >= kExpClip) ds = 0.f;
    }
    sp[tid] = p;
    sds[tid] = ds * scale;
    __syncthreads();
    if (tid < hd) {
      const int n = min(kF32Threads, seq - i0);
      for (int ii = 0; ii < n; ++ii) {
        const size_t at = base + (size_t)(i0 + ii) * d_model + tid;
        dk_acc = fmaf(sds[ii], q[at] + (bqh ? bqh[tid] : 0.f), dk_acc);
        dv_acc = fmaf(sp[ii], dout[at], dv_acc);
      }
    }
  }
  if (tid < hd) {
    dk[base + (size_t)key * d_model + tid] = dk_acc;
    dv[base + (size_t)key * d_model + tid] = dv_acc;
  }
}

// The bf16 entries' body: kDefer selects the variant.
template <bool kDefer>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const void* bq, const void* bk, const void* bv, void* dq,
                void* dk, void* dv, void* stats, void* partial, void* dbias,
                int batch, int seq, int num_heads, int head_dim, float scale,
                int exact, void* stream) {
  if (bad_shape(batch, seq, num_heads, head_dim) ||
      (bq != nullptr) != (partial != nullptr) ||
      (partial != nullptr) != (dbias != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const bf16* bq_ = static_cast<const bf16*>(bq);
  const bf16* bk_ = static_cast<const bf16*>(bk);
  const bf16* bv_ = static_cast<const bf16*>(bv);
  bf16* dq_ = static_cast<bf16*>(dq);
  bf16* dk_ = static_cast<bf16*>(dk);
  bf16* dv_ = static_cast<bf16*>(dv);
  float* st_ = static_cast<float*>(stats);
  float* pa_ = static_cast<float*>(partial);
  float* db_ = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CLIPA_LAUNCH(HDP)                                                   \
  return launch<HDP, kDefer>(q_, k_, v_, do_, bq_, bk_, bv_, dq_, dk_, dv_, \
                             st_, pa_, db_, batch, seq, num_heads, head_dim,  \
                             scale, exact, s)
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

}  // namespace

// q/k/v/do/dq/dk/dv: (batch * seq, num_heads * head_dim) bf16, contiguous,
// 16-byte aligned; bq/bk/bv: (num_heads * head_dim,) bf16 or all null.
// stats: 3 * batch * seq * num_heads fp32 scratch. With biases, partial:
// 3 * batch * ceil(seq / 64) * num_heads * head_dim fp32 scratch and dbias:
// 3 * num_heads * head_dim fp32 (dbq, dbk, dbv); both null without. head_dim
// must be a multiple of 8 and at most 128. Returns the cudaError_t of the
// launches.
extern "C" int clipa_fused_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bq, const void* bk, const void* bv, void* dq, void* dk,
    void* dv, void* stats, void* partial, void* dbias, int batch, int seq,
    int num_heads, int head_dim, float scale, int exact, void* stream) {
  return launch_bf16<false>(q, k, v, dout, bq, bk, bv, dq, dk, dv, stats,
                            partial, dbias, batch, seq, num_heads, head_dim,
                            scale, exact, stream);
}

// The deferred-normalization variant: the same arguments, limits and
// outputs (bf16 only; see the header).
extern "C" int clipa_fused_attention_bwd_deferred(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bq, const void* bk, const void* bv, void* dq, void* dk,
    void* dv, void* stats, void* partial, void* dbias, int batch, int seq,
    int num_heads, int head_dim, float scale, int exact, void* stream) {
  return launch_bf16<true>(q, k, v, dout, bq, bk, bv, dq, dk, dv, stats,
                           partial, dbias, batch, seq, num_heads, head_dim,
                           scale, exact, stream);
}

// The fp32 twin: same arguments and limits, fp32 tensors (4-byte aligned
// suffices); `partial` is not used (the bias grads are the column sums of
// the fp32 dq/dk/dv), `dbias` is set iff the biases are.
extern "C" int clipa_fused_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bq, const void* bk, const void* bv, void* dq, void* dk,
    void* dv, void* stats, void* partial, void* dbias, int batch, int seq,
    int num_heads, int head_dim, float scale, int exact, void* stream) {
  (void)partial;
  if (bad_shape(batch, seq, num_heads, head_dim) ||
      (bq != nullptr) != (dbias != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* bq_ = static_cast<const float*>(bq);
  const float* bk_ = static_cast<const float*>(bk);
  const float* bv_ = static_cast<const float*>(bv);
  float* dq_ = static_cast<float*>(dq);
  float* dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
  float* st_ = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_stats = batch * num_heads * seq;
  const dim3 grid(seq, num_heads, batch);
  attention_bwd_dq_f32_kernel<<<grid, kF32Threads, 0, s>>>(
      q_, k_, v_, do_, bq_, bk_, bv_, dq_, st_, seq, num_heads, head_dim,
      scale, exact, n_stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_f32_kernel<<<grid, kF32Threads, 0, s>>>(
      q_, k_, v_, do_, bq_, bk_, bv_, dk_, dv_, st_, seq, num_heads,
      head_dim, scale, exact, n_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return (int)err;
  return column_sums(dq_, dk_, dv_, batch * seq, num_heads * head_dim,
                     static_cast<float*>(dbias), s);
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
