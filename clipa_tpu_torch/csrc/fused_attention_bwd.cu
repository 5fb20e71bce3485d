// Fused multi-head self-attention backward for Hopper (sm_90a), bf16 or fp32
// in/out (one entry point per operand type).
//
// Replaces the three Pallas TPU backward kernels of
// clipa_tpu/ops/block_attention.py with one kernel family over flat
// (B*L, D) rows, row i belonging to sample i // L:
//   _bwd_kernel         (:185, called at :311)  per-sample, dK/dV
//                               fp32-accumulated across q-tiles
//   _bwd2d_kernel       (:504, called at :599)  flat rows, no bias
//   _bwd2d_bias_kernel  (:672, called at :781)  flat rows with the (D,)
//                               q/k/v biases, plus fp32 bias grads
//                               (has-bias: non-null bq/bk/bv)
// They differ only in layout; the function (held against the plain PyTorch
// version attention_plain_bwd in ops/block_attention.py) is:
//   qb = q + bq (one rounding), kb, vb likewise
//   s  = (qb . kb) in fp32 times scale;   p = softmax(clip(s, +-70)) with no
//   row max (clip mode) or the row-max softmax (exact mode), in fp32
//   dp = do . vb in fp32;   ds = p * (dp - rowsum(dp * p))
//   clip mode: ds = 0 where |s| >= 70 (the clip's own gradient)
//   dsb = bf16(ds * scale), pb = bf16(p)
//   dq = dsb . kb,  dk = dsb^T . qb,  dv = pb^T . do   (fp32 sums, rounded
//   once);  dbq/dbk/dbv = fp32 column sums of the fp32 dq/dk/dv.
// rowsum(dp * p) is taken from p and dp themselves, not from dO . O (the
// FlashAttention-2 shortcut would use the bf16-rounded O). No atomics: every
// sum runs in a fixed order, so two calls give bit-identical outputs.
//
// What bounds it: at the pretrain shapes (ViT-L/16 @112: B = 384, L = 50,
// 16 heads of 64; ViT-H/14 @84: B = 256, L = 37, 16 heads of 80) the
// function moves q, k, v, dO in and dq, dk, dv out once each (275 MB at
// L/16: 0.082 ms at 3.35 TB/s) and needs 10 L^2 hd operations per head
// and sample (9.8 GFLOP: 0.010 ms at 989 TFLOP/s): device memory bounds it.
// At the fine-tune `auto` route's shape (B = 128, L = 138, hd 64) bytes
// bound it too (0.076 ms). A (sample, head) is small (50 x 64), so what
// holds a kernel back is latency and instruction issue: the products of
// one head are a few mma.sync each, and every copy, reduction and barrier
// sits between them; at L = 138 the whole-head block (9 warps, 136 KB of
// shared memory) fits once per SM.
//
// Two schemes; ops/block_attention.py bwd_plan picks one per shape:
//   whole-head (L <= 16 kMaxChunks = 144: the pretrain shapes and the
//   fine-tune `auto` route's L = 138): persistent blocks of one warp per
//   16-row chunk of L, each (sample, head) an item.
//     1. cp.async brings the item's Q, dO, K and V (round16(L) rows each,
//        zero-filled past L) into shared memory; after its own wait, the
//        thread that copied a chunk adds that chunk's bias with bf16x2 adds
//        (RowSlice: one column per thread, its bias chunk loaded into
//        registers with the copies). The other blocks resident on the SM
//        compute while one block waits for its copies;
//     2. warp w, query strip w: S = Qb Kb^T and dP = dO Vb^T over every key
//        in registers (A and B fragments through ldmatrix); then, with quad
//        shuffles, the row max (exact mode), e and rowsum(e), P, u =
//        rowsum(dP * P), dS, the clip-grad mask and dsb; dQ = dsb Kb with
//        dsb's A fragments straight from those registers (as
//        FlashAttention-2 re-packs its accumulators) and Kb through
//        ldmatrix.trans;
//     3. after a barrier K and V are dead: bf16(P) and dsb replace them in
//        shared memory ([query][key]); after another, warp w owns key strip
//        w: dV = bf16(P)^T dO and dK = dsb^T Qb, the A fragments of the
//        transposes through ldmatrix.trans, fp32 registers rounded once;
//     4. bias grads: each item writes the fp32 column sums of its valid
//        rows of dq, dk and dv (a fixed shuffle tree per warp, the warps in
//        order) as one partial per (sample, head slice of D); a second pass
//        sums the B partials of each column in a fixed order.
//   S and dP are formed once per (query, key) pair: 5 products. The chunk
//   count is a template argument: nothing is loaded or computed for a
//   16-row or 16-key chunk wholly past L (L = 50: 4 chunks; L = 37: 3).
//   split (longer sequences, and the deferred variant): one block per
//   (sample, head, 64-row tile), 4 warps, synchronous tile loads:
//     1. dq kernel: sweep A over the key tiles accumulates the row sum r of
//        exp (with the online row max m in exact mode) and u = sum(exp *
//        dp), so rowsum(dp * p) = u / r; sweep B recomputes s and dp and
//        accumulates dq in registers. It writes (m, r, delta) per (row,
//        head) to scratch;
//     2. dk/dv kernel: per key tile, sweeps the q-tiles with those
//        statistics and accumulates dK and dV in fp32 registers;
//     3. bias grads: each block writes the fp32 column sums of its tile;
//        the second pass sums those partials per column in a fixed order.
//   9 products: s and dp three times.
// Tensor cores: mma.sync m16n8k16 (bf16 in, fp32 accumulate); a wgmma
// tile's 64 rows would be mostly padding at L = 37 or 50.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bench.py --kernels
// fused, device time, this design and the previous one, the split pair, in
// turns in one run): B = 384, L = 50, D = 1024 (L/16 @112, bias, clip)
// 0.1642-0.1646 ms, 50% of its bound, against 0.7069-0.7115; B = 256,
// L = 37, D = 1280 (H/14 @84) 0.1017-0.1019 against 0.4594-0.4615; B =
// 128, L = 138 (fine-tune `auto`) 0.2553 against 1.3008-1.3078; the exact
// form without bias at L = 50 0.1261-0.1273 against 0.4577-0.4594 and
// SDPA's backward 0.3471-0.3478. The biases (their adds, the column sums,
// the second pass) are most of the gap between the biased clip form's
// 0.164 ms at L = 50 and the unbiased exact form's 0.127.
// Other shapes in PERF.md section 6.
//
// fp32 operands (configs/smoke.py trains in fp32, as the Pallas kernels
// take fp32 operands) run scalar twins: one block per (sample, head, row),
// fp32 FMA throughout, no TF32, nothing rounded to a narrower type. They are
// written to be right, not fast.
//
// Deferred normalization (entry clipa_fused_attention_bwd_deferred, bf16
// only, the split scheme only; the compile-time variant kDefer of its two
// kernels): the backward variant that clipa_tpu/tools/attn_sweep.py:76
// make_bwd_bias(g, defer=True) times, computing the same gradients with the
// softmax's 1/denom folded into dO's rows so the score-sized products run on
// unnormalized e:
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

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kWarps = 4;           // split scheme: warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;  // rows per block tile, 16 per warp
constexpr int kMaxChunks = 9;       // whole-head: L <= 16 kMaxChunks
constexpr float kExpClip = 70.f;    // block_attention._EXP_CLIP
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClipLog2 = kExpClip * kLog2e;
constexpr float kNegInf = -1e30f;

// The split scheme's shared memory per block: four 64-row tiles, then the
// fp32 column sums of each warp and (the deferred variant's) 64 row
// denominators (dq kernel) or the three row statistics (dk/dv kernel).
__host__ __device__ constexpr int split_smem_dq(int hdp) {
  return 4 * kTile * (hdp + 8) * (int)sizeof(bf16) +
         (kWarps * hdp + kTile) * (int)sizeof(float);
}
__host__ __device__ constexpr int split_smem_dkv(int hdp) {
  return 4 * kTile * (hdp + 8) * (int)sizeof(bf16) +
         (3 * kTile + kWarps * hdp) * (int)sizeof(float);
}

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

// The whole-head scheme's shared memory for its item, in bf16 elements:
// Q and dO, then a region that holds K and V in phase 1 and bf16(P) and
// dsb (both [query][key], row stride lp + 8) in phase 2.
__host__ __device__ constexpr int whole_item_elems(int lp, int hdp) {
  return 2 * lp * (hdp + 8) + 2 * lp * (hdp > lp ? hdp + 8 : lp + 8);
}

// Its bytes per block: the item, then the fp32 column sums of dq, dk and
// dv per warp (lp / 16 warps of kHdp columns each).
__host__ __device__ constexpr int whole_smem(int lp, int hdp) {
  return whole_item_elems(lp, hdp) * (int)sizeof(bf16) +
         3 * (lp / 16) * hdp * (int)sizeof(float);
}

// Writes the fp32 column sums of a warp's 16-row accumulator tile (rows
// row0 + ..., those below `len` only) to colsum[0, kHdp): a fixed shuffle
// tree over the tile's rows.
template <int kHdp>
__device__ __forceinline__ void warp_colsum(const float acc[kHdp / 8][4],
                                            float* colsum, int row0,
                                            int len) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool lo_ok = row0 + g < len, hi_ok = row0 + g + 8 < len;
#pragma unroll
  for (int nt = 0; nt < kHdp / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = (lo_ok ? acc[nt][j] : 0.f) + (hi_ok ? acc[nt][2 + j] : 0.f);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) colsum[nt * 8 + 2 * t + j] = s;
    }
  }
}

// Stores a warp's A fragments a[c] (16 rows from `row0`, 16 columns per
// chunk c) to the row-major bf16 matrix `dst` (row stride `stride`).
template <int kNc>
__device__ __forceinline__ void store_frags(bf16* dst, const uint32_t a[kNc][4],
                                            int row0, int stride) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* d = dst + (row0 + g) * stride + 2 * t;
#pragma unroll
  for (int c = 0; c < kNc; ++c) {
    *reinterpret_cast<uint32_t*>(d + c * 16) = a[c][0];
    *reinterpret_cast<uint32_t*>(d + 8 * stride + c * 16) = a[c][1];
    *reinterpret_cast<uint32_t*>(d + c * 16 + 8) = a[c][2];
    *reinterpret_cast<uint32_t*>(d + 8 * stride + c * 16 + 8) = a[c][3];
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
  const int row0 = tile0 + threadIdx.x / 32 * 16;
  store_strip<kHdp>(acc, dst, row0, seq, hd, ld, 1.f);
  if (partial == nullptr) return;
  warp_colsum<kHdp>(acc, colsum + threadIdx.x / 32 * kHdp, row0, seq);
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

// The whole-head scheme: persistent blocks of kNc warps (one per 16-row
// strip: L <= 16 kNc), each walking the (head, sample) items blockIdx.x,
// + gridDim.x, ..., one item's operands in shared memory at a time.
// Warp w owns query strip w in phase 1 and key strip w in phase 2.
// partial: null, or the (3, batch, num_heads * hd) fp32 column sums of
// each sample's dq, dk and dv rows.
template <int kHdp, int kNc>
__global__ void __launch_bounds__(kNc * 32)
attention_bwd_whole_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const bf16* __restrict__ bq,
                           const bf16* __restrict__ bk,
                           const bf16* __restrict__ bv,
                           bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, float* __restrict__ partial,
                           int batch, int seq, int num_heads, int hd,
                           float scale, int exact) {
  constexpr int kStride = kHdp + 8;
  constexpr int kLp = kNc * 16;
  constexpr int kPStride = kLp + 8;   // P and dsb, [query][key]
  constexpr int kNt = kHdp / 8;
  constexpr int kItem = whole_item_elems(kLp, kHdp);
  constexpr int kThreadsW = kNc * 32;
  const int tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int items = batch * num_heads;
  const int ld = num_heads * hd;
  const float scale_log2 = scale * kLog2e;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kLp * kStride;
  bf16* sk = sdo + kLp * kStride;
  bf16* sv = sk + kLp * kStride;
  float* colsum = reinterpret_cast<float*>(sq + kItem);
  const RowSlice<kHdp> slice(tid, kThreadsW);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int h = item % num_heads, b = item / num_heads;
    const size_t base = (size_t)b * seq * ld + (size_t)h * hd;
    // this thread's chunks of the q, k and v biases, loaded with its copies
    // so that their latency hides behind them
    uint4 bias[3];
    if (bq != nullptr) {
      bias[0] = bias_chunk<kHdp>(bq + h * hd, hd, slice);
      bias[1] = bias_chunk<kHdp>(bk + h * hd, hd, slice);
      bias[2] = bias_chunk<kHdp>(bv + h * hd, hd, slice);
    }
    issue_rows<kHdp>(sq, q + base, 0, kLp, seq, hd, ld, slice);
    issue_rows<kHdp>(sdo, dout + base, 0, kLp, seq, hd, ld, slice);
    issue_rows<kHdp>(sk, k + base, 0, kLp, seq, hd, ld, slice);
    issue_rows<kHdp>(sv, v + base, 0, kLp, seq, hd, ld, slice);
    cp_async_commit();
    cp_async_wait<0>();
    if (bq != nullptr) {   // each thread biases the chunks it copied
      add_bias_chunk<kHdp>(sq, bias[0], 0, kLp, seq, hd, slice);
      add_bias_chunk<kHdp>(sk, bias[1], 0, kLp, seq, hd, slice);
      add_bias_chunk<kHdp>(sv, bias[2], 0, kLp, seq, hd, slice);
    }
    __syncthreads();  // this item's operands, biased, for every warp

    // Phase 1, query strip `warp`: S = Qb Kb^T and dP = dO Vb^T over every
    // key. Element i of n-tile nt: query q0 + g + 8 (i >> 1), key 8 nt +
    // 2t + (i & 1).
    const int q0 = warp * 16;
    float s[2 * kNc][4], dp[2 * kNc][4];
#pragma unroll
    for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < kHdp / 16; ++kc) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, ldsm_rows16(sq + q0 * kStride + kc * 16, kStride));
      ldsm_x4(ado, ldsm_rows16(sdo + q0 * kStride + kc * 16, kStride));
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        uint32_t bm[4];
        ldsm_x4(bm, ldsm_rows8x2(sk + c * 16 * kStride + kc * 16, kStride));
        mma_16816(s[2 * c], aq, bm[0], bm[1]);
        mma_16816(s[2 * c + 1], aq, bm[2], bm[3]);
        ldsm_x4(bm, ldsm_rows8x2(sv + c * 16 * kStride + kc * 16, kStride));
        mma_16816(dp[2 * c], ado, bm[0], bm[1]);
        mma_16816(dp[2 * c + 1], ado, bm[2], bm[3]);
      }
    }
    // e in s (0 for keys past L), clip-saturated scores in `clipped`
    uint32_t clipped[(kNc + 3) / 4] = {};  // bit 4 (nt % 8) + i, word nt / 8
    if (exact) {
      float m[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = nt * 8 + 2 * t + (i & 1);
          if (nt >= 2 * kNc - 2 && key >= seq) s[nt][i] = kNegInf;
          m[i >> 1] = fmaxf(m[i >> 1], s[nt][i]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
        m[r] *= scale_log2;
      }
#pragma unroll
      for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt][i] = ex2(fmaf(s[nt][i], scale_log2, -m[i >> 1]));
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = nt * 8 + 2 * t + (i & 1);
          const float x = s[nt][i] * scale;
          if (fabsf(x) >= kExpClip) clipped[nt / 8] |= 1u << (4 * (nt % 8) + i);
          const float e = ex2(fminf(fmaxf(x * kLog2e, -kClipLog2), kClipLog2));
          s[nt][i] = (nt >= 2 * kNc - 2 && key >= seq) ? 0.f : e;
        }
      }
    }
    // p = e / rowsum(e) (0 on query rows past L), u = rowsum(dp * p),
    // dsb = bf16(p (dp - u) scale), 0 where the clip saturates
    float inv[2], u[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * kNc; ++nt) sum += s[nt][2 * r] + s[nt][2 * r + 1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = q0 + g + 8 * r < seq ? 1.f / sum : 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] *= inv[i >> 1];
        u[i >> 1] = fmaf(dp[nt][i], s[nt][i], u[i >> 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      u[r] += __shfl_xor_sync(0xffffffffu, u[r], 1);
      u[r] += __shfl_xor_sync(0xffffffffu, u[r], 2);
    }
    uint32_t pa[kNc][4], da[kNc][4];
#pragma unroll
    for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = s[nt][i] * (dp[nt][i] - u[i >> 1]) * scale;
        dp[nt][i] = (clipped[nt / 8] >> (4 * (nt % 8) + i)) & 1u ? 0.f : ds;
      }
    }
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      pack_a(pa[c], s[2 * c], s[2 * c + 1]);
      pack_a(da[c], dp[2 * c], dp[2 * c + 1]);
    }
    // dQ = dsb Kb: A from the registers, B through ldmatrix.trans
    {
      float acc[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        mma_rows16<kHdp>(acc, da[c], sk + c * 16 * kStride);
      }
      store_strip<kHdp>(acc, dq + base, q0, seq, hd, ld, 1.f);
      if (partial != nullptr) {
        warp_colsum<kHdp>(acc, colsum + warp * kHdp, q0, seq);
      }
    }
    __syncthreads();  // every warp done with K and V: P and dsb replace them
    bf16* sp = sk;
    bf16* sds = sk + kLp * kPStride;
    store_frags<kNc>(sp, pa, q0, kPStride);
    store_frags<kNc>(sds, da, q0, kPStride);
    __syncthreads();

    // Phase 2, key strip `warp`: dV = bf16(P)^T dO, dK = dsb^T Qb, the A
    // fragments of the transposes through ldmatrix.trans.
    {
      const int k0 = warp * 16;
      float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        uint32_t a[4];
        ldsm_x4_trans(a, ldsm_rows8x2(sp + c * 16 * kPStride + k0, kPStride));
        mma_rows16<kHdp>(dv_acc, a, sdo + c * 16 * kStride);
        ldsm_x4_trans(a, ldsm_rows8x2(sds + c * 16 * kPStride + k0, kPStride));
        mma_rows16<kHdp>(dk_acc, a, sq + c * 16 * kStride);
      }
      store_strip<kHdp>(dk_acc, dk + base, k0, seq, hd, ld, 1.f);
      store_strip<kHdp>(dv_acc, dv + base, k0, seq, hd, ld, 1.f);
      if (partial != nullptr) {
        warp_colsum<kHdp>(dk_acc, colsum + (kNc + warp) * kHdp, k0, seq);
        warp_colsum<kHdp>(dv_acc, colsum + (2 * kNc + warp) * kHdp, k0, seq);
      }
    }
    __syncthreads();  // the operands are free; the column sums are written
    if (partial != nullptr) {
      // this sample's column sums, the warps' strips summed in order
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        float* out = partial + ((size_t)y * batch + b) * ld + h * hd;
        for (int c = tid; c < hd; c += kThreadsW) {
          const float* cs = colsum + y * kNc * kHdp + c;
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kNc; ++w) sum += cs[w * kHdp];
          out[c] = sum;
        }
      }
    }
  }
}

// out[y * width + c] = sum over p < n of src_y[p * width + c] in fp32 and a
// fixed order (kSumGroups interleaved runs of rows, then the runs in
// order), rounded once to the output type: the bias grads from the
// per-sample or per-tile partials (bf16) or from the fp32 dq/dk/dv
// themselves (fp32 twin). blockIdx.y selects q, k or v.
constexpr int kSumCols = 32, kSumGroups = 32;

__device__ __forceinline__ void store_sum(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_sum(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumGroups)
column_sum_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, int n, int width,
                  T* __restrict__ out) {
  __shared__ float runs[kSumGroups][kSumCols];
  const int cx = threadIdx.x % kSumCols, gy = threadIdx.x / kSumCols;
  const int col = blockIdx.x * kSumCols + cx;
  const float* src = blockIdx.y == 0 ? a : (blockIdx.y == 1 ? b : c);
  float s = 0.f;
  if (col < width) {
#pragma unroll 4
    for (int p = gy; p < n; p += kSumGroups) s += src[(size_t)p * width + col];
  }
  runs[gy][cx] = s;
  __syncthreads();
  if (gy == 0 && col < width) {
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < kSumGroups; ++i) r += runs[i][cx];
    store_sum(out + blockIdx.y * width + col, r);
  }
}

template <typename T>
int column_sums(const float* a, const float* b, const float* c, int n,
                int width, T* out, cudaStream_t stream) {
  const dim3 grid((width + kSumCols - 1) / kSumCols, 3);
  column_sum_kernel<T><<<grid, kSumCols * kSumGroups, 0, stream>>>(
      a, b, c, n, width, out);
  return (int)cudaGetLastError();
}

// The split scheme: the dq kernel, the dk/dv kernel, then the bias grads
// from their per-tile partials. The plan's sizes must be these layouts'.
template <int kHdp, bool kDefer>
int launch_split(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const bf16* bq, const bf16* bk,
                 const bf16* bv, bf16* dq, bf16* dk, bf16* dv, float* stats,
                 float* partial, bf16* dbias, int batch, int seq,
                 int num_heads, int hd, int warps, int smem_dq, int smem_dkv,
                 float scale, int exact, cudaStream_t stream) {
  if (stats == nullptr || warps != kWarps || smem_dq != split_smem_dq(kHdp) ||
      smem_dkv != split_smem_dkv(kHdp)) {
    return (int)cudaErrorInvalidValue;
  }
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

// The whole-head scheme at kNc chunks: the persistent grid (as many blocks
// as the card holds at once, at most one per item), then the bias grads
// from the per-sample partials.
template <int kHdp, int kNc>
int launch_whole_nc(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const bf16* bq, const bf16* bk,
                    const bf16* bv, bf16* dq, bf16* dk, bf16* dv,
                    float* partial, bf16* dbias, int batch, int seq,
                    int num_heads, int hd, int smem, float scale, int exact,
                    cudaStream_t stream) {
  const void* fn = (const void*)attention_bwd_whole_kernel<kHdp, kNc>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)batch * num_heads;
  const int resident = resident_blocks(fn, kNc * 32, smem);
  if (resident <= 0 || items > 0x7fffffff) {
    return (int)cudaErrorInvalidConfiguration;
  }
  attention_bwd_whole_kernel<kHdp, kNc>
      <<<(int)(items < resident ? items : resident), kNc * 32, smem,
         stream>>>(q, k, v, dout, bq, bk, bv, dq, dk, dv, partial, batch,
                   seq, num_heads, hd, scale, exact);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const size_t part_size = (size_t)batch * num_heads * hd;
  return column_sums(partial, partial + part_size, partial + 2 * part_size,
                     batch, num_heads * hd, dbias, stream);
}

// The whole-head plan's check: one warp per 16-row chunk of L (at most
// kMaxChunks) and this layout's shared memory.
template <int kHdp>
int launch_whole(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const bf16* bq, const bf16* bk,
                 const bf16* bv, bf16* dq, bf16* dk, bf16* dv, float* partial,
                 bf16* dbias, int batch, int seq, int num_heads, int hd,
                 int warps, int smem, int smem_dkv, float scale, int exact,
                 cudaStream_t stream) {
  const int nc = (seq + 15) / 16;
  if (nc > kMaxChunks || warps != nc || smem_dkv != 0 ||
      smem != whole_smem(16 * nc, kHdp)) {
    return (int)cudaErrorInvalidValue;
  }
#define CLIPA_WHOLE(NC)                                                   \
  case NC:                                                                \
    return launch_whole_nc<kHdp, NC>(q, k, v, dout, bq, bk, bv, dq, dk, dv, \
                                     partial, dbias, batch, seq, num_heads, \
                                     hd, smem, scale, exact, stream)
  switch (nc) {
    CLIPA_WHOLE(1);
    CLIPA_WHOLE(2);
    CLIPA_WHOLE(3);
    CLIPA_WHOLE(4);
    CLIPA_WHOLE(5);
    CLIPA_WHOLE(6);
    CLIPA_WHOLE(7);
    CLIPA_WHOLE(8);
    CLIPA_WHOLE(9);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CLIPA_WHOLE
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

// The bf16 entries' body: kDefer selects the variant (split scheme only).
template <bool kDefer>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const void* bq, const void* bk, const void* bv, void* dq,
                void* dk, void* dv, void* stats, void* partial, void* dbias,
                int batch, int seq, int num_heads, int head_dim, int whole,
                int warps, int smem, int smem_dkv, float scale, int exact,
                void* stream) {
  if (bad_shape(batch, seq, num_heads, head_dim) ||
      (bq == nullptr) != (bk == nullptr) ||
      (bq == nullptr) != (bv == nullptr) ||
      (bq != nullptr) != (partial != nullptr) ||
      (partial != nullptr) != (dbias != nullptr) || whole < 0 || whole > 1 ||
      (kDefer && whole)) {
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
  bf16* db_ = static_cast<bf16*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CLIPA_LAUNCH(HDP)                                                    \
  case HDP:                                                                  \
    return whole ? launch_whole<HDP>(q_, k_, v_, do_, bq_, bk_, bv_, dq_,    \
                                     dk_, dv_, pa_, db_, batch, seq,         \
                                     num_heads, head_dim, warps, smem,       \
                                     smem_dkv, scale, exact, s)              \
                  : launch_split<HDP, kDefer>(                               \
                        q_, k_, v_, do_, bq_, bk_, bv_, dq_, dk_, dv_, st_,  \
                        pa_, db_, batch, seq, num_heads, head_dim, warps,    \
                        smem, smem_dkv, scale, exact, s)
  switch (round16(head_dim)) {
    CLIPA_LAUNCH(16);
    CLIPA_LAUNCH(32);
    CLIPA_LAUNCH(48);
    CLIPA_LAUNCH(64);
    CLIPA_LAUNCH(80);
    CLIPA_LAUNCH(96);
    CLIPA_LAUNCH(112);
    CLIPA_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CLIPA_LAUNCH
}

}  // namespace

// q/k/v/do/dq/dk/dv: (batch * seq, num_heads * head_dim) bf16, contiguous,
// 16-byte aligned; bq/bk/bv: (num_heads * head_dim,) bf16, 16-byte aligned,
// or all null. head_dim must be a multiple of 8 and at most 128. The plan
// is ops/block_attention.py bwd_plan's (whole, warps, smem, smem_dkv):
//   whole 1: the whole-head scheme (L <= 16 kMaxChunks), `warps` one per
//     16-row chunk of L, one item in shared memory per block, `smem` its
//     bytes, smem_dkv 0; stats unused (may be null); partial:
//     3 * batch * num_heads * head_dim fp32 scratch;
//   whole 0: the split scheme, `warps` 4, `smem` and `smem_dkv` the dq and
//     dk/dv kernels' bytes; stats: 3 * batch * seq * num_heads fp32
//     scratch; partial: 3 * batch * ceil(seq / 64) * num_heads * head_dim.
// Each size must be its kernel's for that plan. With biases, partial and
// dbias (3 * num_heads * head_dim bf16: dbq, dbk, dbv, each the fp32
// column sum rounded once) are set; both null without. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a plan or shape
// it refuses).
extern "C" int clipa_fused_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bq, const void* bk, const void* bv, void* dq, void* dk,
    void* dv, void* stats, void* partial, void* dbias, int batch, int seq,
    int num_heads, int head_dim, int whole, int warps, int smem,
    int smem_dkv, float scale, int exact, void* stream) {
  return launch_bf16<false>(q, k, v, dout, bq, bk, bv, dq, dk, dv, stats,
                            partial, dbias, batch, seq, num_heads, head_dim,
                            whole, warps, smem, smem_dkv, scale, exact,
                            stream);
}

// The deferred-normalization variant: the same arguments, limits and
// outputs, the split scheme only (bf16 only; see the header).
extern "C" int clipa_fused_attention_bwd_deferred(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bq, const void* bk, const void* bv, void* dq, void* dk,
    void* dv, void* stats, void* partial, void* dbias, int batch, int seq,
    int num_heads, int head_dim, int whole, int warps, int smem,
    int smem_dkv, float scale, int exact, void* stream) {
  return launch_bf16<true>(q, k, v, dout, bq, bk, bv, dq, dk, dv, stats,
                           partial, dbias, batch, seq, num_heads, head_dim,
                           whole, warps, smem, smem_dkv, scale, exact,
                           stream);
}

// The fp32 twin: the same arguments but the plan, the same limits, fp32
// tensors (4-byte aligned suffices); `partial` is not used (the bias grads
// are the column sums of the fp32 dq/dk/dv), `dbias` is set iff the biases
// are.
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
