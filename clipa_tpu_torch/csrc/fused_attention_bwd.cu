// Fused multi-head self-attention backward for Hopper (sm_90a), bf16 in/out.
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
//   long (L > 144: the H/14 unmask-tuning stages' L = 180 at 224 px, mask
//   0.3, and L = 346 at 336 px, mask 0.4; up to the 577 of an unmasked
//   336 px tower): S and dP of a 16-query strip over every key no longer
//   fit in registers, nor bf16(P) and dsb beside the operands in shared
//   memory, so a dq kernel and a dk/dv kernel share the row statistics
//   through device memory, built as the fused forward is: one warp per
//   16-row strip, the strips of a (sample, head) spread over `blocks`
//   blocks of `warps` warps (bwd_plan ranks the splits as fwd_plan does,
//   then by blocks resident per SM: L = 180 at hd 80 two blocks of 6
//   warps, L = 346 two of 11), the streamed operands through a cp.async
//   ring of `stages` 128-row tiles that holds every row where it fits
//   (L = 180 and 346 at hd 80: no refill barrier), else two stages;
//     1. dq kernel: the block's Q and dO strips, K and V through the ring,
//        each thread biasing the chunks it copied (RowSlice, bf16x2, one
//        rounding). Sweep A, per 16-key chunk: S and dP through ldmatrix
//        fragments, e by exp2 with the scale in the exponent and the clip
//        in the log2 domain (exact mode: against the running row max,
//        rescaling), r = rowsum(e) and u = rowsum(e dP), two chunks per
//        step with Q's and dO's fragments loaded once for both (twice the
//        independent products in flight). Then lse2 = m +
//        log2(r) and delta = u / r (rowsum(dP * P), from p and dp) go to a
//        (2, B * L * H) fp32 scratch. Sweep B: S and dP again, p = 2^(x -
//        lse2), dsb, and dQ += dsb Kb with dsb's A fragments straight from
//        the registers and Kb through ldmatrix.trans; where the ring holds
//        every key, sweep B reads the tiles sweep A left there;
//     2. dk/dv kernel: the block's K and V strips (biased), Q (biased), dO
//        and the statistics through the ring; per 16-query chunk S^T and
//        dP^T, then P^T and dS^T, dV += bf16(P^T) dO and dK += dsb^T Qb
//        (dO and Qb through ldmatrix.trans), fp32 registers rounded once;
//     3. bias grads: each block's fp32 column sums of its strips (the warps
//        in order) as one partial per (sample, block); the second pass
//        sums them in a fixed order.
//   9 products; nothing past L is loaded or computed (16-row strips, 16-key
//   chunks: L = 180 pads to 192, not 256), no tile is copied or biased more
//   than once per block, and every fragment comes through ldmatrix. Its
//   bound at the H/14 fine-tune shapes (D = 1280, 16 heads of 80; q, k, v,
//   dO in and dq, dk, dv out once each): B = 64, L = 180: 0.0616 ms by
//   bytes; B = 16, L = 346: 0.0296 ms. Latency and
//   instruction issue hold it back, as at the pretrain shapes: three warps
//   per SM sub-partition, each product's accumulation a chain of 5
//   dependent mma at hd 80; the two-chunk step of sweeps A and B doubles
//   the independent chains (8-9% faster at both shapes, measured in turns).
// Tensor cores: mma.sync m16n8k16 (bf16 in, fp32 accumulate); a wgmma
// tile's 64 rows would be mostly padding at L = 37 or 50.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bench.py --kernels
// fused, device time, this design and the previous one, a dq and a dk/dv
// kernel over 64-row tiles with synchronous loads, in turns in one run): B =
// 384, L = 50, D = 1024 (L/16 @112, bias, clip) 0.1642-0.1646 ms, 50% of its
// bound, against 0.7069-0.7115; B = 256, L = 37, D = 1280 (H/14 @84)
// 0.1017-0.1019 against 0.4594-0.4615; B = 128, L = 138 (fine-tune `auto`)
// 0.2553 against 1.3008-1.3078; the exact form without bias at L = 50
// 0.1261-0.1273 against 0.4577-0.4594 and SDPA's backward 0.3471-0.3478. The
// biases (their adds, the column sums, the second pass) are most of the gap
// between the biased clip form's 0.164 ms at L = 50 and the unbiased exact
// form's 0.127.
// The long scheme (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bench.py
// --kernels fused, device time, against that 64-row-tile pair in one run,
// then against its own variants in turns): B = 64, L = 180 (bias, clip)
// 0.3806-0.3872 ms, 16% of the bound, against the pair's 0.9131-0.9181; B =
// 16, L = 346 0.2807-0.2840, 10.5%, against 0.7696-0.7733; the exact form
// without bias 0.2964-0.2981 at L = 180 and 0.2439-0.2466 at L = 346 against
// SDPA's backward 0.2736-0.2759 and 0.1549-0.1584 (1.08x, 1.57x). Other
// shapes in PERF.md section 6.
//
// bf16 operands only: the wrapper refuses others. fp32 attention on the card
// takes the flash kernels' fp32 twins (ops/attention.py, impl "auto"); a
// scalar fp32 pair of kernels here took 15 times the plain version's time
// (B = 8, L = 257: PERF.md section 6).
//
// Deferred normalization (entry clipa_fused_attention_bwd_deferred): the
// backward variant that clipa_tpu/tools/attn_sweep.py:76
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
// attention_plain_bwd(..., defer=True). It takes the whole-head scheme alone
// (L <= 144; the sweep's L = 50; ops/block_attention.py bwd_deferred_plan
// refuses longer sequences): the kernel above with kDefer. Per warp and
// 16-row query strip, in registers: S = Qb Kb^T over every key, e and denom
// (quad shuffles); then per 16-column chunk of the head dim dO's A fragment
// through ldmatrix, divided by its row's denom (IEEE, one rounding) into
// dohn, written back over the strip's dO rows (only this warp reads them
// before the barrier) and multiplied into dphat = dohn Vb^T; u =
// rowsum(dphat e) / denom, ds, dsb and dQ = dsb Kb as in the normalized
// form. After the barrier bf16(e) and dsb replace K and V, and dV =
// bf16(e)^T dohn, dK = dsb^T Qb per key strip. 5 products, as the normalized
// form; no statistics leave the block.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bench.py --kernels
// deferred, in turns with the 64-row-tile pair it replaced at this L): B =
// 384, L = 50, D = 1024, bias, 0.2413-0.2430 ms (clip) and 0.2387-0.2439
// (exact) by CUDA events, against 0.6791-0.6839 and 0.6382-0.6472;
// 1.36-1.40x the normalized form's 0.1735-0.1781 in the same run: dohn needs
// denom, so dphat = dohn Vb^T waits for S and its row sums, behind a pass
// over dO's fragments with an IEEE division per element, where the
// normalized form forms S and dP side by side.

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kMaxChunks = 9;       // whole-head: L <= 16 kMaxChunks
constexpr float kExpClip = 70.f;    // block_attention._EXP_CLIP
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClipLog2 = kExpClip * kLog2e;
constexpr float kNegInf = -1e30f;

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

// The whole-head scheme: persistent blocks of kNc warps (one per 16-row
// strip: L <= 16 kNc), each walking the (head, sample) items blockIdx.x,
// + gridDim.x, ..., one item's operands in shared memory at a time.
// Warp w owns query strip w in phase 1 and key strip w in phase 2.
// partial: null, or the (3, batch, num_heads * hd) fp32 column sums of
// each sample's dq, dk and dv rows. kDefer: the deferred-normalization
// form (the header's), whose dohn overwrites the strip's dO rows.
template <int kHdp, int kNc, bool kDefer>
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

    // Phase 1, query strip `warp`: S = Qb Kb^T and (normalized form) dP =
    // dO Vb^T over every key. Element i of n-tile nt: query q0 + g + 8
    // (i >> 1), key 8 nt + 2t + (i & 1).
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
      if (!kDefer) {
        ldsm_x4(ado, ldsm_rows16(sdo + q0 * kStride + kc * 16, kStride));
      }
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        uint32_t bm[4];
        ldsm_x4(bm, ldsm_rows8x2(sk + c * 16 * kStride + kc * 16, kStride));
        mma_16816(s[2 * c], aq, bm[0], bm[1]);
        mma_16816(s[2 * c + 1], aq, bm[2], bm[3]);
        if (!kDefer) {
          ldsm_x4(bm,
                  ldsm_rows8x2(sv + c * 16 * kStride + kc * 16, kStride));
          mma_16816(dp[2 * c], ado, bm[0], bm[1]);
          mma_16816(dp[2 * c + 1], ado, bm[2], bm[3]);
        }
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
    // denom = rowsum(e); normalized form: p = e / denom (0 on query rows
    // past L), u = rowsum(dp * p), dsb = bf16(p (dp - u) scale); deferred
    // form: e stays (0 on rows past L), u = rowsum(dphat * e) / denom,
    // dsb = bf16(e (dphat - u) scale); 0 where the clip saturates
    float den[2], u[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * kNc; ++nt) sum += s[nt][2 * r] + s[nt][2 * r + 1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const bool valid = q0 + g + 8 * r < seq;
      den[r] = kDefer ? (valid ? sum : 1.f) : (valid ? 1.f / sum : 0.f);
      if (kDefer && !valid) {
#pragma unroll
        for (int nt = 0; nt < 2 * kNc; ++nt) s[nt][2 * r] = s[nt][2 * r + 1] = 0.f;
      }
    }
    if (kDefer) {
      // dohn = bf16(dO / denom) in dO's A fragments (IEEE division, one
      // rounding), written back over the strip's dO rows for dV; dphat =
      // dohn Vb^T. Register j of a fragment holds row g + 8 (j & 1).
#pragma unroll
      for (int kc = 0; kc < kHdp / 16; ++kc) {
        bf16* rows = sdo + q0 * kStride + kc * 16;
        uint32_t ado[4];
        ldsm_x4(ado, ldsm_rows16(rows, kStride));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ado[j]));
          ado[j] = pack_floats(__fdiv_rn(f.x, den[j & 1]),
                               __fdiv_rn(f.y, den[j & 1]));
        }
        __syncwarp();   // every lane's ldmatrix read precedes the stores
        bf16* d = rows + g * kStride + 2 * t;
        *reinterpret_cast<uint32_t*>(d) = ado[0];
        *reinterpret_cast<uint32_t*>(d + 8 * kStride) = ado[1];
        *reinterpret_cast<uint32_t*>(d + 8) = ado[2];
        *reinterpret_cast<uint32_t*>(d + 8 * kStride + 8) = ado[3];
#pragma unroll
        for (int c = 0; c < kNc; ++c) {
          uint32_t bm[4];
          ldsm_x4(bm,
                  ldsm_rows8x2(sv + c * 16 * kStride + kc * 16, kStride));
          mma_16816(dp[2 * c], ado, bm[0], bm[1]);
          mma_16816(dp[2 * c + 1], ado, bm[2], bm[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!kDefer) s[nt][i] *= den[i >> 1];
        u[i >> 1] = fmaf(dp[nt][i], s[nt][i], u[i >> 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      u[r] += __shfl_xor_sync(0xffffffffu, u[r], 1);
      u[r] += __shfl_xor_sync(0xffffffffu, u[r], 2);
      if (kDefer) u[r] = __fdiv_rn(u[r], den[r]);
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

    // Phase 2, key strip `warp`: dV = bf16(P)^T dO (deferred: bf16(e)^T
    // dohn), dK = dsb^T Qb, the A fragments of the transposes through
    // ldmatrix.trans.
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

// ---------------------------------------------------------------------------
// The long scheme (L past 16 kMaxChunks): two kernels over 16-row strips.
// The strips of a (sample, head) spread over `blocks` blocks of `warps`
// warps (one warp per strip, as the fused forward spreads its query
// strips); the other operand pair streams through a ring of `stages`
// 128-row tiles, every tile in flight at once where the ring holds the
// whole sequence.
// ---------------------------------------------------------------------------

constexpr int kRingTile = 128;   // rows per ring tile
constexpr int kMaxStages = 8;    // the deepest ring the launcher takes

// The long scheme's shared memory per block, in bytes. dq kernel: the
// block's Q and dO strips, the K and V rings (`ring` rows each), then the
// warps' fp32 column sums of dq. dk/dv kernel: its K and V strips, the Q
// and dO rings, the ring's fp32 row statistics (lse2, then delta), then the
// warps' column sums of dk and of dv.
__host__ __device__ inline int long_smem_dq(int hdp, int warps, int ring) {
  return (2 * warps * 16 + 2 * ring) * (hdp + 8) * (int)sizeof(bf16) +
         warps * hdp * (int)sizeof(float);
}
__host__ __device__ inline int long_smem_dkv(int hdp, int warps, int ring) {
  return (2 * warps * 16 + 2 * ring) * (hdp + 8) * (int)sizeof(bf16) +
         (2 * ring + 2 * warps * hdp) * (int)sizeof(float);
}

// acc[2c], acc[2c + 1] (16 x 16 each) = A . B_c^T for a warp's 16-row
// block `a_rows` and the kN 16-row blocks B_c at b_rows + 16 c rows (all
// row-major over the head dim, stride kHdp + 8): A's fragment loaded once
// per 16 columns for the kN blocks, every fragment through ldmatrix.
template <int kHdp, int kN>
__device__ __forceinline__ void mma_scores(float acc[2 * kN][4],
                                           const bf16* a_rows,
                                           const bf16* b_rows) {
  constexpr int kStride = kHdp + 8;
#pragma unroll
  for (int nt = 0; nt < 2 * kN; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < kHdp / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, ldsm_rows16(a_rows + kc * 16, kStride));
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      uint32_t b[4];
      ldsm_x4(b, ldsm_rows8x2(b_rows + c * 16 * kStride + kc * 16, kStride));
      mma_16816(acc[2 * c], a, b[0], b[1]);
      mma_16816(acc[2 * c + 1], a, b[2], b[3]);
    }
  }
}

// Sweep A of the dq kernel over kN 16-key chunks (keys at `skc`, V rows at
// `svc`, the first key key0; every chunk holds a key below L) for a warp's
// 16 query rows (`sqw`, dO at `sdow`): S = Qb Kb^T and dP = dO Vb^T, then
// this thread's row statistics (rows g and g + 8), partial over its key
// columns: r = sum(e), u = sum(e dp). Clip mode: e = 2^clamp(s scale
// log2(e), +-70 log2(e)), 0 for keys past L (m stays 0). Exact mode: e =
// 2^(s scale log2(e) - m) against the running row max m (log2 domain,
// quad-reduced per step so the four threads of a row agree; r and u
// rescaled as it grows; keys past L at -1e30 before the max). Element i of
// n-tile nt: query g + 8 (i >> 1), key key0 + 8 nt + 2t + (i & 1).
template <int kHdp, int kN>
__device__ __forceinline__ void stats_chunks(float m[2], float r[2],
                                             float u[2], const bf16* sqw,
                                             const bf16* sdow,
                                             const bf16* skc,
                                             const bf16* svc, int key0,
                                             int seq, float scale_log2,
                                             int exact) {
  const int t = threadIdx.x % 4;
  float s[2 * kN][4], dp[2 * kN][4];
  mma_scores<kHdp, kN>(s, sqw, skc);
  mma_scores<kHdp, kN>(dp, sdow, svc);
  const bool ragged = seq - key0 < 16 * kN;
  if (exact) {
    float cm[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2 * kN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ragged && key0 + nt * 8 + 2 * t + (i & 1) >= seq) {
          s[nt][i] = kNegInf;
        }
        cm[i >> 1] = fmaxf(cm[i >> 1], s[nt][i]);
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      cm[row] = fmaxf(cm[row], __shfl_xor_sync(0xffffffffu, cm[row], 1));
      cm[row] = fmaxf(cm[row], __shfl_xor_sync(0xffffffffu, cm[row], 2));
      const float m_new = fmaxf(m[row], cm[row] * scale_log2);
      const float alpha = ex2(m[row] - m_new);
      m[row] = m_new;
      r[row] *= alpha;
      u[row] *= alpha;
    }
#pragma unroll
    for (int nt = 0; nt < 2 * kN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = ex2(fmaf(s[nt][i], scale_log2, -m[i >> 1]));
        r[i >> 1] += e;
        u[i >> 1] = fmaf(e, dp[nt][i], u[i >> 1]);
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 2 * kN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e = ex2(fminf(fmaxf(s[nt][i] * scale_log2, -kClipLog2),
                            kClipLog2));
        if (ragged && key0 + nt * 8 + 2 * t + (i & 1) >= seq) e = 0.f;
        r[i >> 1] += e;
        u[i >> 1] = fmaf(e, dp[nt][i], u[i >> 1]);
      }
    }
  }
}

// Sweep B of the dq kernel over kN chunks: S and dP again, p = 2^(x -
// lse2) with x the clipped (clip mode) or raw (exact mode) s scale log2(e)
// and lse2 = m + log2(r) the row's statistic, ds = p (dp - delta) scale,
// zeroed where |s scale| >= 70 in clip mode and for keys past L; then acc
// += bf16(ds) Kb, the A fragments straight from the registers, Kb through
// ldmatrix.trans.
template <int kHdp, int kN>
__device__ __forceinline__ void dq_chunks(float acc[kHdp / 8][4],
                                          const float lse2[2],
                                          const float delta[2],
                                          const bf16* sqw, const bf16* sdow,
                                          const bf16* skc, const bf16* svc,
                                          int key0, int seq, float scale,
                                          float scale_log2, int exact) {
  constexpr int kStride = kHdp + 8;
  const int t = threadIdx.x % 4;
  float s[2 * kN][4], dp[2 * kN][4];
  mma_scores<kHdp, kN>(s, sqw, skc);
  mma_scores<kHdp, kN>(dp, sdow, svc);
  const bool ragged = seq - key0 < 16 * kN;
  if (exact) {
#pragma unroll
    for (int nt = 0; nt < 2 * kN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i >> 1;
        const float p = ex2(fmaf(s[nt][i], scale_log2, -lse2[row]));
        s[nt][i] = p * (dp[nt][i] - delta[row]) * scale;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 2 * kN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i >> 1;
        const float x = s[nt][i] * scale_log2;
        const float p =
            ex2(fminf(fmaxf(x, -kClipLog2), kClipLog2) - lse2[row]);
        const float ds = p * (dp[nt][i] - delta[row]) * scale;
        // the clip's own gradient: 0 where |s scale| >= 70
        s[nt][i] = fabsf(s[nt][i] * scale) >= kExpClip ? 0.f : ds;
      }
    }
  }
  if (ragged) {
#pragma unroll
    for (int nt = 0; nt < 2 * kN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (key0 + nt * 8 + 2 * t + (i & 1) >= seq) s[nt][i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    uint32_t a[4];
    pack_a(a, s[2 * c], s[2 * c + 1]);
    mma_rows16<kHdp>(acc, a, skc + c * 16 * kStride);
  }
}

// One 16-query chunk (Qb at `sqc`, dO at `sdoc`, the statistics of its
// rows at lse2_c and delta_c, the first query query0) for the warp that
// owns the 16 keys at `skw` (Vb at `svw`, the first key key0): S^T = Kb
// Qb^T and dP^T = Vb dO^T, P^T and dS^T as in dq_chunks (0 for keys or
// queries past L), then dv += bf16(P^T) dO and dk += bf16(dS^T) Qb, dO and
// Qb through ldmatrix.trans. Element i of n-tile nt: key key0 + g + 8 (i >>
// 1), query query0 + 8 nt + 2t + (i & 1).
template <int kHdp>
__device__ __forceinline__ void key_chunk(float dk[kHdp / 8][4],
                                          float dv[kHdp / 8][4],
                                          const bf16* skw, const bf16* svw,
                                          const bf16* sqc, const bf16* sdoc,
                                          const float* lse2_c,
                                          const float* delta_c, int key0,
                                          int query0, int seq, float scale,
                                          float scale_log2, int exact) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float st[2][4], dpt[2][4];
  mma_scores<kHdp, 1>(st, skw, sqc);
  mma_scores<kHdp, 1>(dpt, svw, sdoc);
  float2 l2[2], d2[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    l2[nt] = *reinterpret_cast<const float2*>(lse2_c + nt * 8 + 2 * t);
    d2[nt] = *reinterpret_cast<const float2*>(delta_c + nt * 8 + 2 * t);
  }
  if (exact) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l = (i & 1) ? l2[nt].y : l2[nt].x;
        const float dl = (i & 1) ? d2[nt].y : d2[nt].x;
        const float p = ex2(fmaf(st[nt][i], scale_log2, -l));
        dpt[nt][i] = p * (dpt[nt][i] - dl) * scale;
        st[nt][i] = p;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l = (i & 1) ? l2[nt].y : l2[nt].x;
        const float dl = (i & 1) ? d2[nt].y : d2[nt].x;
        const float x = st[nt][i] * scale_log2;
        const float p =
            ex2(fminf(fmaxf(x, -kClipLog2), kClipLog2) - l);
        const float ds = p * (dpt[nt][i] - dl) * scale;
        dpt[nt][i] = fabsf(st[nt][i] * scale) >= kExpClip ? 0.f : ds;
        st[nt][i] = p;
      }
    }
  }
  // keys or queries past L: 0 (a select, not a branch)
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = key0 + g + 8 * (i >> 1) < seq &&
                      query0 + nt * 8 + 2 * t + (i & 1) < seq;
      st[nt][i] = ok ? st[nt][i] : 0.f;
      dpt[nt][i] = ok ? dpt[nt][i] : 0.f;
    }
  }
  uint32_t pa[4], da[4];
  pack_a(pa, st[0], st[1]);
  pack_a(da, dpt[0], dpt[1]);
  mma_rows16<kHdp>(dv, pa, sdoc);
  mma_rows16<kHdp>(dk, da, sqc);
}

// After a barrier that makes the warps' sums visible: this block's fp32
// column sums, its first `n` warps' rows of `colsum` (kHdp floats each)
// summed in order, to out[0, hd).
template <int kHdp>
__device__ __forceinline__ void block_colsum(const float* colsum, int n,
                                             float* out, int hd) {
  __syncthreads();
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < n; ++w) sum += colsum[w * kHdp + c];
    out[c] = sum;
  }
}

// Kernel 1 of the long scheme: dq and the softmax statistics, grid
// (blocks, num_heads, batch). Each block copies its Q and dO strips and
// streams K and V through the ring; sweep A over every key tile gives each
// query row m, r and u, hence lse2 = m + log2(r) and delta = rowsum(dP * P)
// = u / r (written to stats: lse2 at [(sample * num_heads + head) * seq +
// row], delta n_stats further); sweep B over the tiles again forms dq in
// fp32 registers. Where the ring holds every key, sweep B reads the tiles
// sweep A left in it; else it streams (and biases) them once more.
// partial: null, or the fp32 column sums of dq per (sample, block).
template <int kHdp>
__global__ void __launch_bounds__(flash_max_warps(kHdp) * 32)
attention_bwd_long_dq_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const bf16* __restrict__ bq,
                             const bf16* __restrict__ bk,
                             const bf16* __restrict__ bv,
                             bf16* __restrict__ dq, float* __restrict__ stats,
                             float* __restrict__ partial, int seq,
                             int num_heads, int hd, int stages, float scale,
                             int exact, int n_stats) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warps = nthreads / 32, warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ring = ring_rows(seq, stages, kRingTile);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + warps * 16 * kStride;
  bf16* sk = sdo + warps * 16 * kStride;
  bf16* sv = sk + ring * kStride;
  float* colsum = reinterpret_cast<float*>(sv + ring * kStride);

  const int h = blockIdx.y;
  const int ld = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * ld + (size_t)h * hd;
  const int2 strips = strip_range((seq + 15) / 16, gridDim.x, blockIdx.x);
  const int q0 = strips.x * 16, q_rows = (strips.y - strips.x) * 16;
  // A warp past the block's strips only helps with the copies.
  const bool active = strips.x + warp < strips.y;
  const int ntiles = (seq + kRingTile - 1) / kRingTile;
  const int inflight = min(stages, ntiles);
  const bool resident = stages >= ntiles;   // the ring holds every key
  const int loads = resident ? ntiles : 2 * ntiles;
  const float scale_log2 = scale * kLog2e;
  const RowSlice<kHdp> slice(tid, nthreads);

  auto tile_rows = [&](int tile) {
    return min(kRingTile, round16(seq - tile * kRingTile));
  };
  // Load `load` brings key tile load % ntiles into ring stage load %
  // stages, as one commit group (empty past the last load, so the group
  // count stays uniform).
  auto stage = [&](int load) { return (load % stages) * kRingTile * kStride; };
  auto issue = [&](int load) {
    if (load < loads) {
      const int tile = load % ntiles;
      issue_rows<kHdp>(sk + stage(load), k + base, tile * kRingTile,
                       tile_rows(tile), seq, hd, ld, slice);
      issue_rows<kHdp>(sv + stage(load), v + base, tile * kRingTile,
                       tile_rows(tile), seq, hd, ld, slice);
    }
    cp_async_commit();
  };
  // Q and dO ride with the first load.
  issue_rows<kHdp>(sq, q + base, q0, q_rows, seq, hd, ld, slice);
  issue_rows<kHdp>(sdo, dout + base, q0, q_rows, seq, hd, ld, slice);
  for (int load = 0; load < inflight; ++load) issue(load);

  const bf16* sqw = sq + warp * 16 * kStride;
  const bf16* sdow = sdo + warp * 16 * kStride;
  float m[2] = {exact ? kNegInf : 0.f, exact ? kNegInf : 0.f};
  float r[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float lse2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  // Turn j: sweep A over tile j (j < ntiles), else sweep B over tile j -
  // ntiles; load j arrives in turn j (every load before sweep B where the
  // ring holds every key).
  for (int j = 0; j < 2 * ntiles; ++j) {
    const int tile = j % ntiles;
    const bool arrives = j < loads;
    if (arrives) {
      cp_async_wait_n(inflight - 1);   // this thread's copies of load j
      if (bq != nullptr) {
        if (j == 0) {
          add_bias_rows<kHdp>(sq, bq + h * hd, q0, q_rows, seq, hd, slice);
        }
        add_bias_rows<kHdp>(sk + stage(j), bk + h * hd, tile * kRingTile,
                            tile_rows(tile), seq, hd, slice);
        add_bias_rows<kHdp>(sv + stage(j), bv + h * hd, tile * kRingTile,
                            tile_rows(tile), seq, hd, slice);
      }
      __syncthreads();   // this tile (and Q), biased, for every warp
    }
    if (active) {
      if (j == ntiles) {
        // the row statistics, whole: quad sums, then lse2 and delta
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          r[row] += __shfl_xor_sync(0xffffffffu, r[row], 1);
          r[row] += __shfl_xor_sync(0xffffffffu, r[row], 2);
          u[row] += __shfl_xor_sync(0xffffffffu, u[row], 1);
          u[row] += __shfl_xor_sync(0xffffffffu, u[row], 2);
          delta[row] = u[row] / r[row];
          lse2[row] = m[row] + log2f(r[row]);
          const int qrow = q0 + warp * 16 + g + 8 * row;
          if (t == 0 && qrow < seq) {
            const size_t at =
                ((size_t)blockIdx.z * num_heads + h) * seq + qrow;
            stats[at] = lse2[row];
            stats[n_stats + at] = delta[row];
          }
        }
      }
      const int k0 = tile * kRingTile;
      const int st = stage(resident ? tile : j);
      const int nc = min(kRingTile / 16, (seq - k0 + 15) / 16);
      // two 16-key chunks per step (twice the independent products in
      // flight), then the odd one
      for (int c = 0; c < nc; c += 2) {
        const bf16* skc = sk + st + c * 16 * kStride;
        const bf16* svc = sv + st + c * 16 * kStride;
        const int key0 = k0 + c * 16;
        if (j < ntiles) {
          if (c + 1 < nc) {
            stats_chunks<kHdp, 2>(m, r, u, sqw, sdow, skc, svc, key0, seq,
                                  scale_log2, exact);
          } else {
            stats_chunks<kHdp, 1>(m, r, u, sqw, sdow, skc, svc, key0, seq,
                                  scale_log2, exact);
          }
        } else if (c + 1 < nc) {
          dq_chunks<kHdp, 2>(acc, lse2, delta, sqw, sdow, skc, svc, key0,
                             seq, scale, scale_log2, exact);
        } else {
          dq_chunks<kHdp, 1>(acc, lse2, delta, sqw, sdow, skc, svc, key0,
                             seq, scale, scale_log2, exact);
        }
      }
    }
    if (arrives) {
      // a ring that refills: every warp done with this stage first
      if (inflight < loads) __syncthreads();
      issue(j + inflight);
    }
  }
  const int row0 = q0 + warp * 16;
  if (active) {
    store_strip<kHdp>(acc, dq + base, row0, seq, hd, ld, 1.f);
    if (partial != nullptr) {
      warp_colsum<kHdp>(acc, colsum + warp * kHdp, row0, seq);
    }
  }
  if (partial == nullptr) return;
  block_colsum<kHdp>(colsum, strips.y - strips.x,
                     partial + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) *
                                   ld + h * hd, hd);
}

// Kernel 2 of the long scheme: dk and dv, grid (blocks, num_heads, batch),
// the key strips spread as kernel 1 spreads the query strips. Each block
// copies its K and V strips and streams Q, dO and kernel 1's (lse2, delta)
// through the ring, one sweep; dK and dV accumulate in fp32 registers.
// partial_k/partial_v: null, or the fp32 column sums of dk and dv per
// (sample, block).
template <int kHdp>
__global__ void __launch_bounds__(flash_max_warps(kHdp) * 32)
attention_bwd_long_dkv_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const bf16* __restrict__ bq,
                              const bf16* __restrict__ bk,
                              const bf16* __restrict__ bv,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              const float* __restrict__ stats,
                              float* __restrict__ partial_k,
                              float* __restrict__ partial_v, int seq,
                              int num_heads, int hd, int stages, float scale,
                              int exact, int n_stats) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warps = nthreads / 32, warp = tid / 32;
  const int ring = ring_rows(seq, stages, kRingTile);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + warps * 16 * kStride;
  bf16* sq = sv + warps * 16 * kStride;
  bf16* sdo = sq + ring * kStride;
  float* s_lse2 = reinterpret_cast<float*>(sdo + ring * kStride);
  float* s_delta = s_lse2 + ring;
  float* colsum = s_delta + ring;

  const int h = blockIdx.y;
  const int ld = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * ld + (size_t)h * hd;
  const float* lse2_h = stats + ((size_t)blockIdx.z * num_heads + h) * seq;
  const float* delta_h = lse2_h + n_stats;
  const int2 strips = strip_range((seq + 15) / 16, gridDim.x, blockIdx.x);
  const int k0 = strips.x * 16, k_rows = (strips.y - strips.x) * 16;
  const bool active = strips.x + warp < strips.y;
  const int ntiles = (seq + kRingTile - 1) / kRingTile;
  const int inflight = min(stages, ntiles);
  const float scale_log2 = scale * kLog2e;
  const RowSlice<kHdp> slice(tid, nthreads);

  auto tile_rows = [&](int tile) {
    return min(kRingTile, round16(seq - tile * kRingTile));
  };
  auto stage = [&](int tile) { return (tile % stages) * kRingTile; };
  // Q, dO, lse2 and delta of query tile `tile`: one commit group (empty
  // past the last tile).
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int q0 = tile * kRingTile, n = tile_rows(tile);
      issue_rows<kHdp>(sq + stage(tile) * kStride, q + base, q0, n, seq, hd,
                       ld, slice);
      issue_rows<kHdp>(sdo + stage(tile) * kStride, dout + base, q0, n, seq,
                       hd, ld, slice);
      for (int i = tid; i < n; i += nthreads) {
        const bool ok = q0 + i < seq;
        cp_async_4(s_lse2 + stage(tile) + i, ok ? lse2_h + q0 + i : lse2_h,
                   ok);
        cp_async_4(s_delta + stage(tile) + i,
                   ok ? delta_h + q0 + i : delta_h, ok);
      }
    }
    cp_async_commit();
  };
  // K and V ride with the first query tile.
  issue_rows<kHdp>(sk, k + base, k0, k_rows, seq, hd, ld, slice);
  issue_rows<kHdp>(sv, v + base, k0, k_rows, seq, hd, ld, slice);
  for (int tile = 0; tile < inflight; ++tile) issue(tile);

  const bf16* skw = sk + warp * 16 * kStride;
  const bf16* svw = sv + warp * 16 * kStride;
  float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait_n(inflight - 1);   // this thread's copies of this tile
    if (bq != nullptr) {
      if (tile == 0) {
        add_bias_rows<kHdp>(sk, bk + h * hd, k0, k_rows, seq, hd, slice);
        add_bias_rows<kHdp>(sv, bv + h * hd, k0, k_rows, seq, hd, slice);
      }
      add_bias_rows<kHdp>(sq + stage(tile) * kStride, bq + h * hd,
                          tile * kRingTile, tile_rows(tile), seq, hd, slice);
    }
    __syncthreads();   // this tile (and K, V), biased, for every warp
    if (active) {
      const int q0 = tile * kRingTile;
      const int nc = min(kRingTile / 16, (seq - q0 + 15) / 16);
      for (int c = 0; c < nc; ++c) {
        const int at = stage(tile) + c * 16;
        key_chunk<kHdp>(dk_acc, dv_acc, skw, svw, sq + at * kStride,
                        sdo + at * kStride, s_lse2 + at, s_delta + at,
                        k0 + warp * 16, q0 + c * 16, seq, scale, scale_log2,
                        exact);
      }
    }
    // a ring that refills: every warp done with this stage first
    if (inflight < ntiles) __syncthreads();
    issue(tile + inflight);
  }
  const int row0 = k0 + warp * 16;
  if (active) {
    store_strip<kHdp>(dk_acc, dk + base, row0, seq, hd, ld, 1.f);
    store_strip<kHdp>(dv_acc, dv + base, row0, seq, hd, ld, 1.f);
    if (partial_k != nullptr) {
      warp_colsum<kHdp>(dk_acc, colsum + warp * kHdp, row0, seq);
      warp_colsum<kHdp>(dv_acc, colsum + (warps + warp) * kHdp, row0, seq);
    }
  }
  if (partial_k == nullptr) return;
  const size_t part =
      ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * ld + h * hd;
  block_colsum<kHdp>(colsum, strips.y - strips.x, partial_k + part, hd);
  block_colsum<kHdp>(colsum + warps * kHdp, strips.y - strips.x,
                     partial_v + part, hd);
}

// out[y * width + c] = sum over p < n of src_y[p * width + c] in fp32 and a
// fixed order (kSumGroups interleaved runs of rows, then the runs in
// order), rounded once to bf16: the bias grads from the per-sample or
// per-block partials. blockIdx.y selects q, k or v.
constexpr int kSumCols = 32, kSumGroups = 32;

__global__ void __launch_bounds__(kSumCols * kSumGroups)
column_sum_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, int n, int width,
                  bf16* __restrict__ out) {
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
    out[blockIdx.y * width + col] = __float2bfloat16_rn(r);
  }
}

int column_sums(const float* a, const float* b, const float* c, int n,
                int width, bf16* out, cudaStream_t stream) {
  const dim3 grid((width + kSumCols - 1) / kSumCols, 3);
  column_sum_kernel<<<grid, kSumCols * kSumGroups, 0, stream>>>(
      a, b, c, n, width, out);
  return (int)cudaGetLastError();
}

// The whole-head scheme at kNc chunks: the persistent grid (as many blocks
// as the card holds at once, at most one per item), then the bias grads
// from the per-sample partials.
template <int kHdp, int kNc, bool kDefer>
int launch_whole_nc(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const bf16* bq, const bf16* bk,
                    const bf16* bv, bf16* dq, bf16* dk, bf16* dv,
                    float* partial, bf16* dbias, int batch, int seq,
                    int num_heads, int hd, int smem, float scale, int exact,
                    cudaStream_t stream) {
  const void* fn =
      (const void*)attention_bwd_whole_kernel<kHdp, kNc, kDefer>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)batch * num_heads;
  const int resident = resident_blocks(fn, kNc * 32, smem);
  if (resident <= 0 || items > 0x7fffffff) {
    return (int)cudaErrorInvalidConfiguration;
  }
  attention_bwd_whole_kernel<kHdp, kNc, kDefer>
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
// kMaxChunks), one block per item, no ring, and this layout's shared memory.
// kDefer: the deferred form.
template <int kHdp, bool kDefer>
int launch_whole(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const bf16* bq, const bf16* bk,
                 const bf16* bv, bf16* dq, bf16* dk, bf16* dv, float* partial,
                 bf16* dbias, int batch, int seq, int num_heads, int hd,
                 int warps, int blocks, int stages, int smem, int smem_dkv,
                 float scale, int exact, cudaStream_t stream) {
  const int nc = (seq + 15) / 16;
  if (nc > kMaxChunks || warps != nc || blocks != 1 || stages != 0 ||
      smem_dkv != 0 || smem != whole_smem(16 * nc, kHdp)) {
    return (int)cudaErrorInvalidValue;
  }
#define CLIPA_WHOLE(NC)                                                   \
  case NC:                                                                \
    return launch_whole_nc<kHdp, NC, kDefer>(                             \
        q, k, v, dout, bq, bk, bv, dq, dk, dv, partial, dbias, batch, seq, \
        num_heads, hd, smem, scale, exact, stream)
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

// The long scheme: the dq kernel, the dk/dv kernel, then the bias grads
// from their per-(sample, block) partials. The plan's check: `blocks`
// blocks of `warps` warps (at most flash_max_warps) over the 16-row strips,
// every block at least one strip and at most `warps`; a ring of `stages`
// tiles (at least two, or one that holds every row; at most kMaxStages);
// and each kernel's shared memory this layout's.
template <int kHdp>
int launch_long(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                const bf16* bq, const bf16* bk, const bf16* bv, bf16* dq,
                bf16* dk, bf16* dv, float* stats, float* partial,
                bf16* dbias, int batch, int seq, int num_heads, int hd,
                int warps, int blocks, int stages, int smem, int smem_dkv,
                float scale, int exact, cudaStream_t stream) {
  const int ntiles = (seq + kRingTile - 1) / kRingTile;
  const int ring = ring_rows(seq, stages, kRingTile);
  if (stats == nullptr ||
      bad_plan(warps, blocks, (seq + 15) / 16, flash_max_warps(kHdp)) ||
      stages < 1 || stages > kMaxStages || (stages < 2 && ntiles > 1) ||
      smem != long_smem_dq(kHdp, warps, ring) ||
      smem_dkv != long_smem_dkv(kHdp, warps, ring)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_long_dq_kernel<kHdp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_long_dkv_kernel<kHdp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const int n_stats = batch * num_heads * seq;
  const size_t part_size = (size_t)batch * blocks * num_heads * hd;
  float* pq = partial;
  float* pk = partial ? partial + part_size : nullptr;
  float* pv = partial ? partial + 2 * part_size : nullptr;
  const dim3 grid(blocks, num_heads, batch);
  attention_bwd_long_dq_kernel<kHdp><<<grid, warps * 32, smem, stream>>>(
      q, k, v, dout, bq, bk, bv, dq, stats, pq, seq, num_heads, hd, stages,
      scale, exact, n_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_long_dkv_kernel<kHdp><<<grid, warps * 32, smem_dkv, stream>>>(
      q, k, v, dout, bq, bk, bv, dk, dv, stats, pk, pv, seq, num_heads, hd,
      stages, scale, exact, n_stats);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  return column_sums(pq, pk, pv, batch * blocks, num_heads * hd, dbias,
                     stream);
}

// The plan's schemes (ops/block_attention.py BWD_WHOLE, BWD_LONG).
constexpr int kWhole = 1, kLong = 2;

// The entries' body: kDefer selects the entry. The normalized one takes
// the whole-head and long schemes, the deferred one the whole-head scheme
// (its deferred form) alone.
template <bool kDefer>
int launch_entry(const void* q, const void* k, const void* v,
                 const void* dout, const void* bq, const void* bk,
                 const void* bv, void* dq, void* dk, void* dv, void* stats,
                 void* partial, void* dbias, int batch, int seq,
                 int num_heads, int head_dim, int scheme, int warps,
                 int blocks, int stages, int smem, int smem_dkv, float scale,
                 int exact, void* stream) {
  if (bad_shape(batch, seq, num_heads, head_dim) ||
      (bq == nullptr) != (bk == nullptr) ||
      (bq == nullptr) != (bv == nullptr) ||
      (bq != nullptr) != (partial != nullptr) ||
      (partial != nullptr) != (dbias != nullptr) ||
      (kDefer ? scheme != kWhole : scheme != kWhole && scheme != kLong)) {
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
    if (scheme == kWhole) {                                                  \
      return launch_whole<HDP, kDefer>(q_, k_, v_, do_, bq_, bk_, bv_, dq_,  \
                                       dk_, dv_, pa_, db_, batch, seq,       \
                                       num_heads, head_dim, warps, blocks,   \
                                       stages, smem, smem_dkv, scale, exact, \
                                       s);                                   \
    }                                                                        \
    return launch_long<HDP>(q_, k_, v_, do_, bq_, bk_, bv_, dq_, dk_, dv_,   \
                            st_, pa_, db_, batch, seq, num_heads, head_dim,  \
                            warps, blocks, stages, smem, smem_dkv, scale,    \
                            exact, s)
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
// is ops/block_attention.py bwd_plan's (scheme, warps, blocks, stages,
// smem, smem_dkv):
//   scheme 1 (whole-head, L <= 16 kMaxChunks): `warps` one per 16-row
//     chunk of L, blocks 1 (one item in shared memory per block), stages 0,
//     `smem` its bytes, smem_dkv 0; stats unused (may be null);
//   scheme 2 (long): `blocks` blocks of `warps` warps per (sample, head),
//     a ring of `stages` 128-row tiles, `smem` and `smem_dkv` the dq and
//     dk/dv kernels' bytes; stats: 2 * batch * seq * num_heads fp32
//     scratch (lse2, delta).
// Each size must be its kernel's for that plan. With biases, partial
// (3 * batch * blocks * num_heads * head_dim fp32 scratch) and dbias
// (3 * num_heads * head_dim bf16: dbq, dbk, dbv, each the fp32 column sum
// rounded once) are set; both null without. Returns the cudaError_t of the
// launches (cudaErrorInvalidValue for a plan or shape it refuses).
extern "C" int clipa_fused_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bq, const void* bk, const void* bv, void* dq, void* dk,
    void* dv, void* stats, void* partial, void* dbias, int batch, int seq,
    int num_heads, int head_dim, int scheme, int warps, int blocks,
    int stages, int smem, int smem_dkv, float scale, int exact,
    void* stream) {
  return launch_entry<false>(q, k, v, dout, bq, bk, bv, dq, dk, dv, stats,
                             partial, dbias, batch, seq, num_heads, head_dim,
                             scheme, warps, blocks, stages, smem, smem_dkv,
                             scale, exact, stream);
}

// The deferred-normalization variant (see the header): the same arguments,
// limits and outputs, scheme 1 only (the whole-head scheme's deferred form,
// L <= 16 kMaxChunks).
extern "C" int clipa_fused_attention_bwd_deferred(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bq, const void* bk, const void* bv, void* dq, void* dk,
    void* dv, void* stats, void* partial, void* dbias, int batch, int seq,
    int num_heads, int head_dim, int scheme, int warps, int blocks,
    int stages, int smem, int smem_dkv, float scale, int exact,
    void* stream) {
  return launch_entry<true>(q, k, v, dout, bq, bk, bv, dq, dk, dv, stats,
                            partial, dbias, batch, seq, num_heads, head_dim,
                            scheme, warps, blocks, stages, smem, smem_dkv,
                            scale, exact, stream);
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
