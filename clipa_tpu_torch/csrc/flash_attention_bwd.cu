// Tiled flash attention backward for Hopper (sm_90a), bf16 or fp32 in/out
// (one entry point per operand type).
//
// Replaces the Pallas TPU kernels of clipa_tpu/ops/flash_attention.py
//   _dq_kernel  (:125, called at :192)   dQ over q-tiles, sweeping key tiles
//   _dkv_kernel (:152, called at :209)   dK/dV over key tiles, sweeping q-tiles
// and the XLA reduction delta = rowsum(dO * O) in front of them (:189). This
// is FlashAttention-2 with the JAX package's roundings, held against the
// plain PyTorch version flash_plain_bwd in ops/flash_attention.py:
//   delta = rowsum(dO . O) in fp32, from the stored (rounded) O
//   s  = (q . k) in fp32 times scale;  keys at or past lk get p = 0
//   p  = exp(s - LSE)  with the forward's saved LSE (the statistics are not
//        recomputed: that is this kernel's function, unlike the fused
//        backward's rowsum(dP * P))
//   dp = dO . V in fp32;   ds = p * (dp - delta)
//   dq = (bf16(ds) . K) * scale,  dk = (bf16(ds)^T . Q) * scale,
//   dv = bf16(p)^T . dO           (fp32 sums, the scale applied once, in
//                                  fp32, then rounded to bf16 once)
// Layouts as in flash_attention_fwd.cu: (B, L, H, hd) contiguous operands,
// LSE and delta (B, H, Lq) fp32; head-dim columns past hd zero-filled.
//
// What bounds it: at the unmask-tuning shape (B = 128, L = 138, 16 heads of
// 64) the function needs 25 GFLOP (5 products) and moves 291 MB (q, k, v,
// o, dO and LSE read, dq, dk, dv written): on an H100 SXM (data-sheet
// rates) device memory bounds it (0.087 ms at 3.35 TB/s; the products take
// 0.025 ms at 989 TFLOP/s), so latency and instruction count hold it back.
//
// Two schemes; ops/flash_attention.py launch_plan picks one per shape:
//   fused (short sequences: everything of one (sample, head) fits in shared
//   memory; self-attention up to L = 208 at hd 64, 192 at hd 80, 160 at hd
//   104-128): persistent blocks, each (sample, head) an item whose Q, dO,
//   K, V, LSE, delta and bf16(dS)^T sit in shared memory. S, P, dP and dS
//   are computed once per (query, key) pair: 5 products, where the
//   two-kernel scheme below computes S and dP twice (7).
//     1. cp.async: an item's Q, dO, K and V as one group, in flight while
//        the previous item is computed where two items fit (else after
//        it); then delta, one thread per row (16-byte loads of O, dO from
//        shared memory);
//     2. each warp owns 16-key strips: for every 16-query strip it forms
//        S^T and dP^T, then P^T and dS^T in registers, accumulates
//        dV += bf16(P^T) dO and dK += bf16(dS^T) Q, and stores bf16(dS^T)
//        to shared memory;
//     3. after one barrier each warp owns 16-query strips:
//        dQ = sum over key strips of bf16(dS) K, reading dS^T with
//        ldmatrix.trans.
//   Every sum runs in a fixed order inside one warp: no atomics, so two
//   calls give bit-identical dq, dk and dv. At L = 138 the 9 strips make 9
//   warps, each with one key strip and one query strip: none idles.
//   split (longer sequences): the TPU kernels' two kernels, asynchronous:
//     1. dq kernel, `blocks` blocks of `warps` warps per (sample, head), the
//        query strips spread evenly over them: delta for its rows (written
//        to the scratch `delta`), then K/V in 64-key tiles through a
//        two-stage cp.async ring, dQ in fp32 registers;
//     2. dk/dv kernel, the key strips spread likewise: Q, dO, LSE and delta
//        in 64-query tiles through the same kind of ring, dK and dV in fp32
//        registers. 7 products (S and dP in both), no atomics.
// Both schemes take every fragment through ldmatrix, with .trans for each
// operand contracted over its rows (K in dS.K, dO in P^T.dO, Q in dS^T.Q),
// and compute nothing for a 16-row or 16-key chunk wholly past the
// sequence end. Tensor cores: mma.sync m16n8k16 (bf16 in, fp32 sums); a
// wgmma tile's 64 rows would pad L = 138 to 192 where 16-row strips pad it
// to 144. Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bench.py,
// device time, this design and the previous one in turns in one run): the
// fused kernel 0.2525-0.2532 ms at the unmask-tuning shape, 34% of its
// bound, against the previous design's 0.6681-0.6691 ms, the split scheme's
// 0.3378 (`--plans`) and SDPA's backward 0.3403-0.3419 (CUDA events through
// the wrapper: 0.2606-0.2648 ms). The fused kernel also beats the split one
// at L = 180 hd 80 (0.2351-0.2373 against 0.3296) and at the 77 x 257
// cross-attention (0.0363-0.0365 against 0.0544). The other shapes are in
// PERF.md section 6.
//
// fp32 operands run scalar twins (one block per query row for dq, per key
// row for dk/dv; fp32 FMA, no TF32, nothing rounded). Right, not fast.

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kTile = 64;   // rows per ring stage of the split kernels

// delta = rowsum(dO . O) in fp32 for `rows` rows of one head from row0: dO
// from shared memory (row r at sdo + r * (kHdp + 8)), O from device memory,
// one thread per row, 16-byte loads, the columns in order. Writes s_delta
// and s_lse for the rows (0 past `len`) and, unless `delta` is null, delta
// for the rows below `len`.
template <int kHdp>
__device__ __forceinline__ void delta_rows(float* s_lse, float* s_delta,
                                           const bf16* sdo, const bf16* o,
                                           const float* lse, float* delta,
                                           int row0, int rows, int len,
                                           int hd, int ld) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int row = row0 + r;
    float sum = 0.f, l = 0.f;
    if (row < len) {
      const bf16* orow = o + (size_t)row * ld;
      const bf16* drow = sdo + r * (kHdp + 8);
#pragma unroll
      for (int c = 0; c < kHdp; c += 8) {
        if (c < hd) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 of = __bfloat1622float2(o2[j]);
            const float2 df = __bfloat1622float2(d2[j]);
            sum = fmaf(df.x, of.x, sum);
            sum = fmaf(df.y, of.y, sum);
          }
        }
      }
      l = lse[row];
      if (delta != nullptr) delta[row] = sum;
    }
    s_lse[r] = l;
    s_delta[r] = sum;
  }
}

// One (16-key strip, 16-query strip) step of the warp that owns the keys:
// S^T = K_j Q_i^T and dP^T = V_j dO_i^T (16 x 16 each); P^T = exp(S^T *
// scale - LSE_i) and dS^T = P^T (dP^T - delta_i), both 0 for keys at or past
// lk and queries at or past lq; dv += bf16(P^T) dO_i, dk += bf16(dS^T) Q_i.
// `ds` returns bf16(dS^T) as the A fragment of a 16 x 16 operand.
template <int kHdp>
__device__ __forceinline__ void key_strip_step(
    float dk[kHdp / 8][4], float dv[kHdp / 8][4], uint32_t ds[4],
    const bf16* skj, const bf16* svj, const bf16* sqi, const bf16* sdoi,
    const float* lse_i, const float* delta_i, int key0, int query0, int lk,
    int lq, float scale) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float st[2][4], dpt[2][4];
  mma_scores16<kHdp>(st, skj, sqi);
  mma_scores16<kHdp>(dpt, svj, sdoi);
  // Branch-free: the statistics of this thread's 4 query columns, then p
  // and ds for every element, zeroed past the sequence ends by a select.
  float2 l2[2], d2[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    l2[nt] = *reinterpret_cast<const float2*>(lse_i + nt * 8 + 2 * t);
    d2[nt] = *reinterpret_cast<const float2*>(delta_i + nt * 8 + 2 * t);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + g + 8 * (i >> 1);
      const int col = nt * 8 + 2 * t + (i & 1);  // query within the strip
      const bool ok = key < lk && query0 + col < lq;
      const float l = (i & 1) ? l2[nt].y : l2[nt].x;
      const float dl = (i & 1) ? d2[nt].y : d2[nt].x;
      const float p = __expf(st[nt][i] * scale - l);
      const float d = p * (dpt[nt][i] - dl);
      st[nt][i] = ok ? p : 0.f;
      dpt[nt][i] = ok ? d : 0.f;
    }
  }
  uint32_t pa[4];
  pack_a(pa, st[0], st[1]);
  pack_a(ds, dpt[0], dpt[1]);
  mma_rows16<kHdp>(dv, pa, sdoi);  // += bf16(p)^T . dO
  mma_rows16<kHdp>(dk, ds, sqi);   // += bf16(ds)^T . Q
}

template <int kHdp>
__device__ __forceinline__ void zero(float acc[kHdp / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < kHdp / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
}

// The fused scheme: persistent blocks, each walking the (head, sample)
// items blockIdx.x, + gridDim.x, ... With `two_stages` the shared memory
// holds two items' Q, dO, K and V, and the next item's copies are in
// flight while this one is computed; else one, refilled after it.
template <int kHdp>
__global__ void __launch_bounds__(flash_max_warps(kHdp) * 32)
flash_attention_bwd_fused_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ out,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int lq, int lk, int num_heads, int hd, int items, int two_stages,
    float scale) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warps = nthreads / 32, warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lqp = round16(lq), lkp = round16(lk);
  const int ds_stride = lqp + 8;
  const int ld = num_heads * hd;
  const int stage_elems = 2 * (lqp + lkp) * kStride;  // Q, dO, K, V
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stage0 = reinterpret_cast<bf16*>(smem);
  bf16* sds = stage0 + (two_stages ? 2 : 1) * stage_elems;  // [key][query]
  float* s_lse = reinterpret_cast<float*>(sds + lkp * ds_stride);
  float* s_delta = s_lse + lqp;

  auto issue = [&](int item, int st) {  // one item's copies: one group
    if (item < items) {
      const int h = item % num_heads, b = item / num_heads;
      const size_t qbase = (size_t)b * lq * ld + (size_t)h * hd;
      const size_t kbase = (size_t)b * lk * ld + (size_t)h * hd;
      bf16* sq = stage0 + st * stage_elems;
      load_rows_async<kHdp>(sq, q + qbase, 0, lqp, lq, hd, ld, tid,
                            nthreads);
      load_rows_async<kHdp>(sq + lqp * kStride, dout + qbase, 0, lqp, lq, hd,
                            ld, tid, nthreads);
      load_rows_async<kHdp>(sq + 2 * lqp * kStride, k + kbase, 0, lkp, lk,
                            hd, ld, tid, nthreads);
      load_rows_async<kHdp>(sq + (2 * lqp + lkp) * kStride, v + kbase, 0,
                            lkp, lk, hd, ld, tid, nthreads);
    }
    cp_async_commit();
  };
  issue(blockIdx.x, 0);
  int st = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    if (two_stages) {
      issue(item + gridDim.x, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this item's copies landed for every thread
    const int h = item % num_heads, b = item / num_heads;
    const size_t qbase = (size_t)b * lq * ld + (size_t)h * hd;
    const size_t kbase = (size_t)b * lk * ld + (size_t)h * hd;
    const size_t stat0 = ((size_t)b * num_heads + h) * lq;
    const bf16* sq = stage0 + st * stage_elems;
    const bf16* sdo = sq + lqp * kStride;
    const bf16* sk = sdo + lqp * kStride;
    const bf16* sv = sk + lkp * kStride;
    delta_rows<kHdp>(s_lse, s_delta, sdo, out + qbase, lse + stat0,
                     nullptr, 0, lqp, lq, hd, ld);
    __syncthreads();

    const int nks = lkp / 16, nqs = lqp / 16;
    for (int js = warp; js < nks; js += warps) {
      float dk_acc[kNt][4], dv_acc[kNt][4];
      zero<kHdp>(dk_acc);
      zero<kHdp>(dv_acc);
      const bf16* skj = sk + js * 16 * kStride;
      const bf16* svj = sv + js * 16 * kStride;
      for (int is = 0; is < nqs; ++is) {
        uint32_t ds[4];
        key_strip_step<kHdp>(dk_acc, dv_acc, ds, skj, svj,
                             sq + is * 16 * kStride, sdo + is * 16 * kStride,
                             s_lse + is * 16, s_delta + is * 16, js * 16,
                             is * 16, lk, lq, scale);
        // bf16(dS^T) rows js*16 + g (+8), columns is*16 + 2t (+8)
        bf16* d = sds + (js * 16 + g) * ds_stride + is * 16 + 2 * t;
        *reinterpret_cast<uint32_t*>(d) = ds[0];
        *reinterpret_cast<uint32_t*>(d + 8 * ds_stride) = ds[1];
        *reinterpret_cast<uint32_t*>(d + 8) = ds[2];
        *reinterpret_cast<uint32_t*>(d + 8 * ds_stride + 8) = ds[3];
      }
      store_strip<kHdp>(dk_acc, dk + kbase, js * 16, lk, hd, ld, scale);
      store_strip<kHdp>(dv_acc, dv + kbase, js * 16, lk, hd, ld, 1.f);
    }
    __syncthreads();  // every dS^T strip stored
    for (int is = warp; is < nqs; is += warps) {
      float acc[kNt][4];
      zero<kHdp>(acc);
      for (int js = 0; js < nks; ++js) {
        uint32_t a[4];  // bf16(dS) of (query strip is, key strip js)
        ldsm_x4_trans(a, ldsm_rows8x2(sds + js * 16 * ds_stride + is * 16,
                                      ds_stride));
        mma_rows16<kHdp>(acc, a, sk + js * 16 * kStride);
      }
      store_strip<kHdp>(acc, dq + qbase, is * 16, lq, hd, ld, scale);
    }
    __syncthreads();  // the stage, dS^T and the row statistics are free
    if (two_stages) {
      st ^= 1;
    } else {
      issue(item + gridDim.x, 0);
    }
  }
}

// Split scheme, kernel 1: delta and dq, `blocks` blocks per (sample, head).
template <int kHdp>
__global__ void __launch_bounds__(flash_max_warps(kHdp) * 32)
flash_attention_dq_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ out,
                          const float* __restrict__ lse,
                          const bf16* __restrict__ dout,
                          bf16* __restrict__ dq, float* __restrict__ delta,
                          int lq, int lk, int num_heads, int hd,
                          float scale) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rows = (nthreads / 32) * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + rows * kStride;
  bf16* sk = sdo + rows * kStride;
  bf16* sv = sk + 2 * kTile * kStride;
  float* s_lse = reinterpret_cast<float*>(sv + 2 * kTile * kStride);
  float* s_delta = s_lse + rows;

  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const size_t qbase = (size_t)b * lq * ld + (size_t)h * hd;
  const size_t kbase = (size_t)b * lk * ld + (size_t)h * hd;
  const size_t stat0 = ((size_t)b * num_heads + h) * lq;
  const int2 strips = strip_range((lq + 15) / 16, gridDim.x, blockIdx.x);
  const int q0 = strips.x * 16;
  const int nrows = (strips.y - strips.x) * 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool active = strips.x + warp < strips.y;
  const int ntiles = (lk + kTile - 1) / kTile;

  auto issue = [&](int tile) {  // K and V of a key tile: one group
    if (tile < ntiles) {
      const int k0 = tile * kTile;
      const int n = min(kTile, round16(lk - k0));
      const int stage = (tile & 1) * kTile * kStride;
      load_rows_async<kHdp>(sk + stage, k + kbase, k0, n, lk, hd, ld, tid,
                            nthreads);
      load_rows_async<kHdp>(sv + stage, v + kbase, k0, n, lk, hd, ld, tid,
                            nthreads);
    }
    cp_async_commit();
  };
  load_rows_async<kHdp>(sq, q + qbase, q0, nrows, lq, hd, ld, tid, nthreads);
  load_rows_async<kHdp>(sdo, dout + qbase, q0, nrows, lq, hd, ld, tid,
                        nthreads);
  cp_async_commit();
  issue(0);
  issue(1);
  cp_async_wait<2>();
  __syncthreads();  // Q and dO landed
  delta_rows<kHdp>(s_lse, s_delta, sdo, out + qbase, lse + stat0,
                   delta + stat0, q0, nrows, lq, hd, ld);
  __syncthreads();
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_lse[r] = s_lse[warp * 16 + g + 8 * r];
    row_delta[r] = s_delta[warp * 16 + g + 8 * r];
  }
  const bf16* sqw = sq + warp * 16 * kStride;
  const bf16* sdow = sdo + warp * 16 * kStride;
  float acc[kNt][4];
  zero<kHdp>(acc);
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<1>();
    __syncthreads();  // this key tile landed
    if (active) {
      const int k0 = tile * kTile;
      const int nck = min(kTile / 16, (lk - k0 + 15) / 16);
      const bf16* skt = sk + (tile & 1) * kTile * kStride;
      const bf16* svt = sv + (tile & 1) * kTile * kStride;
#pragma unroll
      for (int c = 0; c < kTile / 16; ++c) {
        if (c < nck) {
          float s[2][4], dp[2][4];
          mma_scores16<kHdp>(s, sqw, skt + c * 16 * kStride);
          mma_scores16<kHdp>(dp, sdow, svt + c * 16 * kStride);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i >> 1;
              const int key = k0 + c * 16 + nt * 8 + 2 * t + (i & 1);
              const float p = __expf(s[nt][i] * scale - row_lse[r]);
              const float d = p * (dp[nt][i] - row_delta[r]);
              s[nt][i] = key < lk ? d : 0.f;  // a select, not a branch
            }
          }
          uint32_t a[4];
          pack_a(a, s[0], s[1]);
          mma_rows16<kHdp>(acc, a, skt + c * 16 * kStride);  // += bf16(ds).K
        }
      }
    }
    __syncthreads();  // every warp done with this stage: refill it
    issue(tile + 2);
  }
  if (active) {
    store_strip<kHdp>(acc, dq + qbase, q0 + warp * 16, lq, hd, ld, scale);
  }
}

// Split scheme, kernel 2: dk and dv, `blocks` blocks per (sample, head),
// sweeping the query tiles with kernel 1's delta.
template <int kHdp>
__global__ void __launch_bounds__(flash_max_warps(kHdp) * 32)
flash_attention_dkv_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ lse,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int lq, int lk, int num_heads, int hd,
                           float scale) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rows = (nthreads / 32) * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + rows * kStride;
  bf16* sq = sv + rows * kStride;
  bf16* sdo = sq + 2 * kTile * kStride;
  float* s_lse = reinterpret_cast<float*>(sdo + 2 * kTile * kStride);
  float* s_delta = s_lse + 2 * kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const size_t qbase = (size_t)b * lq * ld + (size_t)h * hd;
  const size_t kbase = (size_t)b * lk * ld + (size_t)h * hd;
  const float* lse_h = lse + ((size_t)b * num_heads + h) * lq;
  const float* delta_h = delta + ((size_t)b * num_heads + h) * lq;
  const int2 strips = strip_range((lk + 15) / 16, gridDim.x, blockIdx.x);
  const int k0 = strips.x * 16;
  const int warp = tid / 32;
  const bool active = strips.x + warp < strips.y;
  const int ntiles = (lq + kTile - 1) / kTile;

  // Q, dO, LSE and delta of a query tile: one group.
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int q0 = tile * kTile;
      const int n = min(kTile, round16(lq - q0));
      const int stage = tile & 1;
      load_rows_async<kHdp>(sq + stage * kTile * kStride, q + qbase, q0, n,
                            lq, hd, ld, tid, nthreads);
      load_rows_async<kHdp>(sdo + stage * kTile * kStride, dout + qbase, q0,
                            n, lq, hd, ld, tid, nthreads);
      for (int i = tid; i < n; i += nthreads) {
        const bool ok = q0 + i < lq;
        cp_async_4(s_lse + stage * kTile + i, ok ? lse_h + q0 + i : lse_h,
                   ok);
        cp_async_4(s_delta + stage * kTile + i,
                   ok ? delta_h + q0 + i : delta_h, ok);
      }
    }
    cp_async_commit();
  };
  load_rows_async<kHdp>(sk, k + kbase, k0, (strips.y - strips.x) * 16, lk,
                        hd, ld, tid, nthreads);
  load_rows_async<kHdp>(sv, v + kbase, k0, (strips.y - strips.x) * 16, lk,
                        hd, ld, tid, nthreads);
  issue(0);  // K and V ride with the first query tile
  issue(1);
  const bf16* skw = sk + warp * 16 * kStride;
  const bf16* svw = sv + warp * 16 * kStride;

  float dk_acc[kNt][4], dv_acc[kNt][4];
  zero<kHdp>(dk_acc);
  zero<kHdp>(dv_acc);
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<1>();
    __syncthreads();  // this query tile landed
    if (active) {
      const int q0 = tile * kTile;
      const int nqc = min(kTile / 16, (lq - q0 + 15) / 16);
      const int stage = tile & 1;
      for (int c = 0; c < nqc; ++c) {
        uint32_t ds[4];
        key_strip_step<kHdp>(
            dk_acc, dv_acc, ds, skw, svw,
            sq + (stage * kTile + c * 16) * kStride,
            sdo + (stage * kTile + c * 16) * kStride,
            s_lse + stage * kTile + c * 16, s_delta + stage * kTile + c * 16,
            k0 + warp * 16, q0 + c * 16, lk, lq, scale);
      }
    }
    __syncthreads();  // every warp done with this stage: refill it
    issue(tile + 2);
  }
  if (!active) return;
  store_strip<kHdp>(dk_acc, dk + kbase, k0 + warp * 16, lk, hd, ld, scale);
  store_strip<kHdp>(dv_acc, dv + kbase, k0 + warp * 16, lk, hd, ld, 1.f);
}

// The plan's shared-memory sizes must be these layouts' (launch_plan
// computes the same ones); a plan with any other is refused.
template <int kHdp>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
           const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
           float* delta, int batch, int lq, int lk, int num_heads, int hd,
           int stages, int warps_q, int blocks_q, int smem_q, int warps_k,
           int blocks_k, int smem_k, float scale, cudaStream_t stream) {
  constexpr int kRow = (kHdp + 8) * (int)sizeof(bf16);
  constexpr int kMax = flash_max_warps(kHdp);
  cudaError_t err;
  if (stages) {
    const int lqp = round16(lq), lkp = round16(lk);
    // `stages` items' Q, dO, K and V, then bf16(dS)^T, LSE and delta
    if (warps_q < 1 || warps_q > kMax || blocks_q != 1 || stages < 0 ||
        stages > 2 ||
        smem_q != stages * 2 * (lqp + lkp) * kRow +
                      lkp * (lqp + 8) * (int)sizeof(bf16) +
                      2 * lqp * (int)sizeof(float)) {
      return (int)cudaErrorInvalidValue;
    }
    const void* fn = (const void*)flash_attention_bwd_fused_kernel<kHdp>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
    if (err != cudaSuccess) return (int)err;
    const long long items = (long long)num_heads * batch;
    const int resident = resident_blocks(fn, warps_q * 32, smem_q);
    if (resident <= 0 || items > 0x7fffffff) {
      return (int)cudaErrorInvalidConfiguration;
    }
    flash_attention_bwd_fused_kernel<kHdp>
        <<<(int)(items < resident ? items : resident), warps_q * 32, smem_q,
           stream>>>(q, k, v, out, lse, dout, dq, dk, dv, lq, lk, num_heads,
                     hd, (int)items, stages == 2, scale);
    return (int)cudaGetLastError();
  }
  // per kernel: its strips' two operands, the two-stage ring of 64-row
  // tiles of two operands, and the fp32 row statistics
  if (delta == nullptr ||
      bad_plan(warps_q, blocks_q, (lq + 15) / 16, kMax) ||
      bad_plan(warps_k, blocks_k, (lk + 15) / 16, kMax) ||
      smem_q != (2 * warps_q * 16 + 4 * kTile) * kRow +
                    2 * warps_q * 16 * (int)sizeof(float) ||
      smem_k != (2 * warps_k * 16 + 4 * kTile) * kRow +
                    4 * kTile * (int)sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(flash_attention_dq_kernel<kHdp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_dkv_kernel<kHdp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_k);
  if (err != cudaSuccess) return (int)err;
  flash_attention_dq_kernel<kHdp>
      <<<dim3(blocks_q, num_heads, batch), warps_q * 32, smem_q, stream>>>(
          q, k, v, out, lse, dout, dq, delta, lq, lk, num_heads, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_dkv_kernel<kHdp>
      <<<dim3(blocks_k, num_heads, batch), warps_k * 32, smem_k, stream>>>(
          q, k, v, lse, dout, delta, dk, dv, lq, lk, num_heads, hd, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 twins: one block per (row, head, sample), thread-per-key (or query)
// scalar dot products, chunks of 128 columns staged in shared memory.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32MaxHd = 128;

// delta and dq of one query row.
__global__ void __launch_bounds__(kF32Threads)
flash_attention_dq_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ out,
                              const float* __restrict__ lse,
                              const float* __restrict__ dout,
                              float* __restrict__ dq,
                              float* __restrict__ delta, int lq, int lk,
                              int num_heads, int hd, float scale) {
  __shared__ float sq[kF32MaxHd], sdo[kF32MaxHd], sds[kF32Threads];
  __shared__ float scratch[kF32Threads / 32];
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const size_t at_q = ((size_t)b * lq + row) * ld + (size_t)h * hd;
  const size_t kbase = (size_t)b * lk * ld + (size_t)h * hd;
  const size_t stat = ((size_t)b * num_heads + h) * lq + row;
  const int tid = threadIdx.x;
  float part = 0.f;
  for (int c = tid; c < hd; c += kF32Threads) {
    sq[c] = q[at_q + c];
    sdo[c] = dout[at_q + c];
    part += sdo[c] * out[at_q + c];
  }
  const float row_delta = block_reduce<kF32Threads>(part, false, scratch);
  const float row_lse = lse[stat];

  float acc = 0.f;  // dq[c] for c = tid (hd <= 128 = threads)
  for (int j0 = 0; j0 < lk; j0 += kF32Threads) {
    const int j = j0 + tid;
    float ds = 0.f;
    if (j < lk) {
      const size_t at = kbase + (size_t)j * ld;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < hd; ++c) {
        s = fmaf(sq[c], k[at + c], s);
        dp = fmaf(sdo[c], v[at + c], dp);
      }
      const float p = expf(s * scale - row_lse);
      ds = p * (dp - row_delta);
    }
    __syncthreads();  // previous chunk consumed
    sds[tid] = ds;
    __syncthreads();
    if (tid < hd) {
      const int n = min(kF32Threads, lk - j0);
      for (int jj = 0; jj < n; ++jj) {
        acc = fmaf(sds[jj], k[kbase + (size_t)(j0 + jj) * ld + tid], acc);
      }
    }
  }
  if (tid < hd) dq[at_q + tid] = acc * scale;
  if (tid == 0) delta[stat] = row_delta;
}

// dk and dv of one key row, sweeping the query rows.
__global__ void __launch_bounds__(kF32Threads)
flash_attention_dkv_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ lse,
                               const float* __restrict__ dout,
                               const float* __restrict__ delta,
                               float* __restrict__ dk,
                               float* __restrict__ dv, int lq, int lk,
                               int num_heads, int hd, float scale) {
  __shared__ float sk[kF32MaxHd], sv[kF32MaxHd];
  __shared__ float sp[kF32Threads], sds[kF32Threads];
  const int key = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const size_t at_k = ((size_t)b * lk + key) * ld + (size_t)h * hd;
  const size_t qbase = (size_t)b * lq * ld + (size_t)h * hd;
  const size_t stat0 = ((size_t)b * num_heads + h) * lq;
  const int tid = threadIdx.x;
  for (int c = tid; c < hd; c += kF32Threads) {
    sk[c] = k[at_k + c];
    sv[c] = v[at_k + c];
  }
  float dk_acc = 0.f, dv_acc = 0.f;
  for (int i0 = 0; i0 < lq; i0 += kF32Threads) {
    __syncthreads();  // sk/sv written; previous chunk consumed
    const int i = i0 + tid;
    float p = 0.f, ds = 0.f;
    if (i < lq) {
      const size_t at = qbase + (size_t)i * ld;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < hd; ++c) {
        s = fmaf(q[at + c], sk[c], s);
        dp = fmaf(dout[at + c], sv[c], dp);
      }
      p = expf(s * scale - lse[stat0 + i]);
      ds = p * (dp - delta[stat0 + i]);
    }
    sp[tid] = p;
    sds[tid] = ds;
    __syncthreads();
    if (tid < hd) {
      const int n = min(kF32Threads, lq - i0);
      for (int ii = 0; ii < n; ++ii) {
        const size_t at = qbase + (size_t)(i0 + ii) * ld + tid;
        dk_acc = fmaf(sds[ii], q[at], dk_acc);
        dv_acc = fmaf(sp[ii], dout[at], dv_acc);
      }
    }
  }
  if (tid < hd) {
    dk[at_k + tid] = dk_acc * scale;
    dv[at_k + tid] = dv_acc;
  }
}

}  // namespace

// q/out/dout/dq: (batch, lq, num_heads, head_dim) bf16, k/v/dk/dv: (batch,
// lk, num_heads, head_dim) bf16, all contiguous and 16-byte aligned; lse (the
// forward's) and delta (scratch of the split scheme, written here; null for
// the fused one): (batch, num_heads, lq) fp32. head_dim must be a multiple
// of 8 and at most 128. The plan is launch_plan's: `stages` 1 or 2 runs the
// fused kernel with `warps_q` warps, `blocks_q` 1, `smem_q` bytes of shared
// memory and that many item stages in it (the _k arguments ignored); 0 runs
// the dq kernel as `blocks_q` blocks of `warps_q` warps per (sample, head)
// with `smem_q` bytes each and the dk/dv kernel as `blocks_k` blocks of
// `warps_k` with `smem_k`. Each size must be its kernel's for that plan.
// Returns the cudaError_t of the launches (cudaErrorInvalidValue for a plan
// it refuses).
extern "C" int clipa_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int batch, int lq, int lk, int num_heads, int head_dim,
    int stages, int warps_q, int blocks_q, int smem_q, int warps_k,
    int blocks_k, int smem_k, float scale, void* stream) {
  if (bad_shape(batch, lq, num_heads, head_dim) || lk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* o_ = static_cast<const bf16*>(out);
  const float* lse_ = static_cast<const float*>(lse);
  const bf16* do_ = static_cast<const bf16*>(dout);
  bf16* dq_ = static_cast<bf16*>(dq);
  bf16* dk_ = static_cast<bf16*>(dk);
  bf16* dv_ = static_cast<bf16*>(dv);
  float* delta_ = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CLIPA_LAUNCH(HDP)                                                   \
  return launch<HDP>(q_, k_, v_, o_, lse_, do_, dq_, dk_, dv_, delta_,     \
                     batch, lq, lk, num_heads, head_dim, stages, warps_q,  \
                     blocks_q, smem_q, warps_k, blocks_k, smem_k, scale, s)
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

// The fp32 twin: same arguments and limits, fp32 tensors (4-byte aligned
// suffices).
extern "C" int clipa_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int batch, int lq, int lk, int num_heads, int head_dim,
    float scale, void* stream) {
  if (bad_shape(batch, lq, num_heads, head_dim) || lk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* lse_ = static_cast<const float*>(lse);
  const float* do_ = static_cast<const float*>(dout);
  float* delta_ = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_attention_dq_f32_kernel<<<dim3(lq, num_heads, batch), kF32Threads, 0,
                                  s>>>(
      q_, k_, v_, static_cast<const float*>(out), lse_, do_,
      static_cast<float*>(dq), delta_, lq, lk, num_heads, head_dim, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_dkv_f32_kernel<<<dim3(lk, num_heads, batch), kF32Threads,
                                   0, s>>>(
      q_, k_, v_, lse_, do_, delta_, static_cast<float*>(dk),
      static_cast<float*>(dv), lq, lk, num_heads, head_dim, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
