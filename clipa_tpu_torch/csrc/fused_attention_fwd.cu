// Fused multi-head self-attention forward for Hopper (sm_90a), bf16 or fp32
// in/out (one entry point per operand type).
//
// Replaces three Pallas TPU kernels of clipa_tpu/ops/block_attention.py with
// one kernel over flat (B*L, D) rows, row i belonging to sample i // L:
//   _fwd_kernel         (:165)  per-sample attention over (B, L, D)
//   _fwd2d_kernel       (:475)  the same over flat rows, no bias
//   _fwd2d_bias_kernel  (:652)  the same with the (D,) q/k/v biases added
//                               inside the kernel (non-null bq/bk/bv)
// The TPU kernels' sample groups, VMEM plans and block-diagonal masks exist
// only to suit Mosaic; here the blocks of one (sample, head) cover its query
// rows, so no cross-sample scores are ever computed.
//
// Math (held against the plain PyTorch version in ops/block_attention.py):
//   q/k/v plus bias added in fp32 and rounded to bf16 once (the JAX graph's
//   round(x@W) + b); padding rows past L and columns past hd get no bias;
//   s = (q . k) in fp32 from bf16 operands, times scale (on the fp32 scores);
//   clip mode : e = exp(clip(s, +-70)), no row max, so E.V and rowsum(E)
//               simply accumulate over key tiles in fp32; keys past L get
//               e = 0 exactly (e itself is masked: clip(-1e30) is -70, and
//               e^-70 is not 0);
//   exact mode: online row max over 128-key tiles with rescaling of the
//               running sums (keys past L get s = -1e30 before the max);
//   E is rounded to bf16 for the P.V product (fp16 would overflow: e^70 is
//   far above 65504), the row sums are of the unrounded fp32 e; O = (E.V) *
//   (1 / rowsum(E)), rounded to bf16 once. No atomics: bit-identical on
//   repeat.
//
// What bounds it: at the serving shape (ViT-H/14 @224, bucket 256: B = 256,
// L = 257, D = 1280, 16 heads of 80) the function moves 673 MB (q, k, v, out
// once each) and needs 87 GFLOP: device memory bounds it on an H100 SXM
// (0.201 ms at 3.35 TB/s against 0.088 ms at 989 TFLOP/s). As for the flash
// forward (flash_attention_fwd.cu), the work per byte is too small for the
// tensor cores to be the limit: latency and instruction issue are. The
// design is the flash forward's, with the bias and the clip:
//   - one warp per 16-row query strip; the ceil(L / 16) strips of a (sample,
//     head) spread evenly over `blocks` blocks of `warps` warps, adjacent in
//     blockIdx.x so that its K/V stay in L2 (ops/block_attention.py
//     fwd_plan picks both: the split that keeps the most warps with a strip
//     resident per SM, then the fewest blocks, each of which copies and
//     biases all of K and V; L = 50: 4 warps x 1 block, L = 138: 3 x 3,
//     L = 257: 6 x 3, whose 17 strips leave one warp of 18 idle);
//   - Q, K and V through cp.async: K and V in 128-key tiles, one commit
//     group per tile (Q rides with the first), into a ring of `stages`
//     tiles. Where every key fits (the plan's choice whenever it keeps as
//     many warps resident), the ring holds round16(L) rows and every tile
//     is in flight from the start: no refill barrier. At L = 257 that is
//     272 rows (95.7 KB for K + V at hd 80) against the two-stage ring's 256
//     rows and a refill barrier for the one key of the third tile; both fit
//     two 6-warp blocks per SM. Past that (L = 577 at hd 80) a two-stage
//     ring, refilled behind a barrier as in the flash forward;
//   - the bias cannot ride a cp.async: each thread adds it, with one
//     rounding, to the very 16-byte chunks it issued, after its own
//     cp.async.wait_group; the block barrier that follows makes them visible
//     to the other warps. Each block biases each K/V row once. A thread
//     owns one column chunk of every row it copies (RowSlice), so its bias
//     sits in registers and a chunk costs a load, four bf16x2 adds and a
//     store: with the row, the column, the bias chunk and an fp32 round
//     trip worked out per chunk, the bias took as many instructions as the
//     products (bucket 256: 0.894 ms with bias against 0.588 for the exact
//     form without, PERF.md);
//   - every fragment through ldmatrix, .trans for V;
//   - the 16-key chunk count of a tile a template argument: nothing is
//     loaded or computed past L;
//   - exp2 with the scale folded in: clip mode clamps s * scale * log2(e) at
//     +-70 log2(e); exact mode one FFMA per score against the running max;
//     one reciprocal per output row, no division per element.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bench.py --kernels
// fused, device time, this design and the previous one in turns in one
// run): bucket 256 (B = 256, L = 257, H/14, bias, clip) 0.7071-0.7134 ms,
// 28% of its bound, against the previous design's 1.6337-1.6404; the exact
// form without bias there 0.5583-0.5588 against SDPA's 0.6070-0.6127; B =
// 384, L = 50 (L/16, bias) 0.0860-0.0872 against 0.1569-0.1574; B = 128,
// L = 138 0.1225-0.1260 against 0.2669-0.2671. `--plans` at bucket 256: the
// ring of every key 0.7153 ms against the two-stage ring's 0.7349 (6 x 3);
// 9 x 2 0.7638, 5 x 4 0.8332, 4 x 5 1.0606, 1 x 17 5.7616: every block
// copies and biases all of K and V, so the plan takes the fewest blocks
// that keep the most warps busy (L = 50: 4 x 1 0.0855 against 2 x 2
// 0.0962). Other shapes in PERF.md section 6.
//
// fp32 operands (the service at precision float32, as the Pallas kernels
// take fp32 operands) run a second, scalar kernel: the same function with
// fp32 FMA for both products, no TF32 and no rounding of E. Block = 128
// threads over 16 query rows; K/V tiles of 32 rows and the 16x32 score tile
// sit in shared memory. It is written to be right, not fast: serving runs
// bf16. It takes no launch plan.

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kBlockK = 128;          // keys per tile of the ring
constexpr int kMaxStages = 8;         // the deepest ring the launcher takes
constexpr float kExpClip = 70.f;      // block_attention._EXP_CLIP
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClipLog2 = kExpClip * kLog2e;
constexpr float kNegInf = -1e30f;

// One 128-key tile for a warp's 16 query rows at `sqw`, over its first kNc
// 16-key chunks (keys at `skt`, the first one k0; a chunk wholly past L is
// not computed): the raw scores q.k, then e and acc += bf16(e) . V (V rows
// at `svt`). Clip mode: e = exp2(clamp(s * scale log2 e, +-70 log2 e)),
// zeroed for keys past L. Exact mode: the tile's row max (keys past L at
// -1e30), the running sums rescaled, e = exp2(s * scale log2 e - m), with m
// kept in the log2 domain. kNc is a template argument so that no predicate
// guards an ldmatrix or mma (a predicated .aligned instruction still takes
// its issue slot and a warp sync, and the kernel is bound by issue).
template <int kHdp, int kNc, bool kExact>
__device__ __forceinline__ void tile_nc(float acc[kHdp / 8][4],
                                        float row_max[2], float row_sum[2],
                                        const bf16* sqw, const bf16* skt,
                                        const bf16* svt, int k0, int seq,
                                        float scale_log2) {
  constexpr int kStride = kHdp + 8;
  const int t = threadIdx.x % 4;
  float s[2 * kNc][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < kHdp / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, ldsm_rows16(sqw + kc * 16, kStride));
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      uint32_t bk[4];
      ldsm_x4(bk, ldsm_rows8x2(skt + c * 16 * kStride + kc * 16, kStride));
      mma_16816(s[2 * c], a, bk[0], bk[1]);
      mma_16816(s[2 * c + 1], a, bk[2], bk[3]);
    }
  }
  // Element i of n-tile nt: row g + 8 (i >> 1), key k0 + 8 nt + 2t + (i & 1).
  const bool ragged = seq - k0 < kNc * 16;   // keys past L in the last chunk
  if (kExact) {
    if (ragged) {
#pragma unroll
      for (int nt = 2 * kNc - 2; nt < 2 * kNc; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          s[nt][i] = key < seq ? s[nt][i] : kNegInf;
        }
      }
    }
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[nt][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(row_max[r], tile_max[r] * scale_log2);
      const float alpha = ex2(row_max[r] - m_new);
      row_max[r] = m_new;
      row_sum[r] *= alpha;
#pragma unroll
      for (int nt = 0; nt < kHdp / 8; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = ex2(fmaf(s[nt][i], scale_log2, -row_max[i >> 1]));
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = ex2(fminf(fmaxf(s[nt][i] * scale_log2, -kClipLog2),
                             kClipLog2));
      }
    }
    if (ragged) {
#pragma unroll
      for (int nt = 2 * kNc - 2; nt < 2 * kNc; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nt * 8 + 2 * t + (i & 1);
          s[nt][i] = key < seq ? s[nt][i] : 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) row_sum[i >> 1] += s[nt][i];
  }
  // the fragments of n-tiles 2c and 2c + 1 are the A fragment of chunk c
#pragma unroll
  for (int c = 0; c < kNc; ++c) {
    uint32_t a[4];
    pack_a(a, s[2 * c], s[2 * c + 1]);
    mma_rows16<kHdp>(acc, a, svt + c * 16 * kStride);
  }
}

// One tile with its chunk count: min(8, chunks left before L).
template <int kHdp, bool kExact>
__device__ __forceinline__ void key_tile(float acc[kHdp / 8][4],
                                         float row_max[2], float row_sum[2],
                                         const bf16* sqw, const bf16* skt,
                                         const bf16* svt, int k0, int seq,
                                         float scale_log2) {
#define CLIPA_TILE(NC)                                                      \
  tile_nc<kHdp, NC, kExact>(acc, row_max, row_sum, sqw, skt, svt, k0, seq, \
                            scale_log2);                                    \
  break
  switch (min(kBlockK / 16, (seq - k0 + 15) / 16)) {
    case 1: CLIPA_TILE(1);
    case 2: CLIPA_TILE(2);
    case 3: CLIPA_TILE(3);
    case 4: CLIPA_TILE(4);
    case 5: CLIPA_TILE(5);
    case 6: CLIPA_TILE(6);
    case 7: CLIPA_TILE(7);
    default: CLIPA_TILE(8);
  }
#undef CLIPA_TILE
}

// `blocks` blocks per (head, sample), each over its share of the query
// strips; K and V stream through a ring of `stages` 128-key tiles, every
// tile in flight at once where the ring holds every key.
template <int kHdp, bool kExact>
__global__ void __launch_bounds__(flash_max_warps(kHdp) * 32)
fused_attention_fwd_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ bq,
                           const bf16* __restrict__ bk,
                           const bf16* __restrict__ bv,
                           bf16* __restrict__ out, int seq, int num_heads,
                           int hd, int stages, float scale_log2) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + (nthreads / 32) * 16 * kStride;
  bf16* sv = sk + ring_rows(seq, stages, kBlockK) * kStride;

  const int h = blockIdx.y;
  const int ld = num_heads * hd;
  const size_t base = (size_t)blockIdx.z * seq * ld + (size_t)h * hd;
  const bf16* qh = q + base;
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const int2 strips = strip_range((seq + 15) / 16, gridDim.x, blockIdx.x);
  const int q0 = strips.x * 16, q_rows = (strips.y - strips.x) * 16;
  const int warp = tid / 32;
  // A warp past the block's strips only helps with the copies.
  const bool active = strips.x + warp < strips.y;
  const int ntiles = (seq + kBlockK - 1) / kBlockK;
  const int inflight = min(stages, ntiles);
  const RowSlice<kHdp> slice(tid, nthreads);

  auto stage = [&](int tile) { return (tile % stages) * kBlockK * kStride; };
  auto tile_rows = [&](int tile) {
    return min(kBlockK, round16(seq - tile * kBlockK));
  };
  // K and V of key tile `tile` into its ring stage, as one commit group
  // (empty past the last tile, so the group count stays uniform).
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      issue_rows<kHdp>(sk + stage(tile), kh, tile * kBlockK,
                       tile_rows(tile), seq, hd, ld, slice);
      issue_rows<kHdp>(sv + stage(tile), vh, tile * kBlockK,
                       tile_rows(tile), seq, hd, ld, slice);
    }
    cp_async_commit();
  };
  // In flight at the top of iteration `tile`: tiles tile .. tile +
  // inflight - 1 (Q rides with the first).
  issue_rows<kHdp>(sq, qh, q0, q_rows, seq, hd, ld, slice);
  for (int tile = 0; tile < inflight; ++tile) issue(tile);

  const bf16* sqw = sq + warp * 16 * kStride;
  float acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  // Per thread: rows g and g + 8. The max (exact mode, log2 domain) is
  // quad-reduced per tile, so the four threads of a row agree on it; the
  // sums are partial over this thread's columns until the end.
  float row_max[2] = {kNegInf, kNegInf};
  float row_sum[2] = {0.f, 0.f};
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait_n(inflight - 1);   // this thread's copies of this tile
    if (bq != nullptr) {
      if (tile == 0) {
        add_bias_rows<kHdp>(sq, bq + h * hd, q0, q_rows, seq, hd, slice);
      }
      add_bias_rows<kHdp>(sk + stage(tile), bk + h * hd, tile * kBlockK,
                          tile_rows(tile), seq, hd, slice);
      add_bias_rows<kHdp>(sv + stage(tile), bv + h * hd, tile * kBlockK,
                          tile_rows(tile), seq, hd, slice);
    }
    __syncthreads();   // this tile (and Q), biased, for every warp
    if (active) {
      key_tile<kHdp, kExact>(acc, row_max, row_sum, sqw, sk + stage(tile),
                             sv + stage(tile), tile * kBlockK, seq,
                             scale_log2);
    }
    // a ring that refills: every warp done with this stage first
    if (inflight < ntiles) __syncthreads();
    issue(tile + inflight);
  }
  if (!active) return;

  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* o = out + base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= seq) continue;
    const float inv = 1.f / row_sum[r];
    bf16* orow = o + (size_t)row * ld;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < hd) {
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_floats(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
      }
    }
  }
}

template <int kHdp, bool kExact>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* bq,
           const bf16* bk, const bf16* bv, bf16* out, int batch, int seq,
           int num_heads, int hd, int warps, int blocks, int smem,
           int stages, float scale, cudaStream_t stream) {
  constexpr int kRow = (kHdp + 8) * (int)sizeof(bf16);
  const int ntiles = (seq + kBlockK - 1) / kBlockK;
  // the plan's ring: two or more stages, or one that holds every key; its
  // size must be this layout's: Q strips, then the K and V rings
  if (bad_plan(warps, blocks, (seq + 15) / 16, flash_max_warps(kHdp)) ||
      stages < 1 || stages > kMaxStages || (stages < 2 && ntiles > 1) ||
      smem != (warps * 16 + 2 * ring_rows(seq, stages, kBlockK)) * kRow) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      fused_attention_fwd_kernel<kHdp, kExact>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks, num_heads, batch);
  fused_attention_fwd_kernel<kHdp, kExact><<<grid, warps * 32, smem,
                                             stream>>>(
      q, k, v, bq, bk, bv, out, seq, num_heads, hd, stages, scale * kLog2e);
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

// The fp32 twin of clipa_fused_attention_fwd: the same arguments but the
// plan, the same limits, fp32 tensors (4-byte aligned suffices).
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
// aligned; bq/bk/bv: (num_heads * head_dim,) bf16, 16-byte aligned, or all
// null. head_dim must be a multiple of 8 and at most 128. The plan is
// ops/block_attention.py fwd_plan's: `blocks` blocks of `warps` warps per
// (sample, head), at most flash_max_warps, each block at least one 16-row
// query strip and at most `warps`; a ring of `stages` 128-key tiles (at
// least two, or one that holds every key; at most 8); and `smem` bytes of
// shared memory per block, which must be this kernel's size for that plan.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a plan
// or shape it refuses).
extern "C" int clipa_fused_attention_fwd(const void* q, const void* k,
                                         const void* v, const void* bq,
                                         const void* bk, const void* bv,
                                         void* out, int batch, int seq,
                                         int num_heads, int head_dim,
                                         int warps, int blocks, int smem,
                                         int stages, float scale, int exact,
                                         void* stream) {
  if (bad_shape(batch, seq, num_heads, head_dim) ||
      (bq == nullptr) != (bk == nullptr) ||
      (bq == nullptr) != (bv == nullptr)) {
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
  return exact ? launch<HDP, true>(q_, k_, v_, bq_, bk_, bv_, out_, batch,   \
                                   seq, num_heads, head_dim, warps, blocks,  \
                                   smem, stages, scale, s)                   \
               : launch<HDP, false>(q_, k_, v_, bq_, bk_, bv_, out_, batch,  \
                                    seq, num_heads, head_dim, warps, blocks, \
                                    smem, stages, scale, s)
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
