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
// LSE is (B, H, Lq) fp32. Head-dim columns past hd are zero-filled (hd 64,
// 80, 104, 112 and 128 are the heads of L/16, H/14, G/14 and e/14; any
// multiple of 8 up to 128 is taken). Lq and Lk are independent.
//
// What bounds it: at the unmask-tuning shape (ViT-L/16 @224 with mask 0.3:
// B = 128, L = 138, 16 heads of 64) the function needs 10 GFLOP and moves
// 146 MB (q, k, v, o once each): on an H100 SXM (data-sheet rates) device
// memory bounds it (0.044 ms at 3.35 TB/s against 0.010 ms at 989
// TFLOP/s). The products are 4x below the byte time, so the kernel is held
// back by latency and instruction count, not by the tensor cores. The design:
//   - one warp per 16-row query strip; the ceil(Lq / 16) strips of a
//     (sample, head) are spread evenly over `blocks` blocks of `warps` warps
//     (ops/flash_attention.py launch_plan picks both: the split that keeps
//     the most warps resident per SM, then the most blocks, so that while
//     one block waits for its copies another computes; at L = 138, hd 64
//     the 9 strips make 3 blocks of 3 warps, 4 blocks and 12 warps per SM,
//     and no warp idles). The blocks of one (sample, head) are adjacent in
//     blockIdx.x, so its K/V stay in L2;
//   - K and V stream through a two-stage ring of 128-key tiles with
//     cp.async (K and V of a tile are one commit group, Q rides with the
//     first): the next tile is in flight while this one is computed. At
//     Lk <= 256 the ring holds every key and only round16(Lk) rows are
//     reserved and copied;
//   - every fragment comes through ldmatrix: Q and K plain, V with .trans
//     for P.V (the previous design read V 16 bits at a time);
//   - the 16-key chunks of a tile that lie wholly past Lk are neither
//     loaded nor computed (their p is exactly 0): at L = 138 the second
//     tile costs 16 keys of work instead of 128;
//   - mma.sync m16n8k16, not wgmma: a wgmma tile has 64 rows per
//     warpgroup, which pads L = 138 to 192 query rows where 16-row strips
//     pad it to 144, and the work is latency-bound, not rate-bound.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bench.py, device
// time, this design and the previous one in turns in one run): 0.0939-0.0940
// ms at the unmask-tuning shape, 46% of its bound, against the previous
// design's 0.2137-0.2140 ms and SDPA's 0.1130-0.1136 (CUDA events through
// the wrapper: 0.0996-0.1086 ms). `--plans` times the other splits there:
// 9 warps x 1 block 0.1227 ms, 5 x 2 0.1069, 3 x 3 0.0934, 2 x 5 0.1388,
// 1 x 9 0.2290. The other shapes are in PERF.md section 6.
//
// fp32 operands run a scalar twin (fp32 FMA, no TF32, nothing rounded):
// 16 query rows per block, 32-key shared-memory tiles, the same online
// softmax. It is written to be right, not fast, and takes no launch plan.

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kBlockK = 128;          // keys per tile: the Pallas block_k
constexpr float kNegInf = -1e30f;     // flash_attention.NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Rows of each of the K and V rings: every key while Lk
// fits two tiles, else two 128-key stages (launch_plan's formula).
inline __host__ __device__ int ring_rows(int lk) {
  return lk <= 2 * kBlockK ? round16(lk) : 2 * kBlockK;
}

// One 128-key tile of the online softmax for a warp's 16 query rows at
// `sqw`, over its first kNc 16-key chunks (keys at `skt`, the first one
// k0; a chunk wholly past Lk is not computed: its p is exactly 0): the raw
// scores q.k, the tile's row max, then p = exp(s * scale - m') and
// acc += bf16(p) . V (V rows at `svt`). kNc is a template argument so that
// no predicate guards an ldmatrix or mma: a predicated .aligned
// instruction still takes its issue slot, costs a warp sync and keeps the
// scheduler from overlapping one chunk's loads with the last one's
// products, and the kernel is bound by instruction issue. For the same
// reason the scale is applied through exp2: max(s) * scale is max(s *
// scale) (scale > 0), and exp(s * scale - m) is computed as
// exp2(s * scale log2(e) - m log2(e)), one FFMA per score, as __expf would
// round it too.
template <int kHdp, int kNc>
__device__ __forceinline__ void tile_nc(float acc[kHdp / 8][4],
                                        float row_max[2], float row_sum[2],
                                        const bf16* sqw, const bf16* skt,
                                        const bf16* svt, int k0, int lk,
                                        float scale) {
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
  if (lk - k0 < kNc * 16) {  // keys past lk in the last chunk
#pragma unroll
    for (int nt = 2 * kNc - 2; nt < 2 * kNc; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        s[nt][i] = key < lk ? s[nt][i] : kNegInf;
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
  float m_log2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r],
                        __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r],
                        __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float m_new = fmaxf(row_max[r], tile_max[r] * scale);
    const float alpha = exp2f((row_max[r] - m_new) * kLog2e);
    row_max[r] = m_new;
    m_log2[r] = m_new * kLog2e;
    row_sum[r] *= alpha;
#pragma unroll
    for (int nt = 0; nt < kHdp / 8; ++nt) {
      acc[nt][2 * r] *= alpha;
      acc[nt][2 * r + 1] *= alpha;
    }
  }
  const float scale_log2 = scale * kLog2e;
#pragma unroll
  for (int nt = 0; nt < 2 * kNc; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nt][i] = exp2f(fmaf(s[nt][i], scale_log2, -m_log2[i >> 1]));
      row_sum[i >> 1] += s[nt][i];
    }
  }
  // the fragments of n-tiles 2c and 2c + 1 are the A fragment of chunk c
#pragma unroll
  for (int c = 0; c < kNc; ++c) {
    uint32_t a[4];
    pack_a(a, s[2 * c], s[2 * c + 1]);
    mma_rows16<kHdp>(acc, a, svt + c * 16 * kStride);
  }
}

// One tile with its chunk count: min(8, chunks left before Lk).
template <int kHdp>
__device__ __forceinline__ void key_tile(float acc[kHdp / 8][4],
                                         float row_max[2], float row_sum[2],
                                         const bf16* sqw, const bf16* skt,
                                         const bf16* svt, int k0, int lk,
                                         float scale) {
#define CLIPA_TILE(NC)                                                     \
  tile_nc<kHdp, NC>(acc, row_max, row_sum, sqw, skt, svt, k0, lk, scale); \
  break
  switch (min(kBlockK / 16, (lk - k0 + 15) / 16)) {
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

template <int kHdp>
__device__ __forceinline__ void init_rows(float acc[kHdp / 8][4],
                                          float row_max[2],
                                          float row_sum[2]) {
#pragma unroll
  for (int nt = 0; nt < kHdp / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  // Per thread: rows g and g + 8. The max is quad-reduced per tile, so the
  // four threads of a row agree on it; the sums are partial over this
  // thread's columns until the quad reduction in store_out.
  row_max[0] = row_max[1] = kNegInf;
  row_sum[0] = row_sum[1] = 0.f;
}

// O = acc / l (one reciprocal per row) and LSE = m + log l of a warp's rows
// from row0 (below lq): `o` and `lse_h` point at the head's row 0.
template <int kHdp>
__device__ __forceinline__ void store_out(const float acc[kHdp / 8][4],
                                          const float row_max[2],
                                          float row_sum[2], bf16* o,
                                          float* lse_h, int row0, int lq,
                                          int hd, int ld) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= lq) continue;
    const float inv = 1.f / row_sum[r];
    bf16* orow = o + (size_t)row * ld;
#pragma unroll
    for (int nt = 0; nt < kHdp / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < hd) {
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_floats(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
      }
    }
    if (t == 0) lse_h[row] = row_max[r] + logf(row_sum[r]);
  }
}

// `blocks` blocks per (head, sample), each over its share of the query
// strips; K and V stream through a two-stage ring of 128-key tiles, the
// next tile in flight while this one is computed.
template <int kHdp>
__global__ void __launch_bounds__(flash_max_warps(kHdp) * 32)
flash_attention_fwd_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int lq, int lk, int num_heads, int hd,
                           float scale) {
  constexpr int kStride = kHdp + 8;
  constexpr int kNt = kHdp / 8;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + (nthreads / 32) * 16 * kStride;
  bf16* sv = sk + ring_rows(lk) * kStride;

  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const bf16* qh = q + (size_t)b * lq * ld + (size_t)h * hd;
  const bf16* kh = k + (size_t)b * lk * ld + (size_t)h * hd;
  const bf16* vh = v + (size_t)b * lk * ld + (size_t)h * hd;
  const int2 strips = strip_range((lq + 15) / 16, gridDim.x, blockIdx.x);
  const int warp = tid / 32;
  // A warp past the block's strips only helps with the copies.
  const bool active = strips.x + warp < strips.y;
  const int ntiles = (lk + kBlockK - 1) / kBlockK;

  // K and V of key tile `tile` into its ring stage, as one commit group
  // (empty past the last tile, so the group count stays uniform).
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int k0 = tile * kBlockK;
      const int n = min(kBlockK, round16(lk - k0));
      const int stage = (tile & 1) * kBlockK * kStride;
      load_rows_async<kHdp>(sk + stage, kh, k0, n, lk, hd, ld, tid,
                            nthreads);
      load_rows_async<kHdp>(sv + stage, vh, k0, n, lk, hd, ld, tid,
                            nthreads);
    }
    cp_async_commit();
  };
  // In flight at the top of iteration `tile`: this tile and the next (Q
  // rides with the first).
  load_rows_async<kHdp>(sq, qh, strips.x * 16, (strips.y - strips.x) * 16,
                        lq, hd, ld, tid, nthreads);
  issue(0);
  issue(1);
  const bf16* sqw = sq + warp * 16 * kStride;
  float acc[kNt][4], row_max[2], row_sum[2];
  init_rows<kHdp>(acc, row_max, row_sum);
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<1>();
    __syncthreads();  // this tile (and Q) landed for every thread
    if (active) {
      key_tile<kHdp>(acc, row_max, row_sum, sqw,
                     sk + (tile & 1) * kBlockK * kStride,
                     sv + (tile & 1) * kBlockK * kStride, tile * kBlockK, lk,
                     scale);
    }
    __syncthreads();  // every warp done with this stage: refill it
    issue(tile + 2);
  }
  if (active) {
    store_out<kHdp>(acc, row_max, row_sum,
                    out + (size_t)b * lq * ld + (size_t)h * hd,
                    lse + ((size_t)b * num_heads + h) * lq,
                    (strips.x + warp) * 16, lq, hd, ld);
  }
}

template <int kHdp>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
           float* lse, int batch, int lq, int lk, int num_heads, int hd,
           int warps, int blocks, int smem, float scale,
           cudaStream_t stream) {
  constexpr int kRow = (kHdp + 8) * (int)sizeof(bf16);
  // the plan's size must be this layout's: Q strips, then the K and V rings
  if (bad_plan(warps, blocks, (lq + 15) / 16, flash_max_warps(kHdp)) ||
      smem != (warps * 16 + 2 * ring_rows(lk)) * kRow) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<kHdp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks, num_heads, batch);
  flash_attention_fwd_kernel<kHdp><<<grid, warps * 32, smem, stream>>>(
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
// The plan is launch_plan's: `blocks` blocks of `warps` warps per (sample,
// head), at most flash_max_warps, each block at least one 16-row query strip
// and at most `warps`, and `smem` bytes of shared memory per block, which
// must be this kernel's size for that plan. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a plan it refuses).
extern "C" int clipa_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int batch, int lq, int lk,
                                         int num_heads, int head_dim,
                                         int warps, int blocks, int smem,
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
                     head_dim, warps, blocks, smem, scale, s)
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
