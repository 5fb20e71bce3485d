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

#include <map>
#include <mutex>
#include <tuple>

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

// ---------------------------------------------------------------------------
// Asynchronous tile copies and ldmatrix fragment loads (the flash kernels).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses the registers (cp.async.cg);
// with `pred` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// The same for one 4-byte word (cp.async.ca: .cg copies 16 bytes only).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's committed groups are still
// in flight; a __syncthreads() after it makes every thread's copies visible.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issues the copies of rows [row0, row0 + rows) of one head into `dst`
// (row stride kHdp + 8) with cp.async: `src` points at the head's first
// column of row 0, rows are `ld` elements apart. Rows at or past `len` and
// columns at or past `hd` are zero-filled, so no uninitialised value enters
// a product (0 * NaN would poison a sum). Threads `tid` of `nthreads`.
template <int kHdp>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                int row0, int rows, int len,
                                                int hd, int ld, int tid,
                                                int nthreads) {
  constexpr int kChunks = kHdp / 8;
  constexpr int kStride = kHdp + 8;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = row0 + r < len && c < hd;
    cp_async_16(dst + r * kStride + c,
                ok ? src + (size_t)(row0 + r) * ld + c : src, ok);
  }
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8m..8m+7 give the rows of matrix m); register m holds matrix m in
// the mma fragment layout (lane: row lane / 4, columns 2 (lane % 4) + {0, 1}),
// transposed with `.trans`.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The lane's row address for a 16 x 16 block at `p` (row stride `stride`)
// read as matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15). With ldsm_x4 that is the A fragment of a row-major
// 16 x 16 operand; with ldsm_x4_trans, on a [k][n] block, the B fragments
// (b0, b1) of n-tiles 0 and 1.
__device__ __forceinline__ const bf16* ldsm_rows16(const bf16* p,
                                                   int stride) {
  const int l = threadIdx.x % 32;
  return p + (l & 15) * stride + (l >> 4) * 8;
}

// The same block read as (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
// With ldsm_x4, on an [n][k] block, that is the B fragments (b0, b1) of
// n-tiles 0 and 1; with ldsm_x4_trans, on a [k][m] block, the A fragment of
// its transpose.
__device__ __forceinline__ const bf16* ldsm_rows8x2(const bf16* p,
                                                    int stride) {
  const int l = threadIdx.x % 32;
  return p + ((l & 7) + ((l >> 4) << 3)) * stride + ((l >> 3) & 1) * 8;
}

// The A fragment of a 16 x 16 bf16 product operand from two fp32
// accumulator n-tiles (x0: columns 0-7, x1: columns 8-15), rounded.
__device__ __forceinline__ void pack_a(uint32_t a[4], const float x0[4],
                                       const float x1[4]) {
  a[0] = pack_floats(x0[0], x0[1]);
  a[1] = pack_floats(x0[2], x0[3]);
  a[2] = pack_floats(x1[0], x1[1]);
  a[3] = pack_floats(x1[2], x1[3]);
}

// out[nt] += A . M over 16 rows of M at `m_rows` ([k][n] row-major, stride
// kHdp + 8), every n-tile of the head dim, B fragments through ldmatrix.
template <int kHdp>
__device__ __forceinline__ void mma_rows16(float out[kHdp / 8][4],
                                           const uint32_t a[4],
                                           const bf16* m_rows) {
#pragma unroll
  for (int np = 0; np < kHdp / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_trans(b, ldsm_rows16(m_rows + np * 16, kHdp + 8));
    mma_16816(out[2 * np], a, b[0], b[1]);
    mma_16816(out[2 * np + 1], a, b[2], b[3]);
  }
}

// acc[0..1] (16 x 16) = A . B^T for a 16-row block `a_rows` and a 16-row
// block `b_rows` (both row-major over the head dim, stride kHdp + 8).
template <int kHdp>
__device__ __forceinline__ void mma_scores16(float acc[2][4],
                                             const bf16* a_rows,
                                             const bf16* b_rows) {
  constexpr int kStride = kHdp + 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[0][i] = acc[1][i] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kHdp / 16; ++kc) {
    uint32_t a[4], b[4];
    ldsm_x4(a, ldsm_rows16(a_rows + kc * 16, kStride));
    ldsm_x4(b, ldsm_rows8x2(b_rows + kc * 16, kStride));
    mma_16816(acc[0], a, b[0], b[1]);
    mma_16816(acc[1], a, b[2], b[3]);
  }
}

// Writes one warp's 16-row accumulator tile (rows row0 + ..., times `mul`)
// to `dst` in bf16: rows below `len`, columns below `hd`.
template <int kHdp>
__device__ __forceinline__ void store_strip(const float acc[kHdp / 8][4],
                                            bf16* dst, int row0, int len,
                                            int hd, int ld, float mul) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= len) continue;
    bf16* o = dst + (size_t)row * ld;
#pragma unroll
    for (int nt = 0; nt < kHdp / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < hd) {
        *reinterpret_cast<uint32_t*>(o + c) =
            pack_floats(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
      }
    }
  }
}

// Strips [first, end) of `n` 16-row strips owned by block `bx` of `blocks`:
// the strips spread evenly (block sizes differ by at most one), the same
// split as ops/flash_attention.py launch_plan.
__device__ __forceinline__ int2 strip_range(int n, int blocks, int bx) {
  return make_int2(bx * n / blocks, (bx + 1) * n / blocks);
}

// The flash kernels' widest block: 12 warps up to kHdp 80, 8 above (their
// fp32 accumulators grow with the head dim); launch_plan mirrors it.
__host__ __device__ constexpr int flash_max_warps(int hdp) {
  return hdp <= 80 ? 12 : 8;
}

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Rows of a ring of `stages` tiles of `tile` rows, or every row of a
// sequence of `len` (rounded up to a 16-row chunk) where fewer suffice.
__host__ __device__ inline int ring_rows(int len, int stages, int tile) {
  return stages * tile < round16(len) ? stages * tile : round16(len);
}

// cp_async_wait with a run-time count (a ring's depth), 0 <= n < 8.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// A flash launch plan's check: `blocks` blocks of `warps` warps (at most
// `max_warps`) over `strips` 16-row strips, every block at least one strip
// and at most `warps`.
inline bool bad_plan(int warps, int blocks, int strips, int max_warps) {
  return warps < 1 || warps > max_warps || blocks < 1 || blocks > strips ||
         (strips + blocks - 1) / blocks > warps;
}

// The entry points' shape check: head dims a multiple of 8 up to 128.
inline bool bad_shape(int batch, int seq, int num_heads, int head_dim) {
  return batch <= 0 || seq <= 0 || num_heads <= 0 || head_dim % 8 != 0 ||
         head_dim <= 0 || head_dim > 128 || batch > 65535 ||
         num_heads > 65535;
}

// ---------------------------------------------------------------------------
// Biased copies, exp2 and the persistent grid (the fused kernels).
// ---------------------------------------------------------------------------

// 2^x by the MUFU unit (ex2.approx.ftz: exp2f without its subnormal-result
// fix-up). In clip mode x >= -70 log2(e) > -126, so nothing is flushed; in
// exact mode e < 2^-126 of the row max flushes to 0, far below what one
// bf16 ulp of the output can hold.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The copies and the bias below split a block of rows over the threads
// the same way: thread `tid` of `nthreads` owns the 16-byte column chunk
// tid % kChunks of rows tid / kChunks, + step, + 2 step, ... (step =
// nthreads / kChunks; the few threads past the last whole step own none).
// Neighbouring threads take neighbouring chunks of a row, so the copies
// coalesce, and a thread's column, its bias and its first address are
// computed once, not per chunk.
template <int kHdp>
struct RowSlice {
  static constexpr int kChunks = kHdp / 8;  // 16-byte chunks per row
  int first, step, col;                     // first row, row step, column
  __device__ __forceinline__ RowSlice(int tid, int nthreads)
      : first(tid / kChunks), step(nthreads / kChunks),
        col((tid % kChunks) * 8) {
    if (first >= step) first = 1 << 30;     // no whole column slot
  }
};

// Issues the copies of rows [row0, row0 + rows) of one head into `dst`
// (row stride kHdp + 8) with cp.async: rows at or past `len` and columns
// at or past `hd` are zero-filled (load_rows_async's function, split as
// RowSlice splits it).
template <int kHdp>
__device__ __forceinline__ void issue_rows(bf16* dst, const bf16* src,
                                           int row0, int rows, int len,
                                           int hd, int ld,
                                           const RowSlice<kHdp>& sl) {
  const bool col_ok = sl.col < hd;
  for (int r = sl.first; r < rows; r += sl.step) {
    const bool ok = col_ok && row0 + r < len;
    cp_async_16(dst + r * (kHdp + 8) + sl.col,
                ok ? src + (size_t)(row0 + r) * ld + sl.col : src, ok);
  }
}

// This thread's 16-byte chunk of a head's bias (`bias`: its first column),
// the one add_bias_chunk adds; zeros past `hd`.
template <int kHdp>
__device__ __forceinline__ uint4 bias_chunk(const bf16* bias, int hd,
                                            const RowSlice<kHdp>& sl) {
  return sl.col < hd ? *reinterpret_cast<const uint4*>(bias + sl.col)
                     : make_uint4(0u, 0u, 0u, 0u);
}

// Adds a head's bias (b4: this thread's chunk of it, from bias_chunk) to
// the rows that issue_rows copied with the same arguments: each thread to
// the chunks it issued itself, after its own cp.async wait. One rounding:
// a bf16x2 add rounds the exact sum of two bf16 values to nearest, as the
// fp32 add then round to bf16 of the JAX graph does (their fp32 sum is
// exact, or the smaller addend is below a bf16 half-ulp of the larger).
// Padding rows (at or past `len`) and columns (at or past `hd`) stay 0.
template <int kHdp>
__device__ __forceinline__ void add_bias_chunk(bf16* dst, uint4 b4, int row0,
                                               int rows, int len, int hd,
                                               const RowSlice<kHdp>& sl) {
  if (sl.col >= hd) return;
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&b4);
  const int end = min(rows, len - row0);
  for (int r = sl.first; r < end; r += sl.step) {
    uint4* p = reinterpret_cast<uint4*>(dst + r * (kHdp + 8) + sl.col);
    uint4 val = *p;
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = __hadd2(x[j], b[j]);
    *p = val;
  }
}

// add_bias_chunk with the chunk loaded here.
template <int kHdp>
__device__ __forceinline__ void add_bias_rows(bf16* dst, const bf16* bias,
                                              int row0, int rows, int len,
                                              int hd,
                                              const RowSlice<kHdp>& sl) {
  add_bias_chunk<kHdp>(dst, bias_chunk<kHdp>(bias, hd, sl), row0, rows, len,
                       hd, sl);
}

// Blocks of `kernel` resident on the card at once (the persistent grid),
// asked of the runtime once per (kernel, device, threads, shared memory).
inline int resident_blocks(const void* kernel, int threads, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  const std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return known[key] = sms * per_sm;
}

}  // namespace attn
