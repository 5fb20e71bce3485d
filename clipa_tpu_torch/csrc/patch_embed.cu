// Fused uint8 -> normalized patch embedding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel clipa_tpu/ops/patch_embed.py:_kernel (:54,
// called from fused_patch_embed(impl="pallas") at :109). It computes
//   out[m, n] = sum_k float(x[m, k]) * w[k, n] + bias[n]
// with x the uint8 patch rows of a (B, H, W, 3) image: row m is patch
// (b, gy, gx) in raster order, column k = (py * p + px) * 3 + c its pixel
// (gy * p + py, gx * p + px), channel c (the conv-layout (p, p, 3, width)
// weights flattened). w is the stem kernel with the per-channel
// normalization folded in and bias the folded bias (ops/patch_embed.py
// fold_normalization), both fp32; out is bf16 or fp32, rounded once after
// the bias is added. No float image ever exists in memory.
//
// The route: uint8 values 0..255 are exact in bf16, and kernel 0 splits
// the folded fp32 weights on every call into hi = bf16(w) and lo = bf16(w -
// hi) ((2, n, k_pad) bf16, K-major rows, zero past K; its plain version is
// ops/patch_embed.py split_weights). w - (hi + lo) is at most 2^-16 of |w|
// (2^-18 in round to nearest), so x.hi + x.lo, both on the tensor cores
// with one fp32 accumulator, is the fp32 product to within the tolerance
// the fp32-FMA kernel before it was held to (ops/patch_embed.py errors);
// hi alone misses it by 20x. The split was six PyTorch calls in the
// wrapper at first; one launch of the entry costs the host and the card
// less (measured below).
//
// Then two kernels, as the reference runs XLA's byte-level patchify before
// its Pallas GEMM:
//   1. patchify: one block per patch-row group (b, gy), whose p image rows
//      are one contiguous span of the image: the span into shared memory
//      (16-byte loads where it is aligned), then the group's grid_w patch
//      rows out as uint8 rows of k_pad bytes (zeros past K), 16-byte
//      stores, each byte pair read from shared memory. The patch rows
//      (rows x k_pad bytes, the image's size) cross device memory once
//      each way. Gathering them inside the GEMM instead, as every one of
//      its n / 128 column tiles must, made the byte traffic the GEMM's
//      bound: at H/14 @224 (a patch row is 42 bytes at a 2-byte aligned
//      offset) 1.39-1.94 ms against 0.58 with the gather removed (NVIDIA
//      H100 80GB HBM3, 700.00 W);
//   2. the GEMM: persistent blocks, one per SM, each walking 192 x 128
//      output tiles (column tiles fastest, so the blocks that read the same
//      patch rows run together; the rings run on from tile to tile, so the
//      next tile's copies and conversions overlap this one's epilogue),
//      512 threads in four warpgroups over a ring of kStages stages of 64
//      k. Warpgroup 0, the producer: thread 0 issues the TMA copies: the
//      uint8 patch rows (a (64 k, 192 m) box; rows past the last come back
//      as zeros) into a ring of their own, kXStages - 1 tiles ahead (a
//      slot frees when the producer has converted it, not when the
//      consumers are done with a stage: with the patch rows in the
//      consumers' ring the GEMM took 0.268 ms at L/16 @112 and 0.953 at
//      H/14 @224, against 0.191 and 0.717 with a ring of their own, 128-row
//      tiles both), and each stage's hi and lo weight
//      tiles (a (64 k, 128 n, 2) box of the 3-D tensor map, 128-byte
//      swizzle; rows past n come back as zeros) once the consumers free its
//      slot. All 128 threads then convert the uint8 tile to bf16
//      (exact) in the 128-byte-swizzled K-major layout that the wgmma
//      descriptor declares (16-byte chunk c of row r at chunk c ^ (r % 8)),
//      one 8-k chunk of 12 rows each, fence.proxy.async and arrive on the
//      stage's full barrier. Warpgroups 1-3, the consumers: 64 rows each;
//      per stage four k16 steps of two wgmma m64n128k16 (A and B
//      from shared memory, fp32 accumulate in 64 registers per thread):
//      x.hi then x.lo into the same accumulator. wgmma.wait_group 1 keeps
//      one stage in flight; the stage before it goes back to the producer
//      through its empty barrier. The epilogue: + bias in fp32, one
//      rounding to the output type (fp32 outputs never pass through bf16),
//      two columns per store; the ragged last row tile and the columns
//      past n are masked.
// No split-K, no atomics: the sums run in a fixed order, two calls agree bit
// for bit. The plan (tile, depth, ring, grid, shared memory of both
// kernels) is ops/patch_embed.py patch_plan's, and the entry checks it
// against these constants.
//
// What bounds it: the function is the fp32 product, but on this route its
// least time is two bf16 tensor-core products: at the pre-training stem
// (ViT-L/16 @112, B = 384: M = 18816 rows, K = 768, N = 1024) 59.2 GFLOP,
// 0.0598 ms at 989 TFLOP/s, against 56 MB of image, weights and bf16
// output (0.017 ms at 3.35 TB/s): operations bound it. K = 588 (p = 14)
// pads to 640 in the k loop. Each 192-row tile reads 32 KB of weight
// tiles per 64 k for 6.3 MFLOP; 192 rows in place of 128 took the GEMM
// from 0.194 to 0.175 ms at L/16 @112 and from 0.696 to 0.611 at H/14
// @224 (device time), so the weights' traffic through L2 is a part of what
// holds it at about a third of its peak.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bench.py
// --kernels patch, CUDA events around the entry on folded weights). With
// the split still in PyTorch, in turns with the fp32-FMA kernel that this
// design replaced: L/16 @112 B = 384 0.2297-0.2316 ms (device
// 0.2155-0.2159) against 0.7960-0.7969; H/14 @224 B = 256 0.6962-0.6983
// (device 0.6728-0.6730) against 2.5469-2.5607. With the split kernel, in
// turns with the PyTorch split: L/16 0.2042-0.2050 ms (device
// 0.1952-0.1954: split 0.0031, patchify 0.0162, GEMM 0.1752-0.1760)
// against 0.2326-0.2331 (the split's PyTorch kernels took 0.024 of device
// time; the entry's host time per call, all three shapes, fell from
// 0.1057-0.1993 to 0.0595-0.0783), 31% of the bound by device time;
// H/14 0.6583-0.6588 (device 0.6509-0.6511: 0.0032, 0.0366, 0.6046-0.6111)
// against 0.6943-0.7017, 31%. ptxas: the GEMM 90 registers, the patchify
// kernel 30-38, the split 30, no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 3;            // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kConsumers;     // rows per tile
constexpr int kBN = 128;      // columns per tile: one wgmma n128 per k16
constexpr int kBK = 64;       // k per stage: one 128-byte swizzle row
constexpr int kStages = 3;     // the ring of bf16 A and weight tiles
constexpr int kXStages = 4;    // the ring of uint8 patch-row tiles
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kXTile = kBM * kBK;              // uint8 patch rows, bytes
constexpr int kATile = kBM * kBK * 2;          // bf16 A tile, bytes
constexpr int kBTile = 2 * kBN * kBK * 2;      // hi and lo tiles, bytes
constexpr int kStage = kATile + kBTile;
// the two rings, their mbarriers (3 per stage, 2 per patch-row tile), and
// the slack to align them to 1024
constexpr int kSmem = kStages * kStage + kXStages * kXTile +
                      (3 * kStages + 2 * kXStages) * 8 + 1024;
constexpr int kPatchifyThreads = 256;
constexpr int kSplitThreads = 256;
constexpr int kSmemLimit = 232448;             // an H100 block's

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The (c0, c1) box of a 2-D tensor map into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// The (c0, c1, 0) box of a 3-D tensor map into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(0),
      "r"(smem_u32(bar))
      : "memory");
}

// A K-major operand tile in shared memory, 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), the leading offset unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// d[64] += A (64 x 16, descriptor a) . B (16 x 128, descriptor b), bf16 in,
// fp32 accumulate; both operands K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2(uint32_t lo, uint32_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight bytes (little-endian in a uint2) as eight bf16 values (exact).
__device__ __forceinline__ uint4 bf16x8(uint2 raw) {
  return make_uint4(bf16x2(raw.x & 0xffu, (raw.x >> 8) & 0xffu),
                    bf16x2((raw.x >> 16) & 0xffu, raw.x >> 24),
                    bf16x2(raw.y & 0xffu, (raw.y >> 8) & 0xffu),
                    bf16x2((raw.y >> 16) & 0xffu, raw.y >> 24));
}

__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x,
                                       float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// Kernel 0, the weight split: w (k, n) fp32 -> wsplit (2, n, k_pad) bf16,
// hi = bf16(w) and lo = bf16(w - hi) (w - float(hi) is exact in fp32), row
// j holding column j of w, zero at k >= K: ops/patch_embed.py
// split_weights, bit for bit. One block per 32 x 32 tile of w, transposed
// through shared memory so that reads run along n and writes along k.
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wsplit,
             int k, int n, int k_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += kSplitThreads / 32) {
    const int kk = k0 + i, j = n0 + tx;
    tile[i][tx] = kk < k && j < n ? w[(size_t)kk * n + j] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += kSplitThreads / 32) {
    const int j = n0 + i, kk = k0 + tx;   // k_pad is a multiple of 32
    if (j < n) {
      const float v = tile[tx][i];
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      wsplit[(size_t)j * k_pad + kk] = hi;
      wsplit[((size_t)n + j) * k_pad + kk] =
          __float2bfloat16_rn(v - __bfloat162float(hi));
    }
  }
}

// Kernel 1, one block per patch-row group g = b * grid_h + gy: its p image
// rows (the bytes [g p pitch, (g + 1) p pitch) of the image) into shared
// memory, then its grid_w patch rows (rows g grid_w + gx of x, k_pad bytes
// each) out, k = py 3p + r at byte py pitch + gx 3p + r of the span.
// kPairs: 3p is even, so byte pairs never straddle two segments py.
// kAligned: the span is 16-byte aligned and a multiple of 16 bytes.
template <bool kPairs, bool kAligned>
__global__ void __launch_bounds__(kPatchifyThreads)
patchify_kernel(const uint8_t* __restrict__ images, uint8_t* __restrict__ x,
                int patch, int width, int k, int k_pad) {
  extern __shared__ __align__(16) unsigned char span[];
  const int pitch = 3 * width, row_bytes = 3 * patch;
  const int bytes = patch * pitch;
  const uint8_t* src = images + (size_t)blockIdx.x * bytes;
  if (kAligned) {
    for (int i = threadIdx.x; i < bytes / 16; i += kPatchifyThreads) {
      reinterpret_cast<uint4*>(span)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    }
  } else {
    for (int i = threadIdx.x; i < bytes; i += kPatchifyThreads) {
      span[i] = src[i];
    }
  }
  __syncthreads();
  const int grid_w = width / patch, units = k_pad / 16;
  uint8_t* dst = x + (size_t)blockIdx.x * grid_w * k_pad;
  for (int u = threadIdx.x; u < grid_w * units; u += kPatchifyThreads) {
    const int gx = u / units, k0 = (u - gx * units) * 16;
    int r = k0 % row_bytes;
    const unsigned char* seg =
        span + (k0 / row_bytes) * pitch + gx * row_bytes;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; i += kPairs ? 2 : 1) {
      if (k0 + i < k) {
        if (r == row_bytes) {   // the next segment, py + 1
          r = 0;
          seg += pitch;
        }
        const uint32_t v =
            kPairs ? *reinterpret_cast<const uint16_t*>(seg + r) : seg[r];
        w[i / 4] |= v << (8 * (i % 4));
        r += kPairs ? 2 : 1;
      }
    }
    *reinterpret_cast<uint4*>(dst + (size_t)gx * k_pad + k0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Kernel 2, persistent: block b takes tiles b, b + gridDim.x, ... of the
// grid_n x grid_m tiles (kBM x kBN) of out (column tiles fastest). xmap:
// the patch rows (k_pad, rows) uint8; wmap: the weights (k_pad, n, 2)
// bf16. The rings run
// on across tiles (stage `it` counts every block's k tiles), so the
// producer converts the next tile's first stages while the consumers store
// this one's.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
patch_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ bias, OutT* __restrict__ out,
                  int rows, int n, int k_tiles, int grid_n, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  // the ring (per stage the bf16 A tile, then the hi and lo tiles), the
  // patch-row ring, then the barriers: the weights' copies, the A tile's
  // stores and the consumers' release per stage; each patch-row tile's
  // copy and its conversion
  unsigned char* xring = smem + kStages * kStage;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(xring + kXStages * kXTile);
  uint64_t* full = wfull + kStages;
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;
  uint64_t* xempty = xfull + kXStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&wfull[s], 1);   // the expect_tx of the weight copies
      mbar_init(&full[s], 128);  // the producer's bf16 A stores
      mbar_init(&empty[s], 4 * kConsumers);  // each consumer warp's lane 0
    }
#pragma unroll
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(&xfull[s], 1);     // the expect_tx of the patch-row copy
      mbar_init(&xempty[s], 128);  // the producer's conversion
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  if (tid < 128) {
    // The producer. Thread 0 keeps kXStages - 1 patch-row tiles in flight
    // (their slots free as soon as the producer has converted them) and
    // copies each stage's weight tiles once the consumers free its slot.
    auto issue_x = [&](int it) {   // this block's k tile `it`
      if (it >= mine * k_tiles) return;
      const int sx = it % kXStages;
      const int tile = blockIdx.x + it / k_tiles * gridDim.x;
      mbar_wait(&xempty[sx], ((it / kXStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&xfull[sx], kXTile);
      tma_load_2d(xring + sx * kXTile, &xmap, &xfull[sx],
                  it % k_tiles * kBK, tile / grid_n * kBM);
    };
    if (tid == 0) {
      for (int it = 0; it < kXStages - 1; ++it) issue_x(it);
    }
    // this thread's chunk: k 8c .. 8c + 7 of rows r0 + 16 j
    const int c = tid % 8, r0 = tid / 8;
    for (int it = 0; it < mine * k_tiles; ++it) {
      const int s = it % kStages, sx = it % kXStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      unsigned char* st = smem + s * kStage;
      if (tid == 0) {
        const int tile = blockIdx.x + it / k_tiles * gridDim.x;
        mbar_arrive_expect_tx(&wfull[s], kBTile);
        tma_load_3d(st + kATile, &wmap, &wfull[s], it % k_tiles * kBK,
                    tile % grid_n * kBN);
        issue_x(it + kXStages - 1);
      }
      mbar_wait(&xfull[sx], (it / kXStages) & 1);
      const unsigned char* xt = xring + sx * kXTile;
#pragma unroll
      for (int j = 0; j < kBM / 16; ++j) {
        const int r = r0 + 16 * j;
        const uint2 raw =
            *reinterpret_cast<const uint2*>(xt + r * kBK + 8 * c);
        *reinterpret_cast<uint4*>(st + r * 128 + ((c ^ (r & 7)) << 4)) =
            bf16x8(raw);
      }
      // the generic-proxy stores, visible to wgmma's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[s]);
      mbar_arrive(&xempty[sx]);
    }
    return;
  }

  // The consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of a tile.
  const int cw = tid / 128 - 1;
  const int lane = tid % 32;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&wfull[s], (it / kStages) & 1);  // the weight tiles
      mbar_wait(&full[s], (it / kStages) & 1);   // the bf16 A tile
      const uint32_t a = smem_u32(smem + s * kStage) + cw * 64 * 128;
      const uint32_t hi = smem_u32(smem + s * kStage + kATile);
      const uint32_t lo = hi + kBN * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = sw128_desc(a + kk * 32);
        wgmma_m64n128k16(acc, da, sw128_desc(hi + kk * 32));
        wgmma_m64n128k16(acc, da, sw128_desc(lo + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // Epilogue: element 4 j + i of acc is row 16 warp + lane / 4 + 8
    // (i / 2), column 8 j + 2 (lane % 4) + i % 2 of this warpgroup's
    // 64 x 128 part of the tile.
    const int row =
        tile / grid_n * kBM + cw * 64 + (tid % 128) / 32 * 16 + lane / 4;
    const int n0 = tile % grid_n * kBN;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= n) continue;   // n is even: col + 1 < n too
      const float b0 = bias[col], b1 = bias[col + 1];
      if (row < rows) {
        store2(out + (size_t)row * n + col, acc[4 * j] + b0,
               acc[4 * j + 1] + b1);
      }
      if (row + 8 < rows) {
        store2(out + (size_t)(row + 8) * n + col, acc[4 * j + 2] + b0,
               acc[4 * j + 3] + b1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry points (no link
// against libcuda), or null.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <bool kPairs, bool kAligned>
int launch_patchify(const uint8_t* images, uint8_t* x, int groups,
                    int patch, int width, int k, int k_pad, int smem,
                    cudaStream_t stream) {
  auto kernel = patchify_kernel<kPairs, kAligned>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<groups, kPatchifyThreads, smem, stream>>>(images, x, patch, width,
                                                     k, k_pad);
  return (int)cudaGetLastError();
}

template <bool kPairs>
int launch_patchify_aligned(const uint8_t* images, uint8_t* x, int groups,
                            int patch, int width, int k, int k_pad,
                            int smem, cudaStream_t stream) {
  // 16-byte span loads where every group's span is aligned
  if (reinterpret_cast<uintptr_t>(images) % 16 == 0 &&
      3LL * patch * width % 16 == 0) {
    return launch_patchify<kPairs, true>(images, x, groups, patch, width, k,
                                         k_pad, smem, stream);
  }
  return launch_patchify<kPairs, false>(images, x, groups, patch, width, k,
                                        k_pad, smem, stream);
}

// The persistent grid: one block per SM (its shared memory allows no
// second), at most one per tile.
template <typename OutT>
int launch_gemm(const CUtensorMap& xmap, const CUtensorMap& wmap,
                const float* bias, OutT* out, int rows, int n, int k_tiles,
                int grid_n, int tiles, cudaStream_t stream) {
  auto kernel = patch_gemm_kernel<OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem, stream>>>(
      xmap, wmap, bias, out, rows, n, k_tiles, grid_n, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// images: (batch, height, width, 3) uint8, contiguous; x: (rows, k_pad)
// uint8 scratch for the patch rows, rows = batch (height / p) (width / p),
// 16-byte aligned; w: (3 p^2, n) fp32, contiguous: the folded weights;
// wsplit: (2, n, k_pad) bf16 scratch, 16-byte aligned, for their hi and lo
// parts (kernel 0); bias: (n,) fp32; out: (rows, n), bf16 (out_bf16 = 1)
// or fp32, contiguous. height and width multiples of p; n a multiple of
// 4. The plan is ops/patch_embed.py patch_plan's: (bm, bn, bk, stages)
// must be this layout's, k_pad 3 p^2 rounded up to bk, (grid_n, grid_m)
// the tiles of out, smem the GEMM's bytes and patchify_smem p image rows
// rounded up to 16 bytes, within a block's limit. At most 65535 row tiles.
// Launches the split, the patchify kernel and the GEMM, in that order, on
// `stream`. Returns the cudaError_t of the launches (cudaErrorInvalidValue
// for a shape or plan it refuses, cudaErrorNotSupported without the
// driver's tensor-map encoder).
extern "C" int clipa_patch_embed(const void* images, void* x, const void* w,
                                 void* wsplit, const void* bias, void* out,
                                 int batch, int height, int width, int patch,
                                 int n, int k_pad, int out_bf16, int bm,
                                 int bn, int bk, int stages, int grid_n,
                                 int grid_m, int smem, int patchify_smem,
                                 void* stream) {
  if (batch <= 0 || patch <= 0 || height <= 0 || width <= 0 ||
      height % patch || width % patch || n <= 0 || n % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const long long groups = (long long)batch * (height / patch);
  const long long rows = groups * (width / patch);
  const int k = 3 * patch * patch;
  if (bm != kBM || bn != kBN || bk != kBK || stages != kStages ||
      k_pad != (k + kBK - 1) / kBK * kBK || grid_n != (n + kBN - 1) / kBN ||
      grid_m != (rows + kBM - 1) / kBM || grid_m > 65535 || smem != kSmem ||
      patchify_smem != (3LL * patch * width + 15) / 16 * 16 ||
      patchify_smem > kSmemLimit || groups > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(wsplit) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[3] = {(cuuint64_t)k_pad, (cuuint64_t)n, 2};
  const cuuint64_t wstrides[2] = {(cuuint64_t)k_pad * 2,
                                  (cuuint64_t)k_pad * 2 * n};
  const cuuint32_t wbox[3] = {kBK, kBN, 2};
  const cuuint64_t xdims[2] = {(cuuint64_t)k_pad, (cuuint64_t)rows};
  const cuuint64_t xstrides[1] = {(cuuint64_t)k_pad};
  const cuuint32_t xbox[2] = {kBK, kBM};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wsplit, wdims,
             wstrides, wbox, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims, xstrides,
             xbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* img = static_cast<const uint8_t*>(images);
  uint8_t* x_ = static_cast<uint8_t*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  split_kernel<<<dim3((n + 31) / 32, k_pad / 32), kSplitThreads, 0, s>>>(
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(wsplit), k,
      n, k_pad);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = patch % 2 == 0
            ? launch_patchify_aligned<true>(img, x_, (int)groups, patch,
                                            width, k, k_pad, patchify_smem, s)
            : launch_patchify_aligned<false>(img, x_, (int)groups, patch,
                                             width, k, k_pad, patchify_smem,
                                             s);
  if (err) return err;
  const float* b_ = static_cast<const float*>(bias);
  if (out_bf16) {
    return launch_gemm(xmap, wmap, b_, static_cast<__nv_bfloat16*>(out),
                       (int)rows, n, k_pad / kBK, grid_n, grid_n * grid_m,
                       s);
  }
  return launch_gemm(xmap, wmap, b_, static_cast<float*>(out), (int)rows, n,
                     k_pad / kBK, grid_n, grid_n * grid_m, s);
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
