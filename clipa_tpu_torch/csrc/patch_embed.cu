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
// the bias is added. The normalized fp32 image never exists in memory.
//
// Mosaic could not collapse dims inside the kernel, so the reference runs a
// byte-level patchify transpose in XLA first. Here each block gathers its
// patch rows straight from the NHWC image in its global -> shared loads:
// the 3p bytes of one patch row (py) are contiguous in the image. Integers
// 0..255 convert to fp32 exactly.
//
// Layout: a tiled fp32-FMA GEMM through shared memory. A block of 256
// threads owns a 128 x 128 output tile and walks K in steps of 16; each
// thread keeps an 8 x 8 accumulator (rows ty*4 + {0..3, 64..67}, columns
// tx*4 + {0..3, 64..67}). K need not be a multiple of 16: at p = 14,
// K = 588 = 36 * 16 + 12, and the last step loads zeros past K. No tensor
// cores: the product is fp32 as the reference's dot_general is.
//
// What bounds it: at the pre-training stem (ViT-L/16 @112, B = 384: M =
// 18816 rows, K = 768, N = 1024) the product is 29.6 GFLOP against 56 MB of
// image, weights and bf16 output, so operations bound it, not memory. This
// design runs on the fp32 FMA units (67 TFLOP/s: 0.44 ms at that shape) and
// keeps the simple synchronous tile loop (no double buffering, no cp.async).
//
// The function itself can run far faster, and a later PR should take this
// route: uint8 values are exact in bf16, so splitting the folded weights
// into a bf16 high part and a bf16 remainder (w = hi + lo) gives two bf16
// tensor-core products (x.hi + x.lo, fp32 accumulate) at near-fp32
// accuracy, at up to 989 TFLOP/s: twice the operations, 0.06 ms at that
// shape. That is the bound chip_smoke.py reports for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kAStride = kBM + 4;  // skew: a column of As spreads over banks

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// One block per 128 x 128 tile of out (rows, n); grid (n / 128, rows / 128).
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
patch_embed_kernel(const uint8_t* __restrict__ images,
                   const float* __restrict__ w,
                   const float* __restrict__ bias, OutT* __restrict__ out,
                   int rows, int n, int k, int patch, int height, int width,
                   int grid_w, int n_patches) {
  __shared__ __align__(16) float As[kBK][kAStride];  // As[kk][m]
  __shared__ __align__(16) float Bs[kBK][kBN];       // Bs[kk][n]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int row_bytes = 3 * patch;  // one patch row: p pixels of 3 bytes

  // The A loads of this thread: column kk = tid % 16 of rows tid / 16 + 16j.
  // Each row's first byte in the image, or -1 past the last row.
  const int a_kk = tid % kBK;
  long long a_base[kBM / 16];
#pragma unroll
  for (int j = 0; j < kBM / 16; ++j) {
    const int row = m0 + tid / kBK + 16 * j;
    a_base[j] = -1;
    if (row < rows) {
      const int b = row / n_patches;
      const int pi = row - b * n_patches;
      const int gy = pi / grid_w;
      const int gx = pi - gy * grid_w;
      a_base[j] = (((long long)b * height + (long long)gy * patch) * width +
                   (long long)gx * patch) * 3;
    }
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are consumed
    // A: gather 16 pixel bytes of 128 patch rows, converted to fp32.
    {
      const int kg = k0 + a_kk;
      long long k_off = -1;
      if (kg < k) {
        const int py = kg / row_bytes;
        k_off = (long long)py * width * 3 + (kg - py * row_bytes);
      }
#pragma unroll
      for (int j = 0; j < kBM / 16; ++j) {
        float x = 0.f;
        if (k_off >= 0 && a_base[j] >= 0) x = (float)images[a_base[j] + k_off];
        As[a_kk][tid / kBK + 16 * j] = x;
      }
    }
    // B: 16 rows of 128 weights, 16 bytes per thread and load.
#pragma unroll
    for (int j = 0; j < (kBK * kBN / 4) / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int kk = idx / (kBN / 4);
      const int c = (idx % (kBN / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + kk < k && n0 + c < n) {
        v = *reinterpret_cast<const float4*>(w + (size_t)(k0 + kk) * n + n0 +
                                             c);
      }
      store4(&Bs[kk][c], v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  // Epilogue: + bias in fp32, one rounding to OutT, rows < rows only.
#pragma unroll
  for (int cg = 0; cg < 2; ++cg) {
    const int col = n0 + cg * 64 + tx * 4;
    if (col >= n) continue;
    const float4 bv = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (row >= rows) continue;
      const float4 v =
          make_float4(acc[i][cg * 4] + bv.x, acc[i][cg * 4 + 1] + bv.y,
                      acc[i][cg * 4 + 2] + bv.z, acc[i][cg * 4 + 3] + bv.w);
      store4(out + (size_t)row * n + col, v);
    }
  }
}

template <typename OutT>
int launch(const uint8_t* images, const float* w, const float* bias,
           OutT* out, int batch, int height, int width, int patch, int n,
           cudaStream_t stream) {
  const int grid_h = height / patch, grid_w = width / patch;
  const int n_patches = grid_h * grid_w;
  const long long rows = (long long)batch * n_patches;
  const int k = 3 * patch * patch;
  const dim3 grid((n + kBN - 1) / kBN, (unsigned)((rows + kBM - 1) / kBM));
  patch_embed_kernel<OutT><<<grid, kThreads, 0, stream>>>(
      images, w, bias, out, (int)rows, n, k, patch, height, width, grid_w,
      n_patches);
  return (int)cudaGetLastError();
}

}  // namespace

// images: (batch, height, width, 3) uint8, contiguous; w: (3 p^2, n) fp32
// and bias: (n,) fp32, contiguous and 16-byte aligned; out: (batch *
// (height / p) * (width / p), n), bf16 (out_bf16 = 1) or fp32, contiguous
// and 16-byte aligned. height and width multiples of p; n a multiple of 4;
// at most 2^31 - 1 output rows and 65535 row tiles. Returns the cudaError_t
// of the launch.
extern "C" int clipa_patch_embed(const void* images, const void* w,
                                 const void* bias, void* out, int batch,
                                 int height, int width, int patch, int n,
                                 int out_bf16, void* stream) {
  if (batch <= 0 || patch <= 0 || height <= 0 || width <= 0 ||
      height % patch || width % patch || n <= 0 || n % 4 ||
      (long long)batch * (height / patch) * (width / patch) >
          65535LL * kBM) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* img = static_cast<const uint8_t*>(images);
  const float* w_ = static_cast<const float*>(w);
  const float* b_ = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch(img, w_, b_, static_cast<__nv_bfloat16*>(out), batch,
                  height, width, patch, n, s);
  }
  return launch(img, w_, b_, static_cast<float*>(out), batch, height, width,
                patch, n, s);
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
