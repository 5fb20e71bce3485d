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
//
// Kernels, on one stream, in this order (no atomics: deterministic):
//   1. dq kernel, one block per (64-row q-tile, head, sample): a prologue
//      computes delta for its rows and writes it to scratch; then it sweeps
//      the key tiles and accumulates dq in fp32 registers.
//   2. dk/dv kernel, one block per (64-row key tile, head, sample): sweeps
//      the q-tiles with LSE and delta, accumulating dK and dV in fp32
//      registers, rounded once at the end.
// Query rows past Lq are zero-filled (dO = 0: they add nothing, as the
// Pallas kernels' padded rows add nothing) and never written; head-dim
// columns past hd are zero-filled. Layouts as in flash_attention_fwd.cu:
// (B, L, H, hd) contiguous operands, LSE and delta (B, H, Lq) fp32.
//
// What bounds it: at the unmask-tuning shape (B = 128, L = 138, 16 heads of
// 64) the function needs 25 GFLOP (5 products) and moves 291 MB (q, k, v,
// o, dO and LSE read, dq, dk, dv written): on an H100 SXM (data-sheet
// rates) device memory bounds it (0.087 ms at 3.35 TB/s). The two kernels
// recompute s and dp each (7 products instead of 5) to keep every sum
// inside a block. This first version keeps the loads synchronous (no
// cp.async/TMA, no wgmma): the known headroom.
//
// fp32 operands run scalar twins (one block per query row for dq, per key
// row for dk/dv; fp32 FMA, no TF32, nothing rounded). Right, not fast.

#include <math.h>

#include "attention_common.cuh"

using namespace attn;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;  // rows per block tile, 16 per warp

// Writes the warp tiles `acc` (16 rows per warp, rows tile0 + ...) of one
// head, times `mul`, to `dst` in bf16 (rows < len, columns < hd).
template <int kHdp>
__device__ __forceinline__ void store_rows(float acc[kHdp / 8][4], bf16* dst,
                                           int tile0, int len, int hd, int ld,
                                           float mul) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = tile0 + warp * 16 + g + 8 * r;
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

// Kernel 1: delta and dq, one block per (q-tile, head, sample).
template <int kHdp>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kTile * kStride;
  bf16* sk = sdo + kTile * kStride;
  bf16* sv = sk + kTile * kStride;
  float* s_delta = reinterpret_cast<float*>(sv + kTile * kStride);

  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const size_t qbase = (size_t)b * lq * ld + (size_t)h * hd;
  const size_t kbase = (size_t)b * lk * ld + (size_t)h * hd;
  const size_t stat0 = ((size_t)b * num_heads + h) * lq;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool active = q0 + warp * 16 < lq;

  load_rows<kHdp, kTile, kThreads>(sq, q + qbase, q0, lq, hd, ld);
  load_rows<kHdp, kTile, kThreads>(sdo, dout + qbase, q0, lq, hd, ld);
  __syncthreads();

  // Prologue: delta = rowsum(dO * O) in fp32, each warp over its 16 rows,
  // the lanes across the head dim.
  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + warp * 16 + rr;
    float part = 0.f;
    if (row < lq) {
      const bf16* o = out + qbase + (size_t)row * ld;
      const bf16* d = sdo + (warp * 16 + rr) * kStride;
      for (int c = lane; c < hd; c += 32) {
        part += __bfloat162float(d[c]) * __bfloat162float(o[c]);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, m);
    }
    if (lane == 0) {
      s_delta[warp * 16 + rr] = part;
      if (row < lq) delta[stat0 + row] = part;
    }
  }
  __syncwarp();
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    row_lse[r] = row < lq ? lse[stat0 + row] : 0.f;
    row_delta[r] = s_delta[warp * 16 + g + 8 * r];
  }

  const bf16* sqw = sq + warp * 16 * kStride;
  const bf16* sdow = sdo + warp * 16 * kStride;
  float acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  float s[kTile / 8][4], dp[kTile / 8][4];
  for (int k0 = 0; k0 < lk; k0 += kTile) {
    __syncthreads();  // every warp done with the last K/V tile
    load_rows<kHdp, kTile, kThreads>(sk, k + kbase, k0, lk, hd, ld);
    load_rows<kHdp, kTile, kThreads>(sv, v + kbase, k0, lk, hd, ld);
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
        float ds = 0.f;
        if (key < lk) {
          const float p = __expf(s[nt][i] * scale - row_lse[r]);
          ds = p * (dp[nt][i] - row_delta[r]);
        }
        s[nt][i] = ds;
      }
    }
    // dq += bf16(ds) . K
    warp_accumulate<kHdp, kTile / 16>(acc, s, sk);
  }
  if (active) store_rows<kHdp>(acc, dq + qbase, q0, lq, hd, ld, scale);
}

// Kernel 2: dk and dv, one block per (key tile, head, sample), sweeping the
// q-tiles with kernel 1's delta. The warp's 16 key rows are the rows of the
// transposed score tile s^T (keys x queries).
template <int kHdp>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kTile * kStride;
  bf16* sq = sv + kTile * kStride;
  bf16* sdo = sq + kTile * kStride;
  float* s_lse = reinterpret_cast<float*>(sdo + kTile * kStride);
  float* s_delta = s_lse + kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const int ld = num_heads * hd;
  const size_t qbase = (size_t)b * lq * ld + (size_t)h * hd;
  const size_t kbase = (size_t)b * lk * ld + (size_t)h * hd;
  const size_t stat0 = ((size_t)b * num_heads + h) * lq;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool active = k0 + warp * 16 < lk;

  load_rows<kHdp, kTile, kThreads>(sk, k + kbase, k0, lk, hd, ld);
  load_rows<kHdp, kTile, kThreads>(sv, v + kbase, k0, lk, hd, ld);
  const bf16* skw = sk + warp * 16 * kStride;
  const bf16* svw = sv + warp * 16 * kStride;
  const bool key_ok[2] = {k0 + warp * 16 + g < lk,
                          k0 + warp * 16 + g + 8 < lk};

  float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;
  }
  float st[kTile / 8][4], dpt[kTile / 8][4];
  for (int q0 = 0; q0 < lq; q0 += kTile) {
    __syncthreads();  // sk/sv written; every warp done with the last tile
    load_rows<kHdp, kTile, kThreads>(sq, q + qbase, q0, lq, hd, ld);
    load_rows<kHdp, kTile, kThreads>(sdo, dout + qbase, q0, lq, hd, ld);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < lq;
      s_lse[i] = ok ? lse[stat0 + q0 + i] : 0.f;
      s_delta[i] = ok ? delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    warp_scores<kHdp, kTile / 8>(st, skw, sq);
    warp_scores<kHdp, kTile / 8>(dpt, svw, sdo);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t + (i & 1);  // query row within tile
        float p = 0.f, ds = 0.f;
        if (key_ok[i >> 1] && q0 + col < lq) {
          p = __expf(st[nt][i] * scale - s_lse[col]);
          ds = p * (dpt[nt][i] - s_delta[col]);
        }
        st[nt][i] = p;
        dpt[nt][i] = ds;
      }
    }
    warp_accumulate<kHdp, kTile / 16>(dv_acc, st, sdo);   // += bf16(p)^T . dO
    warp_accumulate<kHdp, kTile / 16>(dk_acc, dpt, sq);   // += bf16(ds)^T . Q
  }
  if (!active) return;
  store_rows<kHdp>(dk_acc, dk + kbase, k0, lk, hd, ld, scale);
  store_rows<kHdp>(dv_acc, dv + kbase, k0, lk, hd, ld, 1.f);
}

template <int kHdp>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
           const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
           float* delta, int batch, int lq, int lk, int num_heads, int hd,
           float scale, cudaStream_t stream) {
  const int tiles_bytes = 4 * kTile * (kHdp + 8) * (int)sizeof(bf16);
  const int smem_dq = tiles_bytes + kTile * (int)sizeof(float);
  const int smem_dkv = tiles_bytes + 2 * kTile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_dq_kernel<kHdp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_dkv_kernel<kHdp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((lq + kTile - 1) / kTile, num_heads, batch);
  flash_attention_dq_kernel<kHdp><<<grid_q, kThreads, smem_dq, stream>>>(
      q, k, v, out, lse, dout, dq, delta, lq, lk, num_heads, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((lk + kTile - 1) / kTile, num_heads, batch);
  flash_attention_dkv_kernel<kHdp><<<grid_k, kThreads, smem_dkv, stream>>>(
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
// forward's) and delta (scratch, written here): (batch, num_heads, lq) fp32.
// head_dim must be a multiple of 8 and at most 128. Returns the cudaError_t
// of the launches.
extern "C" int clipa_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int batch, int lq, int lk, int num_heads, int head_dim,
    float scale, void* stream) {
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
                     batch, lq, lk, num_heads, head_dim, scale, s)
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
