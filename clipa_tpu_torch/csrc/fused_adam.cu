// Adam's whole chain for every parameter in one pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package runs the same chain as an
// optax transform that XLA fuses into a few loops over each leaf
// (clipa_tpu/optim.py scale_by_fused_adam, :143-230, on the launch count);
// the port ran it as eager PyTorch, some twenty elementwise kernels for
// each leaf (optim.py Optimizer.chain_update, the plain version). This
// kernel computes, for each element of every unfrozen leaf,
//
//   g   <- g / norm * clip                where a clip is set and norm >= clip
//   mu  <- g (1 - b1) + b1 mu             (scale_by_adam: b1 mu rounded to
//                                           mu's dtype; fused: in fp32)
//   nu  <- g^2 (1 - b2) + b2 nu
//   x   <- (mu / bc1) / (sqrt(nu / bc2 + eps_root) + eps)
//   x   <- x + wd p                       (where the leaf decays)
//   x   <- x lr * lr_mult * lwd * sched[group]
//   p   <- p - x,  updates <- -x          (updates only when asked)
//
// reading p, g, mu and nu once and writing p, mu and nu once: 24 bytes per
// parameter with fp32 p, g and nu and a bf16 mu (the benchmark's configs),
// 23.2 GB at H/14 (967.9M parameters), 6.9 ms at 3.35 TB/s. Bytes bound it:
// some 25 flops per element against 24 bytes is far below the card's ratio.
//
// Rounding: the eager chain rounds after every op, and this kernel does the
// same ops in the same order with the rounding intrinsics (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn: cuda_build's flags let nvcc contract a
// multiply and an add into one FMA otherwise), as PyTorch's CUDA kernels
// execute them: a tensor divided by a Python scalar (mu / bc1, nu / bc2) is
// a multiply by the scalar's fp32 reciprocal; a tensor times a 0-d CPU
// tensor of mu's dtype (scale_by_adam's b1 mu) is an fp32 product of the
// two rounded to mu's dtype; lr, lr_mult, lwd and the schedule's value are
// four fp32 multiplies. The wrapper computes each scalar as PyTorch
// converts it (ops/fused_adam.py StepArgs). So the kernel matches the
// chain on the card bit for bit (tests/test_torch_cuda.py).
//
// The layout: a leaf table (Leaf, one row per unfrozen leaf: its p, mu and
// nu pointers and constants, on the device from the optimizer's
// construction), a chunk table (Chunk: (leaf, offset, length) pieces of at
// most ops/fused_adam.py CHUNK elements over every leaf, built once) and
// the gradients' pointers (one int64 per leaf, copied to the device each
// step: autograd allocates new gradients every step). One
// block per chunk, so the ~370 tiny leaves (biases, norms, scalars) and
// the large kernels share one launch, and a large leaf spreads over many
// SMs (H/14: some 15,000 blocks of 256 threads). Each thread takes 8
// consecutive elements per step, with 16-byte loads and stores (two for a
// 4-byte type, one for a 2-byte type) where every pointer of the chunk is
// 16-byte aligned, then a scalar tail; a chunk with an unaligned pointer (a
// gradient that is a view at an odd offset) runs scalar. No shared memory,
// no atomics, no host synchronisation; the clip's norm is read from the
// device. Measured (tools/adam_bench.py,
// NVIDIA H100 80GB HBM3, 700 W, device time per step): 8.12 ms at H/14
// against its 6.93-ms bound (85%), 3.51 ms at L/16 against 2.97 (84.5%);
// the eager chain's kernels took 71.8 and 34.4 ms.
//
// Dtypes: fp32 parameters and gradients (every config trains fp32 masters,
// and the chain takes g.float()), mu and nu each fp32 or bf16 (what a
// config's mu_dtype and nu_dtype can name), scale_by_adam or
// scale_by_fused_adam: 8 instantiations. The wrapper refuses anything else.
//
// A frozen leaf (schedule None) is not in the table and is left untouched:
// the eager chain added a zero update to it, which turned a -0.0 into +0.0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements per thread per vector step
constexpr int kMaxGroups = 8;      // ops/fused_adam.py MAX_GROUPS

// One unfrozen leaf: ops/fused_adam.py LEAF (64 bytes).
struct Leaf {
  void* p;
  void* mu;
  void* nu;
  int64_t numel;
  int64_t out;        // the leaf's offset in the updates buffer
  float wd;           // decoupled weight decay (has_wd)
  float lr_mult;      // 1 where config.lr_mults names no pattern for it
  float lwd;          // 1 where config.lwd gives no multiplier
  int32_t group;      // its schedule's index in StepArgs.sched
  int32_t has_wd;
  int32_t pad;
};
static_assert(sizeof(Leaf) == 64, "Leaf is ops/fused_adam.py LEAF");

// One piece of a leaf: ops/fused_adam.py CHUNK_ROW (16 bytes).
struct Chunk {
  int32_t leaf;
  int32_t len;
  int64_t begin;      // a multiple of kVec
};
static_assert(sizeof(Chunk) == 16, "Chunk is ops/fused_adam.py CHUNK_ROW");

// The step's scalars, each the fp32 value PyTorch computes with: ops/
// fused_adam.py StepArgs (the same fields in the same order).
struct StepArgs {
  float one_minus_b1;  // fp32(1 - b1)
  float b1;            // fp32(b1): scale_by_fused_adam's mu.float() * b1
  float b1_mu;         // float(b1 in mu's dtype): scale_by_adam's
  float one_minus_b2;
  float b2;
  float inv_bc1;       // fp32(1) / fp32(bc1)
  float inv_bc2;
  float eps_root;
  float eps;
  float lr;
  float clip;          // fp32(grad_clip_norm)
  int32_t n_groups;
  const float* norm;   // the gradients' global norm, or null: no clip
  float* updates;      // fp32, one per parameter, or null: not asked
  float sched[kMaxGroups];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// fp32 -> T, round to nearest even (PyTorch's .to(dtype) and copy_)
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kVec elements from 16-byte aligned `src`, widened to fp32
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float (&out)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < kVec / kPer; ++v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + v * kPer);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[v * kPer + i] = to_f(e[i]);
  }
}

// kVec fp32 values rounded to T, to 16-byte aligned `dst`
template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float (&in)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < kVec / kPer; ++v) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) e[i] = from_f<T>(in[v * kPer + i]);
    *reinterpret_cast<uint4*>(dst + v * kPer) = raw;
  }
}

// The leaf's constants and the step's, for one element.
struct Consts {
  bool scale;          // the clip scales: norm >= clip (or NaN)
  float norm, clip;
  float wd, lr_mult, lwd, sched;
  bool has_wd;
};

// The chain for one element: p, mu and nu in and out (fp32; the caller
// rounds them to their dtypes), g in; returns the update -x.
template <typename M, bool kFused>
__device__ __forceinline__ float adam_element(float& p, float g, float& mu,
                                              float& nu, const StepArgs& s,
                                              const Consts& c) {
  if (c.scale) {   // torch.where(norm < clip, g, g / norm * clip)
    g = __fmul_rn(__fdiv_rn(g, c.norm), c.clip);
  }
  // scale_by_fused_adam: mu.float() * b1; scale_by_adam: mu * bf16(b1) in
  // mu's dtype, an fp32 product rounded to it (no rounding for fp32 mu)
  const float decayed =
      kFused ? __fmul_rn(mu, s.b1) : to_f(from_f<M>(__fmul_rn(mu, s.b1_mu)));
  mu = __fadd_rn(__fmul_rn(g, s.one_minus_b1), decayed);
  const float g2 = kFused ? __fmul_rn(__fmul_rn(g, s.one_minus_b2), g)
                          : __fmul_rn(__fmul_rn(g, g), s.one_minus_b2);
  nu = __fadd_rn(g2, __fmul_rn(nu, s.b2));
  const float denom = __fadd_rn(
      __fsqrt_rn(__fadd_rn(__fmul_rn(nu, s.inv_bc2), s.eps_root)), s.eps);
  float x = __fdiv_rn(__fmul_rn(mu, s.inv_bc1), denom);
  if (c.has_wd) x = __fadd_rn(x, __fmul_rn(p, c.wd));
  x = __fmul_rn(x, s.lr);
  x = __fmul_rn(x, c.lr_mult);
  x = __fmul_rn(x, c.lwd);
  x = __fmul_rn(x, c.sched);
  p = __fadd_rn(p, -x);
  return -x;
}

template <typename M, typename N, bool kFused>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(const Leaf* __restrict__ leaves,
                      const Chunk* __restrict__ chunks,
                      const int64_t* __restrict__ grads, StepArgs s) {
  const Chunk ch = chunks[blockIdx.x];
  const Leaf& leaf = leaves[ch.leaf];
  float* __restrict__ p = static_cast<float*>(leaf.p) + ch.begin;
  const float* __restrict__ g =
      reinterpret_cast<const float*>(grads[ch.leaf]) + ch.begin;
  M* __restrict__ mu = static_cast<M*>(leaf.mu) + ch.begin;
  N* __restrict__ nu = static_cast<N*>(leaf.nu) + ch.begin;
  float* __restrict__ out =
      s.updates != nullptr ? s.updates + leaf.out + ch.begin : nullptr;

  Consts c;
  c.norm = s.norm != nullptr ? *s.norm : 0.0f;
  c.clip = s.clip;
  c.scale = s.norm != nullptr && !(c.norm < s.clip);   // NaN scales too
  c.wd = leaf.wd;
  c.lr_mult = leaf.lr_mult;
  c.lwd = leaf.lwd;
  // a static index per candidate: s.sched[leaf.group] would copy the
  // launch's arguments to each thread's stack
  c.sched = s.sched[0];
#pragma unroll
  for (int k = 1; k < kMaxGroups; ++k) {
    if (leaf.group == k) c.sched = s.sched[k];
  }
  c.has_wd = leaf.has_wd != 0;

  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(mu) |
                         reinterpret_cast<uintptr_t>(nu) |
                         reinterpret_cast<uintptr_t>(out);
  const int n = ch.len;
  const int n_vec = (bits & 15) == 0 ? n / kVec * kVec : 0;
  for (int i = threadIdx.x * kVec; i < n_vec; i += kThreads * kVec) {
    float pv[kVec], gv[kVec], mv[kVec], nv[kVec], ov[kVec];
    load_vec(p + i, pv);
    load_vec(g + i, gv);
    load_vec(mu + i, mv);
    load_vec(nu + i, nv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      ov[k] = adam_element<M, kFused>(pv[k], gv[k], mv[k], nv[k], s, c);
    }
    store_vec(p + i, pv);
    store_vec(mu + i, mv);
    store_vec(nu + i, nv);
    if (out != nullptr) store_vec(out + i, ov);
  }
  for (int i = n_vec + threadIdx.x; i < n; i += kThreads) {
    float pe = p[i], me = to_f(mu[i]), ne = to_f(nu[i]);
    const float o = adam_element<M, kFused>(pe, g[i], me, ne, s, c);
    p[i] = pe;
    mu[i] = from_f<M>(me);
    nu[i] = from_f<N>(ne);
    if (out != nullptr) out[i] = o;
  }
}

// ops/fused_adam.py MOMENT_DTYPES: the moments' dtypes a config can name
template <typename F>
cudaError_t with_moment_dtype(int code, F&& f) {
  switch (code) {
    case 0: return f(static_cast<float*>(nullptr));
    case 1: return f(static_cast<__nv_bfloat16*>(nullptr));
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
using Pointee = std::remove_pointer_t<T>;

}  // namespace

// One launch over `n_chunks` chunks: leaves (the leaf table), chunks (the
// chunk table), grads (one int64 pointer per leaf, each gradient
// contiguous in its leaf's shape), device memory; the dtype codes of mu
// and nu (0 fp32, 1 bf16; p and g are fp32); fused: scale_by_fused_adam
// (1) or scale_by_adam (0); args: the step's scalars, in host memory
// (copied into the launch). On `stream`; returns the launch's cudaError_t
// (cudaErrorInvalidValue for what it refuses).
extern "C" int clipa_fused_adam(const void* leaves, const void* chunks,
                                const void* grads, int n_chunks, int m_dtype,
                                int n_dtype, int fused, const void* args,
                                void* stream) {
  const StepArgs s = *static_cast<const StepArgs*>(args);
  if (n_chunks <= 0 || s.n_groups <= 0 || s.n_groups > kMaxGroups ||
      (fused != 0 && fused != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* l = static_cast<const Leaf*>(leaves);
  const auto* c = static_cast<const Chunk*>(chunks);
  const auto* g = static_cast<const int64_t*>(grads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_moment_dtype(m_dtype, [&](auto mt) {
    return with_moment_dtype(n_dtype, [&](auto nt) {
      using M = Pointee<decltype(mt)>;
      using N = Pointee<decltype(nt)>;
      if (fused) {
        fused_adam_kernel<M, N, true>
            <<<n_chunks, kThreads, 0, st>>>(l, c, g, s);
      } else {
        fused_adam_kernel<M, N, false>
            <<<n_chunks, kThreads, 0, st>>>(l, c, g, s);
      }
      return cudaGetLastError();
    });
  });
  return (int)err;
}

extern "C" const char* clipa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
