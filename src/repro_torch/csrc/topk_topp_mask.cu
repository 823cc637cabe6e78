// Per-row top-k / top-p logit mask for Hopper (sm_90a), without a sort.
//
// Replaces the TPU kernel src/repro/kernels/sampling/kernel.py
// topk_topp_mask_kernel. Semantics are those of the sort-based oracle
// (repro_torch/kernels/sampling/ref.py): keep logits >= the k-th largest
// (ties kept) and probs >= the nucleus cutoff (ties kept); dropped entries
// become -1e30.
//
// Bound: device memory for the one read and one write of the [T, V] f32
// logits; everything in between stays on chip. One thread block per row
// holds the row in dynamic shared memory (32000 f32 = 125 KiB, within the
// 227 KiB a block may opt into; wider rows are refused with
// cudaErrorInvalidValue). Both thresholds are found by
// bisection, each step one block-wide count or mass reduction, as on the
// TPU, but over the 32-bit order-preserving encoding of the values instead
// of over the float range: 32 steps then land exactly on the k-th largest
// logit and on the nucleus cutoff probability, so the keep-set equals the
// oracle's instead of approximating it within range/2^30.
//
// Plain C interface, loaded with ctypes; launched on the caller's stream;
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
// shared memory a block may use on Hopper, less a margin for the
// reductions' static scratch
constexpr size_t kMaxRowBytes = 227 * 1024 - 1024;
constexpr int kMaxDevices = 64;

// Monotone map of a float onto uint32: a < b  <=>  key(a) < key(b), with
// -0.0 folded onto +0.0 so the comparisons agree with float ones.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide reductions; every thread gets the result. The leading barrier
// keeps one reduction's scratch from being overwritten while the previous
// one is still being read.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? scratch[threadIdx.x] : T(0);
  if (threadIdx.x < 32) v = warp_sum(v);
  if (threadIdx.x == 0) scratch[0] = v;
  __syncthreads();
  return scratch[0];
}

__device__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? scratch[threadIdx.x] : -INFINITY;
  if (threadIdx.x < 32) v = warp_max(v);
  if (threadIdx.x == 0) scratch[0] = v;
  __syncthreads();
  return scratch[0];
}

__global__ void __launch_bounds__(kThreads) topk_topp_mask_kernel(
    const float* __restrict__ logits, const int* __restrict__ top_k,
    const float* __restrict__ top_p, float* __restrict__ out, int V) {
  extern __shared__ float x[];
  __shared__ float red_f[kWarps];
  __shared__ double red_d[kWarps];
  __shared__ unsigned int red_u[kWarps];
  const int t = blockIdx.x;
  const float* xg = logits + (int64_t)t * V;
  for (int i = threadIdx.x; i < V; i += kThreads) x[i] = xg[i];
  __syncthreads();
  const int k = top_k[t];
  const float p = top_p[t];

  float mx = -INFINITY;
  for (int i = threadIdx.x; i < V; i += kThreads) mx = fmaxf(mx, x[i]);
  mx = block_max(mx, red_f);

  // top-k: the largest key t with count(key >= t) >= k is the k-th
  // largest logit's key (k >= V keeps everything, as the oracle's clip)
  uint32_t k_key = 0;
  if (k > 0 && k < V) {
    uint64_t lo = 0, hi = 0xFFFFFFFFull;  // invariant: count(>= lo) >= k
    while (lo < hi) {
      const uint64_t mid = lo + (hi - lo + 1) / 2;
      unsigned int cnt = 0;
      for (int i = threadIdx.x; i < V; i += kThreads)
        cnt += order_key(x[i]) >= (uint32_t)mid;
      cnt = block_sum(cnt, red_u);
      if (cnt >= (unsigned int)k) lo = mid; else hi = mid - 1;
    }
    k_key = (uint32_t)lo;
  }

  // top-p over probs = exp(x - max) / sum: the largest prob value t with
  // mass(prob >= t) >= top_p. Probs are non-negative, so their bit patterns
  // order like their values. The probs are f32, as in the plain version;
  // the sum and the masses are accumulated in f64, as there, so the cutoff
  // does not depend on the order of summation (f32 rounding of a
  // 32000-term mass is as large as the tail probs near top_p ~ 1).
  uint32_t p_key = 0;
  float denom = 1.f;
  if (p < 1.0f) {
    double s = 0.0;
    for (int i = threadIdx.x; i < V; i += kThreads) s += (double)expf(x[i] - mx);
    denom = (float)block_sum(s, red_d);
    double total = 0.0;
    for (int i = threadIdx.x; i < V; i += kThreads)
      total += (double)(expf(x[i] - mx) / denom);
    total = block_sum(total, red_d);
    uint32_t lo = 0, hi = __float_as_uint(1.0f / denom);  // the max's prob
    if (total < (double)p) {
      lo = hi;  // no prefix reaches top_p: the oracle keeps the max only
    }
    while (lo < hi) {
      const uint32_t mid = lo + (hi - lo + 1) / 2;
      double mass = 0.0;
      for (int i = threadIdx.x; i < V; i += kThreads) {
        const float pi = expf(x[i] - mx) / denom;
        if (__float_as_uint(pi) >= mid) mass += (double)pi;
      }
      mass = block_sum(mass, red_d);
      if (mass >= (double)p) lo = mid; else hi = mid - 1;
    }
    p_key = lo;
  }

  float* o = out + (int64_t)t * V;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float xi = x[i];
    bool keep = order_key(xi) >= k_key;
    if (p < 1.0f) keep = keep && __float_as_uint(expf(xi - mx) / denom) >= p_key;
    o[i] = keep ? xi : kNegInf;
  }
}

}  // namespace

extern "C" int topk_topp_mask_f32(const void* logits, const void* top_k,
                                  const void* top_p, void* out, int T, int V,
                                  void* stream) {
  const size_t smem = (size_t)V * sizeof(float);
  if (T <= 0 || V <= 0 || smem > kMaxRowBytes) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  // The opt-in to more than 48 KiB holds per device. It is made once per
  // device, always to the widest row, so the limit never shrinks under a
  // launch on another thread (the first call on a device happens outside
  // any CUDA graph capture).
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(topk_topp_mask_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxRowBytes);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  topk_topp_mask_kernel<<<T, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(top_k),
      static_cast<const float*>(top_p), static_cast<float*>(out), V);
  return (int)cudaGetLastError();
}
