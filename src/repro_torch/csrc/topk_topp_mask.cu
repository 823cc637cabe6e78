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
// 227 KiB a block may opt into). A row wider than that (rwkv6's 65536,
// recurrentgemma's 256000 logits) is split over a cluster of kCluster
// blocks on neighbouring SMs, each holding 1/kCluster of the row in its
// shared memory: every count, mass and max is reduced in each block and
// then across the cluster through distributed shared memory (each block
// reads the others' partials in rank order, so all agree bit for bit on
// every decision). Past kCluster * 57856 logits a single block reads the
// row from global memory on every pass instead (L2-resident while T rows
// fit in the 50 MB L2). Both thresholds are found by bisection, each step
// one row-wide count or mass reduction, as on the TPU, but over the
// 32-bit order-preserving encoding of the values instead of over the
// float range: 32 steps then land exactly on the k-th largest logit and
// on the nucleus cutoff probability, so the keep-set equals the oracle's
// instead of approximating it within range/2^30.
//
// Plain C interface, loaded with ctypes; launched on the caller's stream;
// returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
// shared memory a block may use on Hopper, less a margin for the
// reductions' static scratch
constexpr size_t kMaxRowBytes = 227 * 1024 - 1024;
constexpr int kMaxDevices = 64;
// blocks a wide row is split over: the portable cluster size
constexpr int kCluster = 8;

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

// Where a row lives: staged in one block's shared memory, read from global
// memory by one block, or split over a cluster's shared memory.
enum class Row { kShared, kGlobal, kCluster };

// Row-wide reductions: the block's, and for a cluster then the cluster's.
// A cluster exchanges each block's total through a slot in its shared
// memory, two slots a type used in turn: a block writes the slot of step
// i + 2 only after the barrier of step i + 1, which every block reaches
// only after reading step i's.
template <Row kRow>
struct Reducer {
  float* red_f;
  double* red_d;
  unsigned int* red_u;
  float* xch_f;
  double* xch_d;
  unsigned int* xch_u;
  int step = 0;

  template <typename T, typename Op>
  __device__ T across(T v, T* slots, Op op) {
    if constexpr (kRow != Row::kCluster) {
      return v;
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      T* slot = slots + (step++ & 1);
      if (threadIdx.x == 0) *slot = v;
      cluster.sync();
      T r = *cluster.map_shared_rank(slot, 0);
      for (unsigned int b = 1; b < cluster.num_blocks(); ++b)
        r = op(r, *cluster.map_shared_rank(slot, b));
      return r;
    }
  }
  __device__ float max(float v) {
    return across(block_max(v, red_f), xch_f,
                  [](float a, float b) { return fmaxf(a, b); });
  }
  __device__ double sum(double v) {
    return across(block_sum(v, red_d), xch_d,
                  [](double a, double b) { return a + b; });
  }
  __device__ unsigned int sum(unsigned int v) {
    return across(block_sum(v, red_u), xch_u,
                  [](unsigned int a, unsigned int b) { return a + b; });
  }
};

// kRow: where the row lives (see Row). A cluster's block holds `per`
// logits of its row from position rank * per on; the other forms hold the
// whole row (per unused).
template <Row kRow>
__global__ void __launch_bounds__(kThreads) topk_topp_mask_kernel(
    const float* __restrict__ logits, const int* __restrict__ top_k,
    const float* __restrict__ top_p, float* __restrict__ out, int V,
    int per) {
  extern __shared__ float row_smem[];
  __shared__ float red_f[kWarps];
  __shared__ double red_d[kWarps];
  __shared__ unsigned int red_u[kWarps];
  __shared__ float xch_f[2];
  __shared__ double xch_d[2];
  __shared__ unsigned int xch_u[2];
  constexpr bool kCl = kRow == Row::kCluster;
  const int t = kCl ? blockIdx.y : blockIdx.x;
  const int j0 = kCl ? blockIdx.x * per : 0;
  const int n = kCl ? max(0, min(per, V - j0)) : V;  // this block's logits
  const float* xg = logits + (int64_t)t * V + j0;
  if constexpr (kRow != Row::kGlobal) {
    for (int i = threadIdx.x; i < n; i += kThreads) row_smem[i] = xg[i];
    __syncthreads();
  }
  const float* __restrict__ x = kRow == Row::kGlobal ? xg : row_smem;
  Reducer<kRow> red{red_f, red_d, red_u, xch_f, xch_d, xch_u};
  const int k = top_k[t];
  const float p = top_p[t];

  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) mx = fmaxf(mx, x[i]);
  mx = red.max(mx);

  // top-k: the largest key t with count(key >= t) >= k is the k-th
  // largest logit's key (k >= V keeps everything, as the oracle's clip)
  uint32_t k_key = 0;
  if (k > 0 && k < V) {
    uint64_t lo = 0, hi = 0xFFFFFFFFull;  // invariant: count(>= lo) >= k
    while (lo < hi) {
      const uint64_t mid = lo + (hi - lo + 1) / 2;
      unsigned int cnt = 0;
      for (int i = threadIdx.x; i < n; i += kThreads)
        cnt += order_key(x[i]) >= (uint32_t)mid;
      cnt = red.sum(cnt);
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
    for (int i = threadIdx.x; i < n; i += kThreads) s += (double)expf(x[i] - mx);
    denom = (float)red.sum(s);
    double total = 0.0;
    for (int i = threadIdx.x; i < n; i += kThreads)
      total += (double)(expf(x[i] - mx) / denom);
    total = red.sum(total);
    uint32_t lo = 0, hi = __float_as_uint(1.0f / denom);  // the max's prob
    if (total < (double)p) {
      lo = hi;  // no prefix reaches top_p: the oracle keeps the max only
    }
    while (lo < hi) {
      const uint32_t mid = lo + (hi - lo + 1) / 2;
      double mass = 0.0;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float pi = expf(x[i] - mx) / denom;
        if (__float_as_uint(pi) >= mid) mass += (double)pi;
      }
      mass = red.sum(mass);
      if (mass >= (double)p) lo = mid; else hi = mid - 1;
    }
    p_key = lo;
  }

  float* o = out + (int64_t)t * V + j0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float xi = x[i];
    bool keep = order_key(xi) >= k_key;
    if (p < 1.0f) keep = keep && __float_as_uint(expf(xi - mx) / denom) >= p_key;
    o[i] = keep ? xi : kNegInf;
  }
  // no block leaves while another may still read its exchange slots
  if constexpr (kCl) cg::this_cluster().sync();
}

// The opt-in to more than 48 KiB of dynamic shared memory holds per
// device and kernel. It is made once per device, always to the widest row,
// so the limit never shrinks under a launch on another thread (the first
// call on a device happens outside any CUDA graph capture).
template <Row kRow>
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(topk_topp_mask_kernel<kRow>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxRowBytes);
    if (e != cudaSuccess) return e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int topk_topp_mask_f32(const void* logits, const void* top_k,
                                  const void* top_p, void* out, int T, int V,
                                  void* stream) {
  if (T <= 0 || V <= 0 || T > 65535) return (int)cudaErrorInvalidValue;
  const float* lg = static_cast<const float*>(logits);
  const int* kk = static_cast<const int*>(top_k);
  const float* pp = static_cast<const float*>(top_p);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t row_bytes = (size_t)V * sizeof(float);
  cudaError_t e;
  if (row_bytes <= kMaxRowBytes) {
    if ((e = opt_in<Row::kShared>()) != cudaSuccess) return (int)e;
    topk_topp_mask_kernel<Row::kShared><<<T, kThreads, row_bytes, s>>>(
        lg, kk, pp, o, V, V);
    return (int)cudaGetLastError();
  }
  const int per = (V + kCluster - 1) / kCluster;
  if ((size_t)per * sizeof(float) > kMaxRowBytes) {
    topk_topp_mask_kernel<Row::kGlobal><<<T, kThreads, 0, s>>>(
        lg, kk, pp, o, V, V);
    return (int)cudaGetLastError();
  }
  if ((e = opt_in<Row::kCluster>()) != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, T);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)per * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, topk_topp_mask_kernel<Row::kCluster>, lg, kk,
                         pp, o, V, per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
