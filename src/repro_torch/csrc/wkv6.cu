// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py:67
// wkv6_kernel (body _wkv_kernel) and computes what the JAX package's
// sequential oracle (kernels/rwkv6/ref.py wkv6_ref) computes: per (row,
// head) an [hd, hd] state S, from zero, and for each step t
//
//   o_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
//
// w_t = exp(logw_t), in f32 throughout; o and the final S in f32.
//
// Layout: r, k, v [B, S, H, hd] bf16 (the model's layout, straight from the
// projections), logw [B, S, H, hd] f32, u [H, hd] f32; o [B, S, H, hd] f32,
// s_final [B, H, hd, hd] f32 (s_final[c][d] = S[c][d]). The pointers r, k,
// v and logw are 16-byte aligned (the op copies any that is not).
//
// Bound: device memory at the serve's shapes. A step of one head reads
// 3 * 2 hd + 4 hd bytes and writes 4 hd for about 4 hd^2 f32 operations:
// 7.9 MB and 134 MFLOP at B = 1, S = 256, H = 32, hd = 64, or 2.35 us of
// bytes against 2.0 us of f32 operations. The work is a serial chain over
// S per state entry, so a design first has to spread the B * H states
// over the card; past that, a block is bound by its shared-memory reads
// (each staged value is read by every warp that holds its key).
//
// Design: a head's state is split by columns. A block owns kCols = 16
// columns d of one (row, head): B * H * hd / 16 blocks (128 at the serve's
// shape, where one block a head filled 32 SMs).
// - Four scanning warps hold the block's columns in registers, four a
//   warp, as 16 key groups x 2 column sets: at hd 64, lane l holds keys
//   4 (l % 16) .. + 3 of two of the warp's four columns. A thread reads its keys' r and k as bf16 (two 32-bit
//   words each), w (four) and its columns' v (one) a step; every value
//   serves several entries.
// - A step costs an entry one multiply and two FMAs: the update
//   fmaf(w_c, S[c][d], k_c v_d), whose only serial chain is one FMA a
//   step, and its share r_c S[c][d] of the output; the bonus term
//   v_d sum_c r_c u_c k_c joins the thread's partial sum. The state never
//   waits on the output, so the partial outputs of kSub steps are summed
//   over the key groups together, after their updates, by a fixed
//   reduce-scatter over 16 lanes (15 shuffles for 16 sums).
// - Four producer warps stage r, k, logw and the block's v columns of
//   kT-step chunks by cp.async in a ring of kStages slots, zero-filled
//   past S (a step past the end leaves S unchanged), and turn a landed
//   chunk's logw into w = exp(logw) in place while the scanners work
//   through the chunk before it: one barrier a chunk.
// A row's arithmetic depends on its own (row, head) inputs and S alone:
// never on B, the grid or the SM count; no atomics.
//
// Decays: the model's logw = -exp(clamp(x, -20, 8)) lies in [-2981, -2e-9].
// No decay is ever factorised: w = exp(logw) is taken one step at a time
// and lies in [0, 1] (exp(-2981) is 0 in f32, exp(-2e-9) rounds to 1), so
// the state is a sum of products of values in [0, 1] and the inputs, and
// stays finite at both ends of the range. (The TPU kernel's chunked form
// multiplies exp(L_t) by exp(-L_s) and clips each exponent to [-60, 0] to
// stay finite; here nothing needs clipping.)
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_mma.cuh"  // cp.async helpers

namespace {

using attention_mma::cp_async16;
using attention_mma::cp_async_commit;
using attention_mma::cp_async_wait;

constexpr int kCols = 16;  // state columns d a block owns
constexpr int kT = 32;     // steps a stage holds
constexpr int kStages = 4; // ring depth
constexpr int kScanners = 128;  // four scanning warps, four columns each
constexpr int kProducers = 128; // four warps that stage and convert chunks
constexpr int kThreads = kScanners + kProducers;
// A scanning warp is kG key groups (the lanes one output is summed over)
// x 2 column sets; a thread holds hd / kG keys x kDPT columns. kSub =
// kG / kDPT steps' partial outputs (kG values a lane) are summed
// together, so a lane ends with one.
constexpr int kG = 16;
constexpr int kDPT = 2;
constexpr int kSub = kG / kDPT;
static_assert(kT % kSub == 0, "a chunk is whole sub-chunks");
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// The ring of staged chunks. The scanners read r, k and v as bf16 where
// they landed; the producers overwrite logw with w = exp(logw) in place.
template <int HD>
struct Smem {
  __nv_bfloat16 r[kStages][kT][HD];
  __nv_bfloat16 k[kStages][kT][HD];
  float w[kStages][kT][HD];
  __nv_bfloat16 v[kStages][kT][kCols];
};

// barrier `id` over the first `count` threads to arrive (a warp multiple)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// N consecutive bf16 values from shared memory to f32, exactly
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p,
                                          float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = bf16_lo(*reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (N == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    x[0] = bf16_lo(u), x[1] = bf16_hi(u);
  } else {
    static_assert(N == 4, "1, 2 or 4 values");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = bf16_lo(u.x), x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y), x[3] = bf16_hi(u.y);
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  } else {
    static_assert(N == 1, "1, 2 or 4 values");
    x[0] = *p;
  }
}

// Half of a lane's values to its partner across lane bit m, the other half
// kept and summed with the partner's: x[N] -> y[N / 2], where y[i] is the
// sum for index i + (N / 2 if the lane's bit m is set).
template <int N>
__device__ __forceinline__ void exchange_half(const float (&x)[N],
                                              float (&y)[N / 2], int lane,
                                              int m) {
  const bool hi = lane & m;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = hi ? x[i + N / 2] : x[i];
    const float send = hi ? x[i] : x[i + N / 2];
    y[i] = keep + __shfl_xor_sync(kFull, send, m);
  }
}

// Sum N values over the N lanes that differ in their low log2(N) bits, in
// a fixed order: lane l ends with the sum of index l % N (N - 1 shuffles).
template <int N>
__device__ __forceinline__ float reduce_scatter(const float (&x)[N],
                                                int lane) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    float y[N / 2];
    exchange_half(x, y, lane, N / 2);
    return reduce_scatter(y, lane);
  }
}

// The producer warps: stage chunk c's r, k, logw and v columns into slot
// c % kStages (cp.async, one commit group a chunk, empty past the last so
// the wait counts hold; steps past S read zeros: r = k = v = 0, w =
// exp(0) = 1), and turn a staged chunk's logw into w.
template <int HD>
struct Producer {
  Smem<HD>& sm;
  const int pt;  // thread among the producers
  const int S, d0, nchunks;
  const int64_t stride, head;

  __device__ void issue(int c, const __nv_bfloat16* r,
                        const __nv_bfloat16* k, const __nv_bfloat16* v,
                        const float* logw) {
    if (c < nchunks) {
      const int slot = c % kStages, t0 = c * kT, n = min(kT, S - t0);
      for (int i = pt; i < kT * HD / 8; i += kProducers) {
        const int t = i / (HD / 8), pc = (i % (HD / 8)) * 8;
        const bool ok = t < n;
        const int64_t off = head + (int64_t)(ok ? t0 + t : 0) * stride + pc;
        cp_async16(&sm.r[slot][t][pc], r + off, ok);
        cp_async16(&sm.k[slot][t][pc], k + off, ok);
      }
      for (int i = pt; i < kT * HD / 4; i += kProducers) {
        const int t = i / (HD / 4), pc = (i % (HD / 4)) * 4;
        const bool ok = t < n;
        const int64_t off = head + (int64_t)(ok ? t0 + t : 0) * stride + pc;
        cp_async16(&sm.w[slot][t][pc], logw + off, ok);
      }
      for (int i = pt; i < kT * 2; i += kProducers) {
        const int t = i / 2, pc = (i % 2) * 8;
        const bool ok = t < n;
        const int64_t off =
            head + (int64_t)(ok ? t0 + t : 0) * stride + d0 + pc;
        cp_async16(&sm.v[slot][t][pc], v + off, ok);
      }
    }
    cp_async_commit();
  }

  __device__ void convert(int c) {
    float4* w4 = reinterpret_cast<float4*>(&sm.w[c % kStages][0][0]);
    for (int i = pt; i < kT * HD / 4; i += kProducers) {
      float4 x = w4[i];
      x.x = expf(x.x), x.y = expf(x.y), x.z = expf(x.z), x.w = expf(x.w);
      w4[i] = x;
    }
  }
};

// Block: the scanning warps, then the producer warps. Chunk c is
// scanned while the producers issue the copies of chunk c + kStages - 1
// (into the slot chunk c - 1 left) and convert chunk c + 1; one
// block-wide barrier a chunk (id 0) hands the slots over, and a
// producers' barrier (id 1) makes every producer's copies visible before
// a conversion.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) wkv6_kernel(
    const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, float* __restrict__ o,
    float* __restrict__ s_final, int S, int H) {
  constexpr int kSplit = HD / kCols;  // blocks a head's state is split over
  constexpr int CPT = HD / kG, DPT = kDPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x / kSplit;
  const int d0 = (blockIdx.x % kSplit) * kCols;  // the block's first column
  const int64_t stride = (int64_t)H * HD;        // one step
  const int64_t head = (int64_t)blockIdx.y * S * stride + (int64_t)h * HD;
  const int nchunks = (S + kT - 1) / kT;

  if (tid >= kScanners) {
    Producer<HD> pr{sm, tid - kScanners, S, d0, nchunks, stride, head};
    for (int c = 0; c < kStages - 1; ++c) pr.issue(c, r, k, v, logw);
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk 0 landed
    bar_sync(1, kProducers);       // ... and every producer's
    pr.convert(0);
    bar_sync(0, kThreads);  // chunk 0 is ready
    for (int c = 0; c < nchunks; ++c) {
      pr.issue(c + kStages - 1, r, k, v, logw);
      cp_async_wait<kStages - 2>();  // chunk c + 1 landed
      bar_sync(1, kProducers);
      if (c + 1 < nchunks) pr.convert(c + 1);
      bar_sync(0, kThreads);
    }
    cp_async_wait<0>();
    return;
  }

  const int kg = lane % kG;  // key group
  // the thread's first column within the block
  const int col = (tid >> 5) * 4 + (lane / kG) * DPT;
  float uu[CPT];       // u of the thread's keys
  float st[CPT][DPT];  // S[kg * CPT + i][d0 + col + q]
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    uu[i] = u[(int64_t)h * HD + kg * CPT + i];
#pragma unroll
    for (int q = 0; q < DPT; ++q) st[i][q] = 0.f;
  }

  bar_sync(0, kThreads);  // chunk 0 is ready
  for (int c = 0; c < nchunks; ++c) {
    const int slot = c % kStages, t0 = c * kT, n = min(kT, S - t0);
    // kSub steps of updates, then their outputs
    for (int s0 = 0; s0 < n; s0 += kSub) {
      float p[kG];  // this thread's share of o: step s0 + j, column q
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = s0 + j;
        float rr[CPT], kk[CPT], ww[CPT], vv[DPT];
        load_bf16(&sm.r[slot][t][kg * CPT], rr);
        load_bf16(&sm.k[slot][t][kg * CPT], kk);
        load_f32(&sm.w[slot][t][kg * CPT], ww);
        load_bf16(&sm.v[slot][t][col], vv);
        // r^T (S + diag(u) k v^T) over the thread's keys: the bonus term
        // sum_c r_c u_c k_c, times v_d, then r_c S[c][d]
        float bonus = 0.f;
#pragma unroll
        for (int i = 0; i < CPT; ++i) bonus = fmaf(rr[i], uu[i] * kk[i], bonus);
#pragma unroll
        for (int q = 0; q < DPT; ++q) {
          float acc = bonus * vv[q];
#pragma unroll
          for (int i = 0; i < CPT; ++i) acc = fmaf(rr[i], st[i][q], acc);
          p[j * DPT + q] = acc;
        }
#pragma unroll
        for (int i = 0; i < CPT; ++i)
#pragma unroll
          for (int q = 0; q < DPT; ++q)
            st[i][q] = fmaf(ww[i], st[i][q], kk[i] * vv[q]);
      }
      // sum over the key groups: lane ends with index kg = j * DPT + q
      const float sum = reduce_scatter(p, lane);
      const int t = s0 + kg / DPT, dc = col + kg % DPT;
      if (t < n) o[head + (int64_t)(t0 + t) * stride + d0 + dc] = sum;
    }
    bar_sync(0, kThreads);  // chunk c is scanned, chunk c + 1 is ready
  }

  float* sf = s_final + ((int64_t)blockIdx.y * H + h) * HD * HD + d0 + col;
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int q = 0; q < DPT; ++q)
      sf[(int64_t)(kg * CPT + i) * HD + q] = st[i][q];
}

// The opt-in to more than 48 KiB of dynamic shared memory holds per device
// and kernel; it is made once per device, on the first call (outside any
// CUDA graph capture).
template <int HD>
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(wkv6_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem<HD>));
    if (e != cudaSuccess) return e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* o, void* s_final, int B, int S, int H,
           cudaStream_t stream) {
  const cudaError_t e = opt_in<HD>();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H * (HD / kCols), B);
  wkv6_kernel<HD><<<grid, kThreads, sizeof(Smem<HD>), stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(s_final), S, H);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, void* o,
                         void* s_final, int B, int S, int H, int hd,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(logw))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(r, k, v, logw, u, o, s_final, B, S, H, s);
    case 32: return launch<32>(r, k, v, logw, u, o, s_final, B, S, H, s);
    case 64: return launch<64>(r, k, v, logw, u, o, s_final, B, S, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
