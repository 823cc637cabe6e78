// Flash-decoding over a contiguous KV cache for Hopper (sm_90a): the
// partial (o, m, l) of one-query GQA attention over k, v [B,Hkv,S,hd],
// f32 or bf16, keys at positions <= cur_len (one scalar for the batch,
// read from device memory so a CUDA graph can capture the call).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py
// flash_decode_kernel (body _fd_kernel), whose partials the
// sequence-sharded op merges across ranks (kernels/flash_decode/ops.py).
// Conventions as there: o normalised with l floored at 1e-30; m the
// largest score, l the sum of exp(score - m); a slice with no valid key
// (cur_len == -1) gives m = -1e30, l = 0, o = 0. Any S (the TPU kernel
// asserts S % block_k == 0).
//
// Bound: device memory. Each valid K/V row is read once and feeds about
// one multiply-add per element per query head of its GQA group, far below
// the card's balance point. The TPU grid (B, Hq, n_kv_blocks) walks the
// sequence in order per query head; here the sequence is split instead,
// as kernel #1's split form does (paged_decode.cuh): one block of 256
// threads per (split, KV head, row), holding all g = Hq/Hkv query heads,
// so each K/V row is read once for its whole group and B * Hkv * n_split
// blocks fill the card (B * Hkv alone is 32 at paper-demo's B=8). The
// valid tokens n = cur_len + 1 are cut into n_split spans of whole tiles
// on the device, so the work follows cur_len and blocks past it exit at
// once. A block walks its span a tile at a time: it stages the tile's K
// and V rows in shared memory as f32 (16-byte loads, 16 values of each
// in flight per thread), scores every (head, token) pair, and carries an
// online softmax across tiles (running m and l per head, the P.V
// accumulator in shared memory), all in f32 with f32 probabilities. It writes its span's
// unnormalised partial to a workspace; a second kernel merges a row's
// spans into (o, m, l).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadsPerPass = 4;   // P.V: query heads a thread accumulates
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

// 16 bytes of a K/V row as f32: 8 bf16 or 4 f32 values
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Tokens a split holds: the n valid tokens cut into n_split spans of
// whole tiles (the split kernel and the merge agree on it).
__device__ __forceinline__ int span_of(int n, int n_split, int tile) {
  const int per = (n + n_split - 1) / n_split;
  return (per + tile - 1) / tile * tile;
}

__device__ __forceinline__ int valid_tokens(const int* cur_len, int S) {
  return min(cur_len[0], S - 1) + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ cur_len,
    float* __restrict__ part_o, float* __restrict__ part_ml, int Hq,
    int Hkv, int S, int hd, int tile, int n_split, float scale) {
  constexpr int kVec = Vec<T>::kN;
  // 16-byte K/V slices a thread has in flight: 16 values of K and of V
  // either way (four f32 slices, two bf16 ones), which keeps the bf16
  // instantiation near the f32 one's 64 registers, four blocks an SM
  constexpr int kLoads = 16 / kVec;
  extern __shared__ float smem[];
  const int sp = blockIdx.x;  // split
  const int h = blockIdx.y;   // KV head
  const int b = blockIdx.z;   // row
  const int n = valid_tokens(cur_len, S);
  if (n <= 0) return;
  const int span = span_of(n, n_split, tile);
  const int j_begin = sp * span;
  if (j_begin >= n) return;  // the merge reads only used splits
  const int j_end = min(j_begin + span, n);
  const int G = Hq / Hkv;
  const int hq0 = h * G;
  const int kst = hd + 1;  // K row stride: lanes on rows t..t+31 of one
                           // column hit 32 different banks
  float* qs = smem;              // [G][hd]
  float* acc = qs + G * hd;      // [G][hd]: running P.V
  float* ks = acc + G * hd;      // [tile][hd + 1]
  float* vs = ks + tile * kst;   // [tile][hd]
  float* ps = vs + tile * hd;    // [G][tile]: scores, then probabilities
  float* run_m = ps + G * tile;  // [G]
  float* run_l = run_m + G;      // [G]
  float* corr = run_l + G;       // [G]: this tile's rescale of acc
  const T* qb = q + ((int64_t)b * Hq + hq0) * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    qs[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < G; i += kThreads) {
    run_m[i] = kNegInf;
    run_l[i] = 0.f;
  }
  const int64_t row0 = ((int64_t)b * Hkv + h) * S;  // position 0's row
  const int tpt = hd / kVec;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int t0 = j_begin; t0 < j_end; t0 += tile) {
    const int nt = min(tile, j_end - t0);
    __syncthreads();  // the last tile's P.V is done with vs and ps

    // stage the tile's K and V rows, each thread issuing kLoads 16-byte
    // loads before it stores any
    const int n_slices = nt * tpt;
    for (int base = threadIdx.x; base < n_slices;
         base += kThreads * kLoads) {
      float kf[kLoads][kVec], vf[kLoads][kVec];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * kThreads;
        if (idx < n_slices) {
          const int64_t el =
              (row0 + t0 + idx / tpt) * hd + (idx % tpt) * kVec;
          Vec<T>::load(k + el, kf[u]);
          Vec<T>::load(v + el, vf[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = base + u * kThreads;
        if (idx < n_slices) {
          const int t = idx / tpt;
          const int c = (idx % tpt) * kVec;
#pragma unroll
          for (int d = 0; d < kVec; ++d) {
            ks[t * kst + c + d] = kf[u][d];
            vs[t * hd + c + d] = vf[u][d];
          }
        }
      }
    }
    __syncthreads();

    // scores: a warp takes 32 tokens of one head, a lane one token's whole
    // dot product (q broadcast), in four chains
    const int n_tg = (nt + 31) / 32;
    for (int task = warp; task < G * n_tg; task += kWarps) {
      const int i = task / n_tg;
      const int t = (task % n_tg) * 32 + lane;
      if (t < nt) {
        const float* qi = qs + i * hd;
        const float* kt = ks + t * kst;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
        for (int d = 0; d < hd; d += 4) {
          s0 = fmaf(qi[d], kt[d], s0);
          s1 = fmaf(qi[d + 1], kt[d + 1], s1);
          s2 = fmaf(qi[d + 2], kt[d + 2], s2);
          s3 = fmaf(qi[d + 3], kt[d + 3], s3);
        }
        ps[i * tile + t] = ((s0 + s1) + (s2 + s3)) * scale;
      }
    }
    __syncthreads();

    // online softmax, one warp per head: the tile's max joins the running
    // one, exp(s - m) in place, acc's rescale for this tile
    for (int i = warp; i < G; i += kWarps) {
      float* pi = ps + i * tile;
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pi[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = run_m[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(pi[t] - m_new);
        pi[t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m_old - m_new);  // first tile: exp(-1e30) = 0
        corr[i] = c;
        run_l[i] = fmaf(run_l[i], c, sum);
        run_m[i] = m_new;
      }
    }
    __syncthreads();

    // P.V: a thread per (column, group of kHeadsPerPass heads), each V
    // value read once for the group
    const int n_hg = (G + kHeadsPerPass - 1) / kHeadsPerPass;
    for (int task = threadIdx.x; task < n_hg * hd; task += kThreads) {
      const int i0 = (task / hd) * kHeadsPerPass;
      const int d = task % hd;
      float a[kHeadsPerPass];
#pragma unroll
      for (int u = 0; u < kHeadsPerPass; ++u) a[u] = 0.f;
      for (int t = 0; t < nt; ++t) {
        const float vv = vs[t * hd + d];
#pragma unroll
        for (int u = 0; u < kHeadsPerPass; ++u)
          if (i0 + u < G) a[u] = fmaf(ps[(i0 + u) * tile + t], vv, a[u]);
      }
#pragma unroll
      for (int u = 0; u < kHeadsPerPass; ++u) {
        if (i0 + u < G) {
          float* ac = acc + (i0 + u) * hd + d;
          *ac = fmaf(*ac, corr[i0 + u], a[u]);
        }
      }
    }
  }
  __syncthreads();

  // the span's partial: unnormalised P.V, m, l
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int i = idx / hd;
    part_o[(((int64_t)b * Hq + hq0 + i) * n_split + sp) * hd + idx % hd] =
        acc[idx];
  }
  for (int i = threadIdx.x; i < G; i += kThreads) {
    float* ml = part_ml + (((int64_t)b * Hq + hq0 + i) * n_split + sp) * 2;
    ml[0] = run_m[i];
    ml[1] = run_l[i];
  }
}

// Merges a row's spans per query head into (o, m, l): the spans' (P.V, l)
// rescaled to the largest m. A block per (query head, row).
__global__ void __launch_bounds__(kThreads) flash_decode_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ cur_len, float* __restrict__ o,
    float* __restrict__ m, float* __restrict__ l, int Hq, int S, int hd,
    int tile, int n_split) {
  const int64_t r = (int64_t)blockIdx.y * Hq + blockIdx.x;
  float* orow = o + r * hd;
  const int n = valid_tokens(cur_len, S);
  if (n <= 0) {
    for (int d = threadIdx.x; d < hd; d += kThreads) orow[d] = 0.f;
    if (threadIdx.x == 0) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
    return;
  }
  const int span = span_of(n, n_split, tile);
  const int used = (n + span - 1) / span;
  const float* ml = part_ml + r * n_split * 2;
  const float* po = part_o + r * n_split * hd;
  // unrolled so that eight spans' loads are in flight at once
  float mx = kNegInf;
#pragma unroll 8
  for (int sp = 0; sp < used; ++sp) mx = fmaxf(mx, ml[2 * sp]);
  float sum = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < used; ++sp)
    sum = fmaf(ml[2 * sp + 1], expf(ml[2 * sp] - mx), sum);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < used; ++sp)
      a = fmaf(po[(int64_t)sp * hd + d], expf(ml[2 * sp] - mx), a);
    orow[d] = a / fmaxf(sum, 1e-30f);
  }
  if (threadIdx.x == 0) {
    m[r] = mx;
    l[r] = sum;
  }
}

// work: B * Hq * n_split * (hd + 2) floats, the spans' P.V then their
// (m, l) pairs.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cur_len,
           void* o, void* m, void* l, void* work, int B, int Hq, int Hkv,
           int S, int hd, int tile, int n_split, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      (size_t)(2 * G * hd + tile * (2 * hd + 1) + G * tile + 3 * G) *
      sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // the opt-in holds per device and per kernel: made by the first call
    // that needs it (outside any CUDA graph capture), then reused
    static std::atomic<int> opted[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (opted[dev].load(std::memory_order_acquire) < (int)smem) {
      e = cudaFuncSetAttribute(flash_decode_split_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      opted[dev].store(kMaxSmem, std::memory_order_release);
    }
  }
  float* part_o = static_cast<float*>(work);
  float* part_ml = part_o + (int64_t)B * Hq * n_split * hd;
  const int* len = static_cast<const int*>(cur_len);
  const float scale = (float)(1.0 / sqrt((double)hd));
  flash_decode_split_kernel<T><<<dim3(n_split, Hkv, B), kThreads, smem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len, part_o, part_ml, Hq, Hkv, S, hd, tile,
      n_split, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_merge_kernel<<<dim3(Hq, B), kThreads, 0, stream>>>(
      part_o, part_ml, len, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), Hq, S, hd, tile, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_partials(const void* q, const void* k,
                                     const void* v, const void* cur_len,
                                     void* o, void* m, void* l, void* work,
                                     int B, int Hq, int Hkv, int S, int hd,
                                     int tile, int n_split, int is_bf16,
                                     void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || hd <= 0 ||
      hd % 8 != 0 || hd > kThreads || tile <= 0 || n_split <= 0 ||
      B > 65535 || Hkv > 65535 || Hq > 65535 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, cur_len, o, m, l, work, B, Hq, Hkv,
                                 S, hd, tile, n_split, s);
  return launch<float>(q, k, v, cur_len, o, m, l, work, B, Hq, Hkv, S, hd,
                       tile, n_split, s);
}
