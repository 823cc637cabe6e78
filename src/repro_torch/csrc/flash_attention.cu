// Flash attention over a whole sequence (causal, sliding-window or
// bidirectional; GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// flash_attention_kernel (body _fa_kernel) and computes what that body
// computes: scores q.k^T in f32, times 1/sqrt(hd) after the dot; masked
// scores at -1e30; an online softmax in f32 with the sum floored at 1e-30;
// the probabilities kept in f32 through P.V; the output in q's dtype
// (bf16). Key tiles that the causal or window mask covers wholly are
// skipped, not computed.
//
// Layout: q [B, Sq, Hq, hd], k/v [B, Sk, Hkv, hd] (the model's layout, so
// no transpose before the call), out [B, Sq, Hq * hd]; query head h reads
// KV head h / (Hq / Hkv). Unlike the TPU kernel, which asserts Sq % 128 ==
// 0, any Sq and Sk are taken: the last tile's missing rows are staged as
// zeros, their keys masked and their queries never stored.
//
// Bound: operations. A causal prefill does 4 * hd flops per unmasked
// (query, key) pair and head against 2 * hd bytes per token and head of
// q, k, v and out, so from a few hundred tokens on the work, not the
// bytes, bounds it. This first version is simple and right rather than
// fast: one thread block of 128 threads per (query tile, query head,
// batch row) stages its query tile once and then walks its key tiles of
// 64, each staged in shared memory as f32; both products run on CUDA
// cores in f32 (each thread owns a BQ/8 x 4 block of scores and a
// BQ/8 x hd/16 block of the output), so P stays f32 as the reference keeps
// it. The query tile is 64 rows up to hd 128 and 32 rows at hd 256
// (recurrentgemma's heads): there a 64-row tile would hold 8 x 16 output
// accumulators a thread and need 215,552 bytes of shared memory, while 32
// rows hold 4 x 16 in 173,824 bytes. The
// tensor cores (mma/wgmma), TMA and a GQA group sharing its K/V loads are
// work for a later speed change, with their error measured then.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;                  // keys per tile
constexpr int kCols = kBK / 16;          // score columns per thread: 4
constexpr int kPStride = kBK + 2;        // P row stride: 8 rows apart = 16 banks
constexpr float kMaskValue = -1e30f;     // the TPU kernel's NEG_INF
constexpr int kMaxDevices = 64;

// Shared-memory layout in floats: Q and K tiles with rows padded by 4 (a
// quarter warp's 16-byte loads from 8 rows hit 8 distinct bank groups),
// the V tile, and the probabilities P [BQ][kPStride]. BQ: queries per
// block.
template <int HD>
struct Layout {
  static constexpr int kBQ = HD > 128 ? 32 : 64;
  static constexpr int kRows = kBQ / (kThreads / 16);  // query rows per thread
  static constexpr int kQK = HD + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQK;
  static constexpr int kV = kK + kBK * kQK;
  static constexpr int kP = kV + kBK * HD;
  static constexpr size_t kBytes = (size_t)(kP + kBQ * kPStride) * sizeof(float);
};

// Stage rows [0, kTile) of a tile as f32: row r starts at src + r * stride
// (HD bf16 values, read as 16-byte loads); rows at or past n_valid are zeros.
template <int HD, int kTile>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src,
                                      int64_t stride, int n_valid, float* dst,
                                      int dst_stride) {
  constexpr int kVecs = HD / 8;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 hi = lo;
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]);
      const float2 b = __bfloat1622float2(h[1]);
      const float2 e = __bfloat1622float2(h[2]);
      const float2 f = __bfloat1622float2(h[3]);
      lo = make_float4(a.x, a.y, b.x, b.y);
      hi = make_float4(e.x, e.y, f.x, f.y);
    }
    float4* o = reinterpret_cast<float4*>(dst + r * dst_stride + c);
    o[0] = lo;
    o[1] = hi;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int Sq, int Sk, int Hq, int Hkv, int causal, int window, float scale) {
  using Lay = Layout<HD>;
  constexpr int kBQ = Lay::kBQ;
  constexpr int kRows = Lay::kRows;
  constexpr int kD = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + Lay::kQ;
  float* Ks = smem + Lay::kK;
  float* Vs = smem + Lay::kV;
  float* Ps = smem + Lay::kP;

  // causal work grows with the query tile: the last tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15;  // score columns tx + 16c, output columns tx + 16d
  const int ty = threadIdx.x >> 4;  // query rows ty * kRows + i
  const int nq = min(kBQ, Sq - q0);
  const int q_last = q0 + nq - 1;
  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;

  stage<HD, kBQ>(q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD,
                 q_stride, nq, Qs, Lay::kQK);

  // the key tiles some query of this tile may see (the TPU kernel's
  // pl.when(needed) skip, as a loop range)
  int kt_begin = 0;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][kD];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[i][d] = 0.f;
  }

  const __nv_bfloat16* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * HD;
  const __nv_bfloat16* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * HD;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, Sk - k0);
    __syncthreads();  // the last tile's readers are done (and Qs is staged)
    stage<HD, kBK>(kb + (int64_t)k0 * kv_stride, kv_stride, nk, Ks, Lay::kQK);
    stage<HD, kBK>(vb + (int64_t)k0 * kv_stride, kv_stride, nk, Vs, HD);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kk[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kk[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * Lay::kQK + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (ty * kRows + i) * Lay::kQK + d);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[i][c] = fmaf(qq.x, kk[c].x, s[i][c]);
          s[i][c] = fmaf(qq.y, kk[c].y, s[i][c]);
          s[i][c] = fmaf(qq.z, kk[c].z, s[i][c]);
          s[i][c] = fmaf(qq.w, kk[c].w, s[i][c]);
        }
      }
    }

    // online softmax over this tile, row by row; the 16 threads of a row
    // group (one half warp) reduce its max and sum by shuffles
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float mx = kMaskValue;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kj = k0 + tx + 16 * c;
        bool ok = kj < Sk;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && qi - kj < window;
        s[i][c] = ok ? s[i][c] * scale : kMaskValue;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[i][c] - m_new);
        Ps[(ty * kRows + i) * kPStride + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[i][d] *= corr;
    }
    __syncthreads();

    // P.V, P in f32
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) vv[d] = Vs[j * HD + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = Ps[(ty * kRows + i) * kPStride + j];
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + ((int64_t)b * Sq + qi) * q_stride + (int64_t)h * HD;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[tx + 16 * d] = __float2bfloat16(acc[i][d] / den);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::kBytes;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    // the opt-in to more than 48 KiB holds per device and per kernel; it
    // is made once, on the first call (outside any CUDA graph capture)
    static std::atomic<bool> opted_in[kMaxDevices];
    if (!opted_in[dev].load(std::memory_order_acquire)) {
      e = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted_in[dev].store(true, std::memory_order_release);
    }
  }
  const float scale = (float)(1.0 / sqrt((double)HD));
  const dim3 grid((Sq + Layout<HD>::kBQ - 1) / Layout<HD>::kBQ, Hq, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int Hq, int Hkv, int hd,
                                    int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      window < 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, s);
    case 32: return launch<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, s);
    case 64: return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, s);
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, s);
    case 256: return launch<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
