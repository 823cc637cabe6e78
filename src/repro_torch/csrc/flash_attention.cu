// Flash attention over a whole sequence (causal, sliding-window or
// bidirectional; GQA) for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// flash_attention_kernel (body _fa_kernel) and computes what that body
// computes: scores q.k^T with f32 accumulation, times 1/sqrt(hd) after the
// dot; masked scores at -1e30; an online softmax in f32 with the sum
// floored at 1e-30; the probabilities kept to 16 bits through P.V (the
// hi/lo split of attention_mma.cuh); the output in q's dtype (bf16). Key
// tiles that the causal or window mask covers wholly are skipped, not
// computed.
//
// Layout: q [B, Sq, Hq, hd], k/v [B, Sk, Hkv, hd] (the model's layout, so
// no transpose before the call), out [B, Sq, Hq * hd]; query head h reads
// KV head h / (Hq / Hkv). Unlike the TPU kernel, which asserts Sq % 128 ==
// 0, any Sq and Sk are taken: the last tile's missing rows are staged as
// zeros, their keys masked and their queries never stored.
//
// Bound: operations for a long prompt (4 * hd flops per unmasked (query,
// key) pair and head against 2 * hd bytes per token and head of q, k, v
// and out: from a few hundred tokens on the work, not the bytes, bounds
// it), bytes and latency for a short one. The design is FlashAttention-2's
// on mma.sync: one block of 4 warps per (64-row query tile, query head,
// batch row); each warp owns 16 query rows. The query tile is staged once;
// K and V tiles are staged as bf16 (not f32) in a ring of two stages
// filled by cp.async, so the next tile's copy overlaps this tile's
// products. A warp's scores stay in registers (m16n8k16 accumulators),
// its softmax reduces over the quad of lanes that share a row, and the
// probabilities re-pack in registers into the A fragments of P.V, as hi
// and lo bf16 halves against V's ldmatrix.trans fragments. No shared
// memory and no barrier is spent on P. Masks are applied only on tiles
// that cross the diagonal, the window edge or Sk; a warp skips a tile
// that its 16 rows cannot see. Blocks run longest query tile first across
// all heads and rows, so the short causal tiles fill the SMs that finish
// early.
//
// Tiles: 64 query rows; 64 keys up to hd 128, 32 keys at hd 256, whose
// 16 x 256 f32 output fragment takes 128 registers a lane. A warp reloads
// its Q fragments from shared memory at each k-step (one ldmatrix per 16
// columns): held in registers for the walk, they ran slower at hd 32 and
// 64 and do not fit at hd 256. Shared memory: 46 KB at hd 64, 87 KB at hd
// 128, 101 KB at hd 256.
//
// A row's arithmetic depends only on its (query tile, head, batch row):
// there is no split over keys and no atomics, so a row computed in a
// batch of 16 equals, bit for bit, the same row computed alone.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_mma.cuh"

namespace {

using namespace attention_mma;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // K/V tiles in flight
constexpr int kMaxDevices = 64;

// Tile shapes and shared memory (in bf16 values: the query tile, then
// kStages stages of (K tile, V tile), every row padded by kPad).
template <int HD>
struct Layout {
  static constexpr int kBQ = 16 * kWarps;         // query rows a block
  static constexpr int kBK = HD > 128 ? 32 : 64;  // keys a tile
  static constexpr int kStride = HD + kPad;
  static constexpr int kStage = 2 * kBK * kStride;
  static constexpr int kKV = kBQ * kStride;  // stage s's K at kKV + s * kStage
  static constexpr size_t kBytes =
      (size_t)(kKV + kStages * kStage) * sizeof(__nv_bfloat16);
};

// Stage rows [0, ROWS) of a tile: row r from src + r * stride (HD bf16
// values), rows at or past n_valid as zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* src,
                                           int64_t stride, int n_valid,
                                           __nv_bfloat16* dst) {
  constexpr int kVecs = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * (HD + kPad) + c, ok ? src + r * stride + c : src, ok);
  }
}

// One block per (query tile, query head, batch row), on a 1-D grid in
// which every block of the i-th longest query tiles precedes those of the
// (i+1)-th: causal work grows with the tile, so the longest start first
// and the short ones fill the SMs that finish early.
// (The minimum of one block an SM in __launch_bounds__ lifts ptxas's own
// register target, under which the hd-128 instantiation spilled.)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int B, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
    float scale) {
  using Lay = Layout<HD>;
  constexpr int kBQ = Lay::kBQ;
  constexpr int kBK = Lay::kBK;
  constexpr int kStride = Lay::kStride;
  constexpr int kNT = kBK / 8;  // 8-key score tiles
  constexpr int kD = HD / 8;    // 8-column output tiles
  extern __shared__ uint4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const __nv_bfloat16* Qs = smem;

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int rank = blockIdx.x / (Hq * B);  // 0: the last query tiles
  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq % B;
  const int q0 = (n_qt - 1 - rank) * kBQ;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nq = min(kBQ, Sq - q0);
  const int q_last = q0 + nq - 1;
  const int row_lo = q0 + 16 * warp;  // this warp's rows: row_lo + g (+8)
  const int row_hi = row_lo + 15;
  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const __nv_bfloat16* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * HD;
  const __nv_bfloat16* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * HD;

  // the key tiles some query of this tile may see (the TPU kernel's
  // pl.when(needed) skip, as a loop range)
  int kt_begin = 0;
  int kt_end = (Sk + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBK;

  auto stage_kv = [&](int kt, int s) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, Sk - k0);
    __nv_bfloat16* ks = smem + Lay::kKV + s * Lay::kStage;
    stage_rows<HD, kBK>(kb + (int64_t)k0 * kv_stride, kv_stride, nk, ks);
    stage_rows<HD, kBK>(vb + (int64_t)k0 * kv_stride, kv_stride, nk,
                        ks + kBK * kStride);
  };

  stage_rows<HD, kBQ>(q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD,
                      q_stride, nq, smem);
  if (kt_begin < kt_end) stage_kv(kt_begin, 0);
  cp_async_commit();  // the query tile and the first K/V tile

  float o[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

  int s = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt, s ^= 1) {
    if (kt + 1 < kt_end) stage_kv(kt + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile kt have landed
    __syncthreads();     // ... and every thread's
    const int k0 = kt * kBK;
    // a tile none of this warp's rows can see: skipping it leaves m, l
    // and o as its zero probabilities would
    const bool skip = (causal && k0 > row_hi) ||
                      (window > 0 && row_lo - (k0 + kBK - 1) >= window);
    if (!skip) {
      const __nv_bfloat16* Ks = smem + Lay::kKV + s * Lay::kStage;
      const __nv_bfloat16* Vs = Ks + kBK * kStride;
      float sc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, a_rows(Qs, kStride, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int p = 0; p < kBK / 16; ++p) {
          uint32_t kf[4];
          ldmatrix_x4(kf, k_rows(Ks, kStride, 16 * p, 16 * kk, lane));
          mma_bf16(sc[2 * p], a, kf[0], kf[1]);
          mma_bf16(sc[2 * p + 1], a, kf[2], kf[3]);
        }
      }
      // scale; mask only where the tile crosses Sk, the diagonal or the
      // window edge for some row of this warp
      const bool masked = k0 + kBK > Sk || (causal && k0 + kBK - 1 > row_lo) ||
                          (window > 0 && row_hi - k0 >= window);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale;
          if (masked) {
            const int qi = row_lo + g + 8 * (e >> 1);
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            bool ok = kj < Sk;
            if (causal) ok = ok && qi >= kj;
            if (window > 0) ok = ok && qi - kj < window;
            x = ok ? x : kMaskValue;
          }
          sc[j][e] = x;
        }
      float corr[2];
      online_softmax<kNT>(sc, m, l, corr);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }
      // P.V: P from the score registers as hi + lo
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        pack_pv_operands(sc[2 * kk], sc[2 * kk + 1], hi, lo);
#pragma unroll
        for (int p = 0; p < HD / 16; ++p) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_rows(Vs, kStride, 16 * kk, 16 * p, lane));
          mma_bf16(o[2 * p], hi, vf[0], vf[1]);
          mma_bf16(o[2 * p], lo, vf[0], vf[1]);
          mma_bf16(o[2 * p + 1], hi, vf[2], vf[3]);
          mma_bf16(o[2 * p + 1], lo, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage s before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_lo + g + 8 * r;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qi >= Sq) continue;
    __nv_bfloat16* orow =
        out + ((int64_t)b * Sq + qi) * q_stride + (int64_t)h * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(o[d][2 * r] / den, o[d][2 * r + 1] / den);
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
  const int64_t blocks =
      (int64_t)((Sq + Layout<HD>::kBQ - 1) / Layout<HD>::kBQ) * Hq * B;
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<HD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      B, Sq, Sk, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a block of the hd instantiation takes (bytes; -1
// for an hd without one).
extern "C" int flash_attention_smem_bytes(int hd) {
  switch (hd) {
    case 16: return (int)Layout<16>::kBytes;
    case 32: return (int)Layout<32>::kBytes;
    case 64: return (int)Layout<64>::kBytes;
    case 128: return (int)Layout<128>::kBytes;
    case 256: return (int)Layout<256>::kBytes;
    default: return -1;
  }
}

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
