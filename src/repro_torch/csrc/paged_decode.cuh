// Paged flash-decode attention for Hopper (sm_90a): the kernel body shared
// by the bf16 pool (paged_decode.cu) and the int8 pool (paged_decode_quant.cu).
//
// One-query GQA attention per row over a global K/V block pool
// [NB, Hkv, bs, hd] read through per-row block tables [B, MB]; lengths[b]
// is the last valid logical position (-1: zero row). Output f32 [B, Hq, hd].
//
// Bound: device memory. Each valid K/V row is read once and feeds about one
// floating-point operation per byte, far below the card's ~20 flops/byte
// balance point for f32 CUDA-core math, so the design spends its effort on
// loads: one thread block per (row, KV head), so the g = Hq/Hkv query heads
// of a GQA group share every K/V load; each thread reads one 16-byte slice
// of a token's K and V row (Rows::kVec values: 8 bf16, or 16 int8 plus the
// token's f32 scale), and hd/kVec neighbouring threads cover one token, so
// a warp reads 32/(hd/kVec) whole rows as coalesced 16-byte loads. A block
// walks the table itself (the TPU grid's sequential MB axis and its
// scalar-prefetched table become a loop over ceil((len+1)/bs) entries), and
// stops at the row's length: blocks past it are never read.
//
// Online softmax in f32 registers: every group of hd/kVec threads keeps its
// own running (max, sum, accumulator) over the tokens it visits; the groups
// are merged through shared memory at the end. The loader is the only part
// that differs between the two pools, so both share one softmax and one
// merge.
//
// A GQA group of 16 (recurrentgemma's 16 query heads over one KV head, hd
// 256) takes the split form below instead: one block of 16 heads would
// hold 2 x 16 x kVec = 256 f32 values of q and accumulator a thread, past
// the 255-register limit, and at hd 256 a warp reads one token per step,
// so a block would walk a 2048-token ring in 512 dependent steps.
//
// Split form (paged_decode_split_kernel + paged_decode_merge_kernel, the
// flash-decode partials of the TPU's kernel #5): the sequence is cut into
// chunks of `chunk` tokens, one block per (chunk, KV head, row) holding all
// G query heads. A block stages q and its chunk's K/V rows in shared
// memory (each row read once, many loads in flight), scores every (head,
// token) pair, takes the chunk's softmax per head and writes the
// unnormalised partial (o, m, l) to a workspace; a second kernel merges a
// row's chunks.
// Blocks past a row's length exit at once, so the work follows the data.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace paged_decode {

constexpr int kThreads = 128;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// K/V rows of a bf16 pool: 8 values per 16-byte load.
struct Bf16Rows {
  static constexpr int kVec = 8;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  // tok: (block * Hkv + head) * bs + slot, the token's row index in the
  // pool; el: the element offset of this thread's slice
  __device__ __forceinline__ void load(int64_t tok, int64_t el, float* kf,
                                       float* vf) const {
    load8(k + el, kf);
    load8(v + el, vf);
  }
};

// K/V rows of an int8 pool with one f32 scale per (block, head, token):
// 16 values per 16-byte load, dequantized in registers as
// float(int8) * scale, as the TPU kernel does after its DMA lands.
struct Int8Rows {
  static constexpr int kVec = 16;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  __device__ __forceinline__ void load(int64_t tok, int64_t el, float* kf,
                                       float* vf) const {
    const uint4 kr = *reinterpret_cast<const uint4*>(k + el);
    const uint4 vr = *reinterpret_cast<const uint4*>(v + el);
    const float ks = k_scale[tok];
    const float vs = v_scale[tok];
    const int8_t* kb = reinterpret_cast<const int8_t*>(&kr);
    const int8_t* vb = reinterpret_cast<const int8_t*>(&vr);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      kf[i] = static_cast<float>(kb[i]) * ks;
      vf[i] = static_cast<float>(vb[i]) * vs;
    }
  }
};

template <class Rows, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    Rows rows, const __nv_bfloat16* __restrict__ q,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    float* __restrict__ out, int Hq, int Hkv, int hd, int bs, int MB,
    float scale) {
  constexpr int kVec = Rows::kVec;
  extern __shared__ float smem[];
  const int h = blockIdx.x;  // KV head
  const int hq0 = h * G;
  const int b = blockIdx.y;  // row
  const int tpt = hd / kVec;  // threads per token: a power of two <= 32
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = 32 / tpt;  // tokens a warp reads per step
  const int n_groups = per_warp * (kThreads / 32);
  const int sub = lane / tpt;
  const int c = lane % tpt;  // this thread's kVec-wide slice of hd
  const int grp = warp * per_warp + sub;
  const int len = lengths[b];
  float* o = out + ((int64_t)b * Hq + hq0) * hd;
  if (len < 0) {
    for (int i = threadIdx.x; i < G * hd; i += kThreads) o[i] = 0.f;
    return;
  }

  float qf[G][kVec];
  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const __nv_bfloat16* qi =
        q + ((int64_t)b * Hq + hq0 + i) * hd + c * kVec;
#pragma unroll
    for (int d = 0; d < kVec; d += 8) load8(qi + d, qf[i] + d);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kVec; ++d) acc[i][d] = 0.f;
  }

  const int n_tok = len + 1;
  const int* tbl = tables + (int64_t)b * MB;
  // j0 depends only on the warp, so every lane of a warp runs the same
  // trips and the shuffles below always see all 32 lanes
  for (int j0 = warp * per_warp; j0 < n_tok; j0 += n_groups) {
    const int j = j0 + sub;
    const bool valid = j < n_tok;
    float kf[kVec], vf[kVec];
    if (valid) {
      const int64_t tok = ((int64_t)tbl[j / bs] * Hkv + h) * bs + j % bs;
      rows.load(tok, tok * hd + c * kVec, kf, vf);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float s = 0.f;
      if (valid) {
#pragma unroll
        for (int d = 0; d < kVec; ++d) s = fmaf(qf[i][d], kf[d], s);
      }
      for (int off = tpt / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (valid) {
        s *= scale;
        const float mn = fmaxf(m[i], s);
        const float corr = expf(m[i] - mn);
        const float p = expf(s - mn);
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int d = 0; d < kVec; ++d) acc[i][d] = fmaf(p, vf[d], acc[i][d] * corr);
        m[i] = mn;
      }
    }
  }

  // merge the groups' partial softmax states
  float* sm_acc = smem;                       // [n_groups][G][hd]
  float* sm_m = smem + n_groups * G * hd;     // [n_groups][G]
  float* sm_l = sm_m + n_groups * G;          // [n_groups][G]
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int d = 0; d < kVec; ++d)
      sm_acc[(grp * G + i) * hd + c * kVec + d] = acc[i][d];
    if (c == 0) {
      sm_m[grp * G + i] = m[i];
      sm_l[grp * G + i] = l[i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int i = idx / hd;
    const int d = idx % hd;
    float mx = -INFINITY;
    for (int gi = 0; gi < n_groups; ++gi) mx = fmaxf(mx, sm_m[gi * G + i]);
    float sum = 0.f, a = 0.f;
    for (int gi = 0; gi < n_groups; ++gi) {
      const float w = expf(sm_m[gi * G + i] - mx);  // idle group: exp(-inf) = 0
      sum = fmaf(sm_l[gi * G + i], w, sum);
      a = fmaf(sm_acc[(gi * G + i) * hd + d], w, a);
    }
    o[idx] = a / fmaxf(sum, 1e-30f);
  }
}

template <class Rows, int G>
int launch(const Rows& rows, const void* q, const void* tables,
           const void* lengths, void* out, int B, int Hq, int Hkv, int hd,
           int bs, int MB, cudaStream_t stream) {
  const int n_groups = (32 / (hd / Rows::kVec)) * (kThreads / 32);
  const size_t smem = (size_t)n_groups * G * (hd + 2) * sizeof(float);
  if (smem > 48 * 1024) {
    // the merge buffer outgrows the default limit only for narrow heads
    // with wide groups (many token groups, each G x hd floats)
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<Rows, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = (float)(1.0 / sqrt((double)hd));
  paged_decode_kernel<Rows, G><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      rows, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(out), Hq, Hkv, hd, bs, MB, scale);
  return (int)cudaGetLastError();
}

constexpr int kSplitThreads = 256;

template <class Rows, int G>
__global__ void __launch_bounds__(kSplitThreads) paged_decode_split_kernel(
    Rows rows, const __nv_bfloat16* __restrict__ q,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    float* __restrict__ part_o, float* __restrict__ part_ml, int Hq, int Hkv,
    int hd, int bs, int MB, int n_split, int chunk, float scale) {
  constexpr int kVec = Rows::kVec;
  constexpr int kLoads = 4;  // K/V slices a thread has in flight
  extern __shared__ float smem[];
  const int sp = blockIdx.x;  // chunk
  const int h = blockIdx.y;   // KV head
  const int b = blockIdx.z;   // row
  const int len = lengths[b];
  const int j0 = sp * chunk;
  if (len < 0 || j0 > len) return;  // the merge reads only used chunks
  const int n = min(chunk, len + 1 - j0);  // tokens of this chunk
  const int hq0 = h * G;
  const int kst = hd + 1;  // K row stride: lanes on rows t..t+31 of one
                           // column hit 32 different banks
  float* qs = smem;               // [G][hd]
  float* ks = qs + G * hd;        // [chunk][hd + 1]
  float* vs = ks + chunk * kst;   // [chunk][hd]
  float* ps = vs + chunk * hd;    // [G][chunk]: scores, then probabilities
  const __nv_bfloat16* qb = q + ((int64_t)b * Hq + hq0) * hd;
  for (int i = threadIdx.x; i < G * hd; i += kSplitThreads)
    qs[i] = __bfloat162float(qb[i]);

  // stage the chunk's K and V rows, 16-byte slices (hd/kVec a row), each
  // thread issuing kLoads loads before it stores any
  const int tpt = hd / kVec;
  const int n_slices = n * tpt;
  const int* tbl = tables + (int64_t)b * MB;
  for (int base = threadIdx.x; base < n_slices;
       base += kSplitThreads * kLoads) {
    float kf[kLoads][kVec], vf[kLoads][kVec];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kSplitThreads;
      if (idx < n_slices) {
        const int j = j0 + idx / tpt;
        const int64_t tok = ((int64_t)tbl[j / bs] * Hkv + h) * bs + j % bs;
        rows.load(tok, tok * hd + (idx % tpt) * kVec, kf[u], vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kSplitThreads;
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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_tg = (n + 31) / 32;
  for (int task = warp; task < G * n_tg; task += kSplitThreads / 32) {
    const int i = task / n_tg;
    const int t = (task % n_tg) * 32 + lane;
    if (t < n) {
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
      ps[i * chunk + t] = ((s0 + s1) + (s2 + s3)) * scale;
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp per head: m, l and exp(s - m) in place
  float* ml = part_ml + (((int64_t)b * Hq + hq0) * n_split + sp) * 2;
  for (int i = warp; i < G; i += kSplitThreads / 32) {
    float* pi = ps + i * chunk;
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pi[t]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(pi[t] - mx);
      pi[t] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml[(int64_t)i * n_split * 2] = mx;
      ml[(int64_t)i * n_split * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // P.V: a thread per output column, all G heads in registers
  float* po = part_o + (((int64_t)b * Hq + hq0) * n_split + sp) * hd;
  for (int d = threadIdx.x; d < hd; d += kSplitThreads) {
    float acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i] = 0.f;
    for (int t = 0; t < n; ++t) {
      const float v = vs[t * hd + d];
#pragma unroll
      for (int i = 0; i < G; ++i) acc[i] = fmaf(ps[i * chunk + t], v, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) po[(int64_t)i * n_split * hd + d] = acc[i];
  }
}

// Merges a row's chunks per query head: the chunks' (o, l) rescaled to the
// largest m. A block per (query head, row). Static: each .cu file that
// includes this header keeps its own copy.
static __global__ void __launch_bounds__(kSplitThreads) paged_decode_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, float* __restrict__ out, int Hq, int hd,
    int n_split, int chunk) {
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  float* o = out + ((int64_t)b * Hq + hq) * hd;
  if (len < 0) {
    for (int d = threadIdx.x; d < hd; d += kSplitThreads) o[d] = 0.f;
    return;
  }
  const int used = min(len / chunk + 1, n_split);
  const float* ml = part_ml + ((int64_t)b * Hq + hq) * n_split * 2;
  const float* po = part_o + ((int64_t)b * Hq + hq) * n_split * hd;
  // unrolled so that eight chunks' loads are in flight at once
  float mx = -INFINITY;
#pragma unroll 8
  for (int sp = 0; sp < used; ++sp) mx = fmaxf(mx, ml[2 * sp]);
  float sum = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < used; ++sp)
    sum = fmaf(ml[2 * sp + 1], expf(ml[2 * sp] - mx), sum);
  for (int d = threadIdx.x; d < hd; d += kSplitThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < used; ++sp)
      a = fmaf(po[(int64_t)sp * hd + d], expf(ml[2 * sp] - mx), a);
    o[d] = a / fmaxf(sum, 1e-30f);
  }
}

// work: B * Hq * ceil(MB * bs / chunk) * (hd + 2) floats, the partial
// outputs then the partial (m, l) pairs.
template <class Rows, int G>
int launch_split(const Rows& rows, const void* q, const void* tables,
                 const void* lengths, void* out, void* work, int B, int Hq,
                 int Hkv, int hd, int bs, int MB, int chunk,
                 cudaStream_t stream) {
  const int n_split = (int)(((int64_t)MB * bs + chunk - 1) / chunk);
  float* part_o = static_cast<float*>(work);
  float* part_ml = part_o + (int64_t)B * Hq * n_split * hd;
  const size_t smem =
      (size_t)(G * hd + chunk * (2 * hd + 1) + G * chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    // the opt-in holds per device and per kernel: made by the first call
    // that needs it (outside any CUDA graph capture), then reused
    constexpr int kMaxDevices = 64;
    static std::atomic<int> opted[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (opted[dev].load(std::memory_order_acquire) < (int)smem) {
      e = cudaFuncSetAttribute(paged_decode_split_kernel<Rows, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted[dev].store((int)smem, std::memory_order_release);
    }
  }
  const float scale = (float)(1.0 / sqrt((double)hd));
  paged_decode_split_kernel<Rows, G>
      <<<dim3(n_split, Hkv, B), kSplitThreads, smem, stream>>>(
          rows, static_cast<const __nv_bfloat16*>(q),
          static_cast<const int*>(tables), static_cast<const int*>(lengths),
          part_o, part_ml, Hq, Hkv, hd, bs, MB, n_split, chunk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_decode_merge_kernel<<<dim3(Hq, B), kSplitThreads, 0, stream>>>(
      part_o, part_ml, static_cast<const int*>(lengths),
      static_cast<float*>(out), Hq, hd, n_split, chunk);
  return (int)cudaGetLastError();
}

// Validates the shapes and dispatches on the GQA group size: chunk == 0
// takes a block per (row, KV head), chunk > 0 the split form (a group of
// 16) with its workspace.
template <class Rows>
int dispatch(const Rows& rows, const void* q, const void* tables,
             const void* lengths, void* out, int B, int Hq, int Hkv, int hd,
             int bs, int MB, int chunk, void* work, void* stream) {
  const int tpt = hd / Rows::kVec;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd % Rows::kVec != 0 ||
      tpt > 32 || (tpt & (tpt - 1)) != 0 || bs <= 0 || MB <= 0 || B > 65535 ||
      Hkv > 65535 || chunk < 0 || (chunk > 0 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk > 0) {
    if (Hq / Hkv != 16) return (int)cudaErrorInvalidValue;
    return launch_split<Rows, 16>(rows, q, tables, lengths, out, work, B, Hq,
                                  Hkv, hd, bs, MB, chunk, s);
  }
  switch (Hq / Hkv) {
    case 1: return launch<Rows, 1>(rows, q, tables, lengths, out, B, Hq, Hkv, hd, bs, MB, s);
    case 2: return launch<Rows, 2>(rows, q, tables, lengths, out, B, Hq, Hkv, hd, bs, MB, s);
    case 3: return launch<Rows, 3>(rows, q, tables, lengths, out, B, Hq, Hkv, hd, bs, MB, s);
    case 4: return launch<Rows, 4>(rows, q, tables, lengths, out, B, Hq, Hkv, hd, bs, MB, s);
    case 6: return launch<Rows, 6>(rows, q, tables, lengths, out, B, Hq, Hkv, hd, bs, MB, s);
    case 8: return launch<Rows, 8>(rows, q, tables, lengths, out, B, Hq, Hkv, hd, bs, MB, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace paged_decode
