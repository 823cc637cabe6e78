// Flash-decoding over a contiguous KV cache for Hopper (sm_90a): the
// partial (o, m, l) of one-query GQA attention over k, v [B,Hkv,S,hd],
// f32 or bf16, keys at positions <= cur_len: one scalar for the batch, or
// (per_row) row b's own cur_len[b], read from device memory so a CUDA
// graph can capture the call. Given a row-to-slot map, row b reads cache
// row slots[b] of k, v [num_slots,Hkv,S,hd] in place (a slot pool's rows,
// several query rows on one slot at their own depths): no cache row is
// copied.
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
// sequence in order per query head; here the sequence is split instead:
// one block per (split, KV head, row), holding all g = Hq/Hkv query heads,
// so each K/V row is read once for its whole group and B * Hkv * n_split
// blocks fill the card (B * Hkv alone is 32 at paper-demo's B=8). The
// valid tokens n = cur_len + 1 (the row's own) are cut into n_split spans
// of whole tiles on the device, so the work follows each row's cur_len and
// blocks past it exit at once. Each block writes its span's unnormalised
// partial to a workspace; a second kernel merges a row's spans into (o, m,
// l).
//
// bf16 (the main dtype): both products on the tensor cores
// (attention_mma.cuh). The GQA group is the M dimension of mma.m16n8k16:
// query heads h*g .. h*g+g-1 fill the rows of a 16-row A fragment, padded
// with zero rows (g = 3 at paper-demo, 16 at recurrentgemma's local
// layer; a larger group takes its 16-row tiles one after another), staged
// once in shared memory and read by ldmatrix at each k-step. The
// block's 4 warps walk disjoint chunks of the span, each with its own
// online softmax (m, l and an f32 output fragment for its 16 rows) and
// its own cp.async ring of two stages of bf16 K/V rows, read with
// ldmatrix / ldmatrix.trans; a warp waits only on its own copies
// (__syncwarp), and the warps' partials merge once, at the end of the
// span, in shared memory: block barriers only around the walk (staging q,
// the merge), where the CUDA-core form took four a tile. Chunks of 32
// tokens up to hd 128 and 16 at hd 256 keep 9-17 KB of K/V in flight a
// warp, one to three blocks an SM, which covers device-memory latency
// (~40 KB an SM at 3.35 TB/s).
// Scores in f32 from bf16 operands, P.V by the hi/lo split of P; an hd
// that is not a multiple of 16 is zero-padded to the next k-step in
// shared memory.
//
// f32 keeps the CUDA-core form (tensor cores would change its f32
// products): a block of 256 threads stages a tile's K and V rows in
// shared memory (16-byte loads, 8 values of each in flight per thread),
// scores every (head, token) pair, and carries an online softmax across
// tiles (running m and l per head, the P.V accumulator in shared memory),
// all in f32.
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

constexpr int kThreads = 256;      // the f32 kernel and the merge
constexpr int kWarps = kThreads / 32;
constexpr int kHeadsPerPass = 4;   // P.V: query heads a thread accumulates
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

constexpr int kMmaWarps = 4;  // the bf16 kernel's warps
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaStages = 2;  // chunks in a warp's ring

// Tokens a split holds: the n valid tokens cut into n_split spans of
// whole tiles (the split kernels and the merge agree on it).
__device__ __forceinline__ int span_of(int n, int n_split, int tile) {
  const int per = (n + n_split - 1) / n_split;
  return (per + tile - 1) / tile * tile;
}

// Row b's valid tokens: its own cur_len[b] (per_row), else the batch's.
__device__ __forceinline__ int valid_tokens(const int* cur_len, int b,
                                            int per_row, int S) {
  return min(cur_len[per_row ? b : 0], S - 1) + 1;
}

// The cache row query row b reads: slots[b] given a map, else b.
__device__ __forceinline__ int64_t cache_row(const int* slots, int b) {
  return slots != nullptr ? (int64_t)slots[b] : (int64_t)b;
}

// 16 bytes of an f32 K/V row
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

__global__ void __launch_bounds__(kThreads) flash_decode_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ cur_len,
    const int* __restrict__ slots, int per_row, float* __restrict__ part_o,
    float* __restrict__ part_ml, int Hq, int Hkv, int S, int hd, int tile,
    int n_split, float scale) {
  constexpr int kVec = 4;  // f32 values in 16 bytes
  // 16-byte K/V slices a thread has in flight: 8 values of K and of V
  // (64 registers, four blocks an SM, no spill)
  constexpr int kLoads = 2;
  extern __shared__ float smem[];
  const int sp = blockIdx.x;  // split
  const int h = blockIdx.y;   // KV head
  const int b = blockIdx.z;   // row
  const int n = valid_tokens(cur_len, b, per_row, S);
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
  const float* qb = q + ((int64_t)b * Hq + hq0) * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    qs[i] = qb[i];
    acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < G; i += kThreads) {
    run_m[i] = kMaskValue;
    run_l[i] = 0.f;
  }
  // position 0's row of the row's slot
  const int64_t row0 = (cache_row(slots, b) * Hkv + h) * S;
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
          load4(k + el, kf[u]);
          load4(v + el, vf[u]);
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
      float mx = kMaskValue;
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

// The bf16 kernel's shapes, by HDB, the head_dim bucket (16, 32, 64, 128
// or 256) that holds hdp = hd rounded up to 16: register arrays are sized
// by HDB, loops stop at hdp.
template <int HDB>
struct MmaTiles {
  static constexpr int kTK = HDB > 128 ? 16 : 32;  // tokens a chunk
};

// Shared memory of the f32 kernel in bytes (the layout in
// flash_decode_f32_kernel)
size_t f32_smem_bytes(int G, int hd, int tile) {
  return (size_t)(2 * G * hd + tile * (2 * hd + 1) + G * tile + 3 * G) *
         sizeof(float);
}

// ... of the bf16 kernel: the query tile [16][hdp + kPad] bf16 (hdp: hd
// rounded up to 16), then the warps' rings [kMmaWarps][kMmaStages][K,
// V][kTK][hdp + kPad] bf16, which the final merge reuses as
// [kMmaWarps][16][hdp] f32 outputs and [kMmaWarps][16] m and l
size_t mma_smem_bytes(int hd) {
  const int hdp = (hd + 15) & ~15;
  const int tk = hdp > 128 ? MmaTiles<256>::kTK : MmaTiles<128>::kTK;
  const size_t ring = (size_t)kMmaWarps * kMmaStages * 2 * tk * (hdp + kPad) *
                      sizeof(__nv_bfloat16);
  const size_t merge = (size_t)kMmaWarps * 16 * (hdp + 2) * sizeof(float);
  return (size_t)16 * (hdp + kPad) * sizeof(__nv_bfloat16) +
         (ring > merge ? ring : merge);
}

// (The minimum of one block an SM in __launch_bounds__ lifts ptxas's own
// register target, under which the hd-64 instantiation spilled.)
template <int HDB>
__global__ void __launch_bounds__(kMmaThreads, 1) flash_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ cur_len,
    const int* __restrict__ slots, int per_row, float* __restrict__ part_o,
    float* __restrict__ part_ml, int Hq, int Hkv, int S, int hd, int tile,
    int n_split, float scale) {
  constexpr int kTK = MmaTiles<HDB>::kTK;
  constexpr int kNT = kTK / 8;  // 8-token score tiles a chunk
  constexpr int kD = HDB / 8;   // 8-column output tiles (at most)
  extern __shared__ uint4 smem4[];
  const int sp = blockIdx.x;  // split
  const int h = blockIdx.y;   // KV head
  const int b = blockIdx.z;   // row
  const int n = valid_tokens(cur_len, b, per_row, S);
  if (n <= 0) return;
  const int span = span_of(n, n_split, tile);
  const int j_begin = sp * span;
  if (j_begin >= n) return;  // the merge reads only used splits
  const int j_end = min(j_begin + span, n);
  const int G = Hq / Hkv;
  const int hdp = (hd + 15) & ~15;
  const int ksteps = hdp / 16;  // k-steps of Q.K^T, column pairs of P.V
  const int stride = hdp + kPad;
  const int vecp = hdp / 8;  // 16-byte slices of a staged row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ring = qs + 16 * stride;
  __nv_bfloat16* wring = ring + warp * kMmaStages * 2 * kTK * stride;
  float* mo = reinterpret_cast<float*>(ring);  // the merge: [warp][16][hdp]
  float* mm = mo + kMmaWarps * 16 * hdp;       // [warp][16]
  float* ml = mm + kMmaWarps * 16;             // [warp][16]
  // position 0's row of the row's slot
  const int64_t row0 = (cache_row(slots, b) * Hkv + h) * S;
  const int n_chunks = (j_end - j_begin + kTK - 1) / kTK;

  // a warp's chunk c of the span into its ring stage st: rows past j_end
  // and columns past hd are zeros
  auto stage_chunk = [&](int c, int st) {
    const int t0 = j_begin + c * kTK;
    const int nt = min(kTK, j_end - t0);
    __nv_bfloat16* ks = wring + st * 2 * kTK * stride;
    __nv_bfloat16* vs = ks + kTK * stride;
    for (int i = lane; i < kTK * vecp; i += 32) {
      const int r = i / vecp;
      const int c8 = (i % vecp) * 8;
      const bool ok = r < nt && c8 < hd;
      const int64_t el = ok ? (row0 + t0 + r) * hd + c8 : 0;
      cp_async16(ks + r * stride + c8, k + el, ok);
      cp_async16(vs + r * stride + c8, v + el, ok);
    }
  };

  for (int mt = 0; mt < G; mt += 16) {
    const int rows = min(16, G - mt);
    const int hq0 = h * G + mt;
    if (mt > 0) __syncthreads();  // the last 16-row tile's merge is done
    // the query tile: rows past the group and columns past hd are zeros
    for (int i = threadIdx.x; i < 16 * vecp; i += kMmaThreads) {
      const int r = i / vecp;
      const int c8 = (i % vecp) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c8 < hd)
        x = *reinterpret_cast<const uint4*>(
            q + ((int64_t)b * Hq + hq0 + r) * hd + c8);
      *reinterpret_cast<uint4*>(qs + r * stride + c8) = x;
    }
    __syncthreads();

    float o[kD][4];
#pragma unroll
    for (int d = 0; d < kD; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    float m[2] = {kMaskValue, kMaskValue};
    float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

    // the warp walks chunks warp, warp + kMmaWarps, ... of the span
    if (warp < n_chunks) stage_chunk(warp, 0);
    cp_async_commit();
    int st = 0;
    for (int c = warp; c < n_chunks; c += kMmaWarps, st ^= 1) {
      if (c + kMmaWarps < n_chunks) stage_chunk(c + kMmaWarps, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk c's copies have landed
      __syncwarp();        // ... every lane's
      const __nv_bfloat16* Ks = wring + st * 2 * kTK * stride;
      const __nv_bfloat16* Vs = Ks + kTK * stride;
      float sc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDB / 16; ++kk) {
        if (kk < ksteps) {
          uint32_t a[4];
          ldmatrix_x4(a, a_rows(qs, stride, 0, 16 * kk, lane));
#pragma unroll
          for (int p = 0; p < kTK / 16; ++p) {
            uint32_t kf[4];
            ldmatrix_x4(kf, k_rows(Ks, stride, 16 * p, 16 * kk, lane));
            mma_bf16(sc[2 * p], a, kf[0], kf[1]);
            mma_bf16(sc[2 * p + 1], a, kf[2], kf[3]);
          }
        }
      }
      // scale; tokens past the span's end masked
      const int t0 = j_begin + c * kTK;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = t0 + 8 * j + 2 * t + (e & 1) < j_end ? sc[j][e] * scale
                                                          : kMaskValue;
      float corr[2];
      online_softmax<kNT>(sc, m, l, corr);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        pack_pv_operands(sc[2 * kk], sc[2 * kk + 1], hi, lo);
#pragma unroll
        for (int p = 0; p < HDB / 16; ++p) {
          if (p < ksteps) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, v_rows(Vs, stride, 16 * kk, 16 * p, lane));
            mma_bf16(o[2 * p], hi, vf[0], vf[1]);
            mma_bf16(o[2 * p], lo, vf[0], vf[1]);
            mma_bf16(o[2 * p + 1], hi, vf[2], vf[3]);
            mma_bf16(o[2 * p + 1], lo, vf[2], vf[3]);
          }
        }
      }
      __syncwarp();  // every lane is done with stage st before it refills
    }
    cp_async_wait<0>();

    // merge the warps' partials: a warp without a chunk holds m = -1e30,
    // l = 0, o = 0, so it weighs nothing
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    __syncthreads();  // every warp is done with its ring
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = g + 8 * r;
      if (i < rows) {
        float* dst = mo + (warp * 16 + i) * hdp + 2 * t;
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          if (d < 2 * ksteps) {
            dst[8 * d] = o[d][2 * r];
            dst[8 * d + 1] = o[d][2 * r + 1];
          }
        }
        if (t == 0) {
          mm[warp * 16 + i] = m[r];
          ml[warp * 16 + i] = l[r];
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * hd; idx += kMmaThreads) {
      const int i = idx / hd;
      const int d = idx % hd;
      float mx = kMaskValue;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, mm[w * 16 + i]);
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w)
        a = fmaf(mo[(w * 16 + i) * hdp + d], expf(mm[w * 16 + i] - mx), a);
      part_o[(((int64_t)b * Hq + hq0 + i) * n_split + sp) * hd + d] = a;
    }
    for (int i = threadIdx.x; i < rows; i += kMmaThreads) {
      float mx = kMaskValue;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, mm[w * 16 + i]);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w)
        sum = fmaf(ml[w * 16 + i], expf(mm[w * 16 + i] - mx), sum);
      float* pml = part_ml + (((int64_t)b * Hq + hq0 + i) * n_split + sp) * 2;
      pml[0] = mx;
      pml[1] = sum;
    }
  }
}

// Merges a row's spans per query head into (o, m, l): the spans' (P.V, l)
// rescaled to the largest m. A block per (query head, row), a thread per
// column (hd <= kThreads). Each span's weight exp(m_span - m) is computed
// once, by one thread, into shared memory, kThreads spans at a time; every
// column then sums its spans in span order, as does the sum l.
__global__ void __launch_bounds__(kThreads) flash_decode_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ cur_len, int per_row, float* __restrict__ o,
    float* __restrict__ m, float* __restrict__ l, int Hq, int S, int hd,
    int tile, int n_split) {
  __shared__ float wt[kThreads];  // a chunk of spans' weights
  __shared__ float ls[kThreads];  // ... and their l
  __shared__ float red[kWarps];
  const int64_t r = (int64_t)blockIdx.y * Hq + blockIdx.x;
  const int d = threadIdx.x;
  float* orow = o + r * hd;
  const int n = valid_tokens(cur_len, blockIdx.y, per_row, S);
  if (n <= 0) {
    if (d < hd) orow[d] = 0.f;
    if (d == 0) {
      m[r] = kMaskValue;
      l[r] = 0.f;
    }
    return;
  }
  const int span = span_of(n, n_split, tile);
  const int used = (n + span - 1) / span;
  const float* ml = part_ml + r * n_split * 2;
  const float* po = part_o + r * n_split * hd;
  float mx = kMaskValue;  // the largest span max: exact in any order
  for (int sp = d; sp < used; sp += kThreads) mx = fmaxf(mx, ml[2 * sp]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((d & 31) == 0) red[d >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  float a = 0.f, sum = 0.f;
  for (int c0 = 0; c0 < used; c0 += kThreads) {
    const int nc = min(kThreads, used - c0);
    __syncthreads();  // the last chunk's readers are done
    if (d < nc) {
      wt[d] = expf(ml[2 * (c0 + d)] - mx);
      ls[d] = ml[2 * (c0 + d) + 1];
    }
    __syncthreads();
    if (d == 0)
      for (int j = 0; j < nc; ++j) sum = fmaf(ls[j], wt[j], sum);
    if (d < hd) {
      const float* pc = po + (int64_t)c0 * hd + d;
#pragma unroll 8
      for (int j = 0; j < nc; ++j) a = fmaf(pc[(int64_t)j * hd], wt[j], a);
    }
  }
  if (d == 0) red[0] = sum;
  __syncthreads();
  sum = red[0];
  if (d < hd) orow[d] = a / fmaxf(sum, 1e-30f);
  if (d == 0) {
    m[r] = mx;
    l[r] = sum;
  }
}

// The opt-in to more than 48 KiB of dynamic shared memory holds per device
// and per kernel: made by the first call that needs it (outside any CUDA
// graph capture), then reused.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, std::atomic<int>* opted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted[dev].load(std::memory_order_acquire) < (int)smem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    opted[dev].store(kMaxSmem, std::memory_order_release);
  }
  return cudaSuccess;
}

int launch_f32(const float* q, const float* k, const float* v,
               const int* len, const int* slots, int per_row, float* part_o,
               float* part_ml, int B, int Hq, int Hkv, int S, int hd,
               int tile, int n_split, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(Hq / Hkv, hd, tile);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static std::atomic<int> opted[kMaxDevices];
  cudaError_t e = opt_in(flash_decode_f32_kernel, smem, opted);
  if (e != cudaSuccess) return (int)e;
  flash_decode_f32_kernel<<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
      q, k, v, len, slots, per_row, part_o, part_ml, Hq, Hkv, S, hd, tile,
      n_split, scale);
  return (int)cudaGetLastError();
}

template <int HDB>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const int* len, const int* slots,
               int per_row, float* part_o, float* part_ml, int B, int Hq,
               int Hkv, int S, int hd, int tile, int n_split, float scale,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(hd);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static std::atomic<int> opted[kMaxDevices];
  cudaError_t e = opt_in(flash_decode_mma_kernel<HDB>, smem, opted);
  if (e != cudaSuccess) return (int)e;
  flash_decode_mma_kernel<HDB>
      <<<dim3(n_split, Hkv, B), kMmaThreads, smem, stream>>>(
          q, k, v, len, slots, per_row, part_o, part_ml, Hq, Hkv, S, hd,
          tile, n_split, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const int* len,
                const int* slots, int per_row, float* part_o, float* part_ml,
                int B, int Hq, int Hkv, int S, int hd, int tile, int n_split,
                float scale, cudaStream_t stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
#define FD_LAUNCH(HDB)                                                      \
  launch_mma<HDB>(qb, kb, vb, len, slots, per_row, part_o, part_ml, B, Hq, \
                  Hkv, S, hd, tile, n_split, scale, stream)
  if (hd <= 16) return FD_LAUNCH(16);
  if (hd <= 32) return FD_LAUNCH(32);
  if (hd <= 64) return FD_LAUNCH(64);
  if (hd <= 128) return FD_LAUNCH(128);
  return FD_LAUNCH(256);
#undef FD_LAUNCH
}

}  // namespace

// Dynamic shared memory a block of the split kernel takes at these shapes
// (bytes).
extern "C" int flash_decode_smem_bytes(int Hq, int Hkv, int hd, int tile,
                                       int is_bf16) {
  if (Hkv <= 0 || Hq % Hkv != 0 || hd <= 0) return -1;
  return (int)(is_bf16 ? mma_smem_bytes(hd)
                       : f32_smem_bytes(Hq / Hkv, hd, tile));
}

// work: B * Hq * n_split * (hd + 2) floats, the spans' P.V then their
// (m, l) pairs. cur_len: 1 int32, or B (per_row). slots: B int32 cache rows
// in [0, num_slots), or null (row b reads cache row b; num_slots == B).
extern "C" int flash_decode_partials(const void* q, const void* k,
                                     const void* v, const void* cur_len,
                                     const void* slots, void* o, void* m,
                                     void* l, void* work, int B, int Hq,
                                     int Hkv, int S, int hd, int tile,
                                     int n_split, int is_bf16, int per_row,
                                     int num_slots, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || hd <= 0 ||
      hd % 8 != 0 || hd > kThreads || tile <= 0 || n_split <= 0 ||
      B > 65535 || Hkv > 65535 || Hq > 65535 || n_split > 65535 ||
      num_slots <= 0 || (slots == nullptr && num_slots != B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_o = static_cast<float*>(work);
  float* part_ml = part_o + (int64_t)B * Hq * n_split * hd;
  const int* len = static_cast<const int*>(cur_len);
  const int* sl = static_cast<const int*>(slots);
  const int pr = per_row ? 1 : 0;
  const float scale = (float)(1.0 / sqrt((double)hd));
  const int rc =
      is_bf16 ? launch_bf16(q, k, v, len, sl, pr, part_o, part_ml, B, Hq, Hkv,
                            S, hd, tile, n_split, scale, s)
              : launch_f32(static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v), len, sl, pr, part_o,
                           part_ml, B, Hq, Hkv, S, hd, tile, n_split, scale,
                           s);
  if (rc != 0) return rc;
  flash_decode_merge_kernel<<<dim3(Hq, B), kThreads, 0, s>>>(
      part_o, part_ml, len, pr, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), Hq, S, hd, tile, n_split);
  return (int)cudaGetLastError();
}
