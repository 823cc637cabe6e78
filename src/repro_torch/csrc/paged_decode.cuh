// Paged flash-decode attention for Hopper (sm_90a): the kernel body shared
// by the bf16 pool (paged_decode.cu) and the int8 pool (paged_decode_quant.cu).
//
// One-query GQA attention per row over a global K/V block pool
// [NB, Hkv, bs, hd] read through per-row block tables [B, MB]; lengths[b]
// is the last valid logical position (-1: zero row). Output f32 [B, Hq, hd].
//
// Bound: device memory. Each valid K/V row is read once and feeds 2 G
// multiply-adds per element (G = Hq/Hkv query heads), far below the card's
// balance point. At the serving shapes a call moves well under a
// megabyte, so what the time is spent on is latency: the chain of
// dependent loads a block waits through, and how many bytes each SM has in
// flight. The design keeps that chain at two round trips and every byte of
// a block's work in flight at once:
//
// - Spans. A row's valid tokens are cut into spans of `span` logical
//   tokens (a constant by GQA group, ops.py span_plan), one
//   block per (span, KV head, row); blocks past a row's length exit at
//   once. A block first turns its span's table entries into pool row
//   indices in shared memory (the table and the length are read together),
//   then each of its 4 warps streams chunks of 32 tokens (16 at hd 256)
//   through its own cp.async ring of up to two stages, K and V in separate
//   groups so that Q.K starts while V lands: at the default spans the
//   whole span is in flight at once. Tiles stay in the stored type (bf16,
//   or int8 with the chunk's f32 scales), and each token's address comes
//   from its own table entry, so a chunk may cross pool blocks of any
//   size.
// - Both products on the tensor cores (mma.sync m16n8k16, the pieces of
//   attention_mma.cuh). A group of G <= 8 query heads is too small for the
//   MMA's M of 16, so tokens go on M and the heads on N = 8 (a group of 3
//   wastes 5/8 of N, not 13/16 of M): S^T = K Q^T with Q^T's fragments
//   held in registers for the whole walk, then O^T += V^T P^T, V^T through
//   ldmatrix.trans and P^T's B fragments gathered from S^T's accumulators
//   by shuffles. A group of 16 (recurrentgemma-9b) puts the heads on M, as
//   flash-decoding does. P enters P.V as three bf16 terms (split_terms),
//   so P.V keeps 24 bits of each probability.
// - int8 without dequantized copies: an int8 value is exact in bf16, so a
//   warp converts its landed int8 chunk to bf16 tiles in one pass over
//   shared memory, and the scales come out of the sums: s_t = ks_t (q .
//   k8_t) scale, and P.V takes p_t vs_t (l sums p_t). Only the order of
//   rounding differs from the plain version's float(int8) * scale.
// - Heads on N (walk_heads_on_n): each warp keeps its own online softmax
//   over its chunks, and the block merges its warps in warp order. Heads
//   on M (walk_heads_on_m): the warps share each round's maxima and P
//   fragments through shared memory and split P.V by output columns, so
//   no warp holds a 16 x hd partial output that the block would merge.
// - A row of one span writes its output directly; a longer row's blocks
//   write (o, m, l) partials to the workspace, and a second launch merges
//   a row's spans in span order. That launch is a programmatic dependent
//   launch: its blocks start while the span kernel runs and wait for its
//   writes only where they read them.
// - Tiles, chunks, warps and spans sit on logical token positions and no
//   sum uses atomics, so a row's output depends only on its q, its
//   tokens' K and V in logical order and its length: not on bs, the
//   physical blocks, B or the other rows.
//
// The TPU kernels walk a grid (B, Hkv, MB) whose sequential MB axis
// carries the softmax in scratch and whose block ids come by scalar
// prefetch; here the spans run in parallel and a block reads its own
// table entries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "attention_mma.cuh"

namespace paged_decode {

using namespace attention_mma;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStages = 2;     // chunks in a warp's ring
constexpr int kPTerms = 3;        // bf16 terms of P in P.V (split_terms)
constexpr int kMaxSpan = 4096;    // tokens a block reads (its row indices
                                  // live in shared memory)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

// Programmatic dependent launch (sm_90): the span kernel lets the merge
// launch as soon as every span block runs, and the merge waits for the
// span grid's writes only where it reads them.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Tokens a warp's chunk holds, by hdp (head_dim rounded up to 16)
__host__ __device__ constexpr int chunk_tokens(int hdp) {
  return hdp > 128 ? 16 : 32;
}

// K/V rows of a bf16 pool: copied into the ring as they are.
struct Bf16Pool {
  static constexpr bool kInt8 = false;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
};

// K/V rows of an int8 pool with one f32 scale per (block, head, token).
struct Int8Pool {
  static constexpr bool kInt8 = true;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Shared memory of a block, in bytes from the start:
//   rows:  int64 [span], the pool row of each token of the span;
//   q:     heads on M only, the query tile [16][hdp + kPad] bf16;
//   ring:  per warp, `stages` stages of [K, V] chunk tiles (bf16
//          [kTK][hdp + kPad]; int8 [kTK][hdp] plus f32 k and v scales
//          [kTK]), then for the int8 pool the bf16 tiles a chunk is
//          converted into;
//   pf:    heads on M, after the rings: P's A fragments [kWarps][kTK/16]
//          [kPTerms][4][32 lanes], then the chunks' maxima and the warps'
//          sums [kWarps][16] each. Heads on N, the block's final merge
//          reuses the rings instead: each warp's output [8][hdp +
//          kMergePad] f32, its running m and l [8] each, then the warps'
//          weights [kWarps][8] and each head's (m, l).
struct Layout {
  int stride;         // bf16 values a staged row
  int stages;         // chunks in each warp's ring
  size_t q;
  size_t ring;
  size_t pf;
  size_t stage_bytes;
  size_t warp_bytes;
  size_t total;
};

// Padding of a row of the warps' merged outputs (heads on N): the stores
// of an output fragment then hit 32 different banks, and the final reads
// run along rows.
constexpr int kMergePad = 4;

__host__ __device__ inline Layout make_layout(bool int8, bool heads_on_m,
                                              int hdp, int span) {
  Layout L;
  const int tk = chunk_tokens(hdp);
  L.stride = hdp + kPad;
  const int chunks = (span + tk - 1) / tk;
  const int per_warp = (chunks + kWarps - 1) / kWarps;
  L.stages = per_warp < kMaxStages ? per_warp : kMaxStages;
  const size_t tile = (size_t)tk * L.stride * sizeof(__nv_bfloat16);
  L.q = align16((size_t)span * sizeof(int64_t));
  L.ring = L.q + (heads_on_m ? 16 * (size_t)L.stride * sizeof(__nv_bfloat16)
                             : 0);
  L.stage_bytes = int8 ? 2 * (size_t)tk * hdp + 2 * (size_t)tk * sizeof(float)
                       : 2 * tile;
  L.warp_bytes = L.stages * L.stage_bytes + (int8 ? 2 * tile : 0);
  const size_t ring = kWarps * L.warp_bytes;
  L.pf = L.ring + ring;
  if (heads_on_m) {
    L.total = L.pf +
              (size_t)kWarps * (tk / 16) * kPTerms * 4 * 32 * sizeof(uint32_t) +
              2 * kWarps * 16 * sizeof(float);
  } else {
    const size_t merge =
        (size_t)kWarps * 8 * (hdp + kMergePad + 4) * sizeof(float);
    L.total = L.ring + (ring > merge ? ring : merge);
  }
  return L;
}

// (x, y) as kPTerms bf16 pairs whose sum is (x, y) to about 24 bits (x in
// the low halves); the first two are split_bf16x2's hi + lo. P.V takes P
// in three terms: with two, the residual is up to 2^-18 of each probability,
// 3.8e-6 of a value, and a row of a few tokens does not average it away:
// at values of 3 that is 1.1e-5, past the 1e-5 the kernel is held to (the
// int8 pool's p' = p vs keeps the scale's own rounding even at p = 1).
// Three leave 2^-26.
__device__ __forceinline__ void split_terms(float x, float y,
                                            uint32_t (&w)[kPTerms]) {
#pragma unroll
  for (int i = 0; i < kPTerms; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    w[i] = bf16x2_bits(h);
    const float2 hf = __bfloat1622float2(h);
    x -= hf.x;  // exact: hf is x rounded
    y -= hf.y;
  }
}

// Four int8 values (a 32-bit word) -> two bf16x2 words, exactly: the
// float with bits 0x4B0000uu is 2^23 + uu, so with uu = x + 128 (the sign
// bit flipped) one byte_perm and one subtraction give float(x), without
// the quarter-rate integer-to-float conversion.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + i)) -
           8388736.f;  // 2^23 + 128
  lo = bf16x2_bits(__floats2bfloat162_rn(f[0], f[1]));
  hi = bf16x2_bits(__floats2bfloat162_rn(f[2], f[3]));
}

// One int8 tile landed in the ring -> a bf16 tile (exact: |x| <= 127),
// 16 values a lane at a time.
template <int HDP, int kTK>
__device__ __forceinline__ void int8_to_bf16(const int8_t* src,
                                             __nv_bfloat16* dst, int stride,
                                             int lane) {
  constexpr int kPer = HDP / 16;  // 16-byte pieces of a row
#pragma unroll 2
  for (int i = lane; i < kTK * kPer; i += 32) {
    const int r = i / kPer;
    const int c = (i % kPer) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * HDP + c);
    uint4 d0, d1;
    int8x4_to_bf16(raw.x, d0.x, d0.y);
    int8x4_to_bf16(raw.y, d0.z, d0.w);
    int8x4_to_bf16(raw.z, d1.x, d1.y);
    int8x4_to_bf16(raw.w, d1.z, d1.w);
    uint4* d = reinterpret_cast<uint4*>(dst + r * stride + c);
    d[0] = d0;
    d[1] = d1;
  }
}

// What a block's walk needs, set up by the kernel's prologue.
template <class Pool>
struct Span {
  Pool pool;
  unsigned char* smem;
  Layout L;
  const int64_t* rows;      // the pool row of each token of the span
  const __nv_bfloat16* qs;  // heads on M: the query tile
  int hd;
  int nv;        // the span's valid tokens
  int G;         // query heads of the group
  int warp, lane, g, t;
  bool direct;   // the row is one span: write the output
  int64_t r0;    // b * Hq + the group's first head: the first output row
  int sp, n_spans;
  float scale;
  float* out;
  float* part_o;
  float* part_ml;
};

// Copies chunk c of the span (its tokens c kTK ..) into the ring stage at
// `base`, as two cp.async groups, K then V, so that Q.K can start while V
// is in flight: rows in the stored type (and the int8 pool's scales of
// each), zeros past the span's valid tokens and past hd. A warp without
// the chunk (`have` false) commits two empty groups, which keeps every
// warp's count of groups the same.
template <class Pool, int HDP>
__device__ __forceinline__ void stage_chunk(const Span<Pool>& s,
                                            unsigned char* base, int c,
                                            bool have) {
  constexpr int kTK = chunk_tokens(HDP);
  const int t0 = c * kTK;
  const int nt = have ? min(kTK, s.nv - t0) : 0;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    if (have) {
      if constexpr (Pool::kInt8) {
        int8_t* x8 = reinterpret_cast<int8_t*>(base) + kv * kTK * HDP;
        float* xs = reinterpret_cast<float*>(
                        reinterpret_cast<int8_t*>(base) + 2 * kTK * HDP) +
                    kv * kTK;
        const int8_t* src = kv ? s.pool.v : s.pool.k;
        const float* ssrc = kv ? s.pool.v_scale : s.pool.k_scale;
        constexpr int kPer = HDP / 16;
        for (int i = s.lane; i < kTK * kPer; i += 32) {
          const int r = i / kPer;
          const int c16 = (i % kPer) * 16;
          const bool ok = r < nt;
          cp_async16(x8 + r * HDP + c16,
                     src + (ok ? s.rows[t0 + r] * s.hd + c16 : 0), ok);
        }
        for (int r = s.lane; r < kTK; r += 32) {
          const bool ok = r < nt;
          cp_async4(xs + r, ssrc + (ok ? s.rows[t0 + r] : 0), ok);
        }
      } else {
        __nv_bfloat16* xt =
            reinterpret_cast<__nv_bfloat16*>(base) + kv * kTK * s.L.stride;
        const __nv_bfloat16* src = kv ? s.pool.v : s.pool.k;
        constexpr int kPer = HDP / 8;
        for (int i = s.lane; i < kTK * kPer; i += 32) {
          const int r = i / kPer;
          const int c8 = (i % kPer) * 8;
          const bool ok = r < nt && c8 < s.hd;
          cp_async16(xt + r * s.L.stride + c8,
                     src + (ok ? s.rows[t0 + r] * s.hd + c8 : 0), ok);
        }
      }
    }
    cp_async_commit();
  }
}

// A landed chunk's tiles: bf16 K and V (the int8 pool's converted copies
// in the warp's tiles at `cvt`: K here, V by convert_v) and the int8
// pool's scales.
template <class Pool, int HDP>
struct ChunkTiles {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* ks = nullptr;
  const float* vs = nullptr;
  const int8_t* v8 = nullptr;
  __nv_bfloat16* vc = nullptr;
};

template <class Pool, int HDP>
__device__ __forceinline__ ChunkTiles<Pool, HDP> chunk_tiles(
    const Span<Pool>& s, unsigned char* base, unsigned char* cvt) {
  constexpr int kTK = chunk_tokens(HDP);
  ChunkTiles<Pool, HDP> c;
  if constexpr (Pool::kInt8) {
    const int8_t* k8 = reinterpret_cast<const int8_t*>(base);
    c.v8 = k8 + kTK * HDP;
    c.ks = reinterpret_cast<const float*>(c.v8 + kTK * HDP);
    c.vs = c.ks + kTK;
    __nv_bfloat16* kc = reinterpret_cast<__nv_bfloat16*>(cvt);
    c.vc = kc + kTK * s.L.stride;
    int8_to_bf16<HDP, kTK>(k8, kc, s.L.stride, s.lane);
    __syncwarp();
    c.k = kc;
    c.v = c.vc;
  } else {
    c.k = reinterpret_cast<const __nv_bfloat16*>(base);
    c.v = c.k + kTK * s.L.stride;
  }
  return c;
}

// The int8 pool's V pass, issued after the score MMAs so that it overlaps
// them; the caller syncs before P.V reads it.
template <class Pool, int HDP>
__device__ __forceinline__ void convert_v(const Span<Pool>& s,
                                          const ChunkTiles<Pool, HDP>& c) {
  if constexpr (Pool::kInt8)
    int8_to_bf16<HDP, chunk_tokens(HDP)>(c.v8, c.vc, s.L.stride, s.lane);
}

// Heads on N (a group of G <= 8): each warp walks its own chunks c =
// warp, warp + kWarps, .. with its own online softmax; S^T = K Q^T puts a
// chunk's tokens on M, O^T += V^T P^T accumulates hd on M; the block then
// merges its warps in warp order.
template <class Pool, int HDP>
__device__ __forceinline__ void walk_heads_on_n(const Span<Pool>& s,
                                                const uint32_t (&qb)[HDP / 16][2]) {
  constexpr int kTK = chunk_tokens(HDP);
  constexpr int kKS = HDP / 16;  // k-steps of Q.K over head_dim
  constexpr int kMT = kTK / 16;  // 16-token tiles of a chunk
  constexpr int kAcc = HDP / 16; // 16-row tiles of O^T
  constexpr int kR = 8;          // heads an MMA tile holds
  const int lane = s.lane, g = s.g, t = s.t, warp = s.warp;
  const int stride = s.L.stride;
  unsigned char* wbase = s.smem + s.L.ring + (size_t)warp * s.L.warp_bytes;
  unsigned char* cvt = wbase + (size_t)s.L.stages * s.L.stage_bytes;
  // running softmax of columns 2t, 2t+1 (m uniform over the eight lanes of
  // a column, l this lane's share)
  float o[kAcc][4];
#pragma unroll
  for (int d = 0; d < kAcc; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};

  const int n_chunks = (s.nv + kTK - 1) / kTK;
  stage_chunk<Pool, HDP>(s, wbase, warp, warp < n_chunks);
  int st = 0;
  for (int c = warp; c < n_chunks; c += kWarps, st ^= 1) {
    // a warp with a next chunk has two stages (make_layout)
    stage_chunk<Pool, HDP>(s, wbase + (size_t)(st ^ 1) * s.L.stage_bytes,
                           c + kWarps, c + kWarps < n_chunks);
    cp_async_wait<3>();  // chunk c's K has landed
    __syncwarp();        // ... every lane's
    const ChunkTiles<Pool, HDP> ct = chunk_tiles<Pool, HDP>(
        s, wbase + (size_t)st * s.L.stage_bytes, cvt);
    const int t0 = c * kTK;  // the chunk's first token in the span

    // S^T = K Q^T: tokens on M (16-token tiles mt: rows g, g+8), heads on
    // N (columns 2t, 2t+1)
    float sc[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, a_rows(ct.k, stride, 16 * mt, 16 * kk, lane));
        mma_bf16(sc[mt], a, qb[kk][0], qb[kk][1]);
      }
    }
    if constexpr (Pool::kInt8) {
      cp_async_wait<2>();  // chunk c's V has landed
      __syncwarp();
      convert_v<Pool, HDP>(s, ct);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mt + g + (e >> 1) * 8;
        float x = sc[mt][e];
        if constexpr (Pool::kInt8) x *= ct.ks[r];
        sc[mt][e] = t0 + r < s.nv ? x * s.scale : kMaskValue;
      }
    // online softmax down each head's column: the chunk's max over the
    // eight lanes that hold it
    float corr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = kMaskValue;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        mx = fmaxf(mx, fmaxf(sc[mt][e], sc[mt][e + 2]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[e], mx);
      float sum = 0.f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        sc[mt][e] = expf(sc[mt][e] - m_new);
        sc[mt][e + 2] = expf(sc[mt][e + 2] - m_new);
        sum += sc[mt][e] + sc[mt][e + 2];
      }
      corr[e] = expf(m[e] - m_new);  // the first chunk: exp(-1e30 - m) = 0
      l[e] = fmaf(l[e], corr[e], sum);
      m[e] = m_new;
    }
#pragma unroll
    for (int d = 0; d < kAcc; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[1];
      o[d][2] *= corr[0];
      o[d][3] *= corr[1];
    }
    if constexpr (Pool::kInt8) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][e] *= ct.vs[16 * mt + g + (e >> 1) * 8];
      __syncwarp();  // V's bf16 tile is complete
    } else {
      cp_async_wait<2>();  // chunk c's V has landed
      __syncwarp();
    }
    // P^T's B fragment over tokens 16mt..16mt+15 (b0: tokens 2t, 2t+1 of
    // head g; b1: tokens 2t+8, 2t+9) from S^T's accumulators: token 2t's
    // row lives in lane 8t + g/2, token 2t+1's in lane 8t + 4 + g/2, each
    // as bf16 pairs of heads (2(g/2), +1); the half g&1 is head g
    const int src = 8 * t + (g >> 1);
    const uint32_t sel = (g & 1) ? 0x7632u : 0x5410u;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t w01[kPTerms], w23[kPTerms], pb[kPTerms][2];
      split_terms(sc[mt][0], sc[mt][1], w01);
      split_terms(sc[mt][2], sc[mt][3], w23);
#pragma unroll
      for (int u = 0; u < kPTerms; ++u) {
        pb[u][0] = __byte_perm(__shfl_sync(0xffffffffu, w01[u], src),
                               __shfl_sync(0xffffffffu, w01[u], src + 4),
                               sel);
        pb[u][1] = __byte_perm(__shfl_sync(0xffffffffu, w23[u], src),
                               __shfl_sync(0xffffffffu, w23[u], src + 4),
                               sel);
      }
      // O^T += V^T P^T: V^T's A fragment over head_dim rows 16d.. and
      // token columns 16mt.. is ldmatrix.trans of V's rows 16mt.. at the
      // addresses k_rows gives for a B fragment
#pragma unroll
      for (int d = 0; d < kAcc; ++d) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, k_rows(ct.v, stride, 16 * mt, 16 * d, lane));
#pragma unroll
        for (int u = 0; u < kPTerms; ++u) mma_bf16(o[d], a, pb[u][0], pb[u][1]);
      }
    }
    __syncwarp();  // every lane is done with stage st before it refills
  }
  cp_async_wait<0>();

  // merge the warps in warp order: a warp without a chunk holds m = -1e30,
  // l = 0, o = 0, so it weighs nothing
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 4);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 8);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 16);
  }
  __syncthreads();  // every warp is done with its ring
  constexpr int kMS = HDP + kMergePad;  // a merged row's floats
  float* mo = reinterpret_cast<float*>(s.smem + s.L.ring);  // [warp][head][kMS]
  float* mm = mo + kWarps * kR * kMS;                       // [warp][head]
  float* ml = mm + kWarps * kR;                             // [warp][head]
#pragma unroll
  for (int d = 0; d < kAcc; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mo[(warp * kR + 2 * t + (e & 1)) * kMS + 16 * d + g + (e >> 1) * 8] =
          o[d][e];
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mm[warp * kR + 2 * t + e] = m[e];
      ml[warp * kR + 2 * t + e] = l[e];
    }
  }
  __syncthreads();
  // each warp's weight exp(m_w - m) and the sum l, once per head
  float* wts = ml + kWarps * kR;  // [warp][head]
  float* hl = wts + kWarps * kR;  // [head]: m, l
  if (threadIdx.x < s.G) {
    const int i = threadIdx.x;
    float mx = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mm[w * kR + i]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(mm[w * kR + i] - mx);
      wts[w * kR + i] = wt;
      sum = fmaf(ml[w * kR + i], wt, sum);
    }
    hl[2 * i] = mx;
    hl[2 * i + 1] = sum;
  }
  __syncthreads();
  // the G x hd outputs, four columns a thread (hd is a multiple of 8)
  const int hd = s.hd;
  const int hd4 = hd / 4;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < s.G * hd4; idx += kThreads) {
    const int i = idx / hd4;
    const int d = (idx % hd4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = wts[w * kR + i];
      const float4 x =
          *reinterpret_cast<const float4*>(mo + (w * kR + i) * kMS + d);
      a.x = fmaf(x.x, wt, a.x);
      a.y = fmaf(x.y, wt, a.y);
      a.z = fmaf(x.z, wt, a.z);
      a.w = fmaf(x.w, wt, a.w);
    }
    const int64_t r = s.r0 + i;
    if (s.direct) {
      const float l = fmaxf(hl[2 * i + 1], 1e-30f);
      *reinterpret_cast<float4*>(s.out + r * hd + d) =
          make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
    } else {
      *reinterpret_cast<float4*>(s.part_o + (r * s.n_spans + s.sp) * hd + d) =
          a;
      if (d == 0) {
        s.part_ml[(r * s.n_spans + s.sp) * 2] = hl[2 * i];
        s.part_ml[(r * s.n_spans + s.sp) * 2 + 1] = hl[2 * i + 1];
      }
    }
  }
}

// Heads on M (a group of 16): the block walks its span in rounds of
// kWarps chunks, warp w scoring chunk w of the round. The chunks' maxima
// meet in shared memory (one barrier), so every warp takes the same
// running max, and each warp's P fragments go to shared memory (a second
// barrier); then each warp accumulates its own output columns (16-column
// pairs warp, warp + kWarps, ..) over every chunk of the round, in chunk
// order. No warp holds a partial output of all columns, so the block needs
// no merge of outputs, only of the sums l.
template <class Pool, int HDP>
__device__ __forceinline__ void walk_heads_on_m(const Span<Pool>& s) {
  constexpr int kTK = chunk_tokens(HDP);
  constexpr int kKS = HDP / 16;    // k-steps of Q.K over head_dim
  constexpr int kNT = kTK / 8;     // 8-token score tiles of a chunk
  constexpr int kKP = kTK / 16;    // 16-token k-steps of P.V a chunk
  constexpr int kPairs = HDP / 16; // 16-column pairs of the output
  constexpr int kMine = (kPairs + kWarps - 1) / kWarps;  // ... a warp's
  const int lane = s.lane, g = s.g, t = s.t, warp = s.warp;
  const int stride = s.L.stride;
  unsigned char* wbase = s.smem + s.L.ring + (size_t)warp * s.L.warp_bytes;
  unsigned char* cvt = wbase + (size_t)s.L.stages * s.L.stage_bytes;
  // P's A fragments [warp][kKP][kPTerms][4][lane], the chunks' maxima and
  // the warps' sums [warp][16]
  uint32_t* pf = reinterpret_cast<uint32_t*>(s.smem + s.L.pf);
  float* red_m = reinterpret_cast<float*>(pf + kWarps * kKP * kPTerms * 4 * 32);
  float* red_l = red_m + kWarps * 16;

  float o[2 * kMine][4];
#pragma unroll
  for (int d = 0; d < 2 * kMine; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};  // rows g, g+8: the block's max
  float l[2] = {0.f, 0.f};  // this lane's share of this warp's tokens' sum

  const int n_chunks = (s.nv + kTK - 1) / kTK;
  const int rounds = (n_chunks + kWarps - 1) / kWarps;
  stage_chunk<Pool, HDP>(s, wbase, warp, warp < n_chunks);
  int st = 0;
  for (int rd = 0; rd < rounds; ++rd, st ^= 1) {
    const int c = rd * kWarps + warp;  // this warp's chunk
    const bool have = c < n_chunks;
    const int present = min(kWarps, n_chunks - rd * kWarps);
    if constexpr (Pool::kInt8) {
      // every warp is done reading the last round's converted V tiles
      if (rd > 0) __syncthreads();
    }
    cp_async_wait<1>();  // this warp's K has landed
    __syncwarp();
    unsigned char* base = wbase + (size_t)st * s.L.stage_bytes;
    float sc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = kMaskValue;
    ChunkTiles<Pool, HDP> ct{};
    if (have) {
      ct = chunk_tiles<Pool, HDP>(s, base, cvt);
      // S = Q K^T: heads on M (rows g, g+8), tokens on N (8-token tiles
      // j: columns 8j + 2t, +1); even and odd k-steps in two chains
      float s2[2][kNT][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s2[u][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, a_rows(s.qs, stride, 0, 16 * kk, lane));
#pragma unroll
        for (int p = 0; p < kKP; ++p) {
          uint32_t kf[4];
          ldmatrix_x4(kf, k_rows(ct.k, stride, 16 * p, 16 * kk, lane));
          mma_bf16(s2[kk & 1][2 * p], a, kf[0], kf[1]);
          mma_bf16(s2[kk & 1][2 * p + 1], a, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = s2[0][j][e] + s2[1][j][e];
      if constexpr (Pool::kInt8) {
        cp_async_wait<0>();  // this warp's V has landed
        __syncwarp();
        convert_v<Pool, HDP>(s, ct);
      }
      const int t0 = c * kTK;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t + (e & 1);
          float x = sc[j][e];
          if constexpr (Pool::kInt8) x *= ct.ks[r];
          sc[j][e] = t0 + r < s.nv ? x * s.scale : kMaskValue;
        }
    }
    // the chunk's max of each row, then the round's over the warps
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = quad_max(mx);
      if (t == 0) red_m[warp * 16 + g + 8 * r] = mx;
    }
    __syncthreads();  // the maxima; every warp is done with the last round
    // the next round's chunk, into the other stage
    stage_chunk<Pool, HDP>(s, wbase + (size_t)(st ^ 1) * s.L.stage_bytes,
                           c + kWarps, c + kWarps < n_chunks);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * 16 + g + 8 * r]);
      corr[r] = expf(m[r] - mx);  // the first round: exp(-1e30 - m) = 0
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        sc[j][2 * r] = expf(sc[j][2 * r] - mx);
        sc[j][2 * r + 1] = expf(sc[j][2 * r + 1] - mx);
        sum += sc[j][2 * r] + sc[j][2 * r + 1];
      }
      l[r] = fmaf(l[r], corr[r], sum);
    }
#pragma unroll
    for (int d = 0; d < 2 * kMine; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }
    if (have) {
      if constexpr (Pool::kInt8) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= ct.vs[8 * j + 2 * t + (e & 1)];
      }
      // P's A fragments over tokens 16kk.. from the accumulators of token
      // tiles 2kk, 2kk + 1 (pack_pv_operands' layout), in kPTerms terms
#pragma unroll
      for (int kk = 0; kk < kKP; ++kk) {
        uint32_t pa[4][kPTerms];
        split_terms(sc[2 * kk][0], sc[2 * kk][1], pa[0]);
        split_terms(sc[2 * kk][2], sc[2 * kk][3], pa[1]);
        split_terms(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pa[2]);
        split_terms(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pa[3]);
#pragma unroll
        for (int u = 0; u < kPTerms; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pf[(((warp * kKP + kk) * kPTerms + u) * 4 + i) * 32 + lane] =
                pa[i][u];
      }
    }
    if constexpr (!Pool::kInt8) cp_async_wait<2>();  // this warp's V
    __syncthreads();  // every chunk's P and V of the round
    // P.V: this warp's columns over the round's chunks, in chunk order
    // (unrolled, so that one chunk's loads overlap another's MMAs)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < present) {
        unsigned char* wb = s.smem + s.L.ring + (size_t)w * s.L.warp_bytes;
        const __nv_bfloat16* vt =
            reinterpret_cast<const __nv_bfloat16*>(
                wb + (size_t)(Pool::kInt8 ? s.L.stages : st) *
                         s.L.stage_bytes) +
            kTK * stride;
#pragma unroll
        for (int kk = 0; kk < kKP; ++kk) {
          uint32_t pa[kPTerms][4];
#pragma unroll
          for (int u = 0; u < kPTerms; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              pa[u][i] =
                  pf[(((w * kKP + kk) * kPTerms + u) * 4 + i) * 32 + lane];
          uint32_t vf[kMine][4];
#pragma unroll
          for (int q = 0; q < kMine; ++q)
            if (warp + q * kWarps < kPairs)
              ldmatrix_x4_trans(vf[q], v_rows(vt, stride, 16 * kk,
                                              16 * (warp + q * kWarps), lane));
#pragma unroll
          for (int u = 0; u < kPTerms; ++u)
#pragma unroll
            for (int q = 0; q < kMine; ++q)
              if (warp + q * kWarps < kPairs) {
                mma_bf16(o[2 * q], pa[u], vf[q][0], vf[q][1]);
                mma_bf16(o[2 * q + 1], pa[u], vf[q][2], vf[q][3]);
              }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the row sums over the warps, in warp order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float x = quad_sum(l[r]);
    if (t == 0) red_l[warp * 16 + g + 8 * r] = x;
  }
  __syncthreads();
  float lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lsum[r] += red_l[w * 16 + g + 8 * r];
  }
  // this warp's columns: rows g, g+8 (heads), columns 16 pair + 8 h + 2t
  const int hd = s.hd;
#pragma unroll
  for (int q = 0; q < kMine; ++q) {
    const int pair = warp + q * kWarps;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = 16 * pair + 8 * hh + 2 * t;
      if (pair < kPairs && col < hd) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int64_t row = s.r0 + g + 8 * r;
          const float x = o[2 * q + hh][2 * r], y = o[2 * q + hh][2 * r + 1];
          if (s.direct) {
            const float lr = fmaxf(lsum[r], 1e-30f);
            *reinterpret_cast<float2*>(s.out + row * hd + col) =
                make_float2(x / lr, y / lr);
          } else {
            *reinterpret_cast<float2*>(
                s.part_o + (row * s.n_spans + s.sp) * hd + col) =
                make_float2(x, y);
          }
        }
      }
    }
  }
  if (!s.direct && warp == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = s.r0 + g + 8 * r;
      s.part_ml[(row * s.n_spans + s.sp) * 2] = m[r];
      s.part_ml[(row * s.n_spans + s.sp) * 2 + 1] = lsum[r];
    }
  }
}

// A block per (span, KV head, row). HDP: head_dim rounded up to 16 (hd is
// HDP, or 8 in a bf16 pool, zero-padded to 16). kHeadsOnM: the group of 16
// on the MMA's M; otherwise G <= 8 heads on its N. (The minimum of one
// block an SM lifts ptxas's own register target, under which the hd-256
// forms would spill.)
template <class Pool, int HDP, bool kHeadsOnM>
__global__ void __launch_bounds__(kThreads, 1) paged_decode_kernel(
    Pool pool, const __nv_bfloat16* __restrict__ q,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    float* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_ml, int Hq, int Hkv, int hd, int bs, int MB,
    int span, int n_spans, float scale) {
  constexpr int kKS = HDP / 16;  // k-steps of Q.K over head_dim
  extern __shared__ uint4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  launch_dependents();        // the merge's own prologue may start
  const int sp = blockIdx.x;  // span
  const int h = blockIdx.y;   // KV head
  const int b = blockIdx.z;   // row
  const int G = Hq / Hkv;
  const int hq0 = h * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int width = MB * bs;  // tokens a table holds
  const Layout L = make_layout(Pool::kInt8, kHeadsOnM, HDP, span);
  const int stride = L.stride;
  int64_t* rows = reinterpret_cast<int64_t*>(smem);
  const int j0 = sp * span;

  // the length, the query and the span's pool rows are all requested
  // before anything waits on them: the block's first round trip
  const int len = lengths[b];
  const __nv_bfloat16* qrow = q + ((int64_t)b * Hq + hq0) * hd;
  // the query: heads on N, Q^T's B fragments in registers for the whole
  // walk (b0: hd 16kk + 2t, +1 of head g; b1: hd + 8), zeros past the
  // group and past hd; heads on M, the A tile in shared memory (cp.async)
  uint32_t qb[kHeadsOnM ? 1 : kKS][2];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  if constexpr (kHeadsOnM) {
    for (int i = threadIdx.x; i < 16 * (HDP / 8); i += kThreads) {
      const int r = i / (HDP / 8);
      const int c8 = (i % (HDP / 8)) * 8;
      const bool ok = r < G && c8 < hd;
      cp_async16(qs + r * stride + c8, qrow + (ok ? (int64_t)r * hd + c8 : 0),
                 ok);
    }
    cp_async_commit();
  } else {
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * kk + 8 * e + 2 * t;
        qb[kk][e] = g < G && c < hd
                        ? *reinterpret_cast<const uint32_t*>(
                              qrow + (int64_t)g * hd + c)
                        : 0u;
      }
    }
  }
  const int* tbl = tables + (int64_t)b * MB;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int j = j0 + i;
    if (j < width) rows[i] = ((int64_t)tbl[j / bs] * Hkv + h) * bs + j % bs;
  }
  float* o_row = out + ((int64_t)b * Hq + hq0) * hd;
  const int n = len < 0 ? 0 : min(len, width - 1) + 1;  // valid tokens
  if (j0 >= n) {  // the merge reads used spans only
    if (len < 0 && sp == 0)
      for (int i = threadIdx.x; i < G * hd; i += kThreads) o_row[i] = 0.f;
    cp_async_wait<0>();
    return;
  }
  const int nv = min(span, n - j0);  // ... of this span
  const bool direct = n <= span;     // one span: write the output
  if constexpr (kHeadsOnM) cp_async_wait<0>();
  __syncthreads();  // rows and the query tile are in place

  const Span<Pool> s{pool, smem, L, rows, qs, hd, nv, G, warp, lane, g, t,
                     direct, (int64_t)b * Hq + hq0, sp, n_spans, scale, out,
                     part_o, part_ml};
  if constexpr (kHeadsOnM)
    walk_heads_on_m<Pool, HDP>(s);
  else
    walk_heads_on_n<Pool, HDP>(s, qb);
}

constexpr int kMergeThreads = 256;  // a column each (hd <= 256)
constexpr int kMergeRun = 32;       // spans whose partials load together

// Merges the spans of each row longer than one span, per query head: the
// spans' (o, l) rescaled to the largest m, summed in span order. A block
// per (query head, row), a thread per column. Latency, not bytes, is what
// a merge waits on, so a run of kMergeRun spans' outputs is requested in
// the same round trip as their (m, l), and each span's weight exp(m_span -
// m) is computed once, by one thread, into shared memory. Static: each .cu
// file that includes this header keeps its own copy.
static __global__ void __launch_bounds__(kMergeThreads)
    paged_decode_merge_kernel(const float* __restrict__ part_o,
                              const float* __restrict__ part_ml,
                              const int* __restrict__ lengths,
                              float* __restrict__ out, int Hq, int hd,
                              int width, int span, int n_spans) {
  __shared__ float sm[kMergeThreads];  // a run of spans' weights
  __shared__ float sl[kMergeThreads];  // ... and their l
  __shared__ float red[kMergeThreads / 32];
  const int64_t r = (int64_t)blockIdx.y * Hq + blockIdx.x;
  const int len = lengths[blockIdx.y];
  const int used = len < 0 ? 0 : (min(len, width - 1) + span) / span;
  // every block waits for the span kernel, so that this launch does not
  // complete (and release the stream's next work) before it
  wait_for_primary();
  if (used <= 1) return;  // a row of one span, or a zero row: written

  const float* ml = part_ml + r * n_spans * 2;
  const float* po = part_o + r * n_spans * hd;
  const int tid = threadIdx.x;
  // the first run's outputs are requested with the spans' maxima, so a
  // row of up to kMergeRun spans waits through one round trip of loads
  float v[kMergeRun];
  auto load_run = [&](int c0) {
#pragma unroll
    for (int j = 0; j < kMergeRun; ++j)
      v[j] = c0 + j < used && tid < hd ? po[(int64_t)(c0 + j) * hd + tid]
                                       : 0.f;
  };
  load_run(0);
  float mx = kMaskValue;  // the largest span max: exact in any order
  for (int s = tid; s < used; s += kMergeThreads) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, red[w]);
  float a = 0.f, sum = 0.f;
  for (int c0 = 0; c0 < used; c0 += kMergeRun) {
    const int nc = min(kMergeRun, used - c0);
    if (c0 > 0) load_run(c0);
    __syncthreads();  // the last run's readers are done
    if (tid < nc) {
      sm[tid] = expf(ml[2 * (c0 + tid)] - mx);
      sl[tid] = ml[2 * (c0 + tid) + 1];
    }
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < nc; ++j) sum = fmaf(sl[j], sm[j], sum);
#pragma unroll
    for (int j = 0; j < kMergeRun; ++j)
      if (j < nc) a = fmaf(v[j], sm[j], a);
  }
  __syncthreads();
  if (tid == 0) red[0] = sum;
  __syncthreads();
  if (tid < hd) out[r * hd + tid] = a / fmaxf(red[0], 1e-30f);
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

template <class Pool, int HDP, bool kHeadsOnM>
int launch(const Pool& pool, const void* q, const void* tables,
           const void* lengths, void* out, void* work, int B, int Hq, int Hkv,
           int hd, int bs, int MB, int span, int n_spans,
           cudaStream_t stream) {
  const Layout L = make_layout(Pool::kInt8, kHeadsOnM, HDP, span);
  if (L.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static std::atomic<int> opted[kMaxDevices];
  cudaError_t e =
      opt_in(paged_decode_kernel<Pool, HDP, kHeadsOnM>, L.total, opted);
  if (e != cudaSuccess) return (int)e;
  float* part_o = static_cast<float*>(work);
  float* part_ml =
      part_o == nullptr ? nullptr : part_o + (int64_t)B * Hq * n_spans * hd;
  const float scale = (float)(1.0 / sqrt((double)hd));
  paged_decode_kernel<Pool, HDP, kHeadsOnM>
      <<<dim3(n_spans, Hkv, B), kThreads, L.total, stream>>>(
          pool, static_cast<const __nv_bfloat16*>(q),
          static_cast<const int*>(tables), static_cast<const int*>(lengths),
          static_cast<float*>(out), part_o, part_ml, Hq, Hkv, hd, bs, MB,
          span, n_spans, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_spans == 1) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hq, B);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_decode_merge_kernel,
                         static_cast<const float*>(part_o),
                         static_cast<const float*>(part_ml),
                         static_cast<const int*>(lengths),
                         static_cast<float*>(out), Hq, hd, MB * bs, span,
                         n_spans);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class Pool, int HDP>
int launch_hd(const Pool& pool, const void* q, const void* tables,
              const void* lengths, void* out, void* work, int B, int Hq,
              int Hkv, int hd, int bs, int MB, int span, int n_spans,
              cudaStream_t stream) {
  if (Hq / Hkv == 16)
    return launch<Pool, HDP, true>(pool, q, tables, lengths, out, work, B, Hq,
                                   Hkv, hd, bs, MB, span, n_spans, stream);
  return launch<Pool, HDP, false>(pool, q, tables, lengths, out, work, B, Hq,
                                  Hkv, hd, bs, MB, span, n_spans, stream);
}

// Validates the shapes and dispatches on head_dim and the GQA group: a
// group of at most 8 heads or of 16; hd a power of two from 16 to 256 (8
// too in a bf16 pool); span tokens a block, n_spans = ceil(MB * bs /
// span); work: B * Hq * n_spans * (hd + 2) floats (the spans' partial
// outputs, then their (m, l) pairs), unused and may be null when n_spans
// is 1.
template <class Pool>
int dispatch(const Pool& pool, const void* q, const void* tables,
             const void* lengths, void* out, int B, int Hq, int Hkv, int hd,
             int bs, int MB, int span, void* work, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || bs <= 0 || MB <= 0 ||
      B > 65535 || Hkv > 65535 || Hq > 65535 || span <= 0 ||
      span > kMaxSpan || (int64_t)MB * bs > (int64_t)INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (G > 8 && G != 16) return (int)cudaErrorInvalidValue;
  const int64_t n_spans = ((int64_t)MB * bs + span - 1) / span;
  if (n_spans > INT32_MAX || (n_spans > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ns = (int)n_spans;
  switch (hd) {
    case 8:
      if (Pool::kInt8) return (int)cudaErrorInvalidValue;
      return launch_hd<Pool, 16>(pool, q, tables, lengths, out, work, B, Hq, Hkv, hd, bs, MB, span, ns, s);
    case 16: return launch_hd<Pool, 16>(pool, q, tables, lengths, out, work, B, Hq, Hkv, hd, bs, MB, span, ns, s);
    case 32: return launch_hd<Pool, 32>(pool, q, tables, lengths, out, work, B, Hq, Hkv, hd, bs, MB, span, ns, s);
    case 64: return launch_hd<Pool, 64>(pool, q, tables, lengths, out, work, B, Hq, Hkv, hd, bs, MB, span, ns, s);
    case 128: return launch_hd<Pool, 128>(pool, q, tables, lengths, out, work, B, Hq, Hkv, hd, bs, MB, span, ns, s);
    case 256: return launch_hd<Pool, 256>(pool, q, tables, lengths, out, work, B, Hq, Hkv, hd, bs, MB, span, ns, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace paged_decode
