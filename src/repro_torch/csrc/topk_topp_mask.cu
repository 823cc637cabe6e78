// Per-row top-k / top-p logit mask for Hopper (sm_90a): a radix select
// over a row held on chip.
//
// Replaces the TPU kernel src/repro/kernels/sampling/kernel.py
// topk_topp_mask_kernel. Semantics are those of the sort-based oracle
// (repro_torch/kernels/sampling/ref.py): keep logits >= the k-th largest
// (ties kept) and probs >= the nucleus cutoff (ties kept); dropped entries
// become -1e30. The output equals the oracle's bit for bit.
//
// Bound: device memory for the one read and one write of the [T, V] f32
// logits (5.5 us at 72 x 32000). Everything in between stays on chip, so
// the kernel's own limit is the work of its passes over a row and the
// barrier that ends each. The first design found both thresholds by
// bisection: ~64 passes a row, each a block-wide reduction. This one
// walks the whole row four times (stage, two counting passes, write; top-p
// alone two more, to list its candidates) and a list of candidates for
// the rest of its at most seven passes (the row where a list would not
// fit in shared memory):
//
// - Stage: a block copies its share of the row into shared memory by
//   16-byte cp.async (4-byte copies at a ragged edge); every pass then
//   reads shared memory in chunks of four logits, 16-byte loads where the
//   row starts on 16 bytes. A chunk's place depends on the logit's index
//   alone, so the f64 sums below do not depend on where the row lies.
// - Top-k: the k-th largest logit is found by a radix select over the
//   32-bit order-preserving key, most significant digit first, in digits
//   of 11, 11 and 10 bits: a histogram of 2048 (1024) integer counts a
//   pass, reduced over the block's warps, and one warp scans the 32 run
//   sums and then the run where the count from the top reaches k.
//   Integer bins make the result independent of the order of the
//   shared-memory atomics. The pass that takes the second digit also
//   lists every logit of the first digit's bin or above (k = 50 lists a
//   few hundred), and later passes walk that list instead of the row.
// - Denominator: sum exp(x - max) in f64, in a fixed order (a thread's
//   chunks in turn, then a shuffle tree, then the warps in order), cast to
//   f32 as ref.py does.
// - Top-p: the oracle's cutoff is the probability of the first logit, in
//   descending logit order, at which the running mass reaches top_p: a
//   weighted radix select over the same keys. Bins hold masses, as 64-bit
//   fixed-point integers (probability * 2^62, truncated; a 32-bit atomic
//   on the low word and the carry into the high one), so they too are
//   exact and order-free. Only candidates need weights: with top-k on, the
//   top-k set S (any key at or above the k-th one sees only S; if S's mass
//   falls short of top_p, all of S is kept, softmax being monotone as
//   ref.py's sorted p_desc assumes; the row total is needed only for a
//   top_p within 2^-21 of 1, as the f32 probabilities sum to within 2^-23
//   of 1). With top-p alone, the denominator's pass also counts the
//   logits by max - x in steps of 1/128, and a lower bound on each step's
//   mass (its least logit's probability, less expf's error) finds a step
//   that the cutoff's logit is at or above: the logits from there up (a
//   few percent more than the nucleus at top_p 0.9) are listed and
//   weighed. The digits run from the highest
//   bit in which the candidates' keys can differ, so the few candidates
//   spread over the bins instead of contending for a handful.
// - Write: keep = key >= the k-th key and exp(x - max) >= e_min, where
//   e_min is the least f32 whose rounded quotient by the denominator
//   reaches the cutoff (rounded division is monotone): no division a
//   logit, and exp only for x - max within 2^-20 of log(e_min), outside
//   which expf's 2-ulp error cannot change the comparison. 16-byte stores
//   where the output row starts on 16 bytes.
// - A row with nothing to mask (top_k <= 0 or >= V, top_p >= 1) is copied
//   from device memory to device memory: no staging, no passes.
//
// Where a row lives: one block's shared memory up to kMaxShared logits;
// a cluster of C = 2, 4 or 8 blocks on neighbouring SMs, each holding
// 1/C of the row, up to kMaxCluster * kMaxShare; past that a cluster of 8
// blocks that read their shares from device memory on every pass. C
// depends on V alone, so a row's bits never depend on T. In a cluster
// every pass ends in one cluster barrier: each block then sums the
// others' histograms and partials through distributed shared memory in
// rank order, so all make the same decisions, and histograms alternate
// between two buffers so the next pass may fill one while another block
// still reads the other.
//
// Plain C interface, loaded with ctypes; launched on the caller's stream;
// returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_mma.cuh"  // cp.async helpers

namespace cg = cooperative_groups;

namespace {

using attention_mma::cp_async16;
using attention_mma::smem_addr;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kBins = 2048;  // 11-bit digits; the last has 10
// a histogram: a 32-bit low and a 32-bit high word a bin, bin b in slot
// b + b / 64 of each (a pad word every 64 bins keeps the warps' reads of
// their runs free of bank conflicts)
constexpr int kSlots = kBins + kBins / 64;
constexpr int kHistWords = 2 * kSlots;
constexpr int kHistBytes = 4 * kHistWords;
// candidate logits a block lists: at least kList, at most kListMax (as
// shared memory allows beside the row)
constexpr int kList = 1024;
constexpr int kListMax = 16384;
// dynamic shared memory a block may use on Hopper (227 KB), less 3 KB of
// static scratch; the row buffer's slack covers the alignment pad
constexpr int kDynMax = 227 * 1024 - 3072;
constexpr int kSlack = 8;
// widest row one block stages (two histograms, the list, the row) and a
// cluster block's widest staged share (a third histogram: the merged one)
constexpr int kMaxShared = (kDynMax - 2 * kHistBytes - 4 * kList) / 4 - kSlack;
constexpr int kMaxShare = (kDynMax - 3 * kHistBytes - 4 * kList) / 4 - kSlack;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxDevices = 64;
// top_p at or below this needs no row total (see the head comment)
constexpr float kTotalSafe = 1.0f - 0x1p-21f;

// where a row lives: one block's shared memory, a cluster's, or a
// cluster that reads device memory
enum class Form { kShared, kCluster, kClusterGlobal };

// what a pass reduces besides its histogram
enum : int { kMax = 1, kSum = 2, kTot = 4 };

struct Scratch {
  float mx[2][kWarps];  // per-warp partials, two passes' worth
  double sum[2][kWarps];
  unsigned long long tot[2][kWarps];
  unsigned long long run[kWarps];  // the histogram's 32 run sums
  float r_mx;                      // the row's values
  double r_sum;
  unsigned long long r_tot;
  unsigned long long rest;  // the scan's result
  int bin;
  double fsum[kWarps];        // mass_floor's sums of 64 buckets' bounds
  unsigned int fcnt[kWarps];  // ... and their counts
  int floor;     // top-p alone: the candidates' last bucket (mass_floor)
  int members;   // ... and how many logits of the row it takes
  int listed;    // candidates offered to the list
  int relisted;  // ... offered again by a top-p pass
};

// Monotone map of a float onto uint32: a < b  <=>  key(a) < key(b), with
// -0.0 folded onto +0.0 so the comparisons agree with float ones.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ int slot(int b) { return b + (b >> 6); }

__device__ __forceinline__ uint64_t bin_value(const unsigned int* h, int sl) {
  return ((uint64_t)h[kSlots + sl] << 32) + h[sl];
}

// one more count in bin b (a plain shared-memory reduction: the
// increment is a register, so the compiler does not turn it into a loop
// over the warp's distinct addresses)
__device__ __forceinline__ void count(unsigned int* h, int b,
                                      unsigned int one) {
  asm volatile("red.shared.add.u32 [%0], %1;\n" ::"r"(smem_addr(h + slot(b))),
               "r"(one)
               : "memory");
}

// w more mass in bin b: a 32-bit atomic on the low word (64-bit ones are
// a compare-and-swap loop in shared memory), whose old value tells the
// carry that goes into the high word with w's upper half. Integer sums:
// the bin is exact whatever the order.
__device__ __forceinline__ void add_mass(unsigned int* h, int b, uint64_t w) {
  const unsigned int lo = (unsigned int)w;
  const unsigned int old = atomicAdd(h + slot(b), lo);
  const unsigned int hi = (unsigned int)(w >> 32) + (old + lo < old);
  if (hi) atomicAdd(h + kSlots + slot(b), hi);
}

// prob * 2^62 truncated, for 0 <= prob <= 1: prob's 24-bit significand
// shifted by its exponent (a subnormal prob is below 2^-126: 0)
__device__ __forceinline__ uint64_t fixed62(float prob) {
  const uint32_t u = __float_as_uint(prob);
  const int shift = (int)(u >> 23) - 88;  // prob = m * 2^(E - 150)
  if ((u >> 23) == 0 || shift <= -24) return 0;
  const uint64_t m = (u & 0x7FFFFFu) | 0x800000u;
  return shift >= 0 ? m << shift : m >> -shift;
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

template <typename T>
__device__ __forceinline__ T warp_incl_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Calls f(x_i) for the logits of chunks threadIdx.x, threadIdx.x +
// kThreads, ... of x[0..n), chunk c holding logits 4c..4c+3: whole chunks
// by one 16-byte load where x is 16-byte aligned (else 4-byte loads), then
// the ragged last chunk, by the thread whose turn it is.
template <typename F>
__device__ __forceinline__ void each4(const float* x, int n, F&& f) {
  const int whole = n >> 2;
  if (aligned16(x)) {
    for (int c = threadIdx.x; c < whole; c += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(x)[c];
      f(v.x);
      f(v.y);
      f(v.z);
      f(v.w);
    }
  } else {
    for (int c = threadIdx.x; c < whole; c += kThreads) {
      f(x[4 * c]);
      f(x[4 * c + 1]);
      f(x[4 * c + 2]);
      f(x[4 * c + 3]);
    }
  }
  if (threadIdx.x == whole % kThreads)
    for (int i = 4 * whole; i < n; ++i) f(x[i]);
}

// out[i] = keep(x[i]) ? x[i] : -1e30 over [0, n), in each4's chunks;
// 16-byte stores where out is 16-byte aligned and the chunk whole
template <typename Keep>
__device__ __forceinline__ void write_row(const float* x, int n, float* o,
                                          Keep&& keep) {
  const bool vin = aligned16(x), vout = aligned16(o);
  const int nch = (n + 3) >> 2;
  for (int c = threadIdx.x; c < nch; c += kThreads) {
    const int i = 4 * c;
    const bool whole = i + 4 <= n;
    float4 v;
    if (vin && whole) {
      v = *reinterpret_cast<const float4*>(x + i);
    } else {
      v.x = x[i];
      v.y = i + 1 < n ? x[i + 1] : 0.f;
      v.z = i + 2 < n ? x[i + 2] : 0.f;
      v.w = i + 3 < n ? x[i + 3] : 0.f;
    }
    float4 r;
    r.x = keep(v.x) ? v.x : kNegInf;
    r.y = keep(v.y) ? v.y : kNegInf;
    r.z = keep(v.z) ? v.z : kNegInf;
    r.w = keep(v.w) ? v.w : kNegInf;
    if (vout && whole) {
      *reinterpret_cast<float4*>(o + i) = r;
    } else {
      o[i] = r.x;
      if (i + 1 < n) o[i + 1] = r.y;
      if (i + 2 < n) o[i + 2] = r.z;
      if (i + 3 < n) o[i + 3] = r.w;
    }
  }
}

// Copies xg[0..n) into xs, logit i at xs[pad + i] where pad puts xs's
// 16-byte pieces on xg's: cp.async of 16 bytes for whole pieces, plain
// 4-byte copies at the ragged ends. Waits for this thread's copies.
__device__ __forceinline__ void stage(const float* xg, int n, int pad,
                                      float* xs) {
  const float* g = xg - pad;  // 16-byte aligned
  const int nq = (pad + n + 3) >> 2;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int i = 4 * q - pad;
    if (i >= 0 && i + 4 <= n) {
      cp_async16(xs + 4 * q, g + 4 * q, true);
    } else {
      for (int e = 0; e < 4; ++e)
        if (i + e >= 0 && i + e < n) xs[4 * q + e] = xg[i + e];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warp 0, after every warp summed its run of histogram h (nb bins, 32
// runs of nb/32, run 0 the top one) into s.run: the largest bin b whose
// suffix sum h[b] + ... + h[nb - 1] reaches need. s.bin = b and s.rest =
// need less the sum above b, or s.bin = -1 when the whole histogram falls
// short. The lanes scan the run sums, and the run where need is reached
// is split over the warp (nb/1024 bins a lane) and scanned again.
__device__ void finish_scan(const unsigned int* h, int nb, uint64_t need,
                            Scratch& s) {
  const int lane = threadIdx.x & 31;
  const int run = nb >> 5, q = run >> 5;
  uint64_t part = s.run[lane];
  uint64_t incl = warp_incl_scan(part);
  unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
  if (!hit) {
    if (lane == 0) s.bin = -1;
    return;
  }
  int src = __ffs(hit) - 1;
  const uint64_t above = __shfl_sync(0xffffffffu, incl - part, src);
  const int top = nb - run * src - q * lane;
  part = 0;
  for (int j = 1; j <= q; ++j) part += bin_value(h, slot(top - j));
  incl = above + warp_incl_scan(part);
  hit = __ballot_sync(0xffffffffu, incl >= need);
  src = __ffs(hit) - 1;
  if (lane == src) {
    uint64_t a = incl - part;
    int b = top - 1;
    for (uint64_t v; a + (v = bin_value(h, slot(b))) < need; --b) a += v;
    s.bin = b;
    s.rest = need - a;
  }
}

// Ends pass ps. The block's histogram ps & 1 (nb bins; nb = 0 for none)
// and the per-thread partials named in `what` are reduced over the row:
// the block's, then, in a cluster, every block's in rank order. The
// other histogram is cleared for the next pass. Then s.r_* hold the row's
// max, f64 sum and fixed-point total, and s.bin / s.rest the scan of the
// row's histogram for `need`. Returns the row's histogram (the block's,
// or in a cluster the merged one), valid until the next pass ends.
template <Form kForm>
__device__ const unsigned int* end_pass(int ps, int what, int nb,
                                        uint64_t need, float vmx, double vsum,
                                        uint64_t vtot, unsigned int* hist,
                                        Scratch& s) {
  const int par = ps & 1, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (what & kMax) {
    vmx = warp_max(vmx);
    if (lane == 0) s.mx[par][warp] = vmx;
  }
  if (what & kSum) {
    vsum = warp_sum(vsum);
    if (lane == 0) s.sum[par][warp] = vsum;
  }
  if (what & kTot) {
    vtot = warp_sum(vtot);
    if (lane == 0) s.tot[par][warp] = vtot;
  }
  unsigned int* h = hist + par * kHistWords;
  unsigned int* next = hist + (par ^ 1) * kHistWords;
  const unsigned int* row_h = h;
  unsigned int blocks = 1;
  if constexpr (kForm != Form::kShared) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    blocks = cluster.num_blocks();
    if (nb) {
      unsigned int* m = hist + 2 * kHistWords;
      for (int j = threadIdx.x; j < kSlots; j += kThreads) {
        uint64_t acc = 0;
        for (unsigned int r = 0; r < blocks; ++r)
          acc += bin_value(cluster.map_shared_rank(h, r), j);
        m[j] = (unsigned int)acc;
        m[kSlots + j] = (unsigned int)(acc >> 32);
      }
      row_h = m;
    }
  }
  for (int j = threadIdx.x; j < kHistWords; j += kThreads) next[j] = 0;
  __syncthreads();
  if (nb) {  // warp w sums run w from the top, nb/1024 bins a lane
    const int run = nb >> 5, q = run >> 5;
    const int top = nb - run * warp - q * lane;
    uint64_t v = 0;
    for (int j = 1; j <= q; ++j) v += bin_value(row_h, slot(top - j));
    v = warp_sum(v);
    if (lane == 0) s.run[warp] = v;
  }
  if (warp == 1 && what) {
    float m = -INFINITY;
    double sm = 0.0;
    unsigned long long tt = 0;
    for (unsigned int r = 0; r < blocks; ++r) {
      const Scratch* rs = &s;
      if constexpr (kForm != Form::kShared)
        rs = cg::this_cluster().map_shared_rank(&s, r);
      if (what & kMax) m = fmaxf(m, rs->mx[par][lane]);
      if (what & kSum) sm += rs->sum[par][lane];
      if (what & kTot) tt += rs->tot[par][lane];
    }
    if (what & kMax) m = warp_max(m);
    if (what & kSum) sm = warp_sum(sm);
    if (what & kTot) tt = warp_sum(tt);
    if (lane == 0) {
      s.r_mx = m;
      s.r_sum = sm;
      s.r_tot = tt;
    }
  }
  if (nb) {
    __syncthreads();
    if (warp == 0) finish_scan(row_h, nb, need, s);
  }
  __syncthreads();
  return row_h;
}

// For top-p alone, from the row's counts h of its logits by (max - x) *
// 128 (bucket j: [j, j + 1), up to 2048, so max - x < 16): the least j
// such that the logits of buckets 0..j weigh at least `need` by a lower
// bound on every weight (expf(-(j + 1) / 128) / denom, less 2^-18 of it
// for expf's and the division's rounding, less 1 for the truncation).
// The cutoff's logit is then in buckets 0..j, and so is every logit above
// it. s.floor = j (-1 where all 2048 fall short) and s.members = the
// count of buckets 0..j. Every warp sums 64 buckets, two a lane; warp 0
// scans the 32 sums, then the 64 buckets where need is reached.
__device__ void mass_floor(const unsigned int* h, float denom, uint64_t need,
                           Scratch& s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const double scale = 0x1p62 * (1.0 - 0x1p-18) / denom;
  auto bound = [&](int j, unsigned int c) {  // bucket j's c logits
    const double w = (double)expf(-(float)(j + 1) / 128.f) * scale - 1.0;
    return c && w > 0.0 ? c * w : 0.0;
  };
  auto pair = [&](int j0, double& w, unsigned int& c) {
    const unsigned int c0 = h[slot(j0)], c1 = h[slot(j0 + 1)];
    w = bound(j0, c0) + bound(j0 + 1, c1);
    c = c0 + c1;
  };
  double w;
  unsigned int c;
  pair(64 * warp + 2 * lane, w, c);
  w = warp_sum(w);
  c = warp_sum(c);
  if (lane == 0) {
    s.fsum[warp] = w;
    s.fcnt[warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    w = s.fsum[lane];
    c = s.fcnt[lane];
    double wi = warp_incl_scan(w);
    unsigned int ci = warp_incl_scan(c);
    unsigned hit = __ballot_sync(0xffffffffu, wi >= (double)need);
    if (!hit) {
      if (lane == 0) s.floor = -1;
    } else {
      const int run = __ffs(hit) - 1;
      const double wa = __shfl_sync(0xffffffffu, wi - w, run);
      const unsigned int ca = __shfl_sync(0xffffffffu, ci - c, run);
      const int j0 = 64 * run + 2 * lane;
      pair(j0, w, c);
      wi = wa + warp_incl_scan(w);
      ci = ca + warp_incl_scan(c);
      hit = __ballot_sync(0xffffffffu, wi >= (double)need);
      // none: the sums' rounding, not the bound; take the run's end
      const int src = hit ? __ffs(hit) - 1 : 31;
      if (lane == src) {
        const unsigned int c0 = h[slot(j0)];
        const bool one = hit && wi - w + bound(j0, c0) >= (double)need;
        s.floor = j0 + (one ? 0 : 1);
        s.members = (int)(ci - c + (one ? c0 : c));
      }
    }
  }
  __syncthreads();
}

// The least f32 e >= 0 with e / denom >= c (rounded division is monotone
// in e), so that fl(e / denom) >= c  <=>  e >= least_e(c, denom).
__device__ float least_e(float c, float denom) {
  float e = c * denom;
  while (e / denom < c) e = __uint_as_float(__float_as_uint(e) + 1);
  while (e > 0.f && __uint_as_float(__float_as_uint(e) - 1) / denom >= c)
    e = __uint_as_float(__float_as_uint(e) - 1);
  return e;
}

// A cluster's block holds `per` logits of its row from position rank *
// per on; a lone block the whole row (per unused). `cap` is the list's
// length, and the staged row follows it.
template <Form kForm>
__global__ void __launch_bounds__(kThreads, 1) topk_topp_mask_kernel(
    const float* __restrict__ logits, const int* __restrict__ top_k,
    const float* __restrict__ top_p, float* __restrict__ out, int V,
    int per, int cap) {
  extern __shared__ __align__(16) unsigned int dyn[];
  __shared__ Scratch s;
  constexpr bool kCl = kForm != Form::kShared;
  const int t = kCl ? blockIdx.y : blockIdx.x;
  const int j0 = kCl ? blockIdx.x * per : 0;
  const int n = kCl ? max(0, min(per, V - j0)) : V;  // this block's logits
  const float* xg = logits + (int64_t)t * V + j0;
  float* og = out + (int64_t)t * V + j0;
  const int k = top_k[t];
  const float p = top_p[t];
  const bool do_k = k > 0 && k < V;  // k >= V keeps everything
  const bool do_p = p < 1.0f;
  if (!do_k && !do_p) {
    write_row(xg, n, og, [](float) { return true; });
    return;
  }

  unsigned int* hist = dyn;  // two histograms (+ the merged one)
  float* list = reinterpret_cast<float*>(dyn + (kCl ? 3 : 2) * kHistWords);
  const float* x = xg;
  if constexpr (kForm != Form::kClusterGlobal) {
    const int pad = (reinterpret_cast<uintptr_t>(xg) & 15) >> 2;
    float* xs = list + cap;
    stage(xg, n, pad, xs);
    x = xs + pad;
  }
  for (int j = threadIdx.x; j < 2 * kHistWords; j += kThreads) hist[j] = 0;
  if (threadIdx.x == 0) s.listed = s.relisted = 0;
  __syncthreads();
  const unsigned int one = blockDim.x > 0;  // 1, in a register

  // pass 0: the max; the k-th key's first digit
  int ps = 0;
  uint32_t kpre = 0;
  uint64_t kneed = (uint64_t)k;
  {
    float lmx = -INFINITY;
    each4(x, n, [&](float v) {
      if (do_p) lmx = fmaxf(lmx, v);
      if (do_k) count(hist, order_key(v) >> 21, one);
    });
    end_pass<kForm>(ps, do_p ? kMax : 0, do_k ? 2048 : 0, kneed, lmx, 0.0, 0,
                    hist, s);
    kpre = s.bin;
    kneed = s.rest;
  }
  const float mx = s.r_mx;

  // pass 1: the denominator; the k-th key's second digit, and the
  // candidate list; for top-p alone, the logits' counts by max - x
  ++ps;
  float denom = 1.f;
  const uint64_t target =
      p > 0.f ? (uint64_t)ceil((double)p * 0x1p62) : 0ull;
  const bool p_alone = do_p && !do_k && target > 0;
  {
    unsigned int* h = hist + kHistWords;
    double lsum = 0.0;
    const uint32_t first = kpre;
    each4(x, n, [&](float v) {
      if (do_p) lsum += (double)expf(v - mx);
      if (do_k) {
        const uint32_t key = order_key(v);
        if ((key >> 21) >= first) {
          const int j = atomicAdd(&s.listed, 1);
          if (j < cap) list[j] = v;
          if ((key >> 21) == first) count(h, (key >> 10) & 2047, one);
        }
      } else if (p_alone) {
        const float b = (mx - v) * 128.f;
        if (b < 2048.f) count(h, (int)b, one);
      }
    });
    const unsigned int* row_h =
        end_pass<kForm>(ps, do_p ? kSum : 0, do_k || p_alone ? 2048 : 0,
                        do_k ? kneed : ~0ull, 0.f, lsum, 0, hist, s);
    denom = (float)s.r_sum;
    kpre = (kpre << 11) | (uint32_t)s.bin;
    kneed = s.rest;
    if (p_alone) mass_floor(row_h, denom, target, s);
  }
  const int listed = s.listed;
  const bool use_list = do_k && listed <= cap;
  // calls f(v) for the first m logits of the list, or for every logit of
  // the row (m < 0)
  auto visit = [&](int m, auto&& f) {
    if (m >= 0) {
      for (int j = threadIdx.x; j < m; j += kThreads) f(list[j]);
    } else {
      each4(x, n, f);
    }
  };
  auto weight = [&](float v) { return fixed62(expf(v - mx) / denom); };

  // pass 2: the k-th key's last digit; the row total where top_p needs it
  uint32_t k_key = 0;
  const bool need_total = do_k && do_p && p > kTotalSafe;
  uint64_t total = 0;
  if (do_k) {
    ++ps;
    unsigned int* h = hist + (ps & 1) * kHistWords;
    uint64_t ltot = 0;
    const uint32_t pre = kpre;
    visit(use_list && !need_total ? listed : -1, [&](float v) {
      const uint32_t key = order_key(v);
      if ((key >> 10) == pre) count(h, key & 1023, one);
      if (need_total) ltot += weight(v);
    });
    end_pass<kForm>(ps, need_total ? kTot : 0, 1024, kneed, 0.f, 0.0, ltot,
                    hist, s);
    k_key = (kpre << 10) | (uint32_t)s.bin;
    total = s.r_tot;
  }

  // top-p: the cutoff probability, then e_min and its window
  bool p_on = do_p;
  float e_min = 0.f, d_lo = 0.f, d_hi = 0.f;
  if (do_p) {
    float cut = 1.0f / denom;  // the max's probability: the oracle's
                               // cutoff when no prefix reaches top_p
    if (target > 0 && !(need_total && total < target)) {
      // the candidates: the top-k set, or for top-p alone the logits
      // with (max - x) * 128 < lim; listed where they fit (the top-k
      // set's list, or a list made now)
      float lim = INFINITY;
      int m = use_list ? listed : -1;
      if (p_alone && s.floor >= 0) {
        lim = (float)(s.floor + 1);
        if (s.members <= cap) {
          each4(x, n, [&](float v) {
            if ((mx - v) * 128.f < lim) list[atomicAdd(&s.relisted, 1)] = v;
          });
          __syncthreads();
          m = s.relisted;
        }
      }
      auto member = [&](float v, uint32_t key) {
        return do_k ? key >= k_key : (mx - v) * 128.f < lim;
      };
      // digits of up to 11 bits from the highest bit in which the
      // candidates' keys can differ (they lie in [lo, hi], so they share
      // the bits above it): a narrow range spreads over more bins and may
      // take fewer passes
      const uint32_t hi = order_key(mx);
      uint32_t lo = k_key;
      if (!do_k) lo = lim < INFINITY ? order_key(mx - (lim + 1.f) / 128.f) : 0;
      int top = lo == hi ? 1 : 32 - __clz(lo ^ hi);  // bits to decide
      uint64_t pre = (uint64_t)hi >> top;  // the decided bits of the key
      uint64_t need = target;
      bool found = true;
      for (int d = 0; top > 0; ++d) {
        ++ps;
        unsigned int* h = hist + (ps & 1) * kHistWords;
        const int sh = max(0, top - 11);
        const uint32_t mask = (1u << (top - sh)) - 1;
        // the second pass lists the logits of the first one's bin where
        // the row had to be walked, for the third
        const bool relist = d == 1 && m < 0;
        visit(m, [&](float v) {
          const uint32_t key = order_key(v);
          if (!member(v, key) || ((uint64_t)key >> top) != pre) return;
          if (relist) {
            const int j = atomicAdd(&s.relisted, 1);
            if (j < cap) list[j] = v;
          }
          const uint64_t w = weight(v);
          if (w) add_mass(h, (key >> sh) & mask, w);
        });
        end_pass<kForm>(ps, 0, 2048, need, 0.f, 0.0, 0, hist, s);
        if (s.bin < 0) {  // only in the first pass
          found = false;
          break;
        }
        pre = (pre << (top - sh)) | (uint32_t)s.bin;
        need = s.rest;
        top = sh;
        if (relist && s.relisted <= cap) m = s.relisted;
      }
      if (found)
        cut = expf(key_value((uint32_t)pre) - mx) / denom;
      else if (do_k)
        p_on = false;  // S's mass falls short of top_p: all of S is kept
    }
    if (p_on) {
      e_min = least_e(cut, denom);
      const double ln = log((double)e_min);
      d_lo = __double2float_rd(ln - 0x1p-20);  // below: expf(d) < e_min
      d_hi = __double2float_ru(ln + 0x1p-20);  // above: expf(d) >= e_min
    }
  }

  write_row(x, n, og, [&](float v) {
    if (order_key(v) < k_key) return false;
    if (!p_on) return true;
    const float d = v - mx;
    return d > d_hi || (d >= d_lo && expf(d) >= e_min);
  });
  // no block leaves while another may still read its shared memory
  if constexpr (kCl) cg::this_cluster().sync();
}

// The opt-in to more than 48 KiB of dynamic shared memory holds per
// device and kernel. It is made once per device, always to the most a
// block may take, so the limit never shrinks under a launch on another
// thread (the first call on a device happens outside any CUDA graph
// capture).
template <Form kForm>
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(topk_topp_mask_kernel<kForm>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDynMax);
    if (e != cudaSuccess) return e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// a cluster block's share of a row of V logits split over C blocks: a
// multiple of 4, so the shares of a 16-byte aligned row stay aligned
int share(int V, int C) { return ((V + C - 1) / C + 3) / 4 * 4; }

// the list's length beside `hists` histograms and a staged row of n
// logits (none: n = 0): what shared memory leaves, a multiple of 4, at
// most kListMax
int list_cap(int hists, int n) {
  const int left =
      ((kDynMax - hists * kHistBytes) / 4 - (n ? n + kSlack : 0)) / 4 * 4;
  return left < kListMax ? left : kListMax;
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
  cudaError_t e;
  if (V <= kMaxShared) {
    if ((e = opt_in<Form::kShared>()) != cudaSuccess) return (int)e;
    const int cap = list_cap(2, V);
    const size_t bytes = 2 * kHistBytes + 4 * (size_t)(cap + V + kSlack);
    topk_topp_mask_kernel<Form::kShared><<<T, kThreads, bytes, s>>>(
        lg, kk, pp, o, V, V, cap);
    return (int)cudaGetLastError();
  }
  int C = 2;
  while (C < kMaxCluster && share(V, C) > kMaxShare) C *= 2;
  const int per = share(V, C);
  const bool staged = per <= kMaxShare;
  const int cap = list_cap(3, staged ? per : 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, T);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      3 * kHistBytes + 4 * (size_t)(cap + (staged ? per + kSlack : 0));
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (staged) {
    if ((e = opt_in<Form::kCluster>()) != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, topk_topp_mask_kernel<Form::kCluster>, lg,
                           kk, pp, o, V, per, cap);
  } else {
    if ((e = opt_in<Form::kClusterGlobal>()) != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(&cfg, topk_topp_mask_kernel<Form::kClusterGlobal>,
                           lg, kk, pp, o, V, per, cap);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
