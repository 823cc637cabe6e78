// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru/kernel.py:45
// rglru_scan_kernel (body _rglru_kernel) and computes what the JAX
// package's sequential oracle (kernels/rglru/ref.py rglru_ref_loop)
// computes: per (row, channel), from h0 (zeros when absent), each step a
// product and a sum in f32, rounded separately (no fused multiply-add), so
// the kernel equals the plain PyTorch version bit for bit.
//
// Layout: a, b, h [B, S, W] f32, h0 [B, W] f32 or null.
//
// Bound: device memory. Each (row, step, channel) reads 8 bytes and writes
// 4 for one multiply and one add: 113 MB at B = 1, S = 2304, W = 4096, or
// 34 us at 3.35 TB/s. The serial chain is not the limit: 2304 steps of a
// dependent multiply and add (~8 cycles) take ~10 us.
//
// No chunked time scan. The TPU kernel closes a time tile in parallel
// through a bounded decay matrix and carries the state across a
// sequential grid axis; a GPU form of that (per-chunk carries, then a
// fix-up) would round differently from the sequential product-then-sum,
// and the kernel is held bit-equal to it. So each channel is still walked
// serially, and the design spends its effort on bytes in flight instead:
//
// - One block is one warp that owns 32 consecutive channels of one row:
//   B * ceil(W / 32) blocks (128 at B = 1, W = 4096), a split that depends
//   on W alone, so a row's arithmetic never depends on B or the card.
// - a and b arrive as [kTile x 32] f32 tiles in a ring of kStages stages
//   in shared memory, by cp.async (16-byte copies when W % 4 == 0 and the
//   pointers are 16-byte aligned, else 4-byte ones): kStages - 1 tiles,
//   48 KB, are in flight while one is scanned, about what an SM needs to
//   keep device memory busy (3.35 TB/s over ~1 us of latency, shared by
//   132 SMs, is ~25 KB an SM).
// - Lane j scans channel j of the staged tile serially (__fmul_rn then
//   __fadd_rn, as the plain version) and writes each h over the a it
//   consumed; the warp then stores the tile's h rows as 16-byte pieces.
// - A ragged last tile (any S), a ragged last channel group (masked
//   lanes) and h0 are taken; the TPU kernel asserts S % bt == 0.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attention_mma.cuh"  // cp.async helpers

namespace {

using attention_mma::cp_async16;
using attention_mma::cp_async_commit;
using attention_mma::cp_async_wait;
using attention_mma::smem_addr;

constexpr int kLanes = 32;   // channels a block owns: one warp
constexpr int kTile = 64;    // steps a stage holds
constexpr int kStages = 4;   // ring depth: kStages - 1 tiles in flight
constexpr int kBatch = 16;   // steps whose shared loads are issued together
constexpr int kStageFloats = kTile * kLanes;
constexpr int kSmemBytes = 2 * kStages * kStageFloats * 4;  // a and b: 64 KB
constexpr int kMaxDevices = 64;

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// kVec: 16-byte copies and stores (W % 4 == 0, 16-byte aligned pointers)
template <bool kVec>
__global__ void __launch_bounds__(kLanes, 1) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ h, int S, int W) {
  extern __shared__ __align__(16) float smem[];
  float* const as = smem;                           // [kStages][kTile][32]
  float* const bs = smem + kStages * kStageFloats;  // the same for b
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kLanes;
  const int nw = min(kLanes, W - w0);  // channels of this group
  const int64_t base = (int64_t)blockIdx.y * S * W + w0;
  const int ntiles = (S + kTile - 1) / kTile;
  // 16-byte pieces: lane copies piece lane % 8 of rows lane / 8 + 4i
  const int piece = 4 * (lane & 7);
  const bool piece_ok = piece < nw;  // W % 4 == 0: a piece is all in or out

  // one commit group a tile, empty past the last, so the wait counts hold
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int t0 = tile * kTile, n = min(kTile, S - t0);
      float* const ad = as + (tile % kStages) * kStageFloats;
      float* const bd = bs + (tile % kStages) * kStageFloats;
      if constexpr (kVec) {
        if (piece_ok) {
          for (int i = lane >> 3; i < n; i += 4) {
            const int64_t off = base + (int64_t)(t0 + i) * W + piece;
            cp_async16(ad + i * kLanes + piece, a + off, true);
            cp_async16(bd + i * kLanes + piece, b + off, true);
          }
        }
      } else if (lane < nw) {
        for (int i = 0; i < n; ++i) {
          const int64_t off = base + (int64_t)(t0 + i) * W + lane;
          cp_async4(ad + i * kLanes + lane, a + off);
          cp_async4(bd + i * kLanes + lane, b + off);
        }
      }
    }
    cp_async_commit();
  };

  float hv = (h0 != nullptr && lane < nw)
                 ? h0[(int64_t)blockIdx.y * W + w0 + lane]
                 : 0.f;
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int tile = 0; tile < ntiles; ++tile) {
    issue(tile + kStages - 1);  // into the slot tile - 1 left
    cp_async_wait<kStages - 1>();  // this lane's copies of `tile` landed
    __syncwarp();                  // ... and every lane's
    const int t0 = tile * kTile, n = min(kTile, S - t0);
    float* const at = as + (tile % kStages) * kStageFloats;
    const float* const bt = bs + (tile % kStages) * kStageFloats;
    int i = 0;
    for (; i + kBatch <= n; i += kBatch) {
      float av[kBatch], bv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        av[j] = at[(i + j) * kLanes + lane];
        bv[j] = bt[(i + j) * kLanes + lane];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        hv = __fadd_rn(__fmul_rn(av[j], hv), bv[j]);
        at[(i + j) * kLanes + lane] = hv;
      }
    }
    for (; i < n; ++i) {
      hv = __fadd_rn(__fmul_rn(at[i * kLanes + lane], hv), bt[i * kLanes + lane]);
      at[i * kLanes + lane] = hv;
    }
    __syncwarp();  // the tile's h is in shared memory
    if constexpr (kVec) {
      if (piece_ok) {
        for (int r = lane >> 3; r < n; r += 4)
          *reinterpret_cast<float4*>(h + base + (int64_t)(t0 + r) * W + piece) =
              *reinterpret_cast<const float4*>(at + r * kLanes + piece);
      }
    } else if (lane < nw) {
      for (int r = 0; r < n; ++r)
        h[base + (int64_t)(t0 + r) * W + lane] = at[r * kLanes + lane];
    }
    __syncwarp();  // the slot is read before the next issue refills it
  }
  cp_async_wait<0>();
}

// The opt-in to more than 48 KiB of dynamic shared memory holds per device
// and kernel; it is made once per device, on the first call (outside any
// CUDA graph capture).
template <bool kVec>
cudaError_t opt_in() {
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(rglru_scan_kernel<kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <bool kVec>
int launch(const float* a, const float* b, const float* h0, float* h, int B,
           int S, int W, cudaStream_t stream) {
  const cudaError_t e = opt_in<kVec>();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kLanes - 1) / kLanes, B);
  rglru_scan_kernel<kVec><<<grid, kLanes, kSmemBytes, stream>>>(a, b, h0, h,
                                                                S, W);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int rglru_scan_f32(const void* a, const void* b, const void* h0,
                              void* h, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(h))
    return launch<true>(af, bf, h0f, hf, B, S, W, s);
  return launch<false>(af, bf, h0f, hf, B, S, W, s);
}
