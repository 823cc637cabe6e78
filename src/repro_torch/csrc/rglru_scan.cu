// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru/kernel.py
// rglru_scan_kernel (body _rglru_kernel) and computes what the JAX
// package's sequential oracle (kernels/rglru/ref.py rglru_ref_loop)
// computes: per (row, channel), from h0 (zeros when absent), each step a
// product and a sum in f32, rounded separately (no fused multiply-add), so
// the kernel equals the plain PyTorch version bit for bit.
//
// Layout: a, b, h [B, S, W] f32, h0 [B, W] f32 or null.
//
// Bound: device memory. Each (row, step, channel) reads 8 bytes and writes
// 4 for one multiply-add. The TPU kernel closes a time tile in parallel
// through a bounded decay matrix (O(bt^2) work a tile, so the VPU avoids a
// serial loop) and carries the state across a sequential grid axis. Here
// each thread owns one (row, channel) and walks the time axis itself with
// the state in a register: neighbouring threads take neighbouring channels,
// so every step's loads and stores are coalesced along W, and kT steps'
// loads are issued together before their serial multiply-adds, so the
// loop waits on memory once per kT steps rather than once a step. Any S
// is taken (the TPU kernel asserts S % bt == 0). B * W threads (4096 at
// B = 1, W = 4096: 64 blocks of 64) leave half the SMs idle at batch 1; a
// chunked two-pass scan (per-chunk carries, then a fix-up) that fills the
// card is work for a later speed change.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kT = 16;  // steps whose loads are issued together

__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const int64_t base = (int64_t)row * S * W + w;
  float hv = h0 != nullptr ? h0[(int64_t)row * W + w] : 0.f;
  int t = 0;
  for (; t + kT <= S; t += kT) {
    float av[kT], bv[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const int64_t off = base + (int64_t)(t + i) * W;
      av[i] = a[off];
      bv[i] = b[off];
    }
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      hv = __fadd_rn(__fmul_rn(av[i], hv), bv[i]);
      h[base + (int64_t)(t + i) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const int64_t off = base + (int64_t)t * W;
    hv = __fadd_rn(__fmul_rn(a[off], hv), b[off]);
    h[off] = hv;
  }
}

}  // namespace

extern "C" int rglru_scan_f32(const void* a, const void* b, const void* h0,
                              void* h, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), S, W);
  return (int)cudaGetLastError();
}
