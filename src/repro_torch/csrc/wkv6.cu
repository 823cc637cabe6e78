// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py wkv6_kernel
// (body _wkv_kernel) and computes what the JAX package's sequential oracle
// (kernels/rwkv6/ref.py wkv6_ref) computes: per (row, head) an [hd, hd]
// state S, from zero, and for each step t
//
//   o_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
//
// w_t = exp(logw_t), in f32 throughout; o and the final S in f32.
//
// Layout: r, k, v [B, S, H, hd] bf16 (the model's layout, straight from the
// projections), logw [B, S, H, hd] f32, u [H, hd] f32; o [B, S, H, hd] f32,
// s_final [B, H, hd, hd] f32 (s_final[c][d] = S[c][d]).
//
// Bound: device memory at these shapes. A step of one head reads
// 3 * 2 hd + 4 hd bytes and writes 4 hd for about 4 hd^2 f32 operations
// (the read of S through r, the bonus term, the decayed update): at hd = 64
// that is ~18 operations a byte, near the f32 CUDA cores' balance point.
// The TPU kernel closes a time chunk in parallel through a pairwise decay
// tensor and two MXU products against the carried state. Here one block of
// hd threads owns one (row, head); thread j keeps column j of S (hd floats)
// in registers for the whole sequence, so the state never leaves the SM.
// kT steps of r, k and w are staged in shared memory at once (thread j
// loads element j of each: coalesced), each thread keeps its own v values,
// and the block then runs the kT steps serially with one barrier per
// chunk, not two a step. Any S is taken (the TPU kernel asserts
// S % chunk == 0). B * H blocks (32 at B = 1, H = 32) use a quarter of the
// SMs: splitting the state's columns over more blocks, or a chunked form
// on the tensor cores, is work for a later speed change.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;  // steps staged per barrier

template <int HD>
__global__ void __launch_bounds__(HD) wkv6_kernel(
    const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, float* __restrict__ o,
    float* __restrict__ s_final, int S, int H) {
  __shared__ float rs[kT][HD];
  __shared__ float ks[kT][HD];
  __shared__ float ws[kT][HD];
  __shared__ float us[HD];
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t stride = (int64_t)H * HD;  // one step
  const int64_t base = (int64_t)b * S * stride + (int64_t)h * HD + j;
  us[j] = u[(int64_t)h * HD + j];

  float st[HD];  // column j of S
#pragma unroll
  for (int c = 0; c < HD; ++c) st[c] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    float vv[kT];
    __syncthreads();  // the last chunk's readers are done
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      if (i < n) {
        const int64_t off = base + (int64_t)(t0 + i) * stride;
        rs[i][j] = __bfloat162float(r[off]);
        ks[i][j] = __bfloat162float(k[off]);
        ws[i][j] = expf(logw[off]);
        vv[i] = __bfloat162float(v[off]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      if (i < n) {
        const float vj = vv[i];
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          const float kc = ks[i][c];
          const float att = st[c] + us[c] * kc * vj;
          acc = fmaf(rs[i][c], att, acc);
          st[c] = fmaf(ws[i][c], st[c], kc * vj);
        }
        o[base + (int64_t)(t0 + i) * stride] = acc;
      }
    }
  }
  float* sf = s_final + ((int64_t)b * H + h) * HD * HD + j;
#pragma unroll
  for (int c = 0; c < HD; ++c) sf[(int64_t)c * HD] = st[c];
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* o, void* s_final, int B, int S, int H,
           cudaStream_t stream) {
  wkv6_kernel<HD><<<dim3(H, B), HD, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(s_final), S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, void* o,
                         void* s_final, int B, int S, int H, int hd,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(r, k, v, logw, u, o, s_final, B, S, H, s);
    case 32: return launch<32>(r, k, v, logw, u, o, s_final, B, S, H, s);
    case 64: return launch<64>(r, k, v, logw, u, o, s_final, B, S, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
