// Paged flash-decode attention over a bf16 block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode/kernel.py
// paged_flash_decode_kernel. The kernel body, its bound and its design are
// in paged_decode.cuh (shared with the int8 pool's kernel); here a chunk's
// K and V rows land in the ring as bf16, 8 values a 16-byte copy, and feed
// the tensor cores as they are.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include "paged_decode.cuh"

// span: tokens a block reads (ops.py span_tokens); work: the partials of
// rows longer than one span (paged_decode.cuh dispatch), may be null when
// MB * bs <= span.
extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* lengths, void* out, int B,
                                 int Hq, int Hkv, int hd, int bs, int MB,
                                 int span, void* work, void* stream) {
  const paged_decode::Bf16Pool pool{
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool)};
  return paged_decode::dispatch(pool, q, tables, lengths, out, B, Hq, Hkv,
                                hd, bs, MB, span, work, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
