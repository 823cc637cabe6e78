// Paged flash-decode attention over a bf16 block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode/kernel.py
// paged_flash_decode_kernel. The kernel body, its bound and its design are
// in paged_decode.cuh (shared with the int8 pool's kernel); here each
// thread loads 8 bf16 values of a token's K and V row per 16-byte load.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include "paged_decode.cuh"

extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* lengths, void* out, int B,
                                 int Hq, int Hkv, int hd, int bs, int MB,
                                 int chunk, void* work, void* stream) {
  const paged_decode::Bf16Rows rows{
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool)};
  return paged_decode::dispatch(rows, q, tables, lengths, out, B, Hq, Hkv,
                                hd, bs, MB, chunk, work, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
