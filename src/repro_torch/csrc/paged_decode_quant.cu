// Paged flash-decode attention over an int8 block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode/kernel.py
// paged_flash_decode_quant_kernel (body _pd_quant_kernel): the same
// one-query GQA attention as paged_decode.cu, over int8 K/V pools
// [NB, Hkv, bs, hd] with one f32 scale per (block, head, token) in
// [NB, Hkv, bs].
//
// Bound: device memory, as for the bf16 pool, at 2 x (hd + 4) bytes a token
// instead of 2 x 2 x hd (136 against 256 at hd 64). A chunk's int8 rows
// land in the ring as they are stored, 16 values a 16-byte copy, beside
// the tokens' two scales (4-byte copies); the warp converts them to bf16
// tiles in shared memory (exact: an int8 value is a bf16 value) and the
// scales multiply the scores and the probabilities instead of the values
// (paged_decode.cuh). The TPU kernel re-reads the last live block for dead
// grid steps (and looks its scales up the same way); here blocks past a
// row's length exit at once, so a block that is never read needs no
// scale.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include "paged_decode.cuh"

extern "C" int paged_decode_int8(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* lengths, void* out, int B,
                                 int Hq, int Hkv, int hd, int bs, int MB,
                                 int span, void* work, void* stream) {
  const paged_decode::Int8Pool pool{
      static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  return paged_decode::dispatch(pool, q, tables, lengths, out, B, Hq, Hkv,
                                hd, bs, MB, span, work, stream);
}
