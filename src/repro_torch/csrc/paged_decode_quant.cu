// Paged flash-decode attention over an int8 block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode/kernel.py
// paged_flash_decode_quant_kernel (body _pd_quant_kernel): the same
// one-query GQA attention as paged_decode.cu, over int8 K/V pools
// [NB, Hkv, bs, hd] with one f32 scale per (block, head, token) in
// [NB, Hkv, bs], dequantized in registers as float(int8) * scale.
//
// Bound: device memory, as for the bf16 pool, at 2 x (hd + 4) bytes a token
// instead of 2 x 2 x hd (136 against 256 at hd 64). Each thread loads 16
// int8 values of a token's row per 16-byte load, so hd/16 threads cover a
// token (4 at hd 64) and a warp reads 8 tokens a step; the token's two
// scales are read beside its rows. The TPU kernel re-reads the last live
// block for dead grid steps (and looks its scales up the same way); here a
// block walks its table up to ceil((len+1)/bs) entries and stops, so a
// block that is never read needs no scale. Softmax and merge are those of
// paged_decode.cuh.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/__init__.py);
// launched on the caller's stream; returns cudaGetLastError().
#include "paged_decode.cuh"

extern "C" int paged_decode_int8(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* lengths, void* out, int B,
                                 int Hq, int Hkv, int hd, int bs, int MB,
                                 int chunk, void* work, void* stream) {
  const paged_decode::Int8Rows rows{
      static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale)};
  return paged_decode::dispatch(rows, q, tables, lengths, out, B, Hq, Hkv,
                                hd, bs, MB, chunk, work, stream);
}
