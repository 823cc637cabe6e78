// Warp-level pieces of attention on the tensor cores (sm_80+ mma.sync,
// built for sm_90a), shared by flash attention (flash_attention.cu), the
// bf16 flash-decoding kernel (flash_decode.cu) and paged decode
// (paged_decode.cuh).
//
// The kernels keep the reference's arithmetic (the TPU kernels take q, k
// and v to f32 and keep the probabilities in f32 through P.V):
//
// - Q.K^T runs as mma.m16n8k16 with bf16 operands and f32 accumulation.
//   The product of two bf16 values is exact in f32, so only the order of
//   the sum differs from an f32 dot product.
// - P.V must not round each probability to one bf16: that is a relative
//   error of up to 2^-8, far outside the 1e-5 that flash-decoding's
//   partials are held to. So P is split: hi = bf16(p), lo = bf16(p - hi),
//   and two MMAs against the same V fragment add hi.V + lo.V into one f32
//   accumulator. hi + lo keeps 16 significant bits of p (an error of at
//   most 2^-16 of p, ~4e-6 on average), for one extra P.V MMA: the
//   tensor-core work is 1.5x that of the two products. V is bf16 on the
//   main path, so it is exact as an operand.
//
// Tiles of K, V and Q are staged in shared memory as bf16 rows padded by
// 16 bytes (kPad values): the eight 16-byte rows that one ldmatrix phase
// reads then start 4 banks apart and cover all 32 banks, so ldmatrix and
// ldmatrix.trans are free of bank conflicts at every head_dim that is a
// multiple of 8. Copies into shared memory are cp.async.cg (16 bytes, L2
// only; a source size of 0 fills zeros, so a ragged tile's missing rows
// and a head_dim's padding columns are zeros).
//
// Fragment layouts (PTX ISA, mma.m16n8k16, lane = 4 * g + t):
//   A (16 x 16, row): a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//                     a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..);
//   B (16 x 8, col):  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C (16 x 8, f32):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the score accumulators of two neighbouring 8-key tiles are, packed to
// bf16 pairs, the A fragment of the next MMA over those 16 keys
// (pack_pv_operands): P never leaves the registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attention_mma {

constexpr int kPad = 8;              // bf16 values of padding a staged row
constexpr float kMaskValue = -1e30f; // the TPU kernels' NEG_INF

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `valid` false fills zeros
// (the source is not read, but must be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// ... 4 bytes, through L1 (cp.async.cg takes only 16): paged decode's
// per-token int8 scales
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed (lane 4g + t gets rows 2t, 2t+1 of
// column g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a . b: a 16x16 bf16 A fragment, b 16x8 bf16 (b0, b1), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) as hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y); x in the
// low half (the fragment's lower column)
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi and lo) of P over keys 16i..16i+15 from the f32
// accumulators of key tiles 2i (c0) and 2i+1 (c1)
__device__ __forceinline__ void pack_pv_operands(const float (&c0)[4],
                                                 const float (&c1)[4],
                                                 uint32_t (&hi)[4],
                                                 uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// Row addresses a lane gives ldmatrix_x4 on a tile of `stride`-value rows:
// the A fragment of rows r0..r0+15, cols c0..c0+15
__device__ __forceinline__ const __nv_bfloat16* a_rows(
    const __nv_bfloat16* tile, int stride, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * stride + c0 + (lane >> 4) * 8;
}

// ... B fragments of two 8-key tiles (keys r0..r0+15 as rows of K) over
// cols c0..c0+15: regs 0, 1 key tile r0 (b0, b1); 2, 3 key tile r0+8
__device__ __forceinline__ const __nv_bfloat16* k_rows(
    const __nv_bfloat16* tile, int stride, int r0, int c0, int lane) {
  const int mi = lane >> 3;
  return tile + (r0 + (mi >> 1) * 8 + (lane & 7)) * stride + c0 + (mi & 1) * 8;
}

// ... B fragments (with ldmatrix_x4_trans) of V rows r0..r0+15 (the k
// dimension) over two 8-column tiles c0, c0+8: regs 0, 1 column tile c0;
// 2, 3 column tile c0+8
__device__ __forceinline__ const __nv_bfloat16* v_rows(
    const __nv_bfloat16* tile, int stride, int r0, int c0, int lane) {
  const int mi = lane >> 3;
  return tile + (r0 + (mi & 1) * 8 + (lane & 7)) * stride + c0 + (mi >> 1) * 8;
}

// max and sum over the four lanes that share a fragment row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax step for the two rows a lane holds (g: c[j][0..1],
// g+8: c[j][2..3]) over NT 8-key tiles of scores already scaled and
// masked: m[r] the running max (quad-uniform), l[r] this lane's share of
// the running sum (summed over the quad at the end). The scores become
// exp(s - m_new); returns each row's rescale of the accumulator in corr.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kMaskValue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * r] = expf(s[j][2 * r] - m_new);
      s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);
      sum += s[j][2 * r] + s[j][2 * r + 1];
    }
    corr[r] = expf(m[r] - m_new);  // the first tile: exp(-1e30 - m) = 0
    l[r] = fmaf(l[r], corr[r], sum);
    m[r] = m_new;
  }
}

}  // namespace attention_mma
