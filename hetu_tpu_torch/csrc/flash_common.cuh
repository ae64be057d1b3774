// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): constants of the TPU kernel's semantics, the
// bf16 mma.sync m16n8k16 fragment helpers, tile loads into shared memory,
// warp reductions and the (batch, head) grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hetu_flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;   // floor of the running max (TPU: m0)
constexpr float kEmptyLse = 1e30f;  // lse of a row with no live key

constexpr int kTile = 64;      // rows of a tensor-core tile (q or kv)
constexpr int kThreads = 128;  // 4 warps per block

// C += A B on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// C 16x8 f32.  Fragment of lane (g = lane / 4, t = lane % 4): A holds rows
// g, g + 8 at columns 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2],
// a[3]); B holds rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g;
// C holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows from `row0`, 16 columns from `col0`) of a row-major
// bf16 tile in shared memory with row stride `st`
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int st, int row0, int col0, int g,
                                       int t) {
  a[0] = ld32(s + (row0 + g) * st + col0 + 2 * t);
  a[1] = ld32(s + (row0 + g + 8) * st + col0 + 2 * t);
  a[2] = ld32(s + (row0 + g) * st + col0 + 8 + 2 * t);
  a[3] = ld32(s + (row0 + g + 8) * st + col0 + 8 + 2 * t);
}

// rows [row0, row0 + 64) x columns [0, D) of a [S, d] matrix into smem,
// in 16-byte chunks (d % 8 == 0); rows >= S and columns >= d read as zero
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int d) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks, gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < S && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = val;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: the rounding the tensor-core path applies to a
// product's operand, applied in the plain-FMA path too
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid of n_tiles row tiles x n_bh (batch, head) pairs: y holds up to 65535
// pairs, z counts the slices of that many
inline dim3 bh_grid(int n_tiles, int n_bh) {
  const int y = n_bh < 65535 ? n_bh : 65535;
  return dim3(n_tiles, y, (n_bh + y - 1) / y);
}

}  // namespace hetu_flash
