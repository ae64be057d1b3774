// The attention-dropout keep bit: a stateless counter-based hash of
// (seed, bh, row, col) in global coordinates, shared by the flash forward,
// dQ and dK/dV kernels and the keep-mask helper.
//
// The Pallas TPU kernels reseed the TPU PRNG per (seed, tile)
// (hetu_tpu/ops/pallas/flash_attention.py `_tile_keep`/`_tile_index`), a
// scheme bound to the TPU's 512-wide tiles and its PRNG.  Here the bit of
// each element is a pure function of its coordinates, so the backward
// kernels may tile differently from the forward and still replay the mask
// exactly, and the plain PyTorch version (`dropout_keep_mask_plain` in
// ops/kernels/flash_attention.py) reproduces it bit for bit.
//
// mix(h, x) = fmix32((h ^ x) + golden): murmur3's 32-bit finaliser after
// folding in one coordinate.  row_key = mix(mix(fmix32(seed), bh), row) is
// computed once per query row; an element's bits are mix(row_key, col).
// An element is kept iff its bits < threshold = min(floor(keep * 2^32),
// 2^32 - 1), as the TPU kernel's `_keep_threshold`.

#pragma once

#include <stdint.h>

namespace hetu_dropout {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t x) {
  return fmix32((h ^ x) + 0x9E3779B9u);
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t bh,
                                            uint32_t row) {
  return mix(mix(fmix32(seed), bh), row);
}

__device__ __forceinline__ bool keep(uint32_t row_key, uint32_t col,
                                     uint32_t threshold) {
  return mix(row_key, col) < threshold;
}

}  // namespace hetu_dropout
