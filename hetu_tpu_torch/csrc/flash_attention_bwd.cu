// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// a dQ kernel and a dK/dV kernel.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// of `_bwd_impl` in hetu_tpu/ops/pallas/flash_attention.py (pl.pallas_call
// at lines 448 and 463).  Both recompute P = exp2(s * scale * log2(e) +
// mask * log2(e) - lse * log2(e)) from (Q, K, lse) in f32 instead of
// reading a stored P, and take D = rowsum(dO * O) from the caller (it is
// jnp outside the kernels in JAX, flash_attention.py:414-416):
//
//   dQ kernel,   one block per (bh, 64-row q tile), looping over kv tiles:
//     dP = dO V^T (dropped by the replayed mask), dS = P * (dP - D),
//     dQ = scale * sum_j dS_j K_j          (flash_attention.py:317-334)
//   dK/dV kernel, one block per (bh, 64-key kv tile), looping over q tiles:
//     dV = sum_i P~^T dO with P~ = dropout(P) / keep,
//     dK = scale * sum_i dS^T Q with dS = P * (dropout(dP) / keep - D)
//                                          (flash_attention.py:353-404)
//
// As in JAX there are two kernels and no atomics: each output tile is
// written by exactly one block, so the result is the same run to run.
// Causal kv tiles above the diagonal are skipped (dQ) and q tiles above it
// are never visited (dK/dV), as at flash_attention.py:328-333 and :395-400.
// The blockwise (ring) backward, `flash_attention_block_bwd`
// (flash_attention.py:568), runs the same two kernels with global offsets,
// a K/V length of its own and the ring's group layout (Blocks in
// flash_common.cuh): the tile bounds are JAX's, clamped to [0, n], and it
// takes the COMBINED lse of the whole ring, so P is each block's share of
// the global softmax and a row that the block does not see has P = 0.
// Rows whose every key was masked have lse = +1e30 from the forward, so
// their P is 0 and they contribute no gradient.  Ragged S and d are masked
// inside the kernels (out-of-range rows and keys get P = 0, out-of-range
// head-dim columns read as zero and are not stored), so the wrapper never
// pads.  Dropout replays the forward's keep bits from the stateless hash of
// dropout_hash.cuh on global (seed, bh, row, col), although these kernels
// tile differently from the forward.  dS and P~ are rounded to the inputs'
// dtype before their products, as the TPU kernel does (`.astype`).
//
// What bounds it on the H100: at BERT-base shapes (S=512, d=64) dQ does
// three products of 2*S^2*d per head and dK/dV four; their bf16
// tensor-core time (989 TFLOP/s) is above the time of the ~5-6 [S, d]
// tensors each reads and writes (3.35 TB/s), so both are bound by the
// operations.  The kernel of a launch is the route the Python wrapper
// names from dtype and shape (`flash_route`) and passes in:
// - wgmma (bf16, d = 64, 80 or 128): `flash_bwd_dq_wgmma`, built for Hopper
//   as flash_attention_fwd.cu's `flash_fwd_wgmma` (flash_hopper.cuh): a
//   persistent block per SM, a producer warp feeding each 128-row item's
//   Q and dO once and its K/V tiles of 64 keys by TMA into 3 stages on
//   mbarriers, two consumer warpgroups running S = Q K^T and dP = dO V^T
//   on wgmma from shared memory and dQ += dS K with dS from registers and
//   K through the descriptor's transpose bit.  64 keys a tile keep two
//   64 x 64 score tiles and the 64 x d accumulator within the 168
//   registers a thread of a 9-warp block gets.  `flash_bwd_dkv_wgmma`,
//   the same pieces turned around: an item of 128 keys whose K/V stay in
//   shared memory, the q tiles streamed past them, two 64 x d accumulators
//   a warpgroup in an 8-warp block of 255 registers a thread (its header
//   below).  Both take GPT-3 2.7B's heads of 80 in the forward's layout
//   of 64-column halves.
// - mma (bf16 with d % 8 == 0 and d <= 128 that wgmma does not take):
//   mma.sync.m16n8k16, 4 warps of 16 rows each, 64x64 score tiles in
//   registers, the Q/dO/K/V tiles in shared memory.
// - simt (f32, and bf16 heads the others do not take): plain-FMA kernels
//   that stay in f32 (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace hetu_flash;
using namespace hetu_hopper;
using bf16 = __nv_bfloat16;

// -------------------------------------------------------------------------
// bf16 tensor-core kernels

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles (rows padded by 8 elements) + the kv tile's mask
  return (size_t)4 * kTile * (D + 8) * sizeof(bf16) + kTile * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles + the q tile's lse (base 2), D and dropout row keys
  return (size_t)4 * kTile * (D + 8) * sizeof(bf16) +
         3 * kTile * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     const float* __restrict__ mask,
                     const int32_t* __restrict__ seed, bf16* __restrict__ dq,
                     int n_bh, int H, Blocks bl, int d, int causal,
                     float scale, float scale_log2, uint32_t thr,
                     float inv_keep) {
  constexpr int ST = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kTile * ST;
  bf16* sK = sdO + kTile * ST;
  bf16* sV = sK + kTile * ST;
  float* sMask = reinterpret_cast<float*>(sV + kTile * ST);

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh >= n_bh) return;  // the tail of the last z slice
  const int b = bh / H;
  const size_t qbase = (size_t)bh * bl.Sq * d, kbase = (size_t)bh * bl.Sk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // per-row lse (base 2), D and dropout row key; rows past S get
  // lse = +inf, so their P is 0
  float lse2[2], dsm[2];
  uint32_t rk[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < bl.Sq;
    lse2[i] = in ? lse[(size_t)bh * bl.Sq + rows[i]] * kLog2e : INFINITY;
    dsm[i] = in ? dsum[(size_t)bh * bl.Sq + rows[i]] : 0.f;
    if (seed) rk[i] = hetu_dropout::row_key((uint32_t)*seed, bh, rows[i]);
  }

  load_tile<D>(sQ, q + qbase, q0, bl.Sq, d);
  load_tile<D>(sdO, dout + qbase, q0, bl.Sq, d);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  // the K/V rows [kb, ke) of this tile's group's block, its live kv tiles
  // (JAX's hi, flash_attention.py:330), a key's position minus a row's
  const int kb = bl.kv_begin(q0 / bl.gq()), ke = kb + bl.gk();
  const int n_tiles = kv_tiles(bl, causal, q0, kTile, kb, kTile);
  const int dpos = bl.k_off - bl.q_off;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kb + j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k + kbase, k0, ke, d);
    load_tile<D>(sV, v + kbase, k0, ke, d);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      sMask[threadIdx.x] =
          key >= ke ? -INFINITY
                    : (mask ? mask[(size_t)b * bl.Sk + key] * kLog2e : 0.f);
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, ST, warp * 16, kc * 16, g, t);
      load_a(da, sdO, ST, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const bf16* kr = sK + (n * 8 + g) * ST + kc * 16 + 2 * t;
        const bf16* vr = sV + (n * 8 + g) * ST + kc * 16 + 2 * t;
        mma_bf16(s[n], qa, ld32(kr), ld32(kr + 8));
        mma_bf16(dp[n], da, ld32(vr), ld32(vr + 8));
      }
    }
    // dS = P * (dropout(dP) - D), into s
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale_log2 + sMask[col];
        if (causal && k0 + col + dpos > rows[i]) x = -INFINITY;
        const float p = exp2f(x - lse2[i]);
        float dpv = dp[n][e];
        if (seed)
          dpv = hetu_dropout::keep(rk[i], k0 + col, thr) ? dpv * inv_keep
                                                          : 0.f;
        s[n][e] = p * (dpv - dsm[i]);
      }
    }
    // dQ += dS K: the dS accumulator fragments are dS's A fragments
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* kr = sK + (kk * 16 + 2 * t) * ST + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const bf16* kp = kr + nd * 8;
        mma_bf16(acc[nd], pa, pack_bf16(kp, kp + ST),
                 pack_bf16(kp + 8 * ST, kp + 9 * ST));
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < bl.Sq)
        *reinterpret_cast<uint32_t*>(dq + qbase + (size_t)rows[i] * d + col) =
            pack_bf16(acc[nd][2 * i] * scale, acc[nd][2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      const float* __restrict__ mask,
                      const int32_t* __restrict__ seed,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int n_bh,
                      int H, Blocks bl, int d, int causal, float scale,
                      float scale_log2, uint32_t thr, float inv_keep) {
  constexpr int ST = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * ST;
  bf16* sQ = sV + kTile * ST;
  bf16* sdO = sQ + kTile * ST;
  float* sLse2 = reinterpret_cast<float*>(sdO + kTile * ST);
  float* sD = sLse2 + kTile;
  uint32_t* sRk = reinterpret_cast<uint32_t*>(sD + kTile);

  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh >= n_bh) return;
  const int b = bh / H;
  const size_t qbase = (size_t)bh * bl.Sq * d, kbase = (size_t)bh * bl.Sk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // this warp's 16 keys are the rows of its fragments: keys[0], keys[1]
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float kmask[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kmask[i] = keys[i] >= bl.Sk
                   ? -INFINITY
                   : (mask ? mask[(size_t)b * bl.Sk + keys[i]] * kLog2e : 0.f);
  const uint32_t sd = seed ? (uint32_t)*seed : 0u;

  load_tile<D>(sK, k + kbase, k0, bl.Sk, d);
  load_tile<D>(sV, v + kbase, k0, bl.Sk, d);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  // the q rows [qb, qe) of the group that attends this tile's block; q
  // tiles wholly above the diagonal see none of this kv tile, and with
  // none left the tile writes dk = dv = 0
  const int qb = bl.q_begin(k0 / bl.gk()), qe = qb + bl.gq();
  const int n_q = (bl.gq() + kTile - 1) / kTile;
  const int dpos = bl.k_off - bl.q_off;
  for (int i = first_q_tile(bl, causal, k0, qb, kTile); i < n_q; ++i) {
    const int q0 = qb + i * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sQ, q + qbase, q0, qe, d);
    load_tile<D>(sdO, dout + qbase, q0, qe, d);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool in = row < qe;
      sLse2[threadIdx.x] =
          in ? lse[(size_t)bh * bl.Sq + row] * kLog2e : INFINITY;
      sD[threadIdx.x] = in ? dsum[(size_t)bh * bl.Sq + row] : 0.f;
      sRk[threadIdx.x] = seed ? hetu_dropout::row_key(sd, bh, row) : 0u;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, ST, warp * 16, kc * 16, g, t);
      load_a(va, sV, ST, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const bf16* qr = sQ + (n * 8 + g) * ST + kc * 16 + 2 * t;
        const bf16* dr = sdO + (n * 8 + g) * ST + kc * 16 + 2 * t;
        mma_bf16(s[n], ka, ld32(qr), ld32(qr + 8));
        mma_bf16(dp[n], va, ld32(dr), ld32(dr + 8));
      }
    }
    // P~^T into s (for dV) and dS^T into dp (for dK)
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qc = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale_log2 + kmask[i];
        if (causal && keys[i] + dpos > q0 + qc) x = -INFINITY;
        const float p = exp2f(x - sLse2[qc]);
        float pd = p, dpv = dp[n][e];
        if (seed) {
          if (hetu_dropout::keep(sRk[qc], keys[i], thr)) {
            pd *= inv_keep;
            dpv *= inv_keep;
          } else {
            pd = dpv = 0.f;
          }
        }
        s[n][e] = pd;
        dp[n][e] = p * (dpv - sD[qc]);
      }
    }
    // dV += P~^T dO and dK += dS^T Q over this tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const bf16* dor = sdO + (kk * 16 + 2 * t) * ST + g;
      const bf16* qr = sQ + (kk * 16 + 2 * t) * ST + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const bf16* op = dor + nd * 8;
        const bf16* qp = qr + nd * 8;
        mma_bf16(dv_acc[nd], pa, pack_bf16(op, op + ST),
                 pack_bf16(op + 8 * ST, op + 9 * ST));
        mma_bf16(dk_acc[nd], da, pack_bf16(qp, qp + ST),
                 pack_bf16(qp + 8 * ST, qp + 9 * ST));
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (keys[i] >= bl.Sk) continue;
      const size_t off = kbase + (size_t)keys[i] * d + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(
          dk_acc[nd][2 * i] * scale, dk_acc[nd][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(dv_acc[nd][2 * i], dv_acc[nd][2 * i + 1]);
    }
  }
}

// -------------------------------------------------------------------------
// Hopper dQ kernel for bf16 heads of d = 64, 80 and 128 (`_bwd_dq_kernel`,
// flash_attention.py:284-335), persistent as flash_fwd_wgmma: 2 consumer
// warpgroups of 64 query rows (a 128-row q tile) and 1 producer warp.  For
// each work item the producer loads Q and dO by TMA into one of two
// buffers, then the K/V tiles of 64 keys through a ring of stages with
// their key masks.  Each consumer warpgroup runs S = Q K^T and dP = dO V^T
// on wgmma from shared memory, forms dS = P * (dropout(dP) - D) in
// registers, and accumulates dQ += dS K on wgmma with dS from registers
// and K through the descriptor's transpose bit.  Each dQ row is one
// warpgroup's: no atomics, the same bits on every launch.
//
// d = 80 (GPT-3 2.7B's heads) takes the forward's layout (`FwdTiles`): a
// Q, dO, K or V tile is two 64-column halves, the second filled by TMA in
// columns 64-79 and zeros past them, so a buffer holds, and its mbarrier
// expects, two full boxes.  S and dP run 5 k-steps of 16 (the fifth at the
// start of the second half), and dQ += dS K one m64n80k16 a 16-key step
// (`wgmma_rs_n80`), K read across both halves through the descriptor's
// LBO: no product reads a zero-filled column.  Its 40 accumulator
// registers sit between d = 64's 32 and d = 128's 64, beside the two
// score tiles and the dS fragments.  The work width, 80, is used where dq
// rows are stored or zero-filled.  Other bf16 heads up to 128, and ring
// groups that are not whole 128-row q tiles, take `flash_bwd_dq_mma`.

template <int D>
struct DqTiles {
  static constexpr int BN = 64;  // keys of a kv tile
  static constexpr int kStages = 3;
  // 64-column halves of a tile: its layout is 64 * kHalves columns wide,
  // wider than the D columns of work at d = 80, and a buffer's bytes,
  // which the mbarriers expect, are what TMA delivers, zero-filled columns
  // included (as `FwdTiles`)
  static constexpr int kHalves = (D + 63) / 64;
  static constexpr int kQBytes = kHopperBM * kHalves * 128;  // Q or dO
  static constexpr int kTileBytes = BN * kHalves * 128;  // one K or V tile
  // 2 buffers of Q and dO, 3 stages of K and V: 112 KB at d = 64, 224 KB
  // at d = 80 and 128 (231,248 bytes with the masks and barriers)
  static constexpr size_t kSmem = 1024 + 4 * kQBytes +
                                  (size_t)kStages * 2 * kTileBytes +
                                  kStages * BN * sizeof(float) +
                                  (4 + 2 * kStages) * sizeof(uint64_t);
};

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       const float* __restrict__ mask,
                       const int32_t* __restrict__ seed,
                       bf16* __restrict__ dq, int n_bh, int H, Blocks bl,
                       int causal, float scale, float scale_log2,
                       uint32_t thr, float inv_keep) {
  using T = DqTiles<D>;
  constexpr int BM = kHopperBM, BN = T::BN, NS = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_hopper[];
  unsigned char* sQ = align1024(smem_hopper);  // buffer b: Q, then dO
  unsigned char* sKV = sQ + 4 * T::kQBytes;     // stage s: K, then V
  float* sMask = reinterpret_cast<float*>(sKV + NS * 2 * T::kTileBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sMask + NS * BN);

  const uint32_t bar0 = smem_u32(bars);
  // barriers: buffer b full, buffer b free, stage s full, stage s free
  auto q_full = [&](int b) { return bar0 + 8u * b; };
  auto q_free = [&](int b) { return bar0 + 8u * (2 + b); };
  auto full = [&](int s) { return bar0 + 8u * (4 + s); };
  auto empty = [&](int s) { return bar0 + 8u * (4 + NS + s); };
  auto q_buf = [&](int b) { return smem_u32(sQ) + b * 2 * T::kQBytes; };
  auto k_tile = [&](int s) { return smem_u32(sKV) + s * 2 * T::kTileBytes; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_free(b), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int n_qt = (bl.Sq + BM - 1) / BM, n_items = n_qt * n_bh;

  if (warp == 8) {
    // producer: an item's Q and dO into buffer qi % 2 once the item two
    // before it is done with it, then its K/V tiles, the tj-th of the
    // block into stage tj % NS once that stage is free
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tdo);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
    }
    int qi = 0, tj = 0;
    for (int it = 0;; ++it) {
      const int i = snake_item(it, blockIdx.x, gridDim.x);
      if (i >= n_items) break;
      const WorkItem w = work_item(i, n_qt, n_bh, causal, bl, BN);
      if (w.n_tiles == 0) continue;
      if (lane == 0) {
        const int qb = qi & 1;
        mbar_wait(q_free(qb), ((qi >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full(qb), 2 * T::kQBytes);
#pragma unroll
        for (int h = 0; h < T::kHalves; ++h) {
          tma_load_3d(q_buf(qb) + h * BM * 128, &tq, q_full(qb), h * 64,
                      w.q0, w.bh);
          tma_load_3d(q_buf(qb) + T::kQBytes + h * BM * 128, &tdo,
                      q_full(qb), h * 64, w.q0, w.bh);
        }
      }
      const int b = w.bh / H;
      for (int j = 0; j < w.n_tiles; ++j, ++tj) {
        const int s = tj % NS, k0 = w.kb + j * BN;
        mbar_wait(empty(s), ((tj / NS) & 1) ^ 1);
        for (int c = lane; c < BN; c += 32) {
          const int key = k0 + c;
          sMask[s * BN + c] =
              key >= w.ke
                  ? -INFINITY
                  : (mask ? mask[(size_t)b * bl.Sk + key] * kLog2e : 0.f);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full(s), 2 * T::kTileBytes);
#pragma unroll
          for (int h = 0; h < T::kHalves; ++h) {
            tma_load_3d(k_tile(s) + h * BN * 128, &tk, full(s), h * 64, k0,
                        w.bh);
            tma_load_3d(k_tile(s) + T::kTileBytes + h * BN * 128, &tv,
                        full(s), h * 64, k0, w.bh);
          }
        }
      }
      ++qi;
    }
    return;
  }

  // consumers: warpgroup wg owns rows [r_wg, r_wg + 64) of each item
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  int qi = 0, tj = 0;
  for (int it = 0;; ++it) {
    const int i = snake_item(it, blockIdx.x, gridDim.x);
    if (i >= n_items) break;
    const WorkItem w = work_item(i, n_qt, n_bh, causal, bl, BN);
    const int bh = w.bh, q0 = w.q0;
    if (w.n_tiles == 0) {  // no live key: dq = 0
      for (int x = threadIdx.x; x < BM * D / 8; x += 256) {
        const int row = q0 + x / (D / 8);
        if (row < bl.Sq)
          reinterpret_cast<uint4*>(dq + ((size_t)bh * bl.Sq + row) *
                                            D)[x % (D / 8)] =
              make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    const int r_wg = q0 + wg * 64;
    const int row_a = r_wg + (warp % 4) * 16 + g;  // and row_a + 8
    const int my_tiles = kv_tiles(bl, causal, r_wg, 64, w.kb, BN);
    const int dpos = bl.k_off - bl.q_off;
    // per-row lse (base 2), D and dropout row key; rows past S get
    // lse = +inf, so their P is 0
    float lse2[2], dsm[2];
    uint32_t rk[2] = {0u, 0u};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      const bool in = row < bl.Sq;
      lse2[r] = in ? lse[(size_t)bh * bl.Sq + row] * kLog2e : INFINITY;
      dsm[r] = in ? dsum[(size_t)bh * bl.Sq + row] : 0.f;
      if (seed) rk[r] = hetu_dropout::row_key((uint32_t)*seed, bh, row);
    }
    float acc[D / 2], s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) s[x] = dp[x] = 0.f;
    const int qb = qi & 1;
    const uint32_t q_wg = q_buf(qb) + wg * 64 * 128;
    const uint32_t do_wg = q_wg + T::kQBytes;

    mbar_wait(q_full(qb), (qi >> 1) & 1);
    for (int j = 0; j < w.n_tiles; ++j, ++tj) {
      const int st = tj % NS, k0 = w.kb + j * BN;
      mbar_wait(full(st), (tj / NS) & 1);
      if (j < my_tiles) {
        const uint32_t kt = k_tile(st), vt = kt + T::kTileBytes;
        // S = Q K^T and dP = dO V^T: 64 rows x BN keys each, D / 16
        // k-steps (the fifth of d = 80 at the start of the second half)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = (kk / 4) * BM * 128 + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * BN * 128 + (kk % 4) * 32;
          wgmma_ss<BN, 0>(s, desc_sw128(q_wg + qo, 16, 1024),
                          desc_sw128(kt + ko, 16, 1024), kk > 0);
          wgmma_ss<BN, 0>(dp, desc_sw128(do_wg + qo, 16, 1024),
                          desc_sw128(vt + ko, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P from the base-2 scores and lse: the key mask (with the keys
        // past the block's end) only on tiles that have one, the causal
        // exclusion only on tiles the diagonal crosses
        const bool masked = mask != nullptr || k0 + BN > w.ke;
        const bool diag = causal && k0 + BN - 1 + dpos > r_wg;
        if (masked || diag) {
          const float* tmask = sMask + st * BN;
#pragma unroll
          for (int x = 0; x < BN / 2; x += 2) {
            const int r = (x >> 1) & 1, col = (x / 4) * 8 + 2 * t;
            const float2 mk = *reinterpret_cast<const float2*>(tmask + col);
            float x0 = s[x] * scale_log2 + mk.x;
            float x1 = s[x + 1] * scale_log2 + mk.y;
            if (diag) {
              const int row = row_a + 8 * r;
              if (k0 + col + dpos > row) x0 = -INFINITY;
              if (k0 + col + 1 + dpos > row) x1 = -INFINITY;
            }
            s[x] = ex2(x0 - lse2[r]);
            s[x + 1] = ex2(x1 - lse2[r]);
          }
        } else {
#pragma unroll
          for (int x = 0; x < BN / 2; ++x)
            s[x] = ex2(fmaf(s[x], scale_log2, -lse2[(x >> 1) & 1]));
        }
        // dS = P * (dropout(dP) - D) as bf16 A fragments, one per 16 keys
        uint32_t da[BN / 16][4];
#pragma unroll
        for (int x = 0; x < BN / 2; x += 2) {
          const int r = (x >> 1) & 1;
          float dp0 = dp[x], dp1 = dp[x + 1];
          if (seed) {
            const int col = k0 + (x / 4) * 8 + 2 * t;
            dp0 = hetu_dropout::keep(rk[r], col, thr) ? dp0 * inv_keep : 0.f;
            dp1 = hetu_dropout::keep(rk[r], col + 1, thr) ? dp1 * inv_keep
                                                          : 0.f;
          }
          da[x / 8][(x / 2) % 4] =
              pack_bf16(s[x] * (dp0 - dsm[r]), s[x + 1] * (dp1 - dsm[r]));
        }

        // dQ += dS K: BN / 16 k-steps of 16 keys, K MN-major (transposed),
        // its columns from 64 on in the next half (LBO)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D, 1>(acc, da[kk],
                         desc_sw128(kt + kk * 2048, BN * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    // this warpgroup's products are done with the Q and dO buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(q_free(qb));
    ++qi;

#pragma unroll
    for (int x = 0; x < D / 2; x += 2) {
      const int r = (x >> 1) & 1;
      const int col = (x / 4) * 8 + 2 * t, row = row_a + 8 * r;
      if (row < bl.Sq)
        *reinterpret_cast<uint32_t*>(dq + ((size_t)bh * bl.Sq + row) * D +
                                     col) =
            pack_bf16(acc[x] * scale, acc[x + 1] * scale);
    }
  }
}

// -------------------------------------------------------------------------
// Hopper dK/dV kernel for bf16 heads of d = 64, 80, 128 (`_bwd_dkv_kernel`,
// flash_attention.py:337-407), persistent as the other wgmma kernels.  A
// work item is (bh, a kv tile of 128 keys); each of the block's 2 consumer
// warpgroups owns 64 of its keys, keeps their K and V rows in shared
// memory for the whole item and holds their dK and dV accumulators, so
// each dK/dV row is written by one warpgroup: no atomics, the same bits on
// every launch.  An item that no query sees writes dk = dv = 0 and loads
// nothing.  The q tiles of 64 rows that see the item stream through a ring
// of stages, each holding Q and dO (TMA), the tile's lse and D (cp.async;
// zeros past the group's end, where Q and dO are TMA's zero rows and
// contribute nothing) and dropout row keys, completing on its `full`
// mbarrier.  An item's K/V land in one of two buffers, so they load under
// the previous item's last tiles.  Per q tile and warpgroup: S^T = K Q^T
// and dP^T = V dO^T on wgmma from shared memory (64 keys x 64 queries),
// then P, P~ = dropout(P) / keep and dS = P * (dropout(dP) / keep - D) in
// registers, and dV += P~^T dO, dK += dS^T Q on wgmma with P~^T and dS^T
// from registers (their accumulators converted in place to A fragments)
// and dO, Q through the descriptor's transpose bit.  Scores come out
// transposed, so the key mask is constant per thread and lse, D and the
// row keys are per column.
//
// d = 80 (GPT-3 2.7B's heads) takes the forward's layout (`FwdTiles`): a
// K, V, Q or dO tile is two 64-column halves, the second filled by TMA in
// columns 64-79 and zeros past them, so a buffer holds, and its mbarrier
// expects, two full boxes.  S^T and dP^T run 5 k-steps of 16 (the fifth
// at the start of the second half), and dV and dK one m64n80k16 product
// each a 16-query step (`wgmma_rs_n80`), dO and Q read across both halves
// through the descriptor's LBO: no product reads a zero-filled column.
//
// Registers: at d = 128 a warpgroup holds two 64 x 128 f32 accumulators
// (128 a thread), S^T and dP^T (64) and their bf16 fragments, more than
// the 168 a thread of the 9-warp block of the other two kernels.  So the
// block has 8 warps (255 registers a thread) and no producer warp: warp 0
// issues the loads between its own products (`feed`), waiting for a stage
// only when the tile it is about to read is not yet loaded.  The dropout
// code is a template parameter: compiled in where there is no seed, it
// slowed the kernel (registers and scheduling), though it never ran.  At
// d = 128, and at d = 80 with dropout, the two warpgroups take turns to
// issue their products (named barriers), so that one forms P and dS while
// the other's products run; at d = 64, where the elementwise work (the
// dropout hash on BERT's path) outweighs the products, the turns made it
// slower, and at d = 80 they cost 1% without dropout and gained 2% with
// it.  PERF.md has the measurements (tools/kernel_ab against the kernel
// without them).

constexpr int kDkvBN = 128;       // keys of a work item, 64 a warpgroup
constexpr int kDkvBQ = 64;        // q rows of a streamed tile
constexpr int kDkvThreads = 256;  // 2 consumer warpgroups

template <int D>
struct DkvTiles {
  static constexpr int BN = kDkvBN, BQ = kDkvBQ;
  // 64-column halves of a tile: its layout is 64 * kHalves columns wide,
  // wider than the D columns of work at d = 80, and a buffer's bytes,
  // which the mbarriers expect, are what TMA delivers, zero-filled columns
  // included (as `FwdTiles`)
  static constexpr int kHalves = (D + 63) / 64;
  // stages of Q and dO: 4 at d = 64 (64 KB), 2 at d = 80 and 128 (64 KB);
  // with the two K/V buffers (64 KB, 128 KB) and the per-row floats within
  // 227 KB (3 stages at d = 80 and 128 would need 232,784 bytes)
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kKvBytes = BN * kHalves * 128;    // one K or V buffer
  static constexpr int kTileBytes = BQ * kHalves * 128;  // one Q or dO tile
  // a stage's per-row values: lse and D interleaved ({lse 2i, lse 2i + 1,
  // D 2i, D 2i + 1} for rows 2i, 2i + 1: one 16-byte read a column pair),
  // then the dropout row keys
  static constexpr size_t kSmem = 1024 + 4 * (size_t)kKvBytes +
                                  (size_t)kStages * 2 * kTileBytes +
                                  kStages * 3 * BQ * sizeof(float) +
                                  (4 + 2 * kStages) * sizeof(uint64_t);
};

// A dK/dV work item: the 128 keys from k0 of (batch, head) bh, the K/V
// rows up to ke of its ring group's block, and the q tiles [first, n_q)
// of 64 rows from qb that see any of them.
struct DkvItem {
  int k0, bh, ke, qb, first, n_q;
};

// Item i of n_kt kv tiles a ring group.  Causally the tiles with the most
// q tiles come first (each group's first tiles of all heads, then the ones
// after them): the reverse of the q-tile items, whose heaviest tiles are
// the last.  Otherwise one head's tiles side by side, which stream the
// same Q and dO through L2.
__device__ __forceinline__ DkvItem dkv_item(int i, int n_kt, int n_bh,
                                            int causal, const Blocks& bl) {
  DkvItem w;
  int kt;
  if (causal) {
    const int rest = i % (n_bh * bl.n);
    w.bh = rest % n_bh;
    kt = rest / n_bh * n_kt + i / (n_bh * bl.n);
  } else {
    kt = i % (n_kt * bl.n);
    w.bh = i / (n_kt * bl.n);
  }
  const int grp = kt / n_kt;
  w.k0 = grp * bl.gk() + kt % n_kt * kDkvBN;
  w.ke = (grp + 1) * bl.gk();
  w.qb = bl.q_begin(grp);
  w.n_q = (bl.gq() + kDkvBQ - 1) / kDkvBQ;
  w.first = first_q_tile(bl, causal, w.k0, w.qb, kDkvBQ);
  return w;
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        const float* __restrict__ mask,
                        const int32_t* __restrict__ seed,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int n_bh, int H, Blocks bl, int causal, float scale,
                        float scale_log2, uint32_t thr, float inv_keep) {
  using T = DkvTiles<D>;
  constexpr int BN = T::BN, BQ = T::BQ, NS = T::kStages;
  // d = 128, and d = 80 with dropout: the warpgroups take turns to issue
  // their products (below)
  constexpr bool kTurns = D == 128 || (D == 80 && DROP);
  extern __shared__ __align__(1024) unsigned char smem_hopper[];
  unsigned char* sKV = align1024(smem_hopper);  // buffer b: K, then V
  unsigned char* sQ = sKV + 4 * T::kKvBytes;     // stage s: Q, then dO
  float* sLD = reinterpret_cast<float*>(sQ + NS * 2 * T::kTileBytes);
  uint32_t* sRk = reinterpret_cast<uint32_t*>(sLD + NS * 2 * BQ);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sRk + NS * BQ);

  const uint32_t bar0 = smem_u32(bars);
  // barriers: K/V buffer b full, K/V buffer b free, stage s full, stage s
  // free
  auto kv_full = [&](int b) { return bar0 + 8u * b; };
  auto kv_free = [&](int b) { return bar0 + 8u * (2 + b); };
  auto full = [&](int s) { return bar0 + 8u * (4 + s); };
  auto empty = [&](int s) { return bar0 + 8u * (4 + NS + s); };
  auto kv_buf = [&](int b) { return smem_u32(sKV) + b * 2 * T::kKvBytes; };
  auto q_tile = [&](int s) { return smem_u32(sQ) + s * 2 * T::kTileBytes; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(kv_full(b), 1);
      mbar_init(kv_free(b), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1 + 32);  // warp 0's TMA lane, its 32 cp.async
      mbar_init(empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int n_kt = (bl.gk() + BN - 1) / BN, n_items = n_kt * bl.n * n_bh;
  const uint32_t sd = DROP ? hetu_dropout::fmix32((uint32_t)*seed) : 0u;

  // -- the feed: warp 0's cursor over the tiles this block loads ----------
  // the item of snake index f_it (f_w, the f_ii-th with a q tile), its next
  // q tile f_j, and f_t tiles loaded so far
  int f_it = -1, f_j = 0, f_t = 0, f_ii = 0;
  uint32_t f_key = 0u;  // its head's dropout key: row_key = mix(f_key, row)
  bool f_live = true;
  DkvItem f_w{};
  auto feed_next_item = [&]() {
    for (;;) {
      const int i = snake_item(++f_it, blockIdx.x, gridDim.x);
      if (i >= n_items) {
        f_live = false;
        return;
      }
      f_w = dkv_item(i, n_kt, n_bh, causal, bl);
      if (f_w.first < f_w.n_q) {
        f_j = f_w.first;
        f_key = hetu_dropout::mix(sd, f_w.bh);
        return;
      }
    }
  };
  // whether the next tile may load now: its stage and, on an item's first
  // tile, its K/V buffer released by both warpgroups; `must`: wait for them
  auto feed_ready = [&](bool must) -> bool {
    const int s = f_t % NS, b = f_ii & 1;
    const uint32_t ps = ((f_t / NS) & 1) ^ 1, pb = ((f_ii >> 1) & 1) ^ 1;
    const bool kv = f_j == f_w.first;
    if (must) {
      mbar_wait(empty(s), ps);
      if (kv) mbar_wait(kv_free(b), pb);
      return true;
    }
    return __all_sync(0xffffffffu,
                      mbar_test(empty(s), ps) &&
                          (!kv || mbar_test(kv_free(b), pb))) != 0;
  };
  // the next tile's loads (warp 0): the rows' lse and D by cp.async and
  // their dropout row keys, then (lane 0) the item's K/V on its first tile
  // and the tile's Q and dO by TMA
  auto feed_load = [&]() {
    const int s = f_t % NS, q0 = f_w.qb + f_j * BQ, qe = f_w.qb + bl.gq();
    for (int x = lane; x < BQ; x += 32) {
      const int row = q0 + x;
      const size_t at = (size_t)f_w.bh * bl.Sq + (row < qe ? row : q0);
      float* ld = sLD + s * 2 * BQ + x / 2 * 4 + x % 2;
      cp_async_4(smem_u32(ld), lse + at, row < qe);
      cp_async_4(smem_u32(ld + 2), dsum + at, row < qe);
      if (DROP) sRk[s * BQ + x] = hetu_dropout::mix(f_key, row);
    }
    cp_async_mbar_arrive(full(s));
    __syncwarp();
    if (lane == 0) {
      if (f_j == f_w.first) {
        const int b = f_ii & 1;
        mbar_arrive_expect_tx(kv_full(b), 2 * T::kKvBytes);
#pragma unroll
        for (int h = 0; h < T::kHalves; ++h) {
          tma_load_3d(kv_buf(b) + h * BN * 128, &tk, kv_full(b), h * 64,
                      f_w.k0, f_w.bh);
          tma_load_3d(kv_buf(b) + T::kKvBytes + h * BN * 128, &tv,
                      kv_full(b), h * 64, f_w.k0, f_w.bh);
        }
      }
      mbar_arrive_expect_tx(full(s), 2 * T::kTileBytes);
#pragma unroll
      for (int h = 0; h < T::kHalves; ++h) {
        tma_load_3d(q_tile(s) + h * BQ * 128, &tq, full(s), h * 64, q0,
                    f_w.bh);
        tma_load_3d(q_tile(s) + T::kTileBytes + h * BQ * 128, &tdo, full(s),
                    h * 64, q0, f_w.bh);
      }
    }
    ++f_t;
    if (++f_j == f_w.n_q) {
      ++f_ii;
      feed_next_item();
    }
  };
  // loads the tiles below `want` whose stages are free, and waits to load
  // every tile below `need`
  auto feed = [&](int need, int want) {
    while (f_live && f_t < want && feed_ready(f_t < need)) feed_load();
  };
  if (warp == 0) {
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tdo);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
    }
    feed_next_item();
  }

  // -- consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64) ----
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const int dpos = bl.k_off - bl.q_off;
  int ii = 0, tj = 0;
  // the turns (kTurns): warpgroup wg issues its products after `bar.sync
  // 1 + wg` and hands the turn over by `bar.arrive 2 - wg`; warpgroup 0
  // goes first, and each takes two turns a q tile (S^T and dP^T, then dV
  // and dK), computing or not, so the turns stay paired
  if (kTurns && wg == 1) named_bar_arrive(1, kDkvThreads);
  for (int it = 0;; ++it) {
    const int i = snake_item(it, blockIdx.x, gridDim.x);
    if (i >= n_items) break;
    const DkvItem w = dkv_item(i, n_kt, n_bh, causal, bl);
    const size_t kbase = (size_t)w.bh * bl.Sk;
    if (w.first >= w.n_q) {  // no query sees these keys: dk = dv = 0
      for (int x = threadIdx.x; x < BN * D / 8; x += kDkvThreads) {
        const int key = w.k0 + x / (D / 8);
        if (key < w.ke) {
          const size_t off = (kbase + key) * D + x % (D / 8) * 8;
          *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      continue;
    }
    const int kw = w.k0 + wg * 64;  // this warpgroup's first key
    const int key_a = kw + (warp % 4) * 16 + g;
    const int keys[2] = {key_a, key_a + 8};
    // its first q tile; keys past the block's end (ragged S) have no work
    const int my_first =
        kw < w.ke ? first_q_tile(bl, causal, kw, w.qb, BQ) : w.n_q;
    float kmask[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      kmask[r] = keys[r] >= w.ke
                     ? -INFINITY
                     : (mask ? mask[(size_t)(w.bh / H) * bl.Sk + keys[r]] *
                                   kLog2e
                             : 0.f);
    const bool masked = mask != nullptr || kw + 64 > w.ke;
    float dk_acc[D / 2], dv_acc[D / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;
#pragma unroll
    for (int x = 0; x < BQ / 2; ++x) s[x] = dp[x] = 0.f;
    const int b = ii & 1;
    const uint32_t k_wg = kv_buf(b) + wg * 64 * 128;
    const uint32_t v_wg = k_wg + T::kKvBytes;

    for (int j = w.first; j < w.n_q; ++j, ++tj) {
      const int st = tj % NS, q0 = w.qb + j * BQ;
      // warp 0 loads this tile (and, on the item's first, its K/V) unless
      // it has already
      if (warp == 0) feed(tj + 1, tj + NS);
      if (j == w.first) mbar_wait(kv_full(b), (ii >> 1) & 1);
      mbar_wait(full(st), (tj / NS) & 1);
      if (kTurns) {
        named_bar_sync(1 + wg, kDkvThreads);
        if (j < my_first) {  // two turns without products
          named_bar_arrive(2 - wg, kDkvThreads);
          named_bar_sync(1 + wg, kDkvThreads);
          named_bar_arrive(2 - wg, kDkvThreads);
        }
      }
      if (j >= my_first) {
        const uint32_t qt = q_tile(st), dot = qt + T::kTileBytes;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, D / 16
        // k-steps (the fifth of d = 80 at the start of the second half)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk / 4) * BN * 128 + (kk % 4) * 32;
          const uint32_t qo = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          wgmma_ss<BQ, 0>(s, desc_sw128(k_wg + ko, 16, 1024),
                          desc_sw128(qt + qo, 16, 1024), kk > 0);
          wgmma_ss<BQ, 0>(dp, desc_sw128(v_wg + ko, 16, 1024),
                          desc_sw128(dot + qo, 16, 1024), kk > 0);
        }
        wgmma_commit();
        if (kTurns) named_bar_arrive(2 - wg, kDkvThreads);
        // the loads of the stage the other warpgroup has released since
        if (warp == 0) feed(0, tj + NS);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P from the base-2 scores and the columns' lse: the key mask (with
        // the keys past the block's end) only where the warpgroup has one,
        // the causal exclusion only on tiles the diagonal crosses
        const bool diag = causal && kw + 63 + dpos > q0;
        const float* tld = sLD + st * 2 * BQ;
        const uint32_t* tr = sRk + st * BQ;
        // P~^T and dS^T as bf16 A fragments, one per 16 queries
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int x = 0; x < BQ / 2; x += 2) {
          const int r = (x >> 1) & 1, col = (x / 4) * 8 + 2 * t;
          // lse and D of the columns col, col + 1
          const float4 ld = *reinterpret_cast<const float4*>(tld + col * 2);
          float x0, x1;
          if (masked || diag) {
            x0 = s[x] * scale_log2 + kmask[r];
            x1 = s[x + 1] * scale_log2 + kmask[r];
            if (diag) {
              if (keys[r] + dpos > q0 + col) x0 = -INFINITY;
              if (keys[r] + dpos > q0 + col + 1) x1 = -INFINITY;
            }
            x0 -= ld.x * kLog2e;
            x1 -= ld.y * kLog2e;
          } else {
            x0 = fmaf(s[x], scale_log2, -ld.x * kLog2e);
            x1 = fmaf(s[x + 1], scale_log2, -ld.y * kLog2e);
          }
          const float p0 = ex2(x0), p1 = ex2(x1);
          float pd0 = p0, pd1 = p1, dp0 = dp[x], dp1 = dp[x + 1];
          if (DROP) {
            const uint2 rk = *reinterpret_cast<const uint2*>(tr + col);
            if (hetu_dropout::keep(rk.x, keys[r], thr)) {
              pd0 *= inv_keep;
              dp0 *= inv_keep;
            } else {
              pd0 = dp0 = 0.f;
            }
            if (hetu_dropout::keep(rk.y, keys[r], thr)) {
              pd1 *= inv_keep;
              dp1 *= inv_keep;
            } else {
              pd1 = dp1 = 0.f;
            }
          }
          pa[x / 8][(x / 2) % 4] = pack_bf16(pd0, pd1);
          da[x / 8][(x / 2) % 4] =
              pack_bf16(p0 * (dp0 - ld.z), p1 * (dp1 - ld.w));
        }

        // dV += P~^T dO and dK += dS^T Q: BQ / 16 k-steps of 16 queries,
        // dO and Q MN-major (transposed), their columns from 64 on in the
        // next half (LBO)
        if (kTurns) named_bar_sync(1 + wg, kDkvThreads);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wgmma_rs<D, 1>(dv_acc, pa[kk],
                         desc_sw128(dot + kk * 2048, BQ * 128, 1024), 1);
          wgmma_rs<D, 1>(dk_acc, da[kk],
                         desc_sw128(qt + kk * 2048, BQ * 128, 1024), 1);
        }
        wgmma_commit();
        if (kTurns) named_bar_arrive(2 - wg, kDkvThreads);
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    // this warpgroup's products are done with the K/V buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_free(b));
    ++ii;

#pragma unroll
    for (int x = 0; x < D / 2; x += 2) {
      const int r = (x >> 1) & 1, col = (x / 4) * 8 + 2 * t;
      if (keys[r] < w.ke) {
        const size_t off = (kbase + keys[r]) * D + col;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(dk_acc[x] * scale, dk_acc[x + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(dv_acc[x], dv_acc[x + 1]);
      }
    }
  }
  // the hand-over that warpgroup 1's last turn left
  if (kTurns && wg == 0) named_bar_sync(1, kDkvThreads);
}

// -------------------------------------------------------------------------
// Plain-FMA kernels for f32 (and bf16 heads wider than 128), 4 warps, each
// lane owning NC of the d <= 32 * NC output columns.  dQ: 16 query rows per
// block (4 per warp) against kv tiles of 32 keys, one key per lane.  dK/dV:
// 8 keys per block (2 per warp) against q tiles of 32 queries, one query
// per lane.

constexpr int kDqRows = 16;
constexpr int kDqKeys = 32;
constexpr int kDqRowsPerWarp = kDqRows / (kThreads / 32);
constexpr int kDkvKeys = 8;
constexpr int kDkvRows = 32;
constexpr int kDkvKeysPerWarp = kDkvKeys / (kThreads / 32);

template <int NC>
constexpr size_t dq_simt_smem_bytes() {
  // Q, dO, K, V rows padded by one float against bank conflicts; mask
  return ((size_t)(2 * kDqRows + 2 * kDqKeys) * (32 * NC + 1) + kDqKeys) *
         sizeof(float);
}

template <int NC>
constexpr size_t dkv_simt_smem_bytes() {
  // K, V, Q, dO rows padded by one float; the q tile's lse, D, row keys
  return ((size_t)(2 * kDkvKeys + 2 * kDkvRows) * (32 * NC + 1) +
          3 * kDkvRows) * sizeof(float);
}

// rows [row0, row0 + n) of a [S, d] matrix into an f32 smem tile of row
// stride 32 * NC + 1; rows >= S and columns >= d read as zero
template <typename T, int NC>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src,
                                              int row0, int n, int S, int d) {
  constexpr int DP = 32 * NC;
  for (int idx = threadIdx.x; idx < n * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP, gr = row0 + r;
    dst[r * (DP + 1) + c] =
        (gr < S && c < d) ? to_f32(src[(size_t)gr * d + c]) : 0.f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      const float* __restrict__ mask,
                      const int32_t* __restrict__ seed, T* __restrict__ dq,
                      int n_bh, int H, Blocks bl, int d, int causal,
                      float scale, float scale_log2, uint32_t thr,
                      float inv_keep) {
  constexpr int DP = 32 * NC;
  extern __shared__ __align__(16) float smem_f[];
  float* sQ = smem_f;                        // [kDqRows][DP + 1]
  float* sdO = sQ + kDqRows * (DP + 1);      // [kDqRows][DP + 1]
  float* sK = sdO + kDqRows * (DP + 1);      // [kDqKeys][DP + 1]
  float* sV = sK + kDqKeys * (DP + 1);       // [kDqKeys][DP + 1]
  float* sMask = sV + kDqKeys * (DP + 1);    // [kDqKeys]

  const int q0 = blockIdx.x * kDqRows;
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh >= n_bh) return;
  const int b = bh / H;
  const size_t qbase = (size_t)bh * bl.Sq * d, kbase = (size_t)bh * bl.Sk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows_f32<T, NC>(sQ, q + qbase, q0, kDqRows, bl.Sq, d);
  load_rows_f32<T, NC>(sdO, dout + qbase, q0, kDqRows, bl.Sq, d);
  float lse2[kDqRowsPerWarp], dsm[kDqRowsPerWarp], acc[kDqRowsPerWarp][NC];
  uint32_t rk[kDqRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kDqRowsPerWarp; ++rr) {
    const int row = q0 + warp * kDqRowsPerWarp + rr;
    lse2[rr] = row < bl.Sq ? lse[(size_t)bh * bl.Sq + row] * kLog2e : INFINITY;
    dsm[rr] = row < bl.Sq ? dsum[(size_t)bh * bl.Sq + row] : 0.f;
    rk[rr] = seed ? hetu_dropout::row_key((uint32_t)*seed, bh, row) : 0u;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
  }

  // the K/V rows [kb, ke) of this tile's group's block (as flash_bwd_dq_mma)
  const int kb = bl.kv_begin(q0 / bl.gq()), ke = kb + bl.gk();
  const int n_tiles = kv_tiles(bl, causal, q0, kDqRows, kb, kDqKeys);
  const int dpos = bl.k_off - bl.q_off;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kb + j * kDqKeys;
    __syncthreads();
    load_rows_f32<T, NC>(sK, k + kbase, k0, kDqKeys, ke, d);
    load_rows_f32<T, NC>(sV, v + kbase, k0, kDqKeys, ke, d);
    if (threadIdx.x < kDqKeys) {
      const int key = k0 + threadIdx.x;
      sMask[threadIdx.x] =
          key >= ke ? -INFINITY
                    : (mask ? mask[(size_t)b * bl.Sk + key] * kLog2e : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kDqRowsPerWarp; ++rr) {
      const int rl = warp * kDqRowsPerWarp + rr;
      const float* qr = sQ + rl * (DP + 1);
      const float* dor = sdO + rl * (DP + 1);
      const float* kr = sK + lane * (DP + 1);
      const float* vr = sV + lane * (DP + 1);
      float sc = 0.f, dpv = 0.f;
      for (int c = 0; c < d; ++c) {
        sc = fmaf(qr[c], kr[c], sc);
        dpv = fmaf(dor[c], vr[c], dpv);
      }
      float x = sc * scale_log2 + sMask[lane];
      if (causal && k0 + lane + dpos > q0 + rl) x = -INFINITY;
      const float p = exp2f(x - lse2[rr]);
      if (seed)
        dpv = hetu_dropout::keep(rk[rr], k0 + lane, thr) ? dpv * inv_keep
                                                         : 0.f;
      const float ds = round_to<T>(p * (dpv - dsm[rr]));
#pragma unroll 4
      for (int jj = 0; jj < kDqKeys; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
        for (int i = 0; i < NC; ++i)
          acc[rr][i] = fmaf(dsj, sK[jj * (DP + 1) + lane + 32 * i],
                            acc[rr][i]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kDqRowsPerWarp; ++rr) {
    const int row = q0 + warp * kDqRowsPerWarp + rr;
    if (row >= bl.Sq) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d)
        dq[qbase + (size_t)row * d + c] = from_f32<T>(acc[rr][i] * scale);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_simt(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       const float* __restrict__ mask,
                       const int32_t* __restrict__ seed, T* __restrict__ dk,
                       T* __restrict__ dv, int n_bh, int H, Blocks bl, int d,
                       int causal, float scale, float scale_log2,
                       uint32_t thr, float inv_keep) {
  constexpr int DP = 32 * NC;
  extern __shared__ __align__(16) float smem_f[];
  float* sK = smem_f;                         // [kDkvKeys][DP + 1]
  float* sV = sK + kDkvKeys * (DP + 1);       // [kDkvKeys][DP + 1]
  float* sQ = sV + kDkvKeys * (DP + 1);       // [kDkvRows][DP + 1]
  float* sdO = sQ + kDkvRows * (DP + 1);      // [kDkvRows][DP + 1]
  float* sLse2 = sdO + kDkvRows * (DP + 1);   // [kDkvRows]
  float* sD = sLse2 + kDkvRows;               // [kDkvRows]
  uint32_t* sRk = reinterpret_cast<uint32_t*>(sD + kDkvRows);

  const int k0 = blockIdx.x * kDkvKeys;
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh >= n_bh) return;
  const int b = bh / H;
  const size_t qbase = (size_t)bh * bl.Sq * d, kbase = (size_t)bh * bl.Sk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t sd = seed ? (uint32_t)*seed : 0u;

  load_rows_f32<T, NC>(sK, k + kbase, k0, kDkvKeys, bl.Sk, d);
  load_rows_f32<T, NC>(sV, v + kbase, k0, kDkvKeys, bl.Sk, d);
  float kmask[kDkvKeysPerWarp], dk_acc[kDkvKeysPerWarp][NC],
      dv_acc[kDkvKeysPerWarp][NC];
#pragma unroll
  for (int kk = 0; kk < kDkvKeysPerWarp; ++kk) {
    const int key = k0 + warp * kDkvKeysPerWarp + kk;
    kmask[kk] = key >= bl.Sk
                    ? -INFINITY
                    : (mask ? mask[(size_t)b * bl.Sk + key] * kLog2e : 0.f);
#pragma unroll
    for (int i = 0; i < NC; ++i) dk_acc[kk][i] = dv_acc[kk][i] = 0.f;
  }

  // the q rows [qb, qe) that attend this tile's block (as flash_bwd_dkv_mma)
  const int qb = bl.q_begin(k0 / bl.gk()), qe = qb + bl.gq();
  const int n_q = (bl.gq() + kDkvRows - 1) / kDkvRows;
  const int dpos = bl.k_off - bl.q_off;
  for (int it = first_q_tile(bl, causal, k0, qb, kDkvRows); it < n_q; ++it) {
    const int q0 = qb + it * kDkvRows;
    __syncthreads();
    load_rows_f32<T, NC>(sQ, q + qbase, q0, kDkvRows, qe, d);
    load_rows_f32<T, NC>(sdO, dout + qbase, q0, kDkvRows, qe, d);
    if (threadIdx.x < kDkvRows) {
      const int row = q0 + threadIdx.x;
      const bool in = row < qe;
      sLse2[threadIdx.x] =
          in ? lse[(size_t)bh * bl.Sq + row] * kLog2e : INFINITY;
      sD[threadIdx.x] = in ? dsum[(size_t)bh * bl.Sq + row] : 0.f;
      sRk[threadIdx.x] = seed ? hetu_dropout::row_key(sd, bh, row) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDkvKeysPerWarp; ++kk) {
      const int kl = warp * kDkvKeysPerWarp + kk, key = k0 + kl;
      const float* qr = sQ + lane * (DP + 1);
      const float* dor = sdO + lane * (DP + 1);
      const float* kr = sK + kl * (DP + 1);
      const float* vr = sV + kl * (DP + 1);
      float sc = 0.f, dpv = 0.f;
      for (int c = 0; c < d; ++c) {
        sc = fmaf(qr[c], kr[c], sc);
        dpv = fmaf(dor[c], vr[c], dpv);
      }
      float x = sc * scale_log2 + kmask[kk];
      if (causal && key + dpos > q0 + lane) x = -INFINITY;
      const float p = exp2f(x - sLse2[lane]);
      float pd = p;
      if (seed) {
        if (hetu_dropout::keep(sRk[lane], key, thr)) {
          pd *= inv_keep;
          dpv *= inv_keep;
        } else {
          pd = dpv = 0.f;
        }
      }
      const float ds = round_to<T>(p * (dpv - sD[lane]));
      pd = round_to<T>(pd);
#pragma unroll 4
      for (int jj = 0; jj < kDkvRows; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pd, jj);
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          dv_acc[kk][i] = fmaf(pj, sdO[jj * (DP + 1) + lane + 32 * i],
                               dv_acc[kk][i]);
          dk_acc[kk][i] = fmaf(dsj, sQ[jj * (DP + 1) + lane + 32 * i],
                               dk_acc[kk][i]);
        }
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < kDkvKeysPerWarp; ++kk) {
    const int key = k0 + warp * kDkvKeysPerWarp + kk;
    if (key >= bl.Sk) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c >= d) continue;
      dk[kbase + (size_t)key * d + c] = from_f32<T>(dk_acc[kk][i] * scale);
      dv[kbase + (size_t)key * d + c] = from_f32<T>(dv_acc[kk][i]);
    }
  }
}

// -------------------------------------------------------------------------
// launchers

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dsum, *mask;
  const int32_t* seed;
  void *dq, *dk, *dv;
  int B, H;
  Blocks bl;
  int d, causal;
  float scale, scale_log2;
  uint32_t thr;
  float inv_keep;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch_dq_mma(const Args& a) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = prepare(flash_bwd_dq_mma<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.bl.Sq + kTile - 1) / kTile, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_mma<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.dsum, a.mask, a.seed, static_cast<bf16*>(a.dq), a.B * a.H, a.H, a.bl,
      a.d, a.causal, a.scale, a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const Args& a) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = prepare(flash_bwd_dkv_mma<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.bl.Sk + kTile - 1) / kTile, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dkv_mma<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.dsum, a.mask, a.seed, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.B * a.H, a.H, a.bl, a.d, a.causal, a.scale,
      a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dq_simt(const Args& a) {
  const size_t smem = dq_simt_smem_bytes<NC>();
  cudaError_t err = prepare(flash_bwd_dq_simt<T, NC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.bl.Sq + kDqRows - 1) / kDqRows, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_simt<T, NC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.dsum, a.mask, a.seed, static_cast<T*>(a.dq), a.B * a.H, a.H, a.bl,
      a.d, a.causal, a.scale, a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkv_simt(const Args& a) {
  const size_t smem = dkv_simt_smem_bytes<NC>();
  cudaError_t err = prepare(flash_bwd_dkv_simt<T, NC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.bl.Sk + kDkvKeys - 1) / kDkvKeys, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dkv_simt<T, NC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.dsum, a.mask, a.seed, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.B * a.H, a.H, a.bl, a.d, a.causal, a.scale, a.scale_log2, a.thr,
      a.inv_keep);
  return cudaGetLastError();
}

// which kernel: 0 = dQ, 1 = dK/dV
template <typename T, int NC>
cudaError_t launch_simt(int which, const Args& a) {
  return which == 0 ? launch_dq_simt<T, NC>(a) : launch_dkv_simt<T, NC>(a);
}

template <typename T>
cudaError_t dispatch_simt(int which, const Args& a) {
  if (a.d <= 32) return launch_simt<T, 1>(which, a);
  if (a.d <= 64) return launch_simt<T, 2>(which, a);
  if (a.d <= 128) return launch_simt<T, 4>(which, a);
  if (a.d <= 256) return launch_simt<T, 8>(which, a);
  if (a.d <= 512) return launch_simt<T, 16>(which, a);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_mma(int which, const Args& a) {
  return which == 0 ? launch_dq_mma<D>(a) : launch_dkv_mma<D>(a);
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a) {
  using T = DqTiles<D>;
  const int n_bh = a.B * a.H;
  // a q tile must lie in one ring group
  if (a.bl.n > 1 && (a.bl.Sq / a.bl.n) % kHopperBM != 0)
    return cudaErrorInvalidValue;
  const long long n_items =
      (long long)((a.bl.Sq + kHopperBM - 1) / kHopperBM) * n_bh;
  if (n_items > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  int blocks = 0;
  cudaError_t err = encode_rows(&tq, a.q, n_bh, a.bl.Sq, D, kHopperBM);
  if (err == cudaSuccess)
    err = encode_rows(&tdo, a.dout, n_bh, a.bl.Sq, D, kHopperBM);
  if (err == cudaSuccess)
    err = encode_rows(&tk, a.k, n_bh, a.bl.Sk, D, T::BN);
  if (err == cudaSuccess)
    err = encode_rows(&tv, a.v, n_bh, a.bl.Sk, D, T::BN);
  if (err == cudaSuccess) err = persistent_grid((int)n_items, &blocks);
  if (err == cudaSuccess) err = prepare(flash_bwd_dq_wgmma<D>, T::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma<D><<<blocks, kHopperThreads, T::kSmem, a.stream>>>(
      tq, tdo, tk, tv, a.lse, a.dsum, a.mask, a.seed,
      static_cast<bf16*>(a.dq), n_bh, a.H, a.bl, a.causal, a.scale,
      a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv_wgmma(const Args& a) {
  using T = DkvTiles<D>;
  const int n_bh = a.B * a.H;
  // a kv item must lie in one ring group
  if (a.bl.n > 1 && (a.bl.Sk / a.bl.n) % T::BN != 0)
    return cudaErrorInvalidValue;
  const long long n_items =
      (long long)((a.bl.Sk / a.bl.n + T::BN - 1) / T::BN) * a.bl.n * n_bh;
  if (n_items > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  int blocks = 0;
  cudaError_t err = encode_rows(&tq, a.q, n_bh, a.bl.Sq, D, T::BQ);
  if (err == cudaSuccess)
    err = encode_rows(&tdo, a.dout, n_bh, a.bl.Sq, D, T::BQ);
  if (err == cudaSuccess)
    err = encode_rows(&tk, a.k, n_bh, a.bl.Sk, D, T::BN);
  if (err == cudaSuccess)
    err = encode_rows(&tv, a.v, n_bh, a.bl.Sk, D, T::BN);
  if (err == cudaSuccess) err = persistent_grid((int)n_items, &blocks);
  if (err == cudaSuccess)
    err = prepare(flash_bwd_dkv_wgmma<D, DROP>, T::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma<D, DROP>
      <<<blocks, kDkvThreads, T::kSmem, a.stream>>>(
      tq, tdo, tk, tv, a.lse, a.dsum, a.mask, a.seed,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n_bh, a.H, a.bl,
      a.causal, a.scale, a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

// The kernel that `route` names (the Python wrapper's `flash_route`; it is
// never chosen here), for dQ (which = 0) or dK/dV (which = 1): 2 = wgmma
// (bf16, d = 64, 80 or 128, Sq and Sk >= 128; in a ring, a group a whole
// number of the kernel's 128-row tiles: q rows for dQ, K/V rows for
// dK/dV), 1 = mma.sync (bf16, d % 8 == 0, d <= 128), 0 = plain
// FMA (f32, or bf16 heads the others do not take, d <= 512).  A route the
// shape does not fit is refused.
cudaError_t dispatch(int which, int route, int is_bf16, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.d <= 0 || !valid_blocks(a.bl, kTile))
    return cudaErrorInvalidValue;
  if (route == 2) {
    if (!is_bf16 || a.bl.Sq < kHopperBM || a.bl.Sk < kHopperBM)
      return cudaErrorInvalidValue;
    if (which == 0) {
      if (a.d == 64) return launch_dq_wgmma<64>(a);
      if (a.d == 80) return launch_dq_wgmma<80>(a);
      if (a.d == 128) return launch_dq_wgmma<128>(a);
    } else if (a.d == 64) {
      return a.seed ? launch_dkv_wgmma<64, true>(a)
                    : launch_dkv_wgmma<64, false>(a);
    } else if (a.d == 80) {
      return a.seed ? launch_dkv_wgmma<80, true>(a)
                    : launch_dkv_wgmma<80, false>(a);
    } else if (a.d == 128) {
      return a.seed ? launch_dkv_wgmma<128, true>(a)
                    : launch_dkv_wgmma<128, false>(a);
    }
    return cudaErrorInvalidValue;
  }
  if (route == 1) {
    if (!is_bf16 || a.d % 8 != 0 || a.d > 128) return cudaErrorInvalidValue;
    switch ((a.d + 15) / 16) {
      case 1: return launch_mma<16>(which, a);
      case 2: return launch_mma<32>(which, a);
      case 3: return launch_mma<48>(which, a);
      case 4: return launch_mma<64>(which, a);
      case 5: return launch_mma<80>(which, a);
      case 6: return launch_mma<96>(which, a);
      case 7: return launch_mma<112>(which, a);
      default: return launch_mma<128>(which, a);
    }
  }
  if (route == 0)
    return is_bf16 ? dispatch_simt<bf16>(which, a)
                   : dispatch_simt<float>(which, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [B*H, S, d] contiguous, bf16 (is_bf16) or f32;
// lse, dsum: [B*H, S] f32 (the forward's lse, rowsum(dO * O)); mask: [B, S]
// f32 or null; seed: one int32 on the device, or null for no dropout (then
// thr and inv_keep are unused); route: the kernel (dispatch).  Each returns
// a cudaError_t (0 = launched).
extern "C" int hetu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* mask,
    const int32_t* seed, void* dq, int B, int H, int S, int d, int causal,
    float scale, uint32_t thr, float inv_keep, int is_bf16, int route,
    void* stream) {
  const Args a{q, k, v, dout, lse, dsum, mask, seed, dq, nullptr, nullptr,
               B, H, self_attention(S), d, causal, scale, scale * kLog2e, thr,
               inv_keep, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(0, route, is_bf16, a);
}

extern "C" int hetu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* mask,
    const int32_t* seed, void* dk, void* dv, int B, int H, int S, int d,
    int causal, float scale, uint32_t thr, float inv_keep, int is_bf16,
    int route, void* stream) {
  const Args a{q, k, v, dout, lse, dsum, mask, seed, nullptr, dk, dv,
               B, H, self_attention(S), d, causal, scale, scale * kLog2e, thr,
               inv_keep, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(1, route, is_bf16, a);
}

// The blockwise backward (`flash_attention_block_bwd`, flash_attention.py
// :568): one ring step's dQ (which = 0) or dK/dV (which = 1) from the
// ring's combined lse and D = rowsum(dO * O), both [B*H, Sq] f32.  q, dout,
// dq: [B*H, Sq, d]; k, v, dk, dv: [B*H, Sk, d]; groups, step and offsets as
// in hetu_flash_attention_block_fwd.  dK/dV land at the rows of their own
// K/V block, so a ring adds each step's into the block's sum as it is; a
// K/V tile that no query of its step sees writes dk = dv = 0.
extern "C" int hetu_flash_attention_block_bwd(
    int which, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, void* dq, void* dk, void* dv, int B,
    int H, int Sq, int Sk, int d, int n, int r, int q_off, int k_off,
    int causal, float scale, int is_bf16, int route, void* stream) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, dsum, nullptr, nullptr, dq, dk, dv, B, H,
               Blocks{Sq, Sk, n, r, q_off, k_off, kBlockEmptyLse}, d, causal,
               scale, scale * kLog2e, 0u, 1.f,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(which, route, is_bf16, a);
}
