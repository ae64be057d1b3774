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
// operations.  bf16 inputs with d <= 128 run every product on the tensor
// cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16
// rows each, 64x64 score tiles kept in registers, the Q/dO/K/V tiles in
// shared memory.  f32 inputs (and bf16 heads wider than 128) take
// plain-FMA kernels that stay in f32 (no TF32).  No TMA, wgmma or
// pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "flash_common.cuh"

namespace {

using namespace hetu_flash;
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
                     int n_bh, int H, int S, int d, int causal, float scale,
                     float scale_log2, uint32_t thr, float inv_keep) {
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
  const size_t base = (size_t)bh * S * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // per-row lse (base 2), D and dropout row key; rows past S get
  // lse = +inf, so their P is 0
  float lse2[2], dsm[2];
  uint32_t rk[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < S;
    lse2[i] = in ? lse[(size_t)bh * S + rows[i]] * kLog2e : INFINITY;
    dsm[i] = in ? dsum[(size_t)bh * S + rows[i]] : 0.f;
    if (seed) rk[i] = hetu_dropout::row_key((uint32_t)*seed, bh, rows[i]);
  }

  load_tile<D>(sQ, q + base, q0, S, d);
  load_tile<D>(sdO, dout + base, q0, S, d);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  int n_tiles = (S + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, (q0 + kTile - 1) / kTile + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k + base, k0, S, d);
    load_tile<D>(sV, v + base, k0, S, d);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      sMask[threadIdx.x] =
          key >= S ? -INFINITY
                   : (mask ? mask[(size_t)b * S + key] * kLog2e : 0.f);
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
        if (causal && k0 + col > rows[i]) x = -INFINITY;
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
      if (rows[i] < S)
        *reinterpret_cast<uint32_t*>(dq + base + (size_t)rows[i] * d + col) =
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
                      int H, int S, int d, int causal, float scale,
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
  const size_t base = (size_t)bh * S * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // this warp's 16 keys are the rows of its fragments: keys[0], keys[1]
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float kmask[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kmask[i] = keys[i] >= S
                   ? -INFINITY
                   : (mask ? mask[(size_t)b * S + keys[i]] * kLog2e : 0.f);
  const uint32_t sd = seed ? (uint32_t)*seed : 0u;

  load_tile<D>(sK, k + base, k0, S, d);
  load_tile<D>(sV, v + base, k0, S, d);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  const int n_q = (S + kTile - 1) / kTile;
  // q tiles wholly above the diagonal see none of this kv tile
  for (int i = causal ? k0 / kTile : 0; i < n_q; ++i) {
    const int q0 = i * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sQ, q + base, q0, S, d);
    load_tile<D>(sdO, dout + base, q0, S, d);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool in = row < S;
      sLse2[threadIdx.x] = in ? lse[(size_t)bh * S + row] * kLog2e : INFINITY;
      sD[threadIdx.x] = in ? dsum[(size_t)bh * S + row] : 0.f;
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
        if (causal && keys[i] > q0 + qc) x = -INFINITY;
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
      if (keys[i] >= S) continue;
      const size_t off = base + (size_t)keys[i] * d + col;
      *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(
          dk_acc[nd][2 * i] * scale, dk_acc[nd][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(dv_acc[nd][2 * i], dv_acc[nd][2 * i + 1]);
    }
  }
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
                      int n_bh, int H, int S, int d, int causal, float scale,
                      float scale_log2, uint32_t thr, float inv_keep) {
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
  const size_t base = (size_t)bh * S * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows_f32<T, NC>(sQ, q + base, q0, kDqRows, S, d);
  load_rows_f32<T, NC>(sdO, dout + base, q0, kDqRows, S, d);
  float lse2[kDqRowsPerWarp], dsm[kDqRowsPerWarp], acc[kDqRowsPerWarp][NC];
  uint32_t rk[kDqRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kDqRowsPerWarp; ++rr) {
    const int row = q0 + warp * kDqRowsPerWarp + rr;
    lse2[rr] = row < S ? lse[(size_t)bh * S + row] * kLog2e : INFINITY;
    dsm[rr] = row < S ? dsum[(size_t)bh * S + row] : 0.f;
    rk[rr] = seed ? hetu_dropout::row_key((uint32_t)*seed, bh, row) : 0u;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
  }

  int n_tiles = (S + kDqKeys - 1) / kDqKeys;
  if (causal) n_tiles = min(n_tiles, (q0 + kDqRows - 1) / kDqKeys + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kDqKeys;
    __syncthreads();
    load_rows_f32<T, NC>(sK, k + base, k0, kDqKeys, S, d);
    load_rows_f32<T, NC>(sV, v + base, k0, kDqKeys, S, d);
    if (threadIdx.x < kDqKeys) {
      const int key = k0 + threadIdx.x;
      sMask[threadIdx.x] =
          key >= S ? -INFINITY
                   : (mask ? mask[(size_t)b * S + key] * kLog2e : 0.f);
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
      if (causal && k0 + lane > q0 + rl) x = -INFINITY;
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
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d)
        dq[base + (size_t)row * d + c] = from_f32<T>(acc[rr][i] * scale);
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
                       T* __restrict__ dv, int n_bh, int H, int S, int d,
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
  const size_t base = (size_t)bh * S * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t sd = seed ? (uint32_t)*seed : 0u;

  load_rows_f32<T, NC>(sK, k + base, k0, kDkvKeys, S, d);
  load_rows_f32<T, NC>(sV, v + base, k0, kDkvKeys, S, d);
  float kmask[kDkvKeysPerWarp], dk_acc[kDkvKeysPerWarp][NC],
      dv_acc[kDkvKeysPerWarp][NC];
#pragma unroll
  for (int kk = 0; kk < kDkvKeysPerWarp; ++kk) {
    const int key = k0 + warp * kDkvKeysPerWarp + kk;
    kmask[kk] = key >= S ? -INFINITY
                         : (mask ? mask[(size_t)b * S + key] * kLog2e : 0.f);
#pragma unroll
    for (int i = 0; i < NC; ++i) dk_acc[kk][i] = dv_acc[kk][i] = 0.f;
  }

  const int n_q = (S + kDkvRows - 1) / kDkvRows;
  for (int it = causal ? k0 / kDkvRows : 0; it < n_q; ++it) {
    const int q0 = it * kDkvRows;
    __syncthreads();
    load_rows_f32<T, NC>(sQ, q + base, q0, kDkvRows, S, d);
    load_rows_f32<T, NC>(sdO, dout + base, q0, kDkvRows, S, d);
    if (threadIdx.x < kDkvRows) {
      const int row = q0 + threadIdx.x;
      const bool in = row < S;
      sLse2[threadIdx.x] = in ? lse[(size_t)bh * S + row] * kLog2e : INFINITY;
      sD[threadIdx.x] = in ? dsum[(size_t)bh * S + row] : 0.f;
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
      if (causal && key > q0 + lane) x = -INFINITY;
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
    if (key >= S) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c >= d) continue;
      dk[base + (size_t)key * d + c] = from_f32<T>(dk_acc[kk][i] * scale);
      dv[base + (size_t)key * d + c] = from_f32<T>(dv_acc[kk][i]);
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
  int B, H, S, d, causal;
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
  const dim3 grid = bh_grid((a.S + kTile - 1) / kTile, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_mma<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.dsum, a.mask, a.seed, static_cast<bf16*>(a.dq), a.B * a.H, a.H, a.S,
      a.d, a.causal, a.scale, a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const Args& a) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = prepare(flash_bwd_dkv_mma<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.S + kTile - 1) / kTile, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dkv_mma<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.dsum, a.mask, a.seed, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.B * a.H, a.H, a.S, a.d, a.causal, a.scale,
      a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dq_simt(const Args& a) {
  const size_t smem = dq_simt_smem_bytes<NC>();
  cudaError_t err = prepare(flash_bwd_dq_simt<T, NC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.S + kDqRows - 1) / kDqRows, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_simt<T, NC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.dsum, a.mask, a.seed, static_cast<T*>(a.dq), a.B * a.H, a.H, a.S,
      a.d, a.causal, a.scale, a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkv_simt(const Args& a) {
  const size_t smem = dkv_simt_smem_bytes<NC>();
  cudaError_t err = prepare(flash_bwd_dkv_simt<T, NC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.S + kDkvKeys - 1) / kDkvKeys, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dkv_simt<T, NC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.dsum, a.mask, a.seed, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.B * a.H, a.H, a.S, a.d, a.causal, a.scale, a.scale_log2, a.thr,
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

cudaError_t dispatch(int which, int is_bf16, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.S <= 0 || a.d <= 0)
    return cudaErrorInvalidValue;
  if (is_bf16 && a.d % 8 == 0 && a.d <= 128) {
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
  if (is_bf16) return dispatch_simt<bf16>(which, a);
  return dispatch_simt<float>(which, a);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [B*H, S, d] contiguous, bf16 (is_bf16) or f32;
// lse, dsum: [B*H, S] f32 (the forward's lse, rowsum(dO * O)); mask: [B, S]
// f32 or null; seed: one int32 on the device, or null for no dropout (then
// thr and inv_keep are unused).  Each returns a cudaError_t (0 = launched).
extern "C" int hetu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* mask,
    const int32_t* seed, void* dq, int B, int H, int S, int d, int causal,
    float scale, uint32_t thr, float inv_keep, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, dsum, mask, seed, dq, nullptr, nullptr,
               B, H, S, d, causal, scale, scale * kLog2e, thr, inv_keep,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(0, is_bf16, a);
}

extern "C" int hetu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* dsum, const float* mask,
    const int32_t* seed, void* dk, void* dv, int B, int H, int S, int d,
    int causal, float scale, uint32_t thr, float inv_keep, int is_bf16,
    void* stream) {
  const Args a{q, k, v, dout, lse, dsum, mask, seed, nullptr, dk, dv,
               B, H, S, d, causal, scale, scale * kLog2e, thr, inv_keep,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(1, is_bf16, a);
}
