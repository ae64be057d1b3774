// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `_fwd` in
// hetu_tpu/ops/pallas/flash_attention.py (pl.pallas_call at line 266):
// FlashAttention-2 forward with an online softmax in base-2 units, an
// optional additive key mask [B,1,1,S] (added in f32), optional causal
// masking with the kv tiles above the diagonal skipped, o in the inputs'
// dtype and the log-sum-exp in natural-log units.  Rows whose every key is
// masked (all scores below the -1e30 running-max floor) give o = 0 and
// lse = +1e30, as on the TPU.  Ragged S and d are masked inside the kernel
// (out-of-range keys are excluded, out-of-range head-dim columns read as
// zero), so the wrapper never pads.
//
// What bounds it on the H100: at BERT-base shapes (S=512, d=64) the
// 4*S^2*d products per head are ~2x the bf16 tensor-core roofline time
// (989 TFLOP/s) of the 8*S*d bytes it must move (3.35 TB/s), so the bound
// is the bytes; at d = 128 and long S (the Mistral witness's 2048-row
// blocks) the products bound it.  Every kernel keeps the S x S score
// matrix out of device memory (one tile at a time in registers), so the
// traffic stays O(S*d).  Three kernels, one per route, which the Python
// wrapper names from dtype and shape (`flash_route`) and passes in:
// - wgmma (bf16, d = 64, 80 or 128): `flash_fwd_wgmma`, built for Hopper
//   (flash_hopper.cuh).  A persistent block per SM walks (q tile, head)
//   work items; one producer warp loads each 128-row q tile and its K/V
//   tiles of 128 keys by TMA into a ring of shared-memory stages on
//   mbarriers (3 stages at d = 64, 2 at d = 80 and 128: 227 KB holds two Q
//   buffers and no more), and two consumer warpgroups of 64 rows run both
//   products on wgmma, Q K^T from shared memory and P V with P from
//   registers and V, in its natural [key, d] layout, through the
//   descriptor's transpose bit.  128 keys a tile halve the per-tile
//   softmax overhead against 64; the softmax takes the exponent on the
//   special-function unit (ex2.approx), adds the key mask only on tiles
//   with masked keys and compares positions only on tiles the diagonal
//   crosses.  The registers are the limit: a 9-warp block gets 168 a
//   thread (3 warps share an SM quarter's 16,384), which holds one score
//   tile and one output accumulator of 64 rows but not a second score
//   tile, so a warpgroup's softmax does not overlap its own next product;
//   the two warpgroups' do overlap each other's.  At d = 80 (GPT-3 2.7B's
//   heads) a tile is laid out 128 columns wide, two 64-column halves of
//   which TMA fills the second only in columns 64-79 (zeros past them);
//   Q K^T runs 5 k-steps of 16 and P V one m64n80k16 product a 16-key
//   step, so no product reads a padded column, and O takes 40 registers a
//   thread where d = 128 takes 64.
// - mma (bf16 with d % 8 == 0 and d <= 128 otherwise, or ring groups of
//   64 rows): `flash_fwd_mma`, mma.sync.m16n8k16 on 64x64 tiles loaded
//   with 16-byte loads and a barrier.
// - simt (f32, and bf16 heads the others do not take): `flash_fwd_simt`,
//   plain FMA accumulating in f32.

// Attention dropout (training): with a seed pointer, each probability is
// kept with probability keep and scaled by 1/keep after it joins the row
// sum, so l holds the UN-dropped sums and O = dropout(softmax(S)) V, as
// the TPU kernel computes it (flash_attention.py:170-176).  The keep bit is
// the hash of dropout_hash.cuh on global (seed, bh, row, col), which the
// backward kernels replay; the seed is read from device memory, so drawing
// it costs the host no sync.
//
// Blockwise (ring) attention: the same kernels also replace the TPU
// kernel's offset path, `flash_attention_block` (flash_attention.py:551,
// `_fwd` with offsets=[q_off, k_off] and empty_lse_neg=True).  Causal
// exclusion compares global positions, the K/V length is its own, and a
// row with no live key in the block gets o = 0 and lse = -1e30, so the
// ring's logaddexp combine gives the block no weight; a block wholly above
// the diagonal runs no kv tile and still writes both.  One launch serves
// every rank of one ring step: q and K/V hold the ranks' blocks in order
// along the sequence and the rows of rank g read the K/V block that r
// rotations of the ring brought it, (g - r) mod n (Blocks in
// flash_common.cuh), so the ring moves no bytes on one card.

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

// -------------------------------------------------------------------------
// bf16 tensor-core kernel: 4 warps, 64 query rows per block (16 per warp),
// K/V tiles of 64 keys in shared memory, head dim padded to D (16 | D).

constexpr int kBM = kTile;
constexpr int kBN = kTile;

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, K, V tiles (rows padded by 8 elements against bank conflicts) + mask
  return (size_t)(kBM + 2 * kBN) * (D + 8) * sizeof(__nv_bfloat16) +
         kBN * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ mask,
                  const int32_t* __restrict__ seed,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int n_bh, int H, Blocks bl, int d, int causal,
                  float scale_log2, uint32_t keep_threshold, float inv_keep) {
  constexpr int ST = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBM * ST;
  __nv_bfloat16* sV = sK + kBN * ST;
  float* sMask = reinterpret_cast<float*>(sV + kBN * ST);

  // query tiles on x, (batch, head) on y and, past the 65535 blocks that
  // y holds, on z; the tiles of one head run side by side and share its
  // K/V in L2
  const int q0 = blockIdx.x * kBM;
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh >= n_bh) return;  // the tail of the last z slice
  const int b = bh / H;
  const size_t qbase = (size_t)bh * bl.Sq * d, kbase = (size_t)bh * bl.Sk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const int r0 = warp * 16 + g;           // this thread's rows: r0, r0 + 8
  const int row_a = q0 + r0, row_b = row_a + 8;
  uint32_t rk[2] = {0u, 0u};  // dropout row keys of rows row_a, row_b
  if (seed) {
    rk[0] = hetu_dropout::row_key((uint32_t)*seed, bh, row_a);
    rk[1] = hetu_dropout::row_key((uint32_t)*seed, bh, row_b);
  }

  load_tile<D>(sQ, q + qbase, q0, bl.Sq, d);
  __syncthreads();
  uint32_t qa[D / 16][4];  // A fragments of this warp's 16 query rows
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    load_a(qa[kc], sQ, ST, warp * 16, kc * 16, g, t);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};

  // the K/V rows [kb, ke) of this tile's group's block, its live kv tiles,
  // and a key's position minus a row's at equal indices
  const int kb = bl.kv_begin(q0 / bl.gq()), ke = kb + bl.gk();
  const int n_tiles = kv_tiles(bl, causal, q0, kBM, kb, kBN);
  const int dpos = bl.k_off - bl.q_off;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kb + j * kBN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k + kbase, k0, ke, d);
    load_tile<D>(sV, v + kbase, k0, ke, d);
    if (threadIdx.x < kBN) {
      const int key = k0 + threadIdx.x;
      sMask[threadIdx.x] =
          key >= ke ? -INFINITY
                    : (mask ? mask[(size_t)b * bl.Sk + key] * kLog2e : 0.f);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, as 8 n-tiles of 8 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = sK + (n * 8 + g) * ST + 2 * t;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma_bf16(s[n], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }
    // base-2 scores, key mask, causal exclusion; tile row max
    float tmax[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = s[n][e] * scale_log2 + sMask[col];
        if (causal && k0 + col + dpos > row) x = -INFINITY;
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] - m[e >> 1]);
        rsum[e >> 1] += p;  // l sums the un-dropped p
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        if (seed && !hetu_dropout::keep(rk[e >> 1], col, keep_threshold))
          p = 0.f;
        s[n][e] = seed ? p * inv_keep : p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l[i] = l[i] * alpha[i] + rsum[i];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
    // O += P V: the S accumulator fragments are P's A fragments (bf16)
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = sV + (kk * 16 + 2 * t) * ST + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vp = vr + nd * 8;
        mma_bf16(acc[nd], pa, pack_bf16(vp, vp + ST),
                 pack_bf16(vp + 8 * ST, vp + 9 * ST));
      }
    }
  }

  float inv[2], row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool empty = l[i] == 0.f;
    inv[i] = empty ? 0.f : 1.f / l[i];
    row_lse[i] = empty ? bl.empty_lse : m[i] * kLn2 + logf(l[i]);
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col >= d) continue;
    if (row_a < bl.Sq)
      *reinterpret_cast<uint32_t*>(o + qbase + (size_t)row_a * d + col) =
          pack_bf16(acc[nd][0] * inv[0], acc[nd][1] * inv[0]);
    if (row_b < bl.Sq)
      *reinterpret_cast<uint32_t*>(o + qbase + (size_t)row_b * d + col) =
          pack_bf16(acc[nd][2] * inv[1], acc[nd][3] * inv[1]);
  }
  if (t == 0) {
    if (row_a < bl.Sq) lse[(size_t)bh * bl.Sq + row_a] = row_lse[0];
    if (row_b < bl.Sq) lse[(size_t)bh * bl.Sq + row_b] = row_lse[1];
  }
}

// -------------------------------------------------------------------------
// Hopper kernel for bf16 heads of d = 64, 80 and 128 (flash_hopper.cuh): a
// persistent block of 2 consumer warpgroups, 64 query rows each (a 128-row
// q tile), and 1 producer warp.  For each work item the producer loads the
// q tile by TMA into one of two Q buffers, then the item's K/V tiles of 128
// keys through a ring of shared-memory stages, each completing on its
// `full` mbarrier, with the tile's key mask (keys past the block's end at
// -inf) beside it.  Each consumer warpgroup runs S = Q K^T and O += P V on
// wgmma (P from registers, V through the descriptor's transpose bit) on
// the tiles that have landed, and frees a stage on its `empty` mbarrier,
// one arrival per consumer warp.  The online softmax, mask, causal and
// dropout code is flash_fwd_mma's: the wgmma accumulator puts rows 16w + g
// and 16w + g + 8 and columns 2t, 2t + 1 of each 8-column group in a
// thread, as mma.sync's C does.

template <int D>
struct FwdTiles {
  static constexpr int BN = 128;  // keys of a kv tile
  // 64-column halves of a tile: its layout is 64 * kHalves columns wide,
  // wider than the D columns of work at d = 80 (flash_hopper.cuh), and a
  // buffer's bytes, which the producer's mbarriers expect, are what TMA
  // delivers, zero-filled columns included
  static constexpr int kHalves = (D + 63) / 64;
  // stages of K and V: 3 at d = 64 (96 KB), 2 at d = 80 and 128 (128 KB);
  // with the two Q buffers and the masks within 227 KB
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kHopperBM * kHalves * 128;  // one Q buffer
  static constexpr int kTileBytes = BN * kHalves * 128;  // one K or V tile
  static constexpr size_t kSmem = 1024 + 2 * kQBytes +
                                  (size_t)kStages * 2 * kTileBytes +
                                  kStages * BN * sizeof(float) +
                                  (4 + 2 * kStages) * sizeof(uint64_t);
};

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ mask,
                    const int32_t* __restrict__ seed,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int n_bh, int H, Blocks bl, int causal, float scale_log2,
                    uint32_t keep_threshold, float inv_keep) {
  using T = FwdTiles<D>;
  constexpr int BM = kHopperBM, BN = T::BN, NS = T::kStages;
  extern __shared__ __align__(1024) unsigned char smem_hopper[];
  unsigned char* sQ = align1024(smem_hopper);  // Q buffers 0 and 1
  unsigned char* sKV = sQ + 2 * T::kQBytes;     // stage s: K, then V
  float* sMask = reinterpret_cast<float*>(sKV + NS * 2 * T::kTileBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sMask + NS * BN);

  const uint32_t bar0 = smem_u32(bars);
  // barriers: Q buffer b full, Q buffer b free, stage s full, stage s free
  auto q_full = [&](int b) { return bar0 + 8u * b; };
  auto q_free = [&](int b) { return bar0 + 8u * (2 + b); };
  auto full = [&](int s) { return bar0 + 8u * (4 + s); };
  auto empty = [&](int s) { return bar0 + 8u * (4 + NS + s); };
  auto q_buf = [&](int b) { return smem_u32(sQ) + b * T::kQBytes; };
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
    // producer: an item's q tile into Q buffer qi % 2 once the item two
    // before it is done with that buffer, then its K/V tiles, the tj-th
    // of the block into stage tj % NS once that stage is free
    if (lane == 0) {
      tma_prefetch(&tq);
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
        mbar_arrive_expect_tx(q_full(qb), T::kQBytes);
#pragma unroll
        for (int h = 0; h < T::kHalves; ++h)
          tma_load_3d(q_buf(qb) + h * BM * 128, &tq, q_full(qb), h * 64,
                      w.q0, w.bh);
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
    if (w.n_tiles == 0) {  // no live key: o = 0 and the empty lse
      for (int x = threadIdx.x; x < BM * D / 8; x += 256) {
        const int row = q0 + x / (D / 8);
        if (row < bl.Sq)
          reinterpret_cast<uint4*>(o + ((size_t)bh * bl.Sq + row) *
                                           D)[x % (D / 8)] =
              make_uint4(0u, 0u, 0u, 0u);
      }
      if (threadIdx.x < BM && q0 + threadIdx.x < bl.Sq)
        lse[(size_t)bh * bl.Sq + q0 + threadIdx.x] = bl.empty_lse;
      continue;
    }
    const int r_wg = q0 + wg * 64;
    const int row_a = r_wg + (warp % 4) * 16 + g, row_b = row_a + 8;
    // this warpgroup's live tiles: causally, its rows may see fewer keys
    // than the item's last row
    const int my_tiles = kv_tiles(bl, causal, r_wg, 64, w.kb, BN);
    const int dpos = bl.k_off - bl.q_off;
    uint32_t rk[2] = {0u, 0u};  // dropout row keys of rows row_a, row_b
    if (seed) {
      rk[0] = hetu_dropout::row_key((uint32_t)*seed, bh, row_a);
      rk[1] = hetu_dropout::row_key((uint32_t)*seed, bh, row_b);
    }
    float acc[D / 2], s[BN / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) s[x] = 0.f;
    float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
    const int qb = qi & 1;
    const uint32_t q_wg = q_buf(qb) + wg * 64 * 128;

    mbar_wait(q_full(qb), (qi >> 1) & 1);
    for (int j = 0; j < w.n_tiles; ++j, ++tj) {
      const int st = tj % NS, k0 = w.kb + j * BN;
      mbar_wait(full(st), (tj / NS) & 1);
      if (j < my_tiles) {
        const uint32_t kt = k_tile(st), vt = kt + T::kTileBytes;
        // S = Q K^T: 64 rows x BN keys, d / 16 k-steps (the fifth of d =
        // 80 at the start of the second half)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns in the atom
          wgmma_ss<BN, 0>(
              s, desc_sw128(q_wg + (kk / 4) * BM * 128 + off, 16, 1024),
              desc_sw128(kt + (kk / 4) * BN * 128 + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // base-2 scores; the key mask (with the keys past the block's
        // end) only on tiles that have one, the causal exclusion only on
        // tiles the diagonal crosses; tile row max
        const bool masked = mask != nullptr || k0 + BN > w.ke;
        const bool diag = causal && k0 + BN - 1 + dpos > r_wg;
        float tmax[2] = {kNegBig, kNegBig};
        if (masked || diag) {
          const float* tmask = sMask + st * BN;
#pragma unroll
          for (int x = 0; x < BN / 2; x += 2) {
            const int r = (x >> 1) & 1, col = (x / 4) * 8 + 2 * t;
            const float2 mk = *reinterpret_cast<const float2*>(tmask + col);
            float x0 = s[x] * scale_log2 + mk.x;
            float x1 = s[x + 1] * scale_log2 + mk.y;
            if (diag) {
              const int row = r ? row_b : row_a;
              if (k0 + col + dpos > row) x0 = -INFINITY;
              if (k0 + col + 1 + dpos > row) x1 = -INFINITY;
            }
            s[x] = x0;
            s[x + 1] = x1;
            tmax[r] = fmaxf(tmax[r], fmaxf(x0, x1));
          }
        } else {
          // the raw scores' max (min for a negative scale) times the
          // scale; the scale then folds into the exponent below
          float e[2] = {s[0], s[2]};
          if (scale_log2 >= 0.f) {
#pragma unroll
            for (int x = 0; x < BN / 2; ++x)
              e[(x >> 1) & 1] = fmaxf(e[(x >> 1) & 1], s[x]);
          } else {
#pragma unroll
            for (int x = 0; x < BN / 2; ++x)
              e[(x >> 1) & 1] = fminf(e[(x >> 1) & 1], s[x]);
          }
          tmax[0] = e[0] * scale_log2;
          tmax[1] = e[1] * scale_log2;
        }
        float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          const float m_new = fmaxf(m[r], tmax[r]);
          alpha[r] = ex2(m[r] - m_new);
          m[r] = m_new;
        }
        // p = 2^(x - m): x = s * scale_log2 unless the scores were formed
        // above, as fmaf(s, scale_log2, -m) then
        const float sc = masked || diag ? 1.f : scale_log2;
        // P (dropped and scaled) as bf16 A fragments: accumulator pair
        // x / 2 of 16-key group x / 8 is A register (x / 2) % 4, rows g,
        // g + 8 at columns 2t, then 2t + 8
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int x = 0; x < BN / 2; x += 2) {
          const int r = (x >> 1) & 1;
          float p0 = ex2(fmaf(s[x], sc, -m[r]));
          float p1 = ex2(fmaf(s[x + 1], sc, -m[r]));
          rsum[r] += p0 + p1;  // l sums the un-dropped p
          if (seed) {
            const int col = k0 + (x / 4) * 8 + 2 * t;
            p0 = hetu_dropout::keep(rk[r], col, keep_threshold)
                     ? p0 * inv_keep
                     : 0.f;
            p1 = hetu_dropout::keep(rk[r], col + 1, keep_threshold)
                     ? p1 * inv_keep
                     : 0.f;
          }
          pa[x / 8][(x / 2) % 4] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
          rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
          l[r] = l[r] * alpha[r] + rsum[r];
        }
        // rescale O unless no row of the warp saw its max move
        if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
          for (int x = 0; x < D / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];
        }

        // O += P V: BN / 16 k-steps of 16 keys, V MN-major (transposed),
        // its columns from 64 on in the next half (LBO)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D, 1>(acc, pa[kk],
                         desc_sw128(vt + kk * 2048, BN * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    // this warpgroup's products are done with the Q buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(q_free(qb));
    ++qi;

    float inv[2], row_lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool empty_row = l[r] == 0.f;
      inv[r] = empty_row ? 0.f : __frcp_rn(l[r]);
      row_lse[r] = empty_row ? bl.empty_lse : m[r] * kLn2 + logf(l[r]);
    }
#pragma unroll
    for (int x = 0; x < D / 2; x += 2) {
      const int r = (x >> 1) & 1, row = r ? row_b : row_a;
      const int col = (x / 4) * 8 + 2 * t;
      if (row < bl.Sq)
        *reinterpret_cast<uint32_t*>(o + ((size_t)bh * bl.Sq + row) * D +
                                     col) =
            pack_bf16(acc[x] * inv[r], acc[x + 1] * inv[r]);
    }
    if (t == 0) {
      if (row_a < bl.Sq) lse[(size_t)bh * bl.Sq + row_a] = row_lse[0];
      if (row_b < bl.Sq) lse[(size_t)bh * bl.Sq + row_b] = row_lse[1];
    }
  }
}

// -------------------------------------------------------------------------
// Plain-FMA kernel for f32 (and bf16 heads wider than 128): 4 warps, 16
// query rows per block (4 per warp), key tiles of 32 (one key per lane for
// the scores), each lane owning NC output columns (d <= 32 * NC).

constexpr int kSimtBM = 16;
constexpr int kSimtBN = 32;
constexpr int kRowsPerWarp = kSimtBM / (kThreads / 32);

template <int NC>
constexpr size_t simt_smem_bytes() {
  // Q and K rows padded by one float against bank conflicts; V; mask
  return ((size_t)(kSimtBM + kSimtBN) * (32 * NC + 1) +
          (size_t)kSimtBN * 32 * NC + kSimtBN) * sizeof(float);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ mask,
                   const int32_t* __restrict__ seed, T* __restrict__ o,
                   float* __restrict__ lse, int n_bh, int H, Blocks bl, int d,
                   int causal, float scale_log2, uint32_t keep_threshold,
                   float inv_keep) {
  constexpr int DP = 32 * NC;
  extern __shared__ __align__(16) float smem_f[];
  float* sQ = smem_f;                          // [BM][DP + 1]
  float* sK = sQ + kSimtBM * (DP + 1);         // [BN][DP + 1]
  float* sV = sK + kSimtBN * (DP + 1);         // [BN][DP]
  float* sMask = sV + kSimtBN * DP;            // [BN]

  const int q0 = blockIdx.x * kSimtBM;  // grid as in flash_fwd_mma
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh >= n_bh) return;
  const int b = bh / H;
  const size_t qbase = (size_t)bh * bl.Sq * d, kbase = (size_t)bh * bl.Sk * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < kSimtBM * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP, gr = q0 + r;
    sQ[r * (DP + 1) + c] =
        (gr < bl.Sq && c < d) ? to_f32(q[qbase + (size_t)gr * d + c]) : 0.f;
  }
  float acc[kRowsPerWarp][NC];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  uint32_t rk[kRowsPerWarp];  // dropout row keys
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegBig;
    l[rr] = 0.f;
    rk[rr] = seed ? hetu_dropout::row_key((uint32_t)*seed, bh,
                                          q0 + warp * kRowsPerWarp + rr)
                  : 0u;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
  }

  // the K/V rows [kb, ke) of this tile's group's block (as flash_fwd_mma)
  const int kb = bl.kv_begin(q0 / bl.gq()), ke = kb + bl.gk();
  const int n_tiles = kv_tiles(bl, causal, q0, kSimtBM, kb, kSimtBN);
  const int dpos = bl.k_off - bl.q_off;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kb + j * kSimtBN;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kSimtBN * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP, gr = k0 + r;
      const bool in = gr < ke && c < d;
      sK[r * (DP + 1) + c] = in ? to_f32(k[kbase + (size_t)gr * d + c]) : 0.f;
      sV[r * DP + c] = in ? to_f32(v[kbase + (size_t)gr * d + c]) : 0.f;
    }
    if (threadIdx.x < kSimtBN) {
      const int key = k0 + threadIdx.x;
      sMask[threadIdx.x] =
          key >= ke ? -INFINITY
                    : (mask ? mask[(size_t)b * bl.Sk + key] * kLog2e : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int rl = warp * kRowsPerWarp + rr;
      const float* qr = sQ + rl * (DP + 1);
      const float* kr = sK + lane * (DP + 1);
      float sc = 0.f;
      for (int c = 0; c < d; ++c) sc = fmaf(qr[c], kr[c], sc);
      float x = sc * scale_log2 + sMask[lane];
      if (causal && k0 + lane + dpos > q0 + rl) x = -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(x));
      float p = exp2f(x - m_new);
      const float alpha = exp2f(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);  // un-dropped sums
      m[rr] = m_new;
      if (seed)
        p = hetu_dropout::keep(rk[rr], k0 + lane, keep_threshold)
                ? p * inv_keep : 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[rr][i] *= alpha;
      // a bounded unroll: unrolled fully, the hoisted V loads of the
      // widest heads (NC = 16) overflow the register file
#pragma unroll 4
      for (int jj = 0; jj < kSimtBN; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
        for (int i = 0; i < NC; ++i)
          acc[rr][i] = fmaf(pj, sV[jj * DP + lane + 32 * i], acc[rr][i]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= bl.Sq) continue;
    const bool empty = l[rr] == 0.f;
    const float inv = empty ? 0.f : 1.f / l[rr];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) o[qbase + (size_t)row * d + c] = from_f32<T>(acc[rr][i] * inv);
    }
    if (lane == 0)
      lse[(size_t)bh * bl.Sq + row] =
          empty ? bl.empty_lse : m[rr] * kLn2 + logf(l[rr]);
  }
}

struct Args {
  const void *q, *k, *v;
  const float* mask;
  const int32_t* seed;
  void* o;
  float* lse;
  int B, H;
  Blocks bl;
  int d, causal;
  float scale_log2;
  uint32_t thr;
  float inv_keep;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_mma(const Args& a) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.bl.Sq + kBM - 1) / kBM, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_mma<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.mask, a.seed,
      static_cast<__nv_bfloat16*>(a.o), a.lse, a.B * a.H, a.H, a.bl, a.d,
      a.causal, a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_simt(const Args& a) {
  const size_t smem = simt_smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((a.bl.Sq + kSimtBM - 1) / kSimtBM, a.B * a.H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_simt<T, NC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, a.seed, static_cast<T*>(a.o),
      a.lse, a.B * a.H, a.H, a.bl, a.d, a.causal, a.scale_log2, a.thr,
      a.inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  using T = FwdTiles<D>;
  const int n_bh = a.B * a.H;
  // a q tile must lie in one ring group
  if (a.bl.n > 1 && (a.bl.Sq / a.bl.n) % kHopperBM != 0)
    return cudaErrorInvalidValue;
  const long long n_items =
      (long long)((a.bl.Sq + kHopperBM - 1) / kHopperBM) * n_bh;
  if (n_items > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int blocks = 0;
  cudaError_t err = encode_rows(&tq, a.q, n_bh, a.bl.Sq, D, kHopperBM);
  if (err == cudaSuccess)
    err = encode_rows(&tk, a.k, n_bh, a.bl.Sk, D, T::BN);
  if (err == cudaSuccess)
    err = encode_rows(&tv, a.v, n_bh, a.bl.Sk, D, T::BN);
  if (err == cudaSuccess) err = persistent_grid((int)n_items, &blocks);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)T::kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<D><<<blocks, kHopperThreads, T::kSmem, a.stream>>>(
      tq, tk, tv, a.mask, a.seed, static_cast<__nv_bfloat16*>(a.o), a.lse,
      n_bh, a.H, a.bl, a.causal, a.scale_log2, a.thr, a.inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(const Args& a) {
  if (a.d <= 32) return launch_simt<T, 1>(a);
  if (a.d <= 64) return launch_simt<T, 2>(a);
  if (a.d <= 128) return launch_simt<T, 4>(a);
  if (a.d <= 256) return launch_simt<T, 8>(a);
  if (a.d <= 512) return launch_simt<T, 16>(a);
  return cudaErrorInvalidValue;
}

// The kernel that `route` names (the Python wrapper's `flash_route`; it is
// never chosen here): 2 = wgmma (bf16, d = 64, 80 or 128, Sq and Sk >= 128, a
// ring group a whole number of 128-row q tiles), 1 = mma.sync (bf16, d % 8
// == 0, d <= 128), 0 = plain FMA (f32, or bf16 heads the others do not
// take, d <= 512).  A route the shape does not fit is refused.
cudaError_t dispatch(int route, int is_bf16, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.d <= 0 || !valid_blocks(a.bl, kTile))
    return cudaErrorInvalidValue;
  if (route == 2) {
    if (!is_bf16 || a.bl.Sq < kHopperBM || a.bl.Sk < kHopperBM)
      return cudaErrorInvalidValue;
    if (a.d == 64) return launch_wgmma<64>(a);
    if (a.d == 80) return launch_wgmma<80>(a);
    if (a.d == 128) return launch_wgmma<128>(a);
    return cudaErrorInvalidValue;
  }
  if (route == 1) {
    if (!is_bf16 || a.d % 8 != 0 || a.d > 128) return cudaErrorInvalidValue;
    switch ((a.d + 15) / 16) {
      case 1: return launch_mma<16>(a);
      case 2: return launch_mma<32>(a);
      case 3: return launch_mma<48>(a);
      case 4: return launch_mma<64>(a);
      case 5: return launch_mma<80>(a);
      case 6: return launch_mma<96>(a);
      case 7: return launch_mma<112>(a);
      default: return launch_mma<128>(a);
    }
  }
  if (route == 0)
    return is_bf16 ? dispatch_simt<__nv_bfloat16>(a) : dispatch_simt<float>(a);
  return cudaErrorInvalidValue;
}

// the keep bits of an [n_bh, Sq, Sk] attention-probability tensor, one
// thread per element: the counterpart of the test-only Pallas kernel that
// extracts the TPU kernel's masks (tests/test_flash_attention.py:195)
__global__ void dropout_keep_mask_kernel(const int32_t* __restrict__ seed,
                                         uint8_t* __restrict__ out,
                                         size_t total, int Sq, int Sk,
                                         uint32_t thr) {
  const uint32_t sd = (uint32_t)*seed;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint32_t col = (uint32_t)(i % Sk);
    const size_t r = i / Sk;
    const uint32_t row = (uint32_t)(r % Sq), bh = (uint32_t)(r / Sq);
    out[i] = hetu_dropout::keep(hetu_dropout::row_key(sd, bh, row), col, thr);
  }
}

}  // namespace

// out: [n_bh, Sq, Sk] uint8 keep bits (1 = kept) for the dropout seed at
// `seed` (one int32 on the device) and threshold thr.
extern "C" int hetu_dropout_keep_mask(const int32_t* seed, uint8_t* out,
                                      int n_bh, int Sq, int Sk, uint32_t thr,
                                      void* stream) {
  if (n_bh <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)n_bh * Sq * Sk;
  const size_t want = (total + 255) / 256;
  const int blocks = (int)(want < 65536 ? want : 65536);
  dropout_keep_mask_kernel<<<blocks, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      seed, out, total, Sq, Sk, thr);
  return (int)cudaGetLastError();
}

// q, k, v, o: [B*H, S, d] contiguous, bf16 (is_bf16) or f32; mask: [B, S]
// f32 or null; seed: one int32 on the device, or null for no dropout (then
// thr and inv_keep are unused); lse: [B*H, S] f32; route: the kernel
// (dispatch).  Returns a cudaError_t (0 = launched).
extern "C" int hetu_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const float* mask,
                                        const int32_t* seed, void* o,
                                        float* lse, int B, int H, int S,
                                        int d, int causal, float scale,
                                        uint32_t thr, float inv_keep,
                                        int is_bf16, int route,
                                        void* stream) {
  const Args a{q, k, v, mask, seed, o, lse, B, H, self_attention(S), d,
               causal, scale * kLog2e, thr, inv_keep,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(route, is_bf16, a);
}

// The blockwise API (`flash_attention_block`, flash_attention.py:551): q
// [B*H, Sq, d] against K/V [B*H, Sk, d] in n groups at ring step r (see
// Blocks; n = 1, r = 0 for one block pair), causal by the global positions
// q_off + row and k_off + key; o normalised, lse = -1e30 and o = 0 on a row
// with no live key.  No mask, no dropout.
extern "C" int hetu_flash_attention_block_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H, int Sq, int Sk, int d, int n, int r, int q_off, int k_off,
    int causal, float scale, int is_bf16, int route, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, o, lse, B, H,
               Blocks{Sq, Sk, n, r, q_off, k_off, kBlockEmptyLse}, d, causal,
               scale * kLog2e, 0u, 1.f, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(route, is_bf16, a);
}
