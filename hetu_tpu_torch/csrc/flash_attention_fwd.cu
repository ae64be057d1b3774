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
// is the bytes; a simple kernel is far from either.  The design keeps the
// S x S score matrix out of device memory (one 64x64 tile at a time in
// registers) so the traffic stays O(S*d), and runs the two products on the
// tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate) for bf16
// inputs with d <= 128.  f32 inputs, and bf16 heads wider than 128, take a
// plain-FMA kernel that accumulates in f32 too.  No TMA, wgmma or
// pipelining yet: tiles are loaded with 16-byte loads and a barrier.
//
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
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "flash_common.cuh"

namespace {

using namespace hetu_flash;

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

template <typename T>
cudaError_t dispatch_simt(const Args& a) {
  if (a.d <= 32) return launch_simt<T, 1>(a);
  if (a.d <= 64) return launch_simt<T, 2>(a);
  if (a.d <= 128) return launch_simt<T, 4>(a);
  if (a.d <= 256) return launch_simt<T, 8>(a);
  if (a.d <= 512) return launch_simt<T, 16>(a);
  return cudaErrorInvalidValue;
}

// the tensor-core kernel for bf16 heads of d <= 128 (d % 8 == 0), the
// plain-FMA kernel otherwise
cudaError_t dispatch(int is_bf16, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.d <= 0 || !valid_blocks(a.bl, kTile))
    return cudaErrorInvalidValue;
  if (is_bf16 && a.d % 8 == 0 && a.d <= 128) {
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
  if (is_bf16) return dispatch_simt<__nv_bfloat16>(a);
  return dispatch_simt<float>(a);
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
// thr and inv_keep are unused); lse: [B*H, S] f32.  Returns a cudaError_t
// (0 = launched).
extern "C" int hetu_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const float* mask,
                                        const int32_t* seed, void* o,
                                        float* lse, int B, int H, int S,
                                        int d, int causal, float scale,
                                        uint32_t thr, float inv_keep,
                                        int is_bf16, void* stream) {
  const Args a{q, k, v, mask, seed, o, lse, B, H, self_attention(S), d,
               causal, scale * kLog2e, thr, inv_keep,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(is_bf16, a);
}

// The blockwise API (`flash_attention_block`, flash_attention.py:551): q
// [B*H, Sq, d] against K/V [B*H, Sk, d] in n groups at ring step r (see
// Blocks; n = 1, r = 0 for one block pair), causal by the global positions
// q_off + row and k_off + key; o normalised, lse = -1e30 and o = 0 on a row
// with no live key.  No mask, no dropout.
extern "C" int hetu_flash_attention_block_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H, int Sq, int Sk, int d, int n, int r, int q_off, int k_off,
    int causal, float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, o, lse, B, H,
               Blocks{Sq, Sk, n, r, q_off, k_off, kBlockEmptyLse}, d, causal,
               scale * kLog2e, 0u, 1.f, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(is_bf16, a);
}
