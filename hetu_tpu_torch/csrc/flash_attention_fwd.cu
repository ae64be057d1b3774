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
                  int n_bh, int H, int S, int d, int causal, float scale_log2,
                  uint32_t keep_threshold, float inv_keep) {
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
  const size_t base = (size_t)bh * S * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const int r0 = warp * 16 + g;           // this thread's rows: r0, r0 + 8
  const int row_a = q0 + r0, row_b = row_a + 8;
  uint32_t rk[2] = {0u, 0u};  // dropout row keys of rows row_a, row_b
  if (seed) {
    rk[0] = hetu_dropout::row_key((uint32_t)*seed, bh, row_a);
    rk[1] = hetu_dropout::row_key((uint32_t)*seed, bh, row_b);
  }

  load_tile<D>(sQ, q + base, q0, S, d);
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

  int n_tiles = (S + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBM - 1) / kBN + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k + base, k0, S, d);
    load_tile<D>(sV, v + base, k0, S, d);
    if (threadIdx.x < kBN) {
      const int key = k0 + threadIdx.x;
      sMask[threadIdx.x] =
          key >= S ? -INFINITY : (mask ? mask[(size_t)b * S + key] * kLog2e : 0.f);
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
        if (causal && k0 + col > row) x = -INFINITY;
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
    row_lse[i] = empty ? kEmptyLse : m[i] * kLn2 + logf(l[i]);
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (col >= d) continue;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row_a * d + col) =
          pack_bf16(acc[nd][0] * inv[0], acc[nd][1] * inv[0]);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)row_b * d + col) =
          pack_bf16(acc[nd][2] * inv[1], acc[nd][3] * inv[1]);
  }
  if (t == 0) {
    if (row_a < S) lse[(size_t)bh * S + row_a] = row_lse[0];
    if (row_b < S) lse[(size_t)bh * S + row_b] = row_lse[1];
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
                   float* __restrict__ lse, int n_bh, int H, int S, int d,
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
  const size_t base = (size_t)bh * S * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < kSimtBM * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP, gr = q0 + r;
    sQ[r * (DP + 1) + c] =
        (gr < S && c < d) ? to_f32(q[base + (size_t)gr * d + c]) : 0.f;
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

  int n_tiles = (S + kSimtBN - 1) / kSimtBN;
  if (causal) n_tiles = min(n_tiles, (q0 + kSimtBM - 1) / kSimtBN + 1);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kSimtBN;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kSimtBN * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP, gr = k0 + r;
      const bool in = gr < S && c < d;
      sK[r * (DP + 1) + c] = in ? to_f32(k[base + (size_t)gr * d + c]) : 0.f;
      sV[r * DP + c] = in ? to_f32(v[base + (size_t)gr * d + c]) : 0.f;
    }
    if (threadIdx.x < kSimtBN) {
      const int key = k0 + threadIdx.x;
      sMask[threadIdx.x] =
          key >= S ? -INFINITY : (mask ? mask[(size_t)b * S + key] * kLog2e : 0.f);
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
      if (causal && k0 + lane > q0 + rl) x = -INFINITY;
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
    if (row >= S) continue;
    const bool empty = l[rr] == 0.f;
    const float inv = empty ? 0.f : 1.f / l[rr];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) o[base + (size_t)row * d + c] = from_f32<T>(acc[rr][i] * inv);
    }
    if (lane == 0)
      lse[(size_t)bh * S + row] =
          empty ? kEmptyLse : m[rr] * kLn2 + logf(l[rr]);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* mask, const int32_t* seed, void* o,
                       float* lse, int B, int H, int S, int d, int causal,
                       float scale_log2, uint32_t thr, float inv_keep,
                       cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((S + kBM - 1) / kBM, B * H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, seed,
      static_cast<__nv_bfloat16*>(o), lse, B * H, H, S, d, causal,
      scale_log2, thr, inv_keep);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const float* mask, const int32_t* seed, void* o,
                        float* lse, int B, int H, int S, int d, int causal,
                        float scale_log2, uint32_t thr, float inv_keep,
                        cudaStream_t stream) {
  const size_t smem = simt_smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = bh_grid((S + kSimtBM - 1) / kSimtBM, B * H);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_simt<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, seed, static_cast<T*>(o), lse, B * H,
      H, S, d, causal, scale_log2, thr, inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(const void* q, const void* k, const void* v,
                          const float* mask, const int32_t* seed, void* o,
                          float* lse, int B, int H, int S, int d, int causal,
                          float scale_log2, uint32_t thr, float inv_keep,
                          cudaStream_t st) {
  if (d <= 32) return launch_simt<T, 1>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
  if (d <= 64) return launch_simt<T, 2>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
  if (d <= 128) return launch_simt<T, 4>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
  if (d <= 256) return launch_simt<T, 8>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
  if (d <= 512) return launch_simt<T, 16>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
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
// thr and inv_keep are unused); lse: [B*H, S] f32.  Returns a cudaError_t
// (0 = launched).
extern "C" int hetu_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const float* mask,
                                        const int32_t* seed, void* o,
                                        float* lse, int B, int H, int S,
                                        int d, int causal, float scale,
                                        uint32_t thr, float inv_keep,
                                        int is_bf16, void* stream) {
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16 && d % 8 == 0 && d <= 128) {
    switch ((d + 15) / 16) {
      case 1: return (int)launch_mma<16>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
      case 2: return (int)launch_mma<32>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
      case 3: return (int)launch_mma<48>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
      case 4: return (int)launch_mma<64>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
      case 5: return (int)launch_mma<80>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
      case 6: return (int)launch_mma<96>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
      case 7: return (int)launch_mma<112>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
      default: return (int)launch_mma<128>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
    }
  }
  if (is_bf16)
    return (int)dispatch_simt<__nv_bfloat16>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
  return (int)dispatch_simt<float>(q, k, v, mask, seed, o, lse, B, H, S, d, causal, scale_log2, thr, inv_keep, st);
}
