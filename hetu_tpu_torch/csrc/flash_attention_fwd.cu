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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;   // floor of the running max (TPU: m0)
constexpr float kEmptyLse = 1e30f;  // lse of a row with no live key

// -------------------------------------------------------------------------
// bf16 tensor-core kernel: 4 warps, 64 query rows per block (16 per warp),
// K/V tiles of 64 keys in shared memory, head dim padded to D (16 | D).

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kThreads = 128;

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, K, V tiles (rows padded by 8 elements against bank conflicts) + mask
  return (size_t)(kBM + 2 * kBN) * (D + 8) * sizeof(__nv_bfloat16) +
         kBN * sizeof(float);
}

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

// rows [row0, row0 + 64) x columns [0, D) of a [S, d] matrix into smem,
// in 16-byte chunks (d % 8 == 0); rows >= S and columns >= d read as zero
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int d) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kBN * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks, gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < S && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, int n_bh, int H, int S, int d,
                  int causal, float scale_log2) {
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

  load_tile<D>(sQ, q + base, q0, S, d);
  __syncthreads();
  uint32_t qa[D / 16][4];  // A fragments of this warp's 16 query rows
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qa[kc][0] = ld32(sQ + r0 * ST + kc * 16 + 2 * t);
    qa[kc][1] = ld32(sQ + (r0 + 8) * ST + kc * 16 + 2 * t);
    qa[kc][2] = ld32(sQ + r0 * ST + kc * 16 + 8 + 2 * t);
    qa[kc][3] = ld32(sQ + (r0 + 8) * ST + kc * 16 + 8 + 2 * t);
  }

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
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rsum[e >> 1] += p;
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

template <int NC>
constexpr size_t simt_smem_bytes() {
  // Q and K rows padded by one float against bank conflicts; V; mask
  return ((size_t)(kSimtBM + kSimtBN) * (32 * NC + 1) +
          (size_t)kSimtBN * 32 * NC + kSimtBN) * sizeof(float);
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

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ mask,
                   T* __restrict__ o, float* __restrict__ lse, int n_bh,
                   int H, int S, int d, int causal, float scale_log2) {
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
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegBig;
    l[rr] = 0.f;
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
      const float p = exp2f(x - m_new);
      const float alpha = exp2f(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
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

// grid of n_q query tiles x n_bh (batch, head) pairs: y holds up to 65535
// pairs, z counts the slices of that many
dim3 bh_grid(int n_q, int n_bh) {
  const int y = n_bh < 65535 ? n_bh : 65535;
  return dim3(n_q, y, (n_bh + y - 1) / y);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* mask, void* o, float* lse, int B, int H,
                       int S, int d, int causal, float scale_log2,
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
      static_cast<const __nv_bfloat16*>(v), mask,
      static_cast<__nv_bfloat16*>(o), lse, B * H, H, S, d, causal,
      scale_log2);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const float* mask, void* o, float* lse, int B, int H,
                        int S, int d, int causal, float scale_log2,
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
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, B * H, H, S,
      d, causal, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(const void* q, const void* k, const void* v,
                          const float* mask, void* o, float* lse, int B,
                          int H, int S, int d, int causal, float scale_log2,
                          cudaStream_t st) {
  if (d <= 32) return launch_simt<T, 1>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
  if (d <= 64) return launch_simt<T, 2>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
  if (d <= 128) return launch_simt<T, 4>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
  if (d <= 256) return launch_simt<T, 8>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
  if (d <= 512) return launch_simt<T, 16>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: [B*H, S, d] contiguous, bf16 (is_bf16) or f32; mask: [B, S]
// f32 or null; lse: [B*H, S] f32.  Returns a cudaError_t (0 = launched).
extern "C" int hetu_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const float* mask,
                                        void* o, float* lse, int B, int H,
                                        int S, int d, int causal, float scale,
                                        int is_bf16, void* stream) {
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16 && d % 8 == 0 && d <= 128) {
    switch ((d + 15) / 16) {
      case 1: return (int)launch_mma<16>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
      case 2: return (int)launch_mma<32>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
      case 3: return (int)launch_mma<48>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
      case 4: return (int)launch_mma<64>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
      case 5: return (int)launch_mma<80>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
      case 6: return (int)launch_mma<96>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
      case 7: return (int)launch_mma<112>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
      default: return (int)launch_mma<128>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
    }
  }
  if (is_bf16)
    return (int)dispatch_simt<__nv_bfloat16>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
  return (int)dispatch_simt<float>(q, k, v, mask, o, lse, B, H, S, d, causal, scale_log2, st);
}
