// row_gather: the MoE token dispatch and combine gather on Hopper.
//
// Replaces the Pallas TPU kernel of hetu_tpu/ops/pallas/moe_dispatch.py
// `row_gather` (`_make_kernel`, `pl.pallas_call` at line 124).  Its function:
//
//   out[i] = src[idx[i]]   if 0 <= idx[i] < n,
//   out[i] = 0             otherwise (negative indices included),
//
// for src [n, h] and idx [m] int32, h % 128 == 0, f32 or bf16.  The MoE
// layer runs it three times a forward: once to dispatch the tokens into
// their (expert, capacity-slot) rows and once per routing choice to bring
// each token's expert output back.  Its backward is a scatter-add of the
// cotangent rows, a plain composition in both packages.
//
// Design.  The TPU kernel DMAs 8 arbitrary rows into a VMEM scratch per grid
// step (the sublane quantum) and writes the masked block out.  Here one warp
// copies one output row straight from device memory to device memory: lane
// 0's index read is broadcast through the warp, and each lane moves 16-byte
// words (4 f32 or 8 bf16 values; h % 128 == 0 makes every row a whole
// number of them), kUnroll words in flight before its stores, neighbouring
// lanes on neighbouring addresses.  A row whose index is out of range
// stores zeros and reads nothing.  The grid runs over rows in its x
// dimension only, so no row count reaches the 65,535 limit of y and z.
// Offsets are 64-bit.  The copy is exact, so the kernel's output equals
// the plain version's bit for bit.
//
// What bounds it on the H100: the bytes.  A call must read each source row
// that an in-range index names once, write every output row once and read
// the m indices: at the MoE main path's dispatch (20,480 slots of 512 f32
// filled from ~8,192 tokens) ~59 MB, ~18 us at 3.35 TB/s; a token named by
// two slots is read twice here, the second time mostly from L2.  It does
// no arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

// src: [n, h] of T; idx: [m] int32; out: [m, h] of T, both as 16-byte words,
// vecs = h * sizeof(T) / 16 words a row.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_gather_kernel(const uint4* __restrict__ src,
                  const int32_t* __restrict__ idx, uint4* __restrict__ out,
                  int64_t n, int64_t m, int64_t vecs) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;
  int32_t j = 0;
  if (lane == 0) j = idx[row];
  j = __shfl_sync(0xffffffffu, j, 0);
  uint4* dst = out + row * vecs;
  if (j < 0 || j >= n) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int64_t v = lane; v < vecs; v += 32) dst[v] = zero;
    return;
  }
  const uint4* from = src + (int64_t)j * vecs;
  int64_t v = lane;
  for (; v + 32 * (kUnroll - 1) < vecs; v += 32 * kUnroll) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = from[v + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[v + 32 * u] = w[u];
  }
  for (; v < vecs; v += 32) dst[v] = from[v];
}

template <typename T>
int launch(const void* src, const int32_t* idx, void* out, int64_t n,
           int64_t m, int64_t h, cudaStream_t stream) {
  static_assert(16 % sizeof(T) == 0, "16-byte words of T");
  if ((h * (int64_t)sizeof(T)) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int64_t vecs = h * (int64_t)sizeof(T) / 16;
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  row_gather_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const uint4*>(src), idx, static_cast<uint4*>(out), n, m,
      vecs);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [n, h] f32 (elem_bytes 4) or bf16 (elem_bytes 2), 16-byte aligned;
// idx: [m] int32; out: [m, h] of src's type, 16-byte aligned; h * elem_bytes
// a multiple of 16.  Returns a cudaError_t (0 = launched; m = 0 launches
// nothing).
extern "C" int hetu_row_gather(const void* src, const int32_t* idx, void* out,
                               int64_t n, int64_t m, int64_t h,
                               int elem_bytes, void* stream) {
  if (n < 0 || m < 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch<float>(src, idx, out, n, m, h, s);
  if (elem_bytes == 2) return launch<__nv_bfloat16>(src, idx, out, n, m, h, s);
  return (int)cudaErrorInvalidValue;
}
